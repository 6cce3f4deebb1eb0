"""The cases of ``tests/test_lowdepth_equivalence.py`` run again on the
port: its live low-depth rule against its frozen ``GoldenLowDepthTusk``,
the rule's selection and refusals, and the audit segment's rule marker
judged by ``consensus/replay.py``.  The cross-package oracle checks are
in ``tests/test_torch_golden.py``."""

from tests.test_torch_tasks import mirror

MIRRORED = mirror(globals(), "test_lowdepth_equivalence")


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED) == 12
