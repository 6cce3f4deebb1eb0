"""The cases of ``tests/test_multileader_equivalence.py`` run again on
the port: its live multi-leader rule against its frozen
``GoldenMultiLeaderTusk``, the slot schedule, the rule's selection and
refusals, and the audit segment's rule marker.  The cross-package oracle
checks are in ``tests/test_torch_golden.py``."""

from tests.test_torch_tasks import mirror

MIRRORED = mirror(
    globals(), "test_multileader_equivalence",
    # The schedule's subprocess imports the port alone: the reference
    # fixture's keys, made the same way, in place of tests.common.
    subs=(('"from tests.common import keys\\n"',
           '"from narwhal_tpu.crypto import KeyPair\\n"\n'
           '        "keys = lambda: [KeyPair.generate(bytes([i]) * 32) '
           'for i in range(4)]\\n"'),),
)


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED) == 17
