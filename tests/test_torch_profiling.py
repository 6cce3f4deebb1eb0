"""The port's ``profiling.py`` (the node's sampling profiler) against the
JAX package's, on the CPU: ``tests/test_profiling.py`` runs again on the
port."""

from tests.test_torch_tasks import mirror

MIRRORED = mirror(globals(), "test_profiling")


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED) == 5
