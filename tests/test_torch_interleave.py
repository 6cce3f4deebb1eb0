"""The port's await-interleaving rules (``narwhal_tpu_torch/analysis/
interleave.py``) on the port's tree, on the CPU: the cases of
``tests/test_interleave.py`` run again on the port — fixture snippets
under ``narwhal_tpu_torch/``, the live tree clean, the pragmas of the
port's copied Proposer and Store stripped to resurface their windows,
and the race explorer's planted race (the port copy of
``benchmark/race_explore.py``, which overlays the port's
``consensus/tusk.py``) flagged."""

from tests.test_torch_tasks import mirror, port_benchmark

RACE = port_benchmark("race_explore")

MIRRORED = mirror(
    globals(), "test_interleave",
    subs=(("from benchmark.race_explore import", f"from {RACE} import"),),
)


def test_mirrors_cover_the_reference_cases():
    assert len(MIRRORED) == 13
