"""The port's frozen golden oracles (``consensus/golden.py``,
``golden_lowdepth.py``, ``golden_multileader.py``) against the JAX
package's, on the CPU.

- The same certificate DAGs, drawn from a seed with numpy and built in
  each package from its own classes, go through the JAX and the port
  oracle of each commit rule: the committed digest sequences must be the
  same bytes (tolerance 0).
- The port's ``KernelTusk(device="cpu")`` (the plain twins of the card's
  window kernels) commits what the port's ``GoldenTusk`` commits on the
  same DAG.
- Then the cases of ``tests/test_tusk_equivalence.py`` run again on the
  port (those of the other two rules' equivalence suites, which share
  their test names, in ``tests/test_torch_golden_lowdepth.py`` and
  ``tests/test_torch_golden_multileader.py``)."""

import numpy as np
import pytest

import narwhal_tpu.config as jconfig
import narwhal_tpu.consensus.golden as jgolden
import narwhal_tpu.consensus.golden_lowdepth as jlowdepth
import narwhal_tpu.consensus.golden_multileader as jmultileader
import narwhal_tpu.primary.messages as jpmessages
import narwhal_tpu_torch.config as tconfig
import narwhal_tpu_torch.consensus.golden as tgolden
import narwhal_tpu_torch.consensus.golden_lowdepth as tlowdepth
import narwhal_tpu_torch.consensus.golden_multileader as tmultileader
import narwhal_tpu_torch.primary.messages as tpmessages
from narwhal_tpu_torch.ops.reachability import KernelTusk

from tests.common import committee
from tests.test_torch_tasks import mirror, package_state

MIRRORED_TUSK = mirror(globals(), "test_tusk_equivalence")


def test_mirror_covers_the_reference_cases():
    assert len(MIRRORED_TUSK) == 10


# -- the oracles across packages ----------------------------------------------

PACKAGES = {
    "jax": (jconfig, jpmessages,
            (jgolden.GoldenTusk, jlowdepth.GoldenLowDepthTusk,
             jmultileader.GoldenMultiLeaderTusk)),
    "torch": (tconfig, tpmessages,
              (tgolden.GoldenTusk, tlowdepth.GoldenLowDepthTusk,
               tmultileader.GoldenMultiLeaderTusk)),
}
RULES = ("classic", "lowdepth", "multileader")


def dag_plan(seed: int, n: int, rounds: int, shuffle: float):
    """A random DAG as indices: per round, the live authorities (a quorum
    or more) and each one's parents among the previous round's live
    certificates (a quorum or more); then a delivery order that may put a
    child up to ``shuffle`` rounds ahead of its parents."""
    rng = np.random.default_rng(seed)
    quorum = 2 * ((n - 1) // 3) + 1
    plan, prev = [], list(range(n))  # round 0: the genesis of every authority
    for r in range(1, rounds + 1):
        live = sorted(rng.permutation(n)[:rng.integers(quorum, n + 1)].tolist())
        for a in live:
            k = int(rng.integers(min(quorum, len(prev)), len(prev) + 1))
            plan.append((r, a, sorted(rng.permutation(prev)[:k].tolist())))
        prev = live
    keys = [r - rng.uniform(0.0, shuffle) for r, _, _ in plan]
    order = sorted(range(len(plan)), key=lambda i: (keys[i], i))
    return plan, order


def build(pkg: str, plan, order, n: int):
    """The plan's certificates in package ``pkg``, in delivery order, and
    that package's committee."""
    config, pmessages, _ = PACKAGES[pkg]
    c = config.Committee.from_json(committee(n=n).to_json())
    names = sorted(c.authorities)
    digests = {(0, names.index(g.origin)): g.digest() for g in pmessages.genesis(c)}
    certs = []
    for r, a, parents in plan:
        cert = pmessages.Certificate(header=pmessages.Header(
            author=names[a], round=r, payload={},
            parents={digests[(r - 1, p)] for p in parents}))
        digests[(r, a)] = cert.digest()
        certs.append(cert)
    return [certs[i] for i in order], c


def committed(oracle, certs) -> list:
    return [bytes(x.digest()) for cert in certs
            for x in oracle.process_certificate(cert)]


CASES = [(seed, n, rounds, shuffle, gc_depth, fixed_coin)
         for seed, n, rounds, shuffle, gc_depth, fixed_coin in (
             (0, 4, 30, 0.0, 50, True),
             (1, 4, 40, 2.2, 50, False),
             (2, 7, 30, 1.0, 50, False),
             (3, 7, 36, 0.0, 6, True),
             (4, 10, 24, 1.5, 50, False),
         )]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "seed%d-n%d" % (c[0], c[1]))
def test_oracles_commit_the_same_bytes_in_both_packages(rule, case):
    seed, n, rounds, shuffle, gc_depth, fixed_coin = case
    plan, order = dag_plan(seed, n, rounds, shuffle)
    seqs = {}
    with package_state():
        for pkg, (_, _, oracles) in PACKAGES.items():
            certs, c = build(pkg, plan, order, n)
            oracle = oracles[RULES.index(rule)](c, gc_depth, fixed_coin=fixed_coin)
            seqs[pkg] = committed(oracle, certs)
    assert seqs["torch"] == seqs["jax"]
    assert len(seqs["jax"]) > 2 * n, "the DAG committed too little to compare"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "seed%d-n%d" % (c[0], c[1]))
def test_kernel_tusk_commits_what_golden_tusk_commits(case):
    seed, n, rounds, shuffle, gc_depth, fixed_coin = case
    plan, order = dag_plan(seed, n, rounds, shuffle)
    certs, c = build("torch", plan, order, n)
    want = committed(tgolden.GoldenTusk(c, gc_depth, fixed_coin=fixed_coin), certs)
    got = committed(KernelTusk(c, gc_depth, fixed_coin=fixed_coin, device="cpu"), certs)
    assert got == want and want


def test_dags_are_the_same_bytes_in_both_packages():
    plan, order = dag_plan(2, 7, 12, 1.0)
    with package_state():
        jcerts, _ = build("jax", plan, order, 7)
        tcerts, _ = build("torch", plan, order, 7)
    assert [bytes(x.digest()) for x in tcerts] == [bytes(x.digest()) for x in jcerts]
