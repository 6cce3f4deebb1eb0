"""The benchmark of the PyTorch/CUDA port (``narwhal_tpu_torch``).

One run starts one committee of port validators through the port's node
CLI, drives it with an open-loop load generator for a fixed window, stops
every process it started, judges what the run left behind against the
plain reference in ``portbench/reference``, and prints one JSON line.

    python3 -m portbench.run --workload local4-steady --seed 7 \
        --seconds 10 --trace 0

Everything that belongs to one deployment, traffic mix or per-layer
metric is a file of its own, found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<workload>.json`` and
``metrics/<metric>.py``.  Nothing here imports ``jax`` or the JAX
package, and nothing here reads the JAX package's ``benchmark/`` folder.
"""
