"""narwhal-tpu-torch — the PyTorch/CUDA port of narwhal-tpu.

A second package beside the JAX reference (``narwhal_tpu``), with the same
module paths and names.  Host modules are copies of the reference's, with
their imports pointed here; the device programs of the reference's
``ops/`` package are hand-written CUDA kernels for Hopper (sm_90a) under
``csrc/``, each with a plain PyTorch twin in the ``ops`` module that wraps
it.  This package never imports ``jax`` or ``narwhal_tpu``.
"""

__version__ = "0.1.0"
