"""Hand-written CUDA kernels for Hopper, beside the JAX package's ``ops/pallas``.

Each module wraps one kernel of ``pointasnl_tpu_torch/csrc`` and counts its
launches in a module-level ``launches`` integer. Importing builds nothing: the
library is built by ``_build.library()`` at the first kernel call.
"""
