"""PointASNL in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``pointasnl_tpu``, which stays the reference it is
held against. It mirrors that package's layout and names:

- ``pointasnl_tpu_torch.ops``    — geometry primitives: plain PyTorch versions
  (``ops.geometry``) and CUDA kernels (``ops.cuda``, sources in ``csrc/``),
  routed by the tensor's device (``ops.dispatch``).
- ``pointasnl_tpu_torch.nn``     — the PointASNL / PointNet++ modules.
- ``pointasnl_tpu_torch.models`` — the models and their name registry.
- ``pointasnl_tpu_torch.utils``  — the flax -> ``state_dict`` converter.
- ``pointasnl_tpu_torch.serve``  — the inference forward.

The port runs in float32. So far it covers the eval forward of the
classifier (``pointasnl_cls``).
"""

__version__ = "0.1.0"
