"""PointASNL in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``pointasnl_tpu``, which stays the reference it is
held against. It mirrors that package's layout and names:

- ``pointasnl_tpu_torch.ops``    — geometry primitives: plain PyTorch versions
  (``ops.geometry``) and CUDA kernels (``ops.cuda``, sources in ``csrc/``),
  routed by the tensor's device (``ops.dispatch``).
- ``pointasnl_tpu_torch.nn``     — the PointASNL / PointNet++ modules.
- ``pointasnl_tpu_torch.models`` — the models and their name registry.
- ``pointasnl_tpu_torch.train``  — schedules, optimizer, train/eval steps.
- ``pointasnl_tpu_torch.utils``  — the flax -> ``state_dict`` converter.
- ``pointasnl_tpu_torch.serve``  — the inference forward.
- ``pointasnl_tpu_torch.data``   — synthetic scenes (numpy).

The port runs in float32, on the card unless a model is built with
``device="cpu"``. So far it covers the eval forward of the classifier
(``pointasnl_cls``), the train step and eval forward of the residual
segmentation model (``pointasnl_sem_seg_res``), and that model's
whole-scene forward in one pass (``nl_kv_block_size``).
"""

__version__ = "0.1.0"
