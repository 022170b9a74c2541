"""PointASNL in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``pointasnl_tpu``, which stays the reference it is
held against. It mirrors that package's layout and names:

- ``pointasnl_tpu_torch.ops``    — geometry primitives: plain PyTorch versions
  (``ops.geometry``) and CUDA kernels (``ops.cuda``, sources in ``csrc/``),
  routed by the tensor's device (``ops.dispatch``).
- ``pointasnl_tpu_torch.nn``     — the PointASNL / PointNet++ modules.
- ``pointasnl_tpu_torch.models`` — the models and their name registry.
- ``pointasnl_tpu_torch.train``  — schedules, optimizer, train/eval steps.
- ``pointasnl_tpu_torch.utils``  — the flax -> ``state_dict`` converter,
  logging and run configs.
- ``pointasnl_tpu_torch.serve``  — the inference forward.
- ``pointasnl_tpu_torch.data``   — synthetic scenes and the ScanNet datasets
  (numpy).
- ``pointasnl_tpu_torch.cli``    — the ScanNet train and test CLIs.

The port runs in float32 or bfloat16, on the card unless a model is built
with ``device="cpu"`` (a CLI run with ``--device cpu``). It covers the
classifier (``pointasnl_cls``), the residual segmentation model
(``pointasnl_sem_seg_res``) and the encoder-decoder one
(``pointasnl_sem_seg``): their train steps and eval forwards, whole scenes
in one pass (``nl_kv_block_size``), and the ScanNet CLIs.
"""

__version__ = "0.1.0"
