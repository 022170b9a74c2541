"""The seg step and the grid driver under ``nl_use_flash`` in bfloat16 on
the CPU (the flash kernels' plain versions), against the JAX package.

- The bfloat16 gate of ``test_torch_precision`` (``seg_gate_runs``: the
  port's and JAX's seg steps at B2 x 2048 in float32 and bfloat16, the
  searches replayed) once more with ``nl_use_flash=True`` in both packages,
  JAX's Pallas flash kernels interpreted (``pltpu.force_tpu_interpret_mode()``).
- ``cli.train_scannet_grid --nl_flash true --device cpu --debug`` and
  ``cli.test_scannet_grid`` under ``POINTASNL_COMPUTE_DTYPE=bfloat16`` (the
  JAX package's way to a bfloat16 run, which reaches its bfloat16 flash
  kernels) on the tiny synthetic rooms of ``tests/test_cli_grid.py``: q, k
  and v reach ``flash_attention`` in bfloat16 in every non-local cell.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_cli_grid import synthetic_scannet_grid  # noqa: F401 (fixture)
from test_torch_precision import check_gate, seg_gate_runs

from pointasnl_tpu_torch.cli import test_scannet_grid, train_scannet_grid
from pointasnl_tpu_torch.nn import pointasnl as tp

torch.set_num_threads(1)


def test_seg_bf16_flash_step_passes_the_gate():
    """check_gate's three distances, as for the dense step: the port's
    bfloat16 flash step no further from JAX's bfloat16 flash step than JAX's
    bfloat16 flash step is from its float32 one."""
    with pltpu.force_tpu_interpret_mode():
        runs = seg_gate_runs(nl_use_flash=True)
    check_gate(runs)


def test_grid_driver_runs_bf16_flash_from_the_environment(synthetic_scannet_grid,  # noqa: F811
                                                          tmp_path, monkeypatch):
    seen = []
    real = tp.flash_attention

    def spy(q, k, v, scaled=True):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, scaled)

    monkeypatch.setattr(tp, "flash_attention", spy)
    monkeypatch.setenv("POINTASNL_COMPUTE_DTYPE", "bfloat16")
    log_dir = str(tmp_path / "logs")
    best = train_scannet_grid.main(["--data", synthetic_scannet_grid, "--log_dir", log_dir,
                                    "--batch_size", "2", "--num_point", "512",
                                    "--num_buffer", "64", "--in_radius", "0.8", "--debug",
                                    "--nl_flash", "true", "--device", "cpu"])
    assert 0.0 <= best <= 100.0
    assert seen and len(seen) % 4 == 0  # four non-local cells a forward
    assert set(seen) == {(torch.bfloat16,) * 3}
    seen.clear()
    miou = test_scannet_grid.main(["--data", synthetic_scannet_grid, "--model_path", log_dir,
                                   "--ckpt", "latest", "--num_votes", "0.001", "--max_rounds",
                                   "1", "--batch_size", "2", "--device", "cpu", "--dump_dir",
                                   str(tmp_path / "dump")])
    assert 0.0 <= miou <= 100.0
    assert seen and set(seen) == {(torch.bfloat16,) * 3}
