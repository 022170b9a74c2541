"""Synthetic point clouds for the port's benchmarks and checks (numpy only)."""

from pointasnl_tpu_torch.data.synthetic import surface_scene

__all__ = ["surface_scene"]
