"""Utilities: the flax -> state_dict converter, logging and run configs."""

from pointasnl_tpu_torch.utils.config import load_args, save_args, snapshot_sources
from pointasnl_tpu_torch.utils.convert import flax_to_state_dict
from pointasnl_tpu_torch.utils.logging import Logger

__all__ = ["Logger", "flax_to_state_dict", "load_args", "save_args", "snapshot_sources"]
