"""Utilities: the flax -> state_dict converter."""

from pointasnl_tpu_torch.utils.convert import flax_to_state_dict

__all__ = ["flax_to_state_dict"]
