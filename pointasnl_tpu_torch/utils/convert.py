"""JAX (flax) variables -> the port's ``state_dict``.

The port's modules carry the flax module names, so the conversion is
mechanical: a leaf's flax path joined by ``.`` is its ``state_dict`` key, with
a Dense ``kernel`` (in, out) stored transposed as ``weight`` (out, in).
``params`` hold the parameters, ``batch_stats`` the BN buffers ``mean`` and
``var``. A tree of gradients (or of an optimizer's moments) converts the same
way, as ``{"params": grads}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: tuple = ()):
    for name, value in tree.items():
        path = prefix + (name,)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def flax_to_state_dict(variables: Mapping[str, Any],
                       dtype=np.float32) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` nested dicts of arrays
    (numpy, or anything ``np.asarray`` takes) to a ``state_dict`` of `dtype`."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            array = np.array(value, dtype=dtype)
            if path[-1] == "kernel":
                if array.ndim != 2:
                    raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense kernel")
                path = path[:-1] + ("weight",)
                array = array.T.copy()
            key = ".".join(path)
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r}")
            out[key] = torch.from_numpy(array)
    return out
