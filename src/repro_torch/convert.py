"""Load a JAX parameter tree, flattened to ``{path: np.ndarray}``, into a
port ``Model``.

The flat form is what ``repro.utils.trees.tree_paths`` gives for the JAX
package's ``Model.init``; the port's ``Model`` registers the same paths
with the same shapes.  bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays, which ``torch.from_numpy`` rejects, so they cross as their uint16
bits.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.registry import Model


def numpy_to_torch(arr) -> torch.Tensor:
    """A CPU tensor holding ``arr``'s values in its dtype (bf16 included)."""
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_jax_params(model: Model, flat: Mapping[str, np.ndarray]) -> None:
    """Copy every leaf of ``flat`` into ``model``.  Every path, shape and
    dtype is checked before anything is copied: a missing or extra leaf
    raises ``KeyError``, a shape or dtype mismatch ``ValueError``."""
    own = {name.replace(".", "/"): p for name, p in model.named_parameters()}
    missing, extra = sorted(set(own) - set(flat)), sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    tensors = {}
    for path, arr in flat.items():
        t = numpy_to_torch(arr)
        p = own[path]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != model's "
                             f"{tuple(p.shape)}")
        if t.dtype != p.dtype:
            raise ValueError(f"{path}: dtype {t.dtype} != model's {p.dtype}")
        tensors[path] = t
    with torch.no_grad():
        for path, t in tensors.items():
            own[path].copy_(t)
