"""Load a JAX parameter tree, flattened to ``{path: np.ndarray}``, into a
port ``Model``.

The flat form is what ``repro.utils.trees.tree_paths`` gives for the JAX
package's ``Model.init``; the port's ``Model`` registers the same paths
with the same shapes.  bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays (or, read from a checkpoint file, as 2-byte void arrays), which
``torch.from_numpy`` rejects, so they cross as their 16-bit payload.  A
model that holds blocks (``Model.shard``) takes the global arrays and
keeps its member's block of each.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models import sharding
from repro_torch.models.registry import Model
from repro_torch.utils.trees import tree_paths


def numpy_to_torch(arr) -> torch.Tensor:
    """A CPU tensor holding ``arr``'s values in its dtype (bf16 included:
    an ``ml_dtypes.bfloat16`` array, or the 2-byte void array that
    ``np.load`` gives for one saved to a file)."""
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_jax_params(model: Model, flat: Mapping[str, np.ndarray]) -> None:
    """Copy every leaf of ``flat`` (the global arrays) into ``model``, or
    this member's block of it where the model holds blocks.  Every path,
    shape and dtype is checked before anything is copied: a missing or
    extra leaf raises ``KeyError``, a shape or dtype mismatch
    ``ValueError``."""
    own = {name.replace(".", "/"): p for name, p in model.named_parameters()}
    lay = model.layout
    shapes = {k: v.shape for k, v in tree_paths(model.param_shapes()).items()}
    missing, extra = sorted(set(own) - set(flat)), sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    tensors = {}
    for path, arr in flat.items():
        p = own[path]
        if tuple(np.shape(arr)) != tuple(shapes[path]):
            raise ValueError(f"{path}: shape {tuple(np.shape(arr))} != model's "
                             f"{tuple(shapes[path])}")
        if lay is not None:
            arr = sharding.local_block(np.asarray(arr), lay.specs[path],
                                       lay.coords, lay.sizes)
        t = numpy_to_torch(arr)
        if t.dtype != p.dtype:
            raise ValueError(f"{path}: dtype {t.dtype} != model's {p.dtype}")
        tensors[path] = t
    with torch.no_grad():
        for path, t in tensors.items():
            own[path].copy_(t)
