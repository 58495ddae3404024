"""Mesh layout of the training CLI — what ``launch/train.py`` needs of
``repro.launch.mesh`` and of the JAX CLI's ``--mesh`` rules.

A mesh is {axis: size}, slowest tier first.  Each rank of the
``torch.distributed`` world is one member (see ``core.prims.Mesh``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


def mesh_axes(dims: Sequence[int]) -> Tuple[str, ...]:
    """The axis names of a ``--mesh`` shape, by the JAX CLI's rules: four
    dims are (pod, host, data, model), three (pod, data, model), fewer the
    trailing ones of (pod, data, model)."""
    if len(dims) == 4:  # 3-tier fabric
        return ("pod", "host", "data", "model")
    if len(dims) < 3:
        return ("pod", "data", "model")[-len(dims):]
    return ("pod", "data", "model")


def parse_mesh(spec: Optional[str], default_data: int = 1) -> Dict[str, int]:
    """``"2,2,2,1"`` -> {'pod': 2, 'host': 2, 'data': 2, 'model': 1}; None
    -> (pod, data, model) = (1, default_data, 1)."""
    if not spec:
        return {"pod": 1, "data": default_data, "model": 1}
    dims = tuple(int(x) for x in spec.split(","))
    return dict(zip(mesh_axes(dims), dims))


def mesh_ranks(sizes: Dict[str, int]) -> int:
    return math.prod(sizes.values())


def rank_device(device: str, backend: str, rank: int, world: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % cards``.  NCCL
    needs a card per rank; gloo lets ranks share a card (its CUDA payloads
    go through host memory)."""
    if device == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise ValueError(f"{world} ranks under nccl need {world} cards, "
                         f"this machine has {cards}; use --backend gloo to "
                         f"share cards")
    return torch.device("cuda", rank % cards)
