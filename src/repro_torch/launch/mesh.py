"""Mesh layouts — ``repro.launch.mesh`` (the production and test meshes)
and the JAX CLI's ``--mesh`` rules.

A mesh here is {axis: size}, slowest tier first: what the sharding rules,
the planner and the cells read.  Each rank of the ``torch.distributed``
world is one member of a bound mesh (``core.prims.Mesh``);
:func:`one_process_mesh` binds a one-member mesh to a world of this
process alone (the examples' meshes).
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False,
                         tiers: int = 2) -> Dict[str, int]:
    """The canonical 512-member production meshes.  ``tiers=2``: (pod,
    data, model) = (2, 16, 16), or (data, model) = (16, 16) in one pod.
    ``tiers=3``: (pod, host, data, model) = (2, 4, 4, 16), the pod's DP
    side split into 4 hosts of 4 data ranks, or (host, data, model) =
    (4, 4, 16) in one pod."""
    if multi_pod and tiers >= 3:
        return {"pod": 2, "host": 4, "data": 4, "model": 16}
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    if tiers >= 3:
        return {"host": 4, "data": 4, "model": 16}
    return {"data": 16, "model": 16}


def make_test_mesh(shape: Sequence[int] = (2, 2, 2),
                   axes: Sequence[str] = ("pod", "data", "model")
                   ) -> Dict[str, int]:
    """A small mesh for tests."""
    return dict(zip(tuple(axes), (int(n) for n in shape)))


def make_ntier_test_mesh(shape: Sequence[int] = (2, 2, 2),
                         axes: Sequence[str] = ("pod", "host", "data")
                         ) -> Dict[str, int]:
    """A small 3-tier DP mesh for tests, slowest tier first."""
    return dict(zip(tuple(axes), (int(n) for n in shape)))


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


def default_backend(device) -> str:
    """The process-group backend for ranks on ``device``: nccl on a card,
    gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@contextlib.contextmanager
def one_process_mesh(shape: Sequence[int], axes: Sequence[str], device) -> Iterator:
    """A ``core.prims.Mesh`` of ``shape`` (every size 1) over ``axes``,
    bound to a ``torch.distributed`` world of this process alone, joined
    through a file store in a temporary directory, under
    :func:`default_backend` of ``device``; the world is destroyed on exit.
    The twin of the reference's ``make_mesh`` on one device."""
    from repro_torch.core.prims import Mesh
    if math.prod(shape) != 1:
        raise ValueError(f"a mesh of {tuple(shape)} needs "
                         f"{math.prod(shape)} processes, not one")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(default_backend(dev),
                                init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0)
        try:
            yield Mesh(dict(zip(axes, shape)))
        finally:
            dist.destroy_process_group()
