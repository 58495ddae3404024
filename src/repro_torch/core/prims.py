"""Collective primitives over the mesh axes, on ``torch.distributed`` — the
port of ``repro.core.prims``.

The JAX package runs its collectives inside a ``shard_map``, where an axis
name resolves against the mesh.  Here one process is one mesh member and a
:class:`Mesh` maps each axis name to a process group of a ``DeviceMesh``
whose dims are the axes, slowest first (``pod, host, data, model``); the
flat rank is slowest-axis-major, the layout order of the JAX package's
batch specs.  ``bind(mesh)`` makes a mesh the one that axis names resolve
against, as entering a ``shard_map`` does.

A group of size 1 issues no collective.  Every function returns a new
tensor and leaves its input as it was, as ``lax`` does.

Transport: NCCL groups take CUDA tensors.  Gloo groups take CPU tensors,
and on torch 2.11 CUDA tensors too (gloo copies them through host memory
itself) for every collective used here: checked on the H100 machine for
``all_reduce``, ``all_gather_into_tensor`` (async too),
``reduce_scatter_tensor`` and ``all_to_all_single``, so the ranks that
share one card in ``chip_smoke.py`` hand gloo their CUDA tensors as they
are.  Gloo's point-to-point ops (``isend``/``irecv``, and so
``batch_isend_irecv``) take the tensor's data pointer as a host address
and do not take CUDA tensors, so :func:`ppermute` on a gloo group copies
its send and receive buffers through host memory itself; the adds of its
callers stay on the card.  That copy is chosen by the group's backend.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

#: mesh axes in the order the port lays them out, slowest tier first
MESH_AXES = ("pod", "host", "data", "model")

Axes = Union[str, Sequence[str]]


class Mesh:
    """This process's place in a mesh of ``torch.distributed`` ranks.

    ``sizes``: {axis: size}, axes in ``MESH_AXES`` order (absent axes are
    not part of the mesh).  The process group must be initialised, with a
    world size equal to the product of the sizes."""

    def __init__(self, sizes: Dict[str, int]):
        from torch.distributed.device_mesh import DeviceMesh
        names = tuple(a for a in MESH_AXES if a in sizes)
        if set(names) != set(sizes):
            raise ValueError(f"mesh axes {tuple(sizes)} not in {MESH_AXES}")
        shape = tuple(int(sizes[a]) for a in names)
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                             f"{math.prod(shape)} ranks, the world has {world}")
        self.axis_names = names
        self.sizes = dict(zip(names, shape))
        self.backend = dist.get_backend()
        self.device_mesh = DeviceMesh(
            "cpu" if self.backend == "gloo" else "cuda",
            torch.arange(world).reshape(shape), mesh_dim_names=names)
        self.groups = {a: self.device_mesh.get_group(a) for a in names}
        self.coords = self.coords_of(dist.get_rank())

    def coords_of(self, rank: int) -> Dict[str, int]:
        """A member's index along each axis, by its flat rank."""
        coords = {}
        for a in reversed(self.axis_names):
            coords[a] = rank % self.sizes[a]
            rank //= self.sizes[a]
        return coords

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def flat_rank(self) -> int:
        return dist.get_rank()


_MESH: Optional[Mesh] = None

# renamed in torch 2.13, where the old names warn; torch 2.11 has the old
# names only
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


@contextlib.contextmanager
def bind(mesh: Mesh):
    """Resolve axis names against ``mesh`` inside the block."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError("no mesh bound: run collectives inside "
                           "`with prims.bind(mesh):`")
    return _MESH


def axis_size(axis_name: str) -> int:
    return current_mesh().size(axis_name)


def axis_rank(axis_name: str) -> int:
    """This member's index along ``axis_name``."""
    return current_mesh().rank(axis_name)


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


@dataclass
class Pending:
    """A collective in flight; ``wait()`` returns its result."""

    result: torch.Tensor
    work: Optional[object] = None

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
        return self.result


def _run(op, out: torch.Tensor, inp: Optional[torch.Tensor], axis: str,
         async_op: bool = False) -> Pending:
    """``op(out[, inp], group=, async_op=)`` over ``axis``'s group."""
    group = current_mesh().groups[axis]
    args = (out,) if inp is None else (out, inp)
    return Pending(out, op(*args, group=group, async_op=async_op))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Sum over every axis in ``axes`` (``lax.psum``)."""
    active = [a for a in _axes(axes) if axis_size(a) > 1]
    if not active:
        return x
    y = x.contiguous().clone()
    for a in active:
        _run(dist.all_reduce, y, None, a).wait()
    return y


def psum_async(x: torch.Tensor, axis_name: str) -> Pending:
    """Start a sum over one axis; ``wait()`` returns it."""
    if axis_size(axis_name) == 1:
        return Pending(x)
    return _run(dist.all_reduce, x.contiguous().clone(), None, axis_name,
                async_op=True)


def pmean(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    n = math.prod(axis_size(a) for a in _axes(axes))
    return psum(x, axes) / n


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Elementwise max over one axis (``lax.pmax``)."""
    if axis_size(axis_name) == 1:
        return x
    y = x.detach().contiguous().clone()
    group = current_mesh().groups[axis_name]
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def reduce_scatter_tiled(x: torch.Tensor, axis_name: str,
                         dim: int) -> torch.Tensor:
    """Tiled reduce-scatter along ``dim``: member *i* keeps block *i* of
    the sum (``lax.psum_scatter(..., tiled=True)``).
    The collective splits dim 0, so ``dim`` is moved there and
    back."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} members of {axis_name!r}")
    out = torch.empty((xm.shape[0] // n,) + xm.shape[1:], dtype=x.dtype,
                      device=x.device)
    _run(_reduce_scatter, out, xm, axis_name).wait()
    return out.movedim(0, dim)


def all_gather_tiled(x: torch.Tensor, axis_name: str,
                     dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim`` (member *i*'s block at position
    *i*)."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + xm.shape[1:], dtype=x.dtype,
                      device=x.device)
    _run(_all_gather, out, xm, axis_name).wait()
    return out.movedim(0, dim)


def all_to_all_tiled(x: torch.Tensor, axis_name: str,
                     dim: int) -> torch.Tensor:
    """Tiled all-to-all along ``dim``: block *j* of ``x`` goes to member
    *j*, and the block received from member *i* lands at position *i*
    (``lax.all_to_all(..., split_axis=dim, concat_axis=dim, tiled=True)``).
    Member *i* of a sub-group is index *i* on its axis, the order ``lax``
    uses."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} members of {axis_name!r}")
    out = torch.empty_like(xm)
    _run(dist.all_to_all_single, out, xm, axis_name).wait()
    return out.movedim(0, dim)


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` along the (source, destination) pairs of ``perm``, axis
    indices; a member that no pair sends to gets zeros (``lax.ppermute``).
    On a gloo group a CUDA tensor is sent and received through host
    buffers (see the module docstring); NCCL takes it as it is."""
    mesh = current_mesh()
    me = mesh.rank(axis_name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    out = torch.zeros_like(x)
    if not dst and not src:
        return out
    group = mesh.groups[axis_name]
    host = mesh.backend == "gloo" and x.device.type != "cpu"
    send = x.detach().contiguous()
    send = send.cpu() if host else send
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, d),
                      group) for d in dst]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, s),
                       group) for s in src]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if src:
        out.copy_(recv)
    return out


def all_gather_stacked(x: torch.Tensor, axis_name: str,
                       async_op: bool = False):
    """Untiled all-gather: a new leading member dim, (n,) + x.shape.  With
    ``async_op`` returns a :class:`Pending` instead of the tensor."""
    n = axis_size(axis_name)
    if n == 1:
        out = Pending(x[None])
    else:
        # gathered flat (gloo wants dim 0 of the output to be n copies of
        # the input's), viewed as (n,) + x.shape
        flat = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        out = _run(_all_gather, flat, x.reshape(-1), axis_name,
                   async_op=async_op)
        out.result = flat.view((n,) + tuple(x.shape))
    return out if async_op else out.wait()


# ---------------------------------------------------------------------------
# collectives that carry a gradient
# ---------------------------------------------------------------------------
#
# What GSPMD inserts for the JAX package's auto-sharded model, written out
# as autograd Functions over the ops above (the Megatron "f" and "g"
# operators, FSDP's gather-on-use, and the sequence split's scatter and
# cut).  Each is the identity when the axis has one member.  ``TP_CALLS`` counts the collectives they run, a
# recomputed layer's again: the sums in the forward and in the backward,
# the gathers and the reduce-scatters.

TP_CALLS = {"psum_fwd": 0, "psum_bwd": 0, "gather": 0, "reduce_scatter": 0}


class _PsumIdentityGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        TP_CALLS["psum_fwd"] += 1
        return psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentityPsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        TP_CALLS["psum_bwd"] += 1
        return psum(g, ctx.axis), None


class _GatherScatterGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        TP_CALLS["gather"] += 1
        return all_gather_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        TP_CALLS["reduce_scatter"] += 1
        return reduce_scatter_tiled(g, ctx.axis, ctx.dim), None, None


class _GatherSliceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        TP_CALLS["gather"] += 1
        return all_gather_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        start = axis_rank(ctx.axis) * ctx.n
        return g.narrow(ctx.dim, start, ctx.n), None, None


class _ScatterGatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        TP_CALLS["reduce_scatter"] += 1
        return reduce_scatter_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        TP_CALLS["gather"] += 1
        return all_gather_tiled(g, ctx.axis, ctx.dim), None, None


class _SliceGatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} members of {axis!r}")
        blk = x.shape[dim] // n
        return x.narrow(dim, axis_rank(axis) * blk, blk).contiguous()

    @staticmethod
    def backward(ctx, g):
        TP_CALLS["gather"] += 1
        return all_gather_tiled(g, ctx.axis, ctx.dim), None, None


class _PsumPsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        TP_CALLS["psum_fwd"] += 1
        return psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        TP_CALLS["psum_bwd"] += 1
        return psum(g, ctx.axes), None


def psum_replicated(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """Sum over ``axis`` whose backward is the identity: the output of a
    row-parallel product, after which every member computes alike, so
    each holds the whole gradient already."""
    if axis is None or axis_size(axis) == 1:
        return x
    return _PsumIdentityGrad.apply(x, axis)


def psum_shared(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Sum of the members' parts over ``axes`` whose backward is a sum as
    well: every member uses the sum in its own share of the loss (the
    batch's MoE aux loss under the GSPMD step), so each part's gradient is
    the sum of every member's use."""
    active = tuple(a for a in _axes(axes) if axis_size(a) > 1)
    if not active:
        return x
    return _PsumPsumGrad.apply(x, active)


def to_parallel(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """The identity whose backward sums over ``axis``: a replicated tensor
    entering a region where each member computes its own part (a
    column-parallel input, or a replicated leaf used on local heads), so
    that its gradient is the sum of the members' parts."""
    if axis is None or axis_size(axis) == 1:
        return x
    return _IdentityPsumGrad.apply(x, axis)


def gather_on_use(x: torch.Tensor, axis: Optional[str],
                  dim: int) -> torch.Tensor:
    """FSDP's gather of a leaf's blocks along ``dim`` over ``axis``; the
    backward reduce-scatters the gradient back onto the blocks (the sum
    of every member's gradient, each member keeping its block)."""
    if axis is None or axis_size(axis) == 1:
        return x
    return _GatherScatterGrad.apply(x, axis, dim)


def gather_replicated(x: torch.Tensor, axis: Optional[str],
                      dim: int) -> torch.Tensor:
    """The gather of a leaf's blocks along ``dim`` over ``axis`` into a
    tensor that every member then uses alike (the learned positions' d
    columns under a model axis, added to the replicated residual stream):
    each member holds the whole gradient already, so the backward keeps
    this member's block of it."""
    if axis is None or axis_size(axis) == 1:
        return x
    return _GatherSliceGrad.apply(x, axis, dim)


def scatter_sum(x: torch.Tensor, axis: Optional[str], dim: int) -> torch.Tensor:
    """The sum over ``axis`` of the members' parts, each member keeping its
    block along ``dim`` (a tiled reduce-scatter): the output of a
    row-parallel product onto a sequence-split residual stream (the
    Megatron-SP scatter point).  Each member's loss reads its block only,
    so the backward gathers the members' block gradients: every part's
    gradient is the whole of them."""
    if axis is None or axis_size(axis) == 1:
        return x
    return _ScatterGatherGrad.apply(x, axis, dim)


def split_replicated(x: torch.Tensor, axis: Optional[str],
                     dim: int) -> torch.Tensor:
    """This member's block along ``dim`` of a tensor that every member of
    ``axis`` computed alike (the embedding lookup of whole tables, or the
    output of a sublayer run whole on the gathered sequence, entering a
    sequence-split residual stream).  The backward gathers the members'
    block gradients, so that each member holds the whole gradient of the
    replicated tensor, as before the split."""
    if axis is None or axis_size(axis) == 1:
        return x
    return _SliceGatherGrad.apply(x, axis, dim)
