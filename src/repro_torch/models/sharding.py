"""Parameter sharding rules of every family (dense, MoE, Mamba, RWKV6, the
encoder-decoder) — ``MeshInfo``, ``param_specs``, ``batch_specs`` and
``cache_specs`` of ``repro.models.sharding``, copied.

A spec is a tuple with one entry per dim: an axis name, or None where the
dim is not sharded (the JAX package's ``PartitionSpec``); the sync state's
specs may also name a tuple of axes, major first.  Rules are name+shape
driven and divisibility-guarded, so a rule may leave a leaf replicated
where its dim does not split.  Under a model axis (tensor parallelism) or
an FSDP axis each member holds the block of every leaf that its spec gives
it (:func:`local_block`); :func:`assemble` puts the global array back
together from the blocks, as ``jax.device_get`` does.

One leaf is cut otherwise than the JAX package cuts it: Mamba's ``w_in``
(d, 2 d_inner), whose product the layer splits into ``xs`` and ``z``
halves.  The JAX rule gives the model members contiguous column blocks
(member 0 all of ``xs``, member 1 all of ``z``) and GSPMD reshards behind
the split; a member here holds the same channels of both halves instead
(the leaf read as (d, 2, d_inner), split on d_inner): its entry is a
:class:`Paired` axis name, equal to the plain name, so the specs still
compare equal to the JAX package's while :func:`local_block` and
:func:`assemble` cut and join the halves.  Global arrays (checkpoints,
the sync state's) keep the JAX layout.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig

Spec = Tuple[Any, ...]


class Paired(str):
    """A spec entry: the axis that splits a dim made of two equal halves
    half by half, member *i* holding block *i* of each, side by side.  It
    is equal to (and hashes as) its axis name."""

    __slots__ = ()


def _div(n: int, size: Optional[int]) -> bool:
    return size is not None and size > 0 and n % size == 0


class MeshInfo:
    """Axis names & sizes the rules need.  ``tp_scope``: "full" shards
    attention/mlp over the TP axis; "embed_only" keeps the embedding vocab-
    sharded but replicates the blocks."""

    def __init__(self, axis_sizes: Dict[str, int], tp_axis: str = "model",
                 fsdp_axis: Optional[str] = None,
                 dp_axes: Tuple[str, ...] = ("data",),
                 tp_scope: str = "full", embed_tp: bool = True):
        self.axis_sizes = dict(axis_sizes)
        self.tp = tp_axis
        self.fsdp = fsdp_axis
        self.dp_axes = tuple(a for a in dp_axes if a in self.axis_sizes)
        self.tp_scope = tp_scope
        self.embed_tp = embed_tp

    def size(self, axis: Optional[str]) -> int:
        return self.axis_sizes.get(axis, 1) if axis else 1

    @property
    def dp_total(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.axis_sizes[a]
        return n


def _spec_for_leaf(arch: ArchConfig, path: str, shape: Tuple[int, ...],
                   mi: MeshInfo) -> Spec:
    tp, fsdp = mi.tp, mi.fsdp
    ntp, nf = mi.size(tp), mi.size(fsdp)
    name = path.split("/")[-1]

    def guard(dim_size, axis, n):
        return axis if _div(dim_size, n) else None

    # ---- top-level tensors --------------------------------------------------
    etp, netp = (tp, ntp) if mi.embed_tp else (None, 1)
    if name == "embed":
        return (guard(shape[0], etp, netp), guard(shape[1], fsdp, nf))
    if name == "lm_head":
        return (guard(shape[0], fsdp, nf), guard(shape[1], etp, netp))
    if name == "pos_embed":
        return (None, guard(shape[1], etp, netp))

    if mi.tp_scope == "embed_only":
        tp, ntp = None, 1

    # strip the group-stack leading dim for block params
    stacked = "blocks/" in path
    core = shape[1:] if stacked else shape

    def wrap(spec: Spec) -> Spec:
        return (None,) + tuple(spec) if stacked else tuple(spec)

    parent = path.split("/")[-2] if "/" in path else ""

    # ---- attention -----------------------------------------------------------
    if parent in ("attn", "xattn"):
        if name in ("wq", "wk", "wv"):
            return wrap((guard(core[0], fsdp, nf), guard(core[1], tp, ntp), None))
        if name == "wo":
            return wrap((guard(core[0], tp, ntp), None, guard(core[2], fsdp, nf)))
        if name in ("bq", "bk", "bv"):
            return wrap((guard(core[0], tp, ntp), None))
        if name in ("q_norm", "k_norm"):
            return wrap((None,))

    # ---- MoE -----------------------------------------------------------------
    if parent == "moe" or name in ("we_in", "we_out", "we_gate", "router"):
        if name == "router":
            return wrap((guard(core[0], fsdp, nf), None))
        if name in ("we_in", "we_gate"):
            return wrap((guard(core[0], tp, ntp), guard(core[1], fsdp, nf), None))
        if name == "we_out":
            return wrap((guard(core[0], tp, ntp), None, guard(core[2], fsdp, nf)))
    if parent == "shared" or "/shared/" in path:
        if name in ("wi", "wg"):
            return wrap((guard(core[0], fsdp, nf), guard(core[1], tp, ntp)))
        if name == "wo":
            return wrap((guard(core[0], tp, ntp), guard(core[1], fsdp, nf)))

    # ---- dense MLP -----------------------------------------------------------
    if parent == "mlp":
        if name in ("wi", "wg"):
            return wrap((guard(core[0], fsdp, nf), guard(core[1], tp, ntp)))
        if name == "wo":
            return wrap((guard(core[0], tp, ntp), guard(core[1], fsdp, nf)))

    # ---- mamba ---------------------------------------------------------------
    if parent == "mamba":
        if name == "w_in":  # xs then z: each member its channels of both
            half = guard(core[1] // 2, tp, ntp)
            return wrap((guard(core[0], fsdp, nf), half and Paired(half)))
        if name == "conv_w":
            return wrap((None, guard(core[1], tp, ntp)))
        if name in ("conv_b", "dt_bias", "D"):
            return wrap((guard(core[0], tp, ntp),))
        if name == "w_x":
            return wrap((guard(core[0], tp, ntp), None))
        if name == "w_dt":
            return wrap((None, guard(core[1], tp, ntp)))
        if name == "A_log":
            return wrap((guard(core[0], tp, ntp), None))
        if name == "w_out":
            return wrap((guard(core[0], tp, ntp), guard(core[1], fsdp, nf)))

    # ---- rwkv ----------------------------------------------------------------
    if parent == "tmix":
        if name in ("wr", "wk", "wv", "wg"):
            return wrap((guard(core[0], fsdp, nf), guard(core[1], tp, ntp)))
        if name == "wo":
            return wrap((guard(core[0], tp, ntp), guard(core[1], fsdp, nf)))
        if name == "u":
            return wrap((guard(core[0], tp, ntp), None))
        return wrap((None,) * len(core))
    if parent == "cmix":
        if name == "wk":
            return wrap((guard(core[0], fsdp, nf), guard(core[1], tp, ntp)))
        if name == "wv":
            return wrap((guard(core[0], tp, ntp), guard(core[1], fsdp, nf)))
        if name == "wr":
            return wrap((guard(core[0], fsdp, nf), None))

    # ---- norms, biases, everything small --------------------------------------
    return wrap((None,) * len(core))


def param_specs(arch: ArchConfig, shapes: Dict[str, Tuple[int, ...]],
                mi: MeshInfo) -> Dict[str, Spec]:
    """{path: spec} for a flat {path: shape} tree."""
    return {path: _spec_for_leaf(arch, path, tuple(shape), mi)
            for path, shape in shapes.items()}


def batch_specs(arch: ArchConfig, mi: MeshInfo) -> Dict[str, Spec]:
    """The batch's rows over the DP axes (a tuple of them, slowest major,
    when there are several), the rest replicated."""
    dp = (mi.dp_axes if len(mi.dp_axes) > 1
          else (mi.dp_axes[0] if mi.dp_axes else None))
    specs = {"tokens": (dp, None), "labels": (dp, None)}
    if arch.is_encdec:
        specs["frames"] = (dp, None, None)
    return specs


def cache_specs(arch: ArchConfig, shapes: Dict[str, Tuple[int, ...]],
                mi: MeshInfo, batch: int) -> Dict[str, Spec]:
    """{path: spec} for a flat {path: shape} cache (stacked over groups):
    the batch over the DP axes where it divides them, else an attention
    cache's sequence over the last DP axis (context-parallel long decode);
    heads or channels over TP where they divide."""
    ntp = mi.size(mi.tp)
    dp = (mi.dp_axes if len(mi.dp_axes) > 1
          else (mi.dp_axes[0] if mi.dp_axes else None))
    dp_total = mi.dp_total
    data_axis = mi.dp_axes[-1] if mi.dp_axes else None
    ndata = mi.size(data_axis)

    def spec_of(path: str, shape: Tuple[int, ...]) -> Spec:
        name = path.split("/")[-1]
        core = shape[1:]  # the leading dim is the group stack
        if name in ("k", "v", "xk", "xv"):
            b, s, kv, hd = core
            bspec = dp if _div(b, dp_total) else None
            sspec = data_axis if (bspec is None and _div(s, ndata)) else None
            kvspec = mi.tp if _div(kv, ntp) else None
            return (None, bspec, sspec, kvspec, None)
        if name == "ssm":
            b, di, ds = core
            bspec = dp if _div(b, dp_total) else None
            return (None, bspec, mi.tp if _div(di, ntp) else None, None)
        if name == "conv":
            b, k, di = core
            bspec = dp if _div(b, dp_total) else None
            return (None, bspec, None, mi.tp if _div(di, ntp) else None)
        if name == "wkv":
            b, h, hk, hv = core
            bspec = dp if _div(b, dp_total) else None
            return (None, bspec, mi.tp if _div(h, ntp) else None, None, None)
        if name in ("tshift", "cshift"):
            b, d = core
            return (None, dp if _div(b, dp_total) else None, None)
        return (None,) * len(shape)

    return {path: spec_of(path, tuple(shape)) for path, shape in shapes.items()}


# ---------------------------------------------------------------------------
# blocks of a global array
# ---------------------------------------------------------------------------


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes one spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec names."""
    return tuple(a for e in spec for a in entry_axes(e))


def local_shape(shape: Sequence[int], spec: Spec,
                sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The block of a global ``shape`` that one member holds under
    ``spec`` (axes absent from ``sizes`` count as size 1)."""
    out = []
    for d, n in enumerate(shape):
        parts = math.prod(sizes.get(a, 1) for a in
                          entry_axes(spec[d] if d < len(spec) else None))
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"under {spec} on {sizes}")
        out.append(n // parts)
    return tuple(out)


def _block_index(entry, coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    idx = 0
    for a in entry_axes(entry):  # major first
        idx = idx * sizes.get(a, 1) + coords.get(a, 0)
    return idx


def block_coords(spec: Spec, coords: Dict[str, int],
                 sizes: Dict[str, int]) -> Tuple[int, ...]:
    """Which block of the global array the member at ``coords`` holds
    under ``spec``: its index along each dim.  Two members with the same
    block coords hold the same block."""
    return tuple(_block_index(e, coords, sizes) for e in spec)


def local_block(x, spec: Spec, coords: Dict[str, int],
                sizes: Dict[str, int]):
    """The member at ``coords``'s block of a global array ``x`` (numpy or
    torch) under ``spec``: a view, but for a :class:`Paired` dim split
    over several members (its two pieces joined by a copy)."""
    for d, entry in enumerate(spec):
        parts = math.prod(sizes.get(a, 1) for a in entry_axes(entry))
        if parts > 1:
            i = _block_index(entry, coords, sizes)
            if isinstance(entry, Paired):  # (..., 2, n/2, ...), split on n/2
                shape = tuple(x.shape)
                blk = shape[d] // 2 // parts
                x = x.reshape(shape[:d] + (2, shape[d] // 2) + shape[d + 1:])
                x = x[(slice(None),) * (d + 1) + (slice(i * blk, (i + 1) * blk),)]
                x = x.reshape(shape[:d] + (2 * blk,) + shape[d + 1:])
            else:
                blk = x.shape[d] // parts
                x = x[(slice(None),) * d + (slice(i * blk, (i + 1) * blk),)]
    return x


def assemble(blocks: Dict[Tuple, Any], spec: Spec, shape: Sequence[int],
             sizes: Dict[str, int], concat: Callable):
    """The global array from every member's block: ``blocks`` maps a
    member's coords (a tuple of (axis, index) pairs) to its block;
    ``concat(parts, dim)`` joins numpy arrays or tensors.  Where several
    members hold the same block (a dim replicated over an axis), the block
    of the first of them in mesh order (slowest axis major, the order of
    ``sizes``) is taken: the copy ``jax.device_get`` returns, that of the
    device with ``replica_id`` 0.  It matters for a state that differs
    across an axis its spec does not name: the int8 error feedback of the
    pod members (ROADMAP.md queue 3)."""
    def mesh_order(item):
        coords = dict(item[0])
        return tuple(coords.get(a, 0) for a in sizes)

    by_index: Dict[Tuple[int, ...], Any] = {}
    for key, blk in sorted(blocks.items(), key=mesh_order):
        coords = dict(key)
        by_index.setdefault(tuple(_block_index(e, coords, sizes)
                                  for e in spec), blk)

    def build(prefix: Tuple[int, ...]):
        d = len(prefix)
        if d == len(spec):
            return by_index[prefix]
        parts = math.prod(sizes.get(a, 1) for a in entry_axes(spec[d]))
        pieces = [build(prefix + (i,)) for i in range(parts)]
        if parts == 1:
            return pieces[0]
        if isinstance(spec[d], Paired):  # every member's first halves, then seconds
            half = pieces[0].shape[d] // 2
            cut = [(slice(None),) * d + (slice(j * half, (j + 1) * half),)
                   for j in range(2)]
            return concat([p[c] for c in cut for p in pieces], d)
        return concat(pieces, d)

    return build(())
