"""Parameter sharding rules of the decoder families (dense, MoE, Mamba,
RWKV6) — ``MeshInfo`` and ``param_specs`` of ``repro.models.sharding``,
copied (the encoder-decoder's cross attention is not ported).

A spec is a tuple with one entry per dim: an axis name, or None where the
dim is not sharded (the JAX package's ``PartitionSpec``).  The port runs DP
only (``model`` of size 1), where no leaf is split; the planner still reads
which dims the rules give to the TP axis, and keeps its scatter off them,
so both packages plan alike.  Rules are name+shape driven and
divisibility-guarded.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig

Spec = Tuple[Optional[str], ...]


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
    if parent == "attn":
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
        if name == "w_in":
            return wrap((guard(core[0], fsdp, nf), guard(core[1], tp, ntp)))
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
