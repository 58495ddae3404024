"""DFabric gradient synchronization — the paper's DDP port, plus ZeRO-1;
the port of ``repro.optim.grad_sync``.

This module executes a :class:`repro_torch.core.planner.SyncPlan` on every
member of the DP domain, with axis names resolved against the mesh bound by
``prims.bind``.  Each Section carries the planner-built
:class:`~repro_torch.core.schedule.CommSchedule`, which goes straight into
the executor (``collectives``).  The fast side of the domain is an ORDERED
tuple of tiers (``SyncSettings.fast_axes``, fastest first); the slowest
tier (``slow_axis`` == "pod") is where the NIC pool stripes.

Two modes, as in the JAX package:

  * ``paper`` — every gradient Section is all-reduced with the
    hierarchical striped collective, then a replicated AdamW update runs.
  * ``zero1`` — the sync stops at the shard after the slow leg, AdamW
    updates the 1/n_fast parameter shard with moments that live sharded
    over the fast tiers, and the final fast-tier all-gather carries updated
    parameters.

Optional int8 compression with error feedback runs on the slow tier only.

Tensor parallelism.  With a model axis each model member syncs its own
blocks of the gradients over its DP groups (the JAX package's nested
model-manual ``shard_map``): the plan's sections come from the local
shapes, a section whose leaf the model axis splits is ``model_sharded``,
and the squared gradient norm of those sections alone is summed over the
model axis too (a replicated leaf's is the same on every member, and
counted once).

State layout.  The JAX package holds the sync state as global arrays with
``PartitionSpec``s (:func:`merged_state_specs`: the DP scatter of
:func:`sync_state_specs` merged with the parameter's TP spec); here each
rank holds only its local block of each array, the shard its spec assigns
to this member.  :func:`local_block` and :func:`assemble` map between the
two (for tests and for checkpoints, which hold the global arrays).
Parameters are updated in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prims
from repro_torch.core.collectives import (dfabric_all_gather,
                                          dfabric_all_reduce,
                                          dfabric_reduce_scatter)
from repro_torch.core.planner import Section, SyncPlan
from repro_torch.models.sharding import (Paired, assemble,  # noqa: F401
                                         local_block, local_shape)
from repro_torch.optim.adamw import AdamWConfig, adamw_leaf, clip_coefficient
from repro_torch.utils.trees import tree_paths

#: one entry per dim: None, an axis name, or a tuple of axis names (major
#: first) — the JAX ``PartitionSpec`` of a state array
Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# Section <-> tensors packing
# ---------------------------------------------------------------------------


def _bucket_pack(flat: Dict[str, torch.Tensor], sec: Section,
                 n_fast: int) -> torch.Tensor:
    parts = [flat[p].reshape(-1).float() for p in sec.leaf_paths]
    pad = (-sum(t.numel() for t in parts)) % n_fast
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _bucket_unpack(x: torch.Tensor, sec: Section,
                   templates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    off = 0
    for p in sec.leaf_paths:
        t = templates[p]
        n = t.numel()
        out[p] = x[off:off + n].reshape(t.shape).to(t.dtype)
        off += n
    return out


def bucket_padded_numel(sec: Section, n_fast: int) -> int:
    return sec.numel + ((-sec.numel) % n_fast)


# ---------------------------------------------------------------------------
# Settings and section kinds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SyncSettings:
    """DP-domain axis layout of one sync plan.  ``fast_axes`` is the
    ordered fast-tier axis list (fastest first); when None, the legacy
    single ``fast_axis`` is used.  ``n_fast`` is the PRODUCT of all
    fast-tier sizes (ZeRO-1 shards are 1/n_fast)."""

    mode: str = "zero1"  # "paper" | "zero1"
    fast_axis: str = "data"
    slow_axis: Optional[str] = "pod"
    n_fast: int = 1
    n_slow: int = 1
    # model_sharded sections' squared norms are summed over this axis
    model_axis: Optional[str] = None
    fast_axes: Optional[Tuple[str, ...]] = None  # ordered, fastest first

    @property
    def fast(self) -> Tuple[str, ...]:
        return self.fast_axes if self.fast_axes else (self.fast_axis,)

    @property
    def fast_entry(self):
        """Spec entry for a dim scattered over the fast tiers: the bare
        axis name for one tier, the ordered tuple for several
        (fastest-major, matching dfabric_reduce_scatter ownership)."""
        f = self.fast
        return f if len(f) > 1 else f[0]

    @property
    def dp_total(self) -> int:
        return self.n_fast * self.n_slow


def flat_fast_index(ss: SyncSettings) -> int:
    """This rank's flattened index over the fast tiers, fastest-tier-major
    (the ownership order of ``dfabric_reduce_scatter``)."""
    idx = 0
    for a in ss.fast:
        idx = idx * prims.axis_size(a) + prims.axis_rank(a)
    return idx


def full_depth(sec: Section, ss: SyncSettings) -> bool:
    """The ZeRO-1 fused path owns a 1/n_fast shard, which requires the
    section's tier plan to scatter over EVERY fast tier."""
    return sec.sync.scatter_depth < 0 or sec.sync.scatter_depth >= len(ss.fast)


def section_kind(sec: Section, ss: SyncSettings) -> str:
    """'shard' (fused ZeRO-1 path), 'full_tensor' (whole-tensor all-reduce +
    replicated update) or 'bucket' (flat pack of small leaves)."""
    if len(sec.leaf_paths) > 1:
        return "bucket"
    if ss.mode == "zero1" and sec.sync.strategy == "hier_striped" \
            and sec.scatter_dim >= 0 and full_depth(sec, ss):
        return "shard"
    return "full_tensor"


def _zero1_path(sec: Section, ss: SyncSettings) -> bool:
    bucket = len(sec.leaf_paths) > 1
    return (ss.mode == "zero1" and sec.sync.strategy == "hier_striped"
            and (bucket or (sec.scatter_dim >= 0 and full_depth(sec, ss))))


def init_entry_has_ef(sec: Section) -> bool:
    return sec.sync.codec is not None and sec.sync.error_feedback


def _scattered_axes(sec: Section, ss: SyncSettings) -> Tuple[str, ...]:
    """The fast-tier axes a hier_striped section actually scatters over —
    the first ``scatter_depth`` entries of the ordered fast-axis list."""
    if sec.sync.strategy != "hier_striped" or sec.scatter_dim < 0:
        return ()
    d = len(ss.fast) if sec.sync.scatter_depth < 0 else sec.sync.scatter_depth
    return ss.fast[:d]


# ---------------------------------------------------------------------------
# State: global shapes, specs, local blocks
# ---------------------------------------------------------------------------


def _global_shape(sec: Section, flat_shapes: Dict[str, Any],
                  ss: SyncSettings) -> Tuple[int, ...]:
    if section_kind(sec, ss) == "bucket":
        return (bucket_padded_numel(sec, ss.n_fast),)
    return tuple(flat_shapes[sec.leaf_paths[0]].shape)


def state_shapes(plan: SyncPlan, param_shapes: Dict[str, Any],
                 ss: SyncSettings) -> Dict[str, Tuple[int, ...]]:
    """{section: the global shape of its m, v (and EF)}."""
    flat = tree_paths(param_shapes)
    return {sec.name: _global_shape(sec, flat, ss) for sec in plan.sections}


def sync_state_specs(plan: SyncPlan, param_shapes: Dict[str, Any],
                     ss: SyncSettings) -> Dict[str, Any]:
    """The JAX package's shard_map specs of the sync state, as tuples."""
    flat = tree_paths(param_shapes)
    specs: Dict[str, Any] = {"step": (), "sections": {}}
    for sec in plan.sections:
        kind = section_kind(sec, ss)
        nd = len(_global_shape(sec, flat, ss))

        def along(dim: int, entry) -> Spec:
            sp = [None] * nd
            sp[dim] = entry
            return tuple(sp)

        replicated = (None,) * nd
        zero1 = _zero1_path(sec, ss)
        if kind == "bucket":
            mv = along(0, ss.fast_entry) if zero1 else replicated
        elif zero1:  # shard
            mv = along(sec.scatter_dim, ss.fast_entry)
        else:
            mv = replicated
        entry = {"m": mv, "v": mv}
        if init_entry_has_ef(sec):
            # EF feeds the slow leg, which operates on the shard scattered
            # over the section's fast-tier PREFIX (its scatter_depth)
            scattered = _scattered_axes(sec, ss)
            if sec.sync.strategy != "hier_striped":
                entry["ef"] = replicated
            elif kind == "bucket":
                entry["ef"] = along(0, ss.fast_entry)
            elif sec.scatter_dim >= 0 and scattered:
                entry["ef"] = along(sec.scatter_dim, scattered
                                    if len(scattered) > 1 else scattered[0])
            else:
                entry["ef"] = replicated
        specs["sections"][sec.name] = entry
    return specs


def inner_state_specs(plan: SyncPlan, param_specs_flat: Dict[str, Spec],
                      param_shapes_flat: Dict[str, Any]) -> Dict[str, Any]:
    """The sync state's specs over the model axis: a one-leaf section
    inherits its parameter's TP spec; a bucket holds TP-replicated leaves
    only."""
    specs: Dict[str, Any] = {"step": (), "sections": {}}
    for sec in plan.sections:
        if len(sec.leaf_paths) == 1:
            pspec = tuple(param_specs_flat[sec.leaf_paths[0]])
            nd = len(param_shapes_flat[sec.leaf_paths[0]].shape)
            sp = pspec + (None,) * (nd - len(pspec))
        else:
            sp = (None,)
        entry = {"m": sp, "v": sp}
        if init_entry_has_ef(sec):
            entry["ef"] = sp
        specs["sections"][sec.name] = entry
    return specs


def merge_specs(a: Spec, b: Spec, ndim: int) -> Spec:
    """Entry-wise union of two specs (on disjoint dims; where both name
    axes, ``a``'s are major).  A :class:`Paired` entry (a dim cut half
    by half) keeps its cut only alone: merged with another axis it raises
    ``ValueError``."""
    ea = tuple(a) + (None,) * (ndim - len(a))
    eb = tuple(b) + (None,) * (ndim - len(b))
    out = []
    for x, y in zip(ea, eb):
        if x is not None and y is not None:
            if isinstance(x, Paired) or isinstance(y, Paired):
                raise ValueError(f"dim {len(out)} of {a} and {b}: a paired "
                                 f"cut merged with another axis")
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            out.append(xs + ys)
        else:
            out.append(x if x is not None else y)
    return tuple(out)


def merged_state_specs(plan: SyncPlan, param_shapes: Dict[str, Any],
                       param_specs_tree, ss: SyncSettings) -> Dict[str, Any]:
    """The full specs of the sync state's global arrays: the DP scatter
    (:func:`sync_state_specs`) merged with the parameter's TP spec
    (:func:`inner_state_specs`).  Every member holds its block under
    these."""
    outer = sync_state_specs(plan, param_shapes, ss)
    shapes = tree_paths(param_shapes)
    inner = inner_state_specs(plan, tree_paths(param_specs_tree), shapes)
    merged: Dict[str, Any] = {"step": (), "sections": {}}
    for sec in plan.sections:
        o, i = outer["sections"][sec.name], inner["sections"][sec.name]
        nd = (len(shapes[sec.leaf_paths[0]].shape)
              if len(sec.leaf_paths) == 1 else 1)
        merged["sections"][sec.name] = {k: merge_specs(o[k], i[k], nd)
                                        for k in o}
    return merged


def init_sync_state(plan: SyncPlan, param_shapes: Dict[str, Any],
                    ss: SyncSettings, device,
                    param_specs_tree=None,
                    sizes: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """This member's local block of the optimizer state: moments per
    Section (+EF when the Section uses a codec), zero.  With the
    parameters' specs the blocks are those of :func:`merged_state_specs`
    (the model axis splits them too).  ``sizes``: the mesh's {axis: size}
    (the bound mesh's when None; ``{}`` gives the global arrays, as the
    JAX package's ``init_sync_state`` does)."""
    flat = tree_paths(param_shapes)
    specs = (sync_state_specs(plan, param_shapes, ss)
             if param_specs_tree is None else
             merged_state_specs(plan, param_shapes, param_specs_tree, ss))
    if sizes is None:
        sizes = {a: prims.axis_size(a) for a in prims.current_mesh().axis_names}
    state: Dict[str, Any] = {"step": 0, "sections": {}}
    for sec in plan.sections:
        shape = _global_shape(sec, flat, ss)
        state["sections"][sec.name] = {
            k: torch.zeros(local_shape(shape, sp, sizes), dtype=torch.float32,
                           device=device)
            for k, sp in specs["sections"][sec.name].items()}
    return state


def _section_leaves(names, leaf_paths) -> Dict[str, Tuple[str, ...]]:
    """{section name: its leaves in packing order} for the sections of a
    plan made on ``leaf_paths`` (the planner's rules: a one-leaf section
    is named by its path, '/' read as '.'; the other leaves, in path
    order, fill the buckets ``bucket[<first>...x<count>]`` in turn)."""
    dotted = {p.replace("/", "."): p for p in leaf_paths}
    out = {n: (dotted[n],) for n in names if n in dotted}
    small = [p for p in sorted(leaf_paths) if p.replace("/", ".") not in out]
    start = {p.replace("/", "."): i for i, p in enumerate(small)}
    for n in names:
        if n in out:
            continue
        first, sep, count = n.removeprefix("bucket[").removesuffix("]").rpartition("...x")
        if not n.startswith("bucket[") or not sep or first not in start:
            raise ValueError(f"the checkpoint's section {n!r} names no leaf "
                             f"of this model")
        i = start[first]
        out[n] = tuple(small[i:i + int(count)])
    return out


def resection_state(saved: Dict[str, Any], plan: SyncPlan,
                    param_shapes: Dict[str, Any],
                    ss: SyncSettings) -> Dict[str, Any]:
    """A checkpoint's sync state (``{section: {m, v[, ef]: global
    array}}``) written under another plan, cut anew for ``plan``: each
    entry is split into its leaves (a bucket is their flat concatenation,
    padded) and the leaves are packed as ``plan``'s sections pack them.
    AdamW and the error feedback are elementwise, so this moves no value.
    A section's entry holds the keys that all of its leaves had."""
    flat = tree_paths(param_shapes)
    owner = _section_leaves(saved, flat)
    per_leaf: Dict[str, Dict[str, Any]] = {}
    for name, leaves in owner.items():
        off = 0
        for path in leaves:
            shape = tuple(flat[path].shape)
            n = math.prod(shape)
            per_leaf[path] = {
                k: (a if len(leaves) == 1 else
                    a.reshape(-1)[off:off + n]).reshape(shape)
                for k, a in saved[name].items()}
            off += n
    if set(per_leaf) != set(flat):
        raise ValueError(f"the checkpoint's sync state lacks the leaves "
                         f"{sorted(set(flat) - set(per_leaf))}")
    out: Dict[str, Any] = {}
    for sec in plan.sections:
        keys = set.intersection(*(set(per_leaf[p]) for p in sec.leaf_paths))
        if len(sec.leaf_paths) == 1:
            out[sec.name] = {k: per_leaf[sec.leaf_paths[0]][k] for k in keys}
            continue
        size = bucket_padded_numel(sec, ss.n_fast)
        entry = {}
        for k in keys:
            parts = [per_leaf[p][k].reshape(-1) for p in sec.leaf_paths]
            packed = np.zeros((size,), dtype=np.float32)
            packed[:sec.numel] = np.concatenate(parts)
            entry[k] = packed
        out[sec.name] = entry
    return out


# ---------------------------------------------------------------------------
# The sync + update pass
# ---------------------------------------------------------------------------


def _drop_leaf(tree, path: str) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree[p]
    del tree[leaf]


@torch.no_grad()
def sync_and_update(params, grads, sync_state, plan: SyncPlan,
                    ss: SyncSettings, lr, opt_cfg: AdamWConfig
                    ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """Execute the plan; returns (params, new_sync_state, metrics).  The
    parameter tensors of ``params`` are updated in place (and returned);
    ``lr`` is a float or a 0-d fp32 tensor.  ``grads`` is consumed: each
    leaf is dropped from the tree once its section is synced, so that a
    step holds a gradient only until then.  So is ``sync_state``: each
    section's entry moves out of it into the new state, where its EF, m
    and v are replaced as they are updated, so that no step holds two
    copies of them."""
    pflat = tree_paths(params)
    gflat = tree_paths(grads)
    step = sync_state["step"]
    n_fast = ss.n_fast
    inv_dp = 1.0 / ss.dp_total

    # ---- pass 1: communicate ------------------------------------------------
    synced: Dict[str, Any] = {}
    new_sections: Dict[str, Any] = {}
    sqnorm = None
    old_sections = sync_state["sections"]
    for sec in plan.sections:
        entry = old_sections.pop(sec.name)
        ef = entry.get("ef")
        bucket = len(sec.leaf_paths) > 1
        if bucket:
            g = _bucket_pack(gflat, sec, n_fast)
            k = 0
        else:
            g = gflat[sec.leaf_paths[0]].float()
            k = max(sec.scatter_dim, 0)
        model_axes = ((ss.model_axis,) if (ss.model_axis and sec.model_sharded)
                      else ())
        lane_off = sec.schedule.lane_offset if sec.schedule is not None else 0
        staging = sec.schedule.staging if sec.schedule is not None else None
        if _zero1_path(sec, ss):
            shard, new_ef = dfabric_reduce_scatter(
                g, ss.fast, ss.slow_axis, sec.sync, scatter_dim=k, ef=ef,
                schedule=sec.schedule, lane_offset=lane_off, staging=staging)
            shard = shard * inv_dp
            synced[sec.name] = ("shard", shard, k)
            sq = prims.psum(torch.sum(torch.square(shard)),
                            ss.fast + model_axes)
        else:
            full, new_ef = dfabric_all_reduce(
                g, ss.fast, ss.slow_axis, sec.sync, scatter_dim=k, ef=ef,
                schedule=sec.schedule, lane_offset=lane_off, staging=staging)
            full = full * inv_dp
            synced[sec.name] = ("full", full, k)
            sq = prims.psum(torch.sum(torch.square(full)), model_axes)
        sqnorm = sq if sqnorm is None else sqnorm + sq
        if new_ef is not None:
            entry["ef"] = new_ef
        new_sections[sec.name] = entry
        del g, ef
        for path in sec.leaf_paths:
            del gflat[path]
            _drop_leaf(grads, path)

    gnorm = torch.sqrt(sqnorm)
    clip = clip_coefficient(gnorm, opt_cfg)

    # ---- pass 2: update -----------------------------------------------------
    for sec in plan.sections:
        kind, g, k = synced.pop(sec.name)
        entry = new_sections[sec.name]
        bucket = len(sec.leaf_paths) > 1
        if kind == "shard":
            # parameter shard owned by this fast-tier rank (flattened
            # fastest-tier-major over all fast axes)
            idx = flat_fast_index(ss)
            if bucket:
                p_full = _bucket_pack(pflat, sec, n_fast)
                blk = p_full.shape[0] // n_fast
                p_sh = p_full.narrow(0, idx * blk, blk)
            else:
                p = pflat[sec.leaf_paths[0]]
                blk = p.shape[k] // n_fast
                p_sh = p.narrow(k, idx * blk, blk)
            new_p_sh, entry["m"], entry["v"] = adamw_leaf(
                p_sh, g, entry["m"], entry["v"], step, lr, opt_cfg, clip,
                inplace=True)
            # the all-gather carries UPDATED PARAMETERS (fused ZeRO-1);
            # gathers run up the fast tiers in reverse scatter order
            new = dfabric_all_gather(new_p_sh, ss.fast,
                                     gather_dim=(0 if bucket else k))
        else:
            p_full = (_bucket_pack(pflat, sec, n_fast) if bucket
                      else pflat[sec.leaf_paths[0]])
            new, entry["m"], entry["v"] = adamw_leaf(
                p_full, g, entry["m"], entry["v"], step, lr, opt_cfg, clip,
                inplace=True)
        if bucket:
            for path, t in _bucket_unpack(new, sec, pflat).items():
                pflat[path].copy_(t)
        else:
            pflat[sec.leaf_paths[0]].copy_(new)
        del g, new

    new_state = {"step": step + 1, "sections": new_sections}
    return params, new_state, {"grad_norm": gnorm}
