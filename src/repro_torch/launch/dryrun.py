"""Multi-pod dry-run — the port of ``repro.launch.dryrun``, without XLA.

For every (architecture x input shape x mesh) cell: build the cell on the
meta device (``launch.cells``), then record one JSON file a cell under
``--out`` with

  * **memory**: the argument bytes one member holds, by kind (parameters,
    optimizer or sync state, batch, cache, scalars), from the stand-ins'
    blocks under their specs.  The reference also records XLA's compiled
    ``temp_size``; the port runs eagerly and plans no temporaries ahead,
    so ``temp_bytes`` is null and the record says why;
  * **collective bytes a member a step, by tier** (the fast DP tiers, then
    ``pod``, then the ``model`` axis), each with its source, in place of
    the reference's parse of the compiled HLO (``hlo_parse``):
      - the DFabric step's gradient sync: the plan's sections, each
        schedule priced leg by leg by the copied ``core/cost_model.py``;
      - the GSPMD step's FSDP gathers (each use: the forward, and again in
        the ``remat="full"`` recompute, a microbatch) and gradient
        reduce-scatters (a microbatch), and the sums of each gradient
        block over the DP axes its spec does not name, from the
        parameter specs (a FSDP serving cell gathers once a forward);
      - the tensor-parallel activation sums, by an analytic count (below);
  * **cost**: ``flops``, ``bytes``, ``model_flops``, ``params`` from the
    copied ``roofline.analytics.model_cost``;
  * **roofline seconds** only when the caller hands in a
    :class:`HardwareSpec`, which the record names.  The copy's defaults
    are the reference's TPU v5e constants (ROADMAP.md queue 3, item 2), so
    the CLI prices nothing unless asked to (``--hardware tpu-v5e``).

The analytic TP count: in a forward pass of a member's rows (b rows x S
tokens, S = 1 in decode), each sublayer whose weights split over the model
axis (attention heads, MLP or expert columns, shared experts, RWKV6 time
and channel mix, Mamba channels, cross attention) sums its (b, S, d)
output once in the compute dtype, each split encoder sublayer its (b,
n_frames, d) output; a vocab-split embedding sums its lookup once and a
vocab-split head reduces three (b, S) fp32 values.  Training adds one sum
of the same size a split sublayer for its input's gradient, and
``remat="full"`` runs each layer's forward again.  The sums inside those
sublayers are counted too: Mamba's (b, S, dt_rank + 2 d_state)
projection a forward and again in the backward; in the backward the
RWKV6 time mix's four input gradients (three beyond the one) and its
decay LoRA's (b, S, 64), the MoE gates' (b, S, top_k) fp32, the encoder
output's (b, n_frames, d) gradient in each split cross attention, and
once a microbatch the gradients of the time mix's replicated leaves used
on a member's channels.  The parameter sums of attention's replicated
leaves (``q_norm``/``k_norm``, kv heads that stay whole) and the gather
of a model-split ``pos_embed`` are small and not counted.  An
all-reduce of X bytes over n members moves 2 (n - 1) / n X a member (a
ring); a gather or reduce-scatter to or from X bytes, (n - 1) / n X.  A
decode cell whose attention cache is split on its sequence (B = 1: the
batch does not divide the DP members) combines each attention layer's
softmax over the members of that axis (``layers.attend_decode``): one max
and two sums a layer a step, all-reduces of its (B, H_local) and (B,
H_local, hd) fp32 values (H_local: the query heads a model member holds).

Under a sequence split (``seq_shard``, ``context_parallel``; training and
prefill) each sum of a split sublayer (attention, cross attention, MLP,
routed or shared experts, RWKV6 time or channel mix, Mamba) becomes a
gather of the sequence before it and a reduce-scatter after it, and in
the backward a gather of its output's gradient and a reduce-scatter of
its input's: the bytes of a ring all-reduce of the same (b, S, d), as
before.  The RWKV6 mixes, Mamba and split experts gather their input with
``gather_replicated`` and sum its gradient inside (``to_parallel``), so
their backward all-reduces the whole gathered (b, S, d) where the others
reduce-scatter it: half a sum more each.  A whole sublayer (the
context-parallel cell's blocks, heads, channels or experts that do not
split) gathers its input, and the backward gathers its output's
gradient; a vocab-split embedding reduce-scatters its lookup and the
backward gathers the gradient, a whole one's gradient is gathered; the
stream is gathered before the final norm.  The leaves a member uses on
its rows of the sequence only (the norms, a whole MLP or shared experts,
RWKV6's channel-mix gate ``wr``) have their gradients summed over the
model axis once a microbatch, and the gate's (b, S, d) input gradient is
summed over it once a layer in the backward.  The GSPMD step with split
moments (the context-parallel cell's ``zero_opt``) gathers each leaf's
updated parts over the axes that split them further, once a step.

Usage::

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --out DIR
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import SHAPES, get_arch, list_archs, shape_applicable
from repro_torch.core.cost_model import CostModel, dtype_itemsize
from repro_torch.core.topology import HardwareSpec, TwoTierTopology
from repro_torch.launch.cells import Cell, build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.sharding import entry_axes
from repro_torch.models.transformer import layer_kind, n_groups, group_size
from repro_torch.roofline.analytics import model_cost
from repro_torch.runtime.train_loop import dp_axes_of, fast_axes_of
from repro_torch.utils.trees import tree_paths

#: the argument kinds of each mode's step, in argument order
ARG_KINDS = {"train": ("params", "state", "batch", "scalars"),
             "prefill": ("params", "batch", "batch"),
             "decode": ("params", "cache", "batch", "scalars")}

TEMP_NOTE = ("XLA's compiled temp_size has no counterpart: the port runs "
             "eagerly, and no temporaries are planned ahead of a run")

HARDWARE = {"none": None, "tpu-v5e": HardwareSpec()}
HARDWARE_NAMES = {"tpu-v5e": "HardwareSpec() defaults: the reference's TPU v5e "
                             "constants (core/topology.py)"}


def argument_bytes(cell: Cell) -> Dict[str, int]:
    """{kind: bytes one member holds of the step's arguments}, and their
    total."""
    out = {k: 0 for k in ("params", "state", "batch", "cache", "scalars")}
    for kind, arg in zip(ARG_KINDS[cell.mode], cell.args):
        out[kind] += sum(leaf.member_bytes(cell.sizes)
                         for leaf in tree_paths(arg).values())
    out["total"] = sum(out.values())
    return out


def _ring(nbytes: float, n: int, factor: float = 1.0) -> float:
    """Wire bytes a member: ``factor`` (n - 1) / n of ``nbytes``."""
    return factor * (n - 1) / n * nbytes if n > 1 else 0.0


def _tp_split_sublayers(cell: Cell) -> Tuple[int, int]:
    """Sublayers a forward pass sums over the model axis, over every
    layer: (the decoder's, on its tokens; the encoder's, on its frames)."""
    specs = tree_paths(cell.args[0])
    arch, tp = cell.arch, "model"

    def split(path: str, dim: int) -> bool:
        leaf = specs.get(path)
        return leaf is not None and tp in entry_axes(leaf.spec[dim]) \
            and cell.sizes.get(tp, 1) > 1

    n = 0
    for off in range(group_size(arch)):
        base = f"blocks/l{off}"
        kind = layer_kind(arch, off)
        if kind == "rwkv":
            parts = [split(f"{base}/tmix/wr", 2), split(f"{base}/cmix/wk", 2)]
        else:
            mixer = (split(f"{base}/mamba/w_in", 2) if kind == "mamba"
                     else split(f"{base}/attn/wq", 2))
            ffn = (split(f"{base}/moe/we_in", 1)
                   + split(f"{base}/moe/shared/wi", 2)
                   if f"{base}/moe/we_in" in specs else split(f"{base}/mlp/wi", 2))
            parts = [mixer, ffn, split(f"{base}/xattn/wq", 2)]
        n += sum(parts) * n_groups(arch)
    enc = 0
    if arch.is_encdec and cell.mode != "decode":  # the encoder's layers
        enc = (split("enc_blocks/attn/wq", 2) + split("enc_blocks/mlp/wi", 2)) \
            * arch.encoder.n_layers
    return n, enc


def _inner_sums(cell: Cell, itemsize: int) -> Dict[str, float]:
    """The model axis's sums inside the RWKV6, Mamba, MoE and cross
    attention sublayers beyond one (b, S, d) sum a pass, over every layer
    (``itemsize``: the compute dtype's):

      * ``fwd``: bytes a token summed in each forward pass: Mamba's
        (dt_rank + 2 d_state) projection (``psum_replicated``);
      * ``bwd``: bytes a token summed in the backward: the RWKV6 time mix's
        input gradients beyond one (``xr``, ``xk``, ``xv`` and ``xg`` each
        enter through ``to_parallel``) and its decay LoRA's; Mamba's
        projection again; the MoE gates (fp32, top_k a token);
      * ``bwd_frame``: bytes a frame summed in the backward: the encoder
        output's gradient, which enters each split cross attention through
        ``to_parallel``;
      * ``leaves``: bytes of the replicated leaves a member uses on its own
        channels (the time mix's ``w0``, ``td_w2``, ``ln_scale``,
        ``ln_bias``), whose gradients are summed over model a microbatch;
      * ``inner``: the split sublayers that gather a sequence-split input
        with ``gather_replicated`` and sum its gradient inside
        (``to_parallel``): the RWKV6 mixes, Mamba and split experts."""
    specs = tree_paths(cell.args[0])
    arch, d = cell.arch, cell.arch.d_model

    def split(path: str, dim: int = 2) -> bool:
        leaf = specs.get(path)
        return leaf is not None and "model" in entry_axes(leaf.spec[dim])

    out = dict(fwd=0.0, bwd=0.0, bwd_frame=0.0, leaves=0.0, inner=0)
    for off in range(group_size(arch)):
        base, ng = f"blocks/l{off}", n_groups(arch)
        kind = layer_kind(arch, off)
        if kind == "rwkv":
            if split(f"{base}/tmix/wr"):
                lora = specs[f"{base}/tmix/td_w1"].shape[-1]
                out["bwd"] += ng * (3 * d + lora) * itemsize
                out["leaves"] += sum(specs[f"{base}/tmix/{k}"].member_bytes(cell.sizes)
                                     for k in ("w0", "td_w2", "ln_scale", "ln_bias"))
                out["inner"] += ng
            out["inner"] += ng * split(f"{base}/cmix/wk")
        elif kind == "mamba" and split(f"{base}/mamba/w_in"):
            m = arch.mamba
            width = (m.resolved_dt_rank(d) + 2 * m.d_state) * itemsize
            out["fwd"] += ng * width
            out["bwd"] += ng * width
            out["inner"] += ng
        if f"{base}/moe/we_in" in specs and split(f"{base}/moe/we_in", 1):
            out["bwd"] += ng * arch.moe.top_k * 4
            out["inner"] += ng
        if split(f"{base}/xattn/wq"):
            out["bwd_frame"] += ng * d * itemsize
    return out


def _sp_whole(cell: Cell) -> Tuple[int, int, int]:
    """Under a sequence split: (the whole sublayers over every layer, which
    every model member runs on the gathered sequence; the bytes a member
    holds of the leaves it uses on its own rows only; the RWKV6 layers,
    whose channel-mix gate takes a member's rows of a gathered input)."""
    specs = tree_paths(cell.args[0])
    arch = cell.arch

    def split(path: str, dim: int = 2) -> bool:
        return "model" in entry_axes(specs[path].spec[dim])

    def under(*parents: str):
        return [k for k in specs if k.startswith(tuple(f"{p}/" for p in parents))]

    whole, rows_only, rwkv = 0, [], 0
    for off in range(group_size(arch)):
        base = f"blocks/l{off}"
        kind = layer_kind(arch, off)
        rows_only += under(f"{base}/ln1", f"{base}/ln2", f"{base}/lnx")
        if kind == "rwkv":
            parts = [split(f"{base}/tmix/wr"), split(f"{base}/cmix/wk")]
            rows_only.append(f"{base}/cmix/wr")
            rwkv += n_groups(arch)
        else:
            parts = [split(f"{base}/mamba/w_in" if kind == "mamba"
                           else f"{base}/attn/wq")]
            if f"{base}/xattn/wq" in specs:
                parts.append(split(f"{base}/xattn/wq"))
            if f"{base}/moe/we_in" in specs:
                parts.append(split(f"{base}/moe/we_in", 1))
                if f"{base}/moe/shared/wi" in specs \
                        and not split(f"{base}/moe/shared/wi"):
                    rows_only += under(f"{base}/moe/shared")
            elif not split(f"{base}/mlp/wi"):
                rows_only += under(f"{base}/mlp")
        whole += parts.count(False) * n_groups(arch)
    return whole, sum(specs[k].member_bytes(cell.sizes) for k in rows_only), rwkv


def tp_bytes(cell: Cell, rows: int) -> float:
    """The analytic TP activation sums' wire bytes a member a step; under a
    sequence split (``seq_axis``, training and prefill) its gathers,
    reduce-scatters and gradient sums."""
    ntp = cell.sizes.get("model", 1)
    if ntp == 1:
        return 0.0
    st, arch = cell.model.settings, cell.arch
    S = 1 if cell.mode == "decode" else cell.shape.seq_len
    itemsize = dtype_itemsize(st.compute_dtype)
    act = rows * S * arch.d_model * itemsize
    layers, enc_layers = _tp_split_sublayers(cell)
    inner = _inner_sums(cell, itemsize)
    frames = rows * arch.encoder.n_frames if arch.is_encdec else 0
    specs = tree_paths(cell.args[0])
    embed = int("model" in entry_axes(specs["embed"].spec[0]))
    head = specs["embed" if arch.tie_embeddings else "lm_head"]
    vocab = int("model" in entry_axes(head.spec[0 if arch.tie_embeddings else 1]))
    train = cell.mode == "train"
    # the forward passes (a recompute under remat "full") and the backward
    passes = (3 if st.remat == "full" else 2) if train else 1
    # microbatches split the rows, not the sums' total
    out = vocab * _ring(3 * rows * S * 4, ntp, 2.0)
    unit, half = _ring(act, ntp, 2.0), _ring(act, ntp)
    # the encoder (never split on its frames) and the sums inside the
    # RWKV6, Mamba, MoE and cross-attention sublayers
    out += enc_layers * passes * _ring(frames * arch.d_model * itemsize, ntp, 2.0)
    out += (passes - 1 if train else 1) * _ring(rows * S * inner["fwd"], ntp, 2.0)
    if train:
        out += _ring(rows * S * inner["bwd"] + frames * inner["bwd_frame"], ntp, 2.0)
        out += cell.microbatches * _ring(inner["leaves"], ntp, 2.0)
    if st.seq_axis is None or cell.mode == "decode":
        return out + (layers * passes + embed) * unit
    # a split sublayer: the gather in and the reduce-scatter out of each
    # forward, the reduce-scatter and the gather of the backward (the bytes
    # of a sum each); one that gathers with gather_replicated and sums its
    # input's gradient inside (``inner``) all-reduces that gradient in
    # place of the reduce-scatter; a whole sublayer: its gather, the
    # backward's gather of its output's gradient; the embedding: a
    # vocab-split lookup's reduce-scatter and the backward's gather, a
    # whole one's gather; the gather before the final norm; in training
    # the sums of the gradients of the leaves used on a member's rows, a
    # microbatch, and of each RWKV6 gate's input
    whole, rows_only, rwkv = _sp_whole(cell)
    out += layers * passes * unit + whole * passes * half + half
    out += (embed + train) * half
    if train:
        out += cell.microbatches * _ring(rows_only, ntp, 2.0) + rwkv * unit
        out += inner["inner"] * half
    return out


def fsdp_bytes(cell: Cell) -> Dict[str, float]:
    """{axis: wire bytes a member} of a GSPMD cell's FSDP gathers and
    reduce-scatters over ``data``, its gradient sums over the DP axes a
    leaf's spec does not name, and where the moments split a leaf further
    than its block (``zero_moment_specs``) the gathers of the updated
    parts; a serving cell's FSDP gathers."""
    sizes, out = cell.sizes, {}
    params = tree_paths(cell.args[0])
    if cell.mode == "train":
        moments = tree_paths(cell.args[1]["m"])
        for k, leaf in params.items():
            size = leaf.member_bytes(sizes)
            extra = [a for e, p in zip(moments[k].spec, leaf.spec + (None,) * 8)
                     for a in entry_axes(e) if a not in entry_axes(p)
                     and sizes.get(a, 1) > 1]
            for a in extra:  # the parts gathered back, each an axis
                out[a] = out.get(a, 0.0) + _ring(size, sizes[a])
                size //= sizes[a]
    uses = 1
    if cell.mode == "train":
        uses = cell.microbatches * (2 if cell.model.settings.remat == "full" else 1)
    nf = sizes.get("data", 1)
    for leaf in params.values():
        axes = [a for e in leaf.spec for a in entry_axes(e)]
        block = leaf.member_bytes(sizes)
        if "data" in axes:
            gathered = block * nf
            out["data"] = out.get("data", 0.0) + uses * _ring(gathered, nf)
            if cell.mode == "train":
                out["data"] += cell.microbatches * _ring(gathered, nf)
        if cell.mode == "train":
            for a in dp_axes_of(sizes):
                if a not in axes:
                    out[a] = out.get(a, 0.0) + _ring(block, sizes[a], 2.0)
    return out


def split_attention_bytes(cell: Cell) -> Dict[str, float]:
    """{axis: wire bytes a member a step} of the two-stage softmax of a
    decode cell's attention layers whose cache splits on its sequence."""
    if cell.mode != "decode":
        return {}
    params = tree_paths(cell.args[0])
    ntp = cell.sizes.get("model", 1)
    out: Dict[str, float] = {}
    for path, leaf in tree_paths(cell.args[1]).items():
        *parent, name = path.split("/")
        axis = leaf.spec[2] if name in ("k", "xk") else None
        if axis is None or cell.sizes.get(axis, 1) == 1:
            continue
        layers, B = leaf.shape[0], leaf.shape[1]
        hd = leaf.shape[-1]
        wq = params[f"blocks/{parent[0]}/{'xattn' if name == 'xk' else 'attn'}/wq"]
        H = wq.shape[2] // (ntp if "model" in entry_axes(wq.spec[2]) else 1)
        values = (2 * B * H + B * H * hd) * 4  # max and sum, then o; fp32
        out[axis] = out.get(axis, 0.0) + layers * _ring(values, cell.sizes[axis], 2.0)
    return out


def collective_bytes(cell: Cell, topo) -> Dict:
    """Wire bytes a member a step, by tier, and the source of each."""
    by_tier: Dict[str, float] = {}
    sources: Dict[str, str] = {}
    rows = cell.args[1 if cell.mode == "prefill" else 2]
    rows = (rows["tokens"] if isinstance(rows, dict) else rows).local_shape(cell.sizes)[0]
    if cell.step_kind == "dfabric":
        cm = CostModel(topo)
        fast = fast_axes_of(cell.sizes) or ("data",)
        for sec in cell.plan.sections:
            for ch in cm.from_schedule(sec.schedule).charges:
                # a tier the fabric does not name ("fast0") is the mesh's
                axis = (ch.axis if ch.axis in cell.sizes
                        else fast[int(ch.axis.removeprefix("fast"))])
                by_tier[axis] = by_tier.get(axis, 0.0) + ch.bytes_per_chip
        for a in by_tier:
            sources[a] = ("the gradient sync: the plan's sections, each schedule "
                          "priced by core/cost_model.py CostModel.from_schedule")
    else:
        for a, b in fsdp_bytes(cell).items():
            by_tier[a] = b
            sources[a] = ("FSDP gathers and reduce-scatters over data, gradient "
                          "sums over the DP axes a spec does not name, from the "
                          "parameter specs" if cell.mode == "train" else
                          "FSDP gathers over data, once a forward, from the "
                          "parameter specs")
    for a, b in split_attention_bytes(cell).items():
        by_tier[a] = by_tier.get(a, 0.0) + b
        sources[a] = "; ".join(filter(None, (
            sources.get(a), "the two-stage softmax of decode attention over a "
            "cache split on its sequence: a max and two sums a layer a step, "
            "analytic (launch/dryrun.py)")))
    if cell.sizes.get("model", 1) > 1:
        by_tier["model"] = tp_bytes(cell, rows)
        sources["model"] = "the TP activation sums: analytic (launch/dryrun.py)"
    order = [a for a in ("data", "host", "pod", "model") if a in by_tier]
    return {"bytes_per_member": {a: by_tier[a] for a in order},
            "sources": {a: sources[a] for a in order}, "rows_per_member": rows}


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             hw: Optional[HardwareSpec] = None, hw_name: Optional[str] = None,
             attn_impl: str = "masked", codec: Optional[str] = None,
             sync_strategy: str = "hier_striped", zero1: bool = True,
             microbatches: Optional[int] = None, seq_shard: bool = False,
             moe_groups: int = 1, loss_chunk: Optional[int] = None,
             context_parallel: bool = False) -> Dict:
    """One cell's record.  ``hw`` (named ``hw_name``) prices roofline
    seconds; without it the record holds no seconds."""
    if hw is not None and not hw_name:
        raise ValueError("a HardwareSpec is priced under a name (hw_name)")
    t0 = time.time()
    sizes = make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(sizes.values())
    topo = TwoTierTopology(num_pods=sizes.get("pod", 1),
                           pod_shape=(sizes.get("data", 1), sizes.get("model", 1)),
                           hw=hw or HardwareSpec())
    rec: Dict = {"arch": arch_name, "shape": shape_name, "mesh": sizes,
                 "multi_pod": multi_pod, "chips": chips, "attn_impl": attn_impl,
                 "codec": codec, "strategy": sync_strategy, "zero1": zero1,
                 "seq_shard": seq_shard, "moe_groups": moe_groups,
                 "context_parallel": context_parallel,
                 "microbatches": microbatches, "loss_chunk": loss_chunk,
                 "plan_hardware": HARDWARE_NAMES.get(
                     hw_name, hw_name) if hw is not None else HARDWARE_NAMES["tpu-v5e"]}
    try:
        cell = build_cell(arch_name, shape_name, sizes, topo=topo,
                          attn_impl=attn_impl, codec=codec,
                          sync_strategy=sync_strategy, zero1=zero1,
                          microbatches=microbatches, seq_shard=seq_shard,
                          moe_groups=moe_groups, loss_chunk=loss_chunk,
                          context_parallel=context_parallel)
        rec.update(mode=cell.mode, step_kind=cell.step_kind,
                   microbatches_used=cell.microbatches,
                   gqa_repeat=cell.model.settings.gqa_repeat)
        rec["memory"] = {"argument_bytes_per_member": argument_bytes(cell),
                         "temp_bytes": None, "temp_note": TEMP_NOTE}
        rec["collectives"] = collective_bytes(cell, topo)
        mc = model_cost(cell.model, cell.shape, cell.mode, n_chips=chips)
        rec["cost"] = {k: mc[k] for k in ("flops", "bytes", "model_flops",
                                          "useful_ratio", "params",
                                          "active_params")}
        if hw is not None:
            rates = {"data": hw.ici_bw, "host": hw.cxl_bw, "pod": hw.dcn_bw,
                     "model": hw.ici_bw}
            coll = {a: b / rates[a] for a, b in
                    rec["collectives"]["bytes_per_member"].items()}
            terms = {"compute_s": mc["flops"] / (chips * hw.peak_flops_bf16),
                     "memory_s": mc["bytes"] / (chips * hw.hbm_bw),
                     "collective_s": sum(coll.values())}
            rec["roofline"] = {"hardware": HARDWARE_NAMES.get(hw_name, hw_name),
                               **terms, "collective_s_by_tier": coll,
                               "dominant": max(terms, key=terms.get),
                               "step_lower_bound_s": max(terms.values())}
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def summary_line(name: str, rec: Dict) -> str:
    """One line a cell: status, step kind, argument GB a member, model
    flops, collective bytes a member by tier (no seconds)."""
    if not rec.get("ok"):
        return f"FAIL {name}: {rec.get('error')}"
    coll = rec["collectives"]["bytes_per_member"]
    return (f"OK   {name} step_kind={rec['step_kind']} args_gb_per_member="
            f"{rec['memory']['argument_bytes_per_member']['total'] / 1e9:.3f} "
            f"model_flops={rec['cost']['model_flops']:.4e} coll_bytes_per_member="
            f"{{{', '.join(f'{a}: {b:.4e}' for a, b in coll.items())}}}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="DFabric multi-pod dry-run (PyTorch port)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--attn-impl", default="masked")
    ap.add_argument("--codec", default=None)
    ap.add_argument("--strategy", default="hier_striped")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--context-parallel", action="store_true")
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--hardware", default="none", choices=sorted(HARDWARE),
                    help="price roofline seconds with this HardwareSpec "
                         "(default: none, no seconds)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    hw = HARDWARE[args.hardware]

    results = []
    for arch_name in archs:
        for shape_name in shapes:
            ok, why = shape_applicable(get_arch(arch_name), SHAPES[shape_name])
            for multi in meshes:
                name = f"{arch_name}__{shape_name}__{'multi' if multi else 'single'}"
                if args.tag:
                    name += f"__{args.tag}"
                path = os.path.join(args.out, name + ".json")
                if not ok:
                    with open(path, "w") as f:
                        json.dump({"arch": arch_name, "shape": shape_name,
                                   "multi_pod": multi, "ok": True, "skipped": True,
                                   "skip_reason": why}, f, indent=1)
                    print(f"SKIP {name}: {why}")
                    continue
                rec = run_cell(arch_name, shape_name, multi_pod=multi, hw=hw,
                               hw_name=args.hardware if hw is not None else None,
                               attn_impl=args.attn_impl, codec=args.codec,
                               sync_strategy=args.strategy,
                               zero1=not args.no_zero1,
                               microbatches=args.microbatches,
                               seq_shard=args.seq_shard,
                               context_parallel=args.context_parallel,
                               moe_groups=args.moe_groups,
                               loss_chunk=args.loss_chunk)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(summary_line(name, rec), flush=True)
                results.append(rec)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK")


if __name__ == "__main__":
    main()
