"""Config-driven model assembly — ``repro.models.transformer`` in PyTorch:
dense attention, mixture of experts, RWKV6, hybrid (Jamba: Mamba +
attention, with or without experts) and the encoder-decoder (whisper).

The parameter tree is the JAX package's, leaf for leaf and shape for shape:
layers are stacked over groups (a leading group dim on every ``blocks/``
leaf), and a Python loop over that dim takes the place of ``lax.scan``.
Every dense, MoE or RWKV group holds one layer, ``blocks/l0``; a hybrid
group holds ``attn_every`` layers, ``blocks/l0`` ..
``blocks/l{attn_every-1}``, whose kinds follow the within-group offset.  A
layer whose id ``layer_is_moe`` names has ``moe`` (an fp32 router, the
experts and the shared experts) in place of ``mlp``.

The encoder-decoder adds ``pos_embed`` (the decoder's learned positions,
``max_seq`` rows), ``enc_blocks`` (the encoder's layers stacked over the
encoder depth) and ``enc_final_norm``, and cross attention in every
decoder layer (``blocks/l0/xattn`` after ``blocks/l0/lnx``).  Its frontend
is the reference's stub: the encoder takes frame embeddings (B, F,
d_model), adds the sinusoidal table and runs non-causal ``masked``
attention whatever ``attn_impl`` says, as the cross attention does; the
prefill caches the cross attention's k/v (``xk``/``xv``), which decode
reads.

Training under a model axis (tensor parallelism; every decoder family)
and an FSDP axis (the GSPMD step), and prefill and decode under either or
both (serving over a mesh, every family), run on each member's blocks of
the leaves (``registry.Layout``): the code reads each leaf's spec, never
assumes a split, and puts in the collectives GSPMD puts in for the JAX
package — local heads with a row-parallel ``wo`` then a sum, column- then
row-parallel MLPs, RWKV6 and Mamba mixers on local heads or channels
(``models/ssm.py``), the vocab-sharded embedding and loss, experts split
over the axis, the learned positions' d columns gathered
(``prims.gather_replicated``), the encoder and the cross attention on
local heads, and each layer's FSDP blocks gathered on use (again in the
recompute; the encoder's layers and the cross attention's too) with their
gradients reduce-scattered back.  Under
the GSPMD step, and in serving where the batch's rows split over the DP
members, the MoE layers route the whole batch as one dispatch group, as
the JAX package's ``jax.jit`` of the global batch does
(``layers.apply_moe``'s ``token_axes``).  In serving the logits' vocab
columns are gathered over the model axis, the decode cache holds each
member's heads and channels (``sharding.cache_specs``), and a cache whose
sequence splits over a DP axis (a batch that does not divide the DP
members) takes decode attention's softmax in two stages over it
(``layers.attend_decode``).

The sequence split (``ModelSettings.seq_axis``, the reference's
Megatron-SP constraints; every family, in training and prefill): between
the sublayers each model member holds its rows of the sequence, (B, S/n,
d).  The embedding is reduce-scattered onto them (or cut, where the vocab
is whole), and the learned positions cut alike; each attention, cross
attention, MLP, MoE layer, RWKV6 mix and Mamba mixer reads the gathered
sequence and its output is reduce-scattered back (a sublayer run whole on
every member, as the context-parallel cell's blocks are, gathers its input
alike and keeps its rows of the output); the norms, and a whole MLP, see
a member's rows only, so their gradients are summed over the axis; the
stream is gathered again before the final norm, whose consumer every
member computes alike (``_sublayer_in``, ``L.sublayer_out``, ``_on_rows``,
``_sp_axis``).  A mixer that sums its input's gradient inside
(``models/ssm.py``), and the MoE layer, whose replicated router and split
experts both read the tokens, gather with ``gather_replicated``; the
prefill cache holds the whole sequence, the recurrent states its last
rows.

Parameters and compute share a dtype (fp32 or bf16), or bf16 parameters
meet an fp32 compute dtype, promoted as jnp promotes them.  fp32
parameters with a bf16 compute dtype have no reference (the JAX forward
raises on them) and raise here.

Modes:
  * train   — full-sequence causal forward, chunked CE loss plus the MoE
              load-balance aux loss; autograd gives the backward, with
              each layer recomputed (``remat="full"``) or its
              no-batch-dim products kept (``remat="dots"``)
  * prefill — forward returning logits of the last position + the cache
              (KV for attention layers; token-shift and wkv states for
              RWKV; conv and ssm states for Mamba)
  * decode  — single-token step over a preallocated cache, updated in place
              (the JAX step returns a new cache; here the one cache is
              written where it lies and returned, to save a copy per step)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prims
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.utils.trees import tree_from_paths, tree_paths

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelSettings:
    """The fields of the JAX ``ModelSettings`` that this slice uses."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "masked"  # masked | tri | kernel (twin of "pallas")
    attn_block: int = 1024
    attn_chunk: int = 1024
    # the wkv6 and mamba_scan kernels (twin of use_pallas_ssm)
    use_kernel_ssm: bool = False
    max_seq: int = 4096  # sizes learned positional tables
    # training: recompute each layer in the backward (torch.utils.checkpoint
    # per layer) — none | full | dots (keep the outputs of products without
    # batch dims, recompute the rest); and the CE loss's sequence chunk
    remat: str = "full"
    loss_chunk: int = 2048
    # MoE dispatch token groups: routing, cumsum and capacity per group
    moe_groups: int = 1
    # the JAX package's sequence-parallel settings: the residual stream's
    # sequence split over ``seq_axis`` (the model axis) between the
    # sublayers, in training and prefill; ``batch_axes``
    # names the DP axes its rows split over, which a member's rows already
    # are (checked against the step: ``_sp_axis``)
    seq_axis: Optional[str] = None
    batch_axes: Optional[Tuple[str, ...]] = None
    # k/v repeated per query head before the attention core (``L.attend``)
    gqa_repeat: bool = False

    def pdt(self) -> torch.dtype:
        return _dtype(self.param_dtype)

    def cdt(self) -> torch.dtype:
        return _dtype(self.compute_dtype)


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def check_supported(arch: ArchConfig, st: ModelSettings) -> None:
    """Raise for what has no reference."""
    if st.pdt() != st.cdt() and (st.pdt(), st.cdt()) != (torch.bfloat16,
                                                          torch.float32):
        raise NotImplementedError(
            f"param_dtype {st.param_dtype} with compute_dtype "
            f"{st.compute_dtype} has no reference: the JAX package's own "
            f"forward raises on it ('TypeError: scan body function carry "
            f"input and carry output must have equal types', the bf16 "
            f"embedding promoted by the first fp32 weight), so the port "
            f"runs fp32/fp32, bf16/bf16 and bf16/fp32 (ROADMAP.md queue 1, "
            f"'What has no reference')")


def group_size(arch: ArchConfig) -> int:
    """Layers per stacked group."""
    return arch.attn_every if arch.is_hybrid else 1


def n_groups(arch: ArchConfig) -> int:
    g = group_size(arch)
    if arch.n_layers % g:
        raise ValueError(f"{arch.name}: n_layers {arch.n_layers} is not a "
                         f"multiple of the group size {g}")
    return arch.n_layers // g


def layer_kind(arch: ArchConfig, layer_id: int) -> str:
    """'rwkv', 'mamba' or 'attn'.  Inside a group the within-group offset
    is the layer id: Jamba's pattern (attention at offset attn_every // 2)
    is the same in every group."""
    if arch.attn_free:
        return "rwkv"
    if arch.is_hybrid:
        return "attn" if layer_id in set(arch.attn_layer_ids()) else "mamba"
    return "attn"


def layer_is_moe(arch: ArchConfig, layer_id: int) -> bool:
    return layer_id in set(arch.moe_layer_ids())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(arch: ArchConfig, gen: torch.Generator, layer_id: int,
                lead: Tuple[int, ...], st: ModelSettings, device) -> Params:
    dt, d = st.pdt(), arch.d_model
    kind = layer_kind(arch, layer_id)
    p: Params = {"ln1": L.init_norm(arch, lead + (d,), dt, device),
                 "ln2": L.init_norm(arch, lead + (d,), dt, device)}
    if kind == "rwkv":
        p["tmix"] = SSM.init_rwkv_time_mix(arch, gen, lead, dt, device)
        p["cmix"] = SSM.init_rwkv_channel_mix(arch, gen, lead, dt, device)
        return p
    if kind == "mamba":
        p["mamba"] = SSM.init_mamba(arch, gen, lead, dt, device)
    else:
        p["attn"] = L.init_attention(arch, gen, lead, dt, device)
    if layer_is_moe(arch, layer_id):
        p["moe"] = L.init_moe(arch, gen, lead, dt, device)
    else:
        p["mlp"] = L.init_mlp(arch, gen, lead, dt, device)
    return p


def init_params(arch: ArchConfig, gen: torch.Generator, st: ModelSettings,
                device) -> Params:
    """The JAX tree (``repro.models.transformer.init_params``), drawn from
    ``gen``: the same paths, shapes, dtypes and init scales; other
    numbers."""
    check_supported(arch, st)
    dt, d = st.pdt(), arch.d_model
    lead = (n_groups(arch),)
    p: Params = {"embed": L.embed_init(gen, (arch.vocab, d), dt, device)}
    p["blocks"] = {f"l{off}": _init_layer(arch, gen, off, lead, st, device)
                   for off in range(group_size(arch))}
    p["final_norm"] = L.init_norm(arch, (d,), dt, device)
    if not arch.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, arch.vocab), d, dt, device)
    if arch.positional == "learned":
        p["pos_embed"] = L.embed_init(gen, (st.max_seq, d), dt, device)
    if arch.is_encdec:  # the encoder's layers have the decoder's dims
        p["enc_blocks"] = _init_layer(arch, gen, 0, (arch.encoder.n_layers,),
                                      st, device)
        p["enc_final_norm"] = L.init_norm(arch, (d,), dt, device)
        p["blocks"]["l0"]["xattn"] = L.init_attention(arch, gen, lead, dt, device)
        p["blocks"]["l0"]["lnx"] = L.init_norm(arch, lead + (d,), dt, device)
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _axis(specs: Optional[Params], *path) -> Optional[str]:
    """The mesh axis ``specs`` gives dim ``path[-1]`` of the leaf at
    ``path[:-1]`` (None without specs, or where the dim is whole)."""
    if specs is None:
        return None
    node = specs
    for key in path[:-1]:
        node = node[key]
    return node[path[-1]]


def _member_heads(p: Params, specs: Optional[Params], parent: str
                  ) -> Tuple[Params, Optional[str], bool]:
    """(the attention leaves ``p[parent]`` as this member's heads use them,
    the axis that splits the query heads or None, whether the kv heads
    stay whole under it).  The replicated q_norm/k_norm, and wk/wv/bk/bv
    where the kv heads stay whole, enter through ``to_parallel``, so their
    gradients sum the members' heads; ``wo`` is row-parallel, its outputs
    summed over the axis."""
    heads = _axis(specs, parent, "wq", 1)
    kv = _axis(specs, parent, "wk", 1)
    names = ("q_norm", "k_norm") + (() if kv else ("wk", "wv", "bk", "bv"))
    pa = {n: prims.to_parallel(t, heads) if n in names else t
          for n, t in p[parent].items()}
    return pa, heads, heads is not None and kv is None


def _sublayer_in(h: torch.Tensor, split: Optional[str],
                 sp: Optional[str]) -> torch.Tensor:
    """The normed stream as a sublayer reads it.  Without a sequence split
    the replicated stream enters a sublayer split over ``split`` (heads or
    d_ff) through ``to_parallel``.  Under ``sp`` the member's rows of the
    sequence are gathered (the Megatron-SP gather point): for a split
    sublayer, whose members' gradients of the gathered input are partial,
    by ``gather_on_use`` (a reduce-scatter backward); for a whole one,
    which every member runs alike, by ``gather_replicated``."""
    if sp is None:
        return prims.to_parallel(h, split)
    return (prims.gather_on_use(h, sp, 1) if split
            else prims.gather_replicated(h, sp, 1))


def _on_rows(p: Params, sp: Optional[str]) -> Params:
    """Replicated leaves (the norms) used on the member's rows of the
    sequence: their gradients are partial, summed over ``sp`` by
    ``to_parallel``."""
    return p if sp is None else _tree_map(lambda t: prims.to_parallel(t, sp), p)


def _own_kv(arch: ArchConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, heads: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole kv heads under a split of the query heads: the kv head of
    each of this member's query heads."""
    Hl, G = q.shape[2], arch.n_heads // arch.n_kv_heads
    idx = (prims.axis_rank(heads) * Hl + torch.arange(Hl, device=q.device)) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _own_kv_heads(arch: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, heads: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_own_kv` of a decode cache: where this member's query heads
    use a run of whole kv groups, or share one kv head, that run of the
    cache's kv heads (a view; the query heads keep their grouping over
    it), else one kv head a query head (a copy)."""
    Hl, G = q.shape[2], arch.n_heads // arch.n_kv_heads
    if Hl % G and G % Hl:
        return _own_kv(arch, q, k, v, heads)
    lo = prims.axis_rank(heads) * Hl // G
    n = max(Hl // G, 1)
    return k.narrow(2, lo, n), v.narrow(2, lo, n)


def _write_row(cache: torch.Tensor, new: torch.Tensor, pos: int,
               seq_axis: Optional[str]) -> None:
    """Write the (B, 1, ...) ``new`` at row ``pos`` of a (B, S, ...) cache
    leaf, in place; under ``seq_axis`` the leaf holds this member's rows of
    the sequence and only the member that holds row ``pos`` writes it (the
    port of ``dynamic_update_slice`` on a sequence-split cache)."""
    S = cache.shape[1]
    n = prims.axis_size(seq_axis) if seq_axis is not None else 1
    pos = min(pos, n * S - 1)  # clamped, as dynamic_update_slice clamps
    if seq_axis is not None:
        pos -= prims.axis_rank(seq_axis) * S
    if 0 <= pos < S:
        cache[:, pos:pos + 1] = new.to(cache.dtype)


def _cross_attention(arch: ArchConfig, p: Params, x: torch.Tensor,
                     enc_out: Optional[torch.Tensor], st: ModelSettings,
                     cache: Optional[Params], specs: Optional[Params],
                     xseq_axis: Optional[str] = None, sp: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decoder layer's cross attention (whisper), non-causal
    ``masked`` attention of the normed stream over the encoder's output:
    its k/v projected from ``enc_out``, or in decode (``cache`` given)
    read from the cache's ``xk``/``xv``; under ``xseq_axis`` those hold
    this member's frames, over which :func:`L.attend_decode` takes the
    softmax in two stages.  Under ``sp`` the queries come from the
    gathered rows and the output is scattered back; the encoder's output
    is whole.  Returns (x, k, v)."""
    h = L.apply_norm(arch, _on_rows(p["lnx"], sp), x)
    pa, heads, whole_kv = _member_heads(p, specs, "xattn")
    q = L.einsum("bsd,dhk->bshk", _sublayer_in(h, heads, sp), pa["wq"])
    if "bq" in pa:
        q = q + pa["bq"]
    if cache is not None:
        kx, vx = cache["xk"], cache["xv"]
    else:
        eo = prims.to_parallel(enc_out, heads)
        kx = L.einsum("bfd,dhk->bfhk", eo, pa["wk"])
        vx = L.einsum("bfd,dhk->bfhk", eo, pa["wv"])
        if "bk" in pa:
            kx, vx = kx + pa["bk"], vx + pa["bv"]
    k, v = _own_kv(arch, q, kx, vx, heads) if whole_kv else (kx, vx)
    if cache is not None and xseq_axis is not None:
        frames = torch.full((x.shape[0],), kx.shape[1] * prims.axis_size(xseq_axis),
                            device=x.device)
        o = L.attend_decode(q, k, v, frames, xseq_axis)
    else:
        o = L.attend(q, k, v, causal=False, impl="masked", q_chunk=st.attn_chunk,
                     kv_chunk=st.attn_chunk)
    return x + L.sublayer_out(L.attention_out(pa, o), heads, sp), kx, vx


def _apply_encoder_layer(arch: ArchConfig, p: Params, x: torch.Tensor,
                         st: ModelSettings, specs: Optional[Params] = None
                         ) -> torch.Tensor:
    """One encoder layer: non-causal ``masked`` self-attention on this
    member's heads (no rotary positions: ``arch`` has ``positional``
    "none"), then the MLP on its d_ff columns."""
    h = L.apply_norm(arch, p["ln1"], x)
    pa, heads, whole_kv = _member_heads(p, specs, "attn")
    q, k, v = L.attention_qkv(arch, pa, prims.to_parallel(h, heads), None)
    if whole_kv:
        k, v = _own_kv(arch, q, k, v, heads)
    o = L.attend(q, k, v, causal=False, impl="masked", q_chunk=st.attn_chunk,
                 kv_chunk=st.attn_chunk)
    x = x + prims.psum_replicated(L.attention_out(pa, o), heads)
    h = L.apply_norm(arch, p["ln2"], x)
    return x + L.apply_mlp_tp(arch, p["mlp"], h, _axis(specs, "mlp", "wi", 1))


def _apply_layer(arch: ArchConfig, p: Params, x: torch.Tensor, positions,
                 st: ModelSettings, layer_id: int,
                 cache: Optional[Params] = None, pos: Optional[int] = None,
                 specs: Optional[Params] = None, token_axes: Tuple[str, ...] = (),
                 enc_out: Optional[torch.Tensor] = None,
                 seq_axis: Optional[str] = None, xseq_axis: Optional[str] = None,
                 sp_axis: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Params]:
    """Prefill (``cache`` None) or one decode step at ``pos`` (the new kv,
    or the new recurrent states, are written into ``cache`` in place).
    Returns (x, its MoE aux loss or None, the layer's cache), as the
    reference's ``_apply_layer`` does.  ``specs``: the layer's leaf specs,
    by which its leaves are this member's blocks (its heads' caches and
    states in decode); ``token_axes``: the DP axes whose members' rows a
    MoE layer routes as one batch (the GSPMD step's, and serving's over
    rows split by member); ``enc_out``: the encoder's output, which a
    layer with cross attention reads in prefill and training;
    ``seq_axis``, ``xseq_axis``: the axes that split the decode cache's
    sequence (an attention layer's k/v) and its frames (a cross
    attention's ``xk``/``xv``), each as its own leaf's spec does, or None;
    ``sp_axis``: the axis over which ``x`` holds this member's rows of the
    sequence (in training or prefill, ``_sp_axis``): each sublayer reads
    the gathered sequence and its output is scattered back
    (``_sublayer_in``, ``L.sublayer_out``), the prefill cache holding the
    whole sequence."""
    kind = layer_kind(arch, layer_id)
    decode = cache is not None
    if kind == "rwkv":
        x, cache = _apply_rwkv_layer(arch, p, x, st, cache, specs, sp_axis)
        return x, None, cache
    h = L.apply_norm(arch, _on_rows(p["ln1"], sp_axis), x)
    if kind == "mamba":
        state = cache or {}
        out, (conv, ssm) = SSM.apply_mamba(
            arch, p["mamba"], h, conv_state=state.get("conv"),
            ssm_state=state.get("ssm"), use_kernel=st.use_kernel_ssm,
            axis=_axis(specs, "mamba", "w_in", 1), sp=sp_axis)
        if cache is None:  # a copy: the view would keep (B, S, 2 di) alive
            cache = {"conv": conv.clone(), "ssm": ssm}
        else:
            cache["conv"].copy_(conv)
            cache["ssm"].copy_(ssm)
    else:
        # this member's heads (all of them when ``heads`` is None)
        pa, heads, whole_kv = _member_heads(p, specs, "attn")
        q, k, v = L.attention_qkv(arch, pa, _sublayer_in(h, heads, sp_axis),
                                  positions)
        if cache is None:
            cache = {"k": k, "v": v}  # whole kv heads stay whole in the cache
            if whole_kv:
                k, v = _own_kv(arch, q, k, v, heads)
            o = L.attend(q, k, v, causal=True, impl=st.attn_impl,
                         block=st.attn_block, q_chunk=st.attn_chunk,
                         kv_chunk=st.attn_chunk, gqa_repeat=st.gqa_repeat)
        else:
            kc, vc = cache["k"], cache["v"]
            _write_row(kc, k, pos, seq_axis)
            _write_row(vc, v, pos, seq_axis)
            if whole_kv:
                kc, vc = _own_kv_heads(arch, q, kc, vc, heads)
            lens = torch.full((x.shape[0],), pos + 1, device=x.device)
            o = L.attend_decode(q, kc, vc, lens, seq_axis)
        out = L.sublayer_out(L.attention_out(pa, o), heads, sp_axis)
    x = x + out
    if "xattn" in p:
        x, xk, xv = _cross_attention(arch, p, x, enc_out, st,
                                     cache if decode else None, specs, xseq_axis,
                                     sp_axis)
        if not decode:
            cache = dict(cache, xk=xk, xv=xv)
    h = L.apply_norm(arch, _on_rows(p["ln2"], sp_axis), x)
    aux = None
    if "moe" in p:
        experts = _axis(specs, "moe", "we_in", 0)
        shared = (_axis(specs, "moe", "shared", "wi", 1)
                  if "shared" in p["moe"] else None)
        out, aux = L.apply_moe(arch, p["moe"], h, groups=st.moe_groups,
                               dispatch_spec=(None, experts) if experts
                               else None, shared_axis=shared,
                               token_axes=token_axes, seq_axis=sp_axis)
        x = x + out
    else:
        x = x + L.apply_mlp_tp(arch, p["mlp"], h, _axis(specs, "mlp", "wi", 1),
                               seq_axis=sp_axis)
    return x, aux, cache


def _apply_rwkv_layer(arch: ArchConfig, p: Params, x: torch.Tensor,
                      st: ModelSettings, cache: Optional[Params] = None,
                      specs: Optional[Params] = None, sp: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """Time mix then channel mix, each from its state in ``cache`` (zeros
    when None).  In decode the new states are copied into ``cache``; the
    shifts returned by the mixers are views of their inputs.  ``specs``,
    ``sp``: as in :func:`_apply_layer` (the time mix on this member's
    heads or, where its projections split over the model axis but its
    heads do not, on every head; the channel mix on its d_ff columns)."""
    state = cache or {}
    h = L.apply_norm(arch, _on_rows(p["ln1"], sp), x)
    out, (tshift, wkv) = SSM.apply_rwkv_time_mix(
        arch, p["tmix"], h, shift_state=state.get("tshift"),
        wkv_state=state.get("wkv"), use_kernel=st.use_kernel_ssm,
        axis=_axis(specs, "tmix", "wr", 1), sp=sp)
    x = x + out
    h = L.apply_norm(arch, _on_rows(p["ln2"], sp), x)
    out, cshift = SSM.apply_rwkv_channel_mix(
        arch, p["cmix"], h, shift_state=state.get("cshift"),
        axis=_axis(specs, "cmix", "wk", 1), sp=sp)
    x = x + out
    new = {"tshift": tshift, "wkv": wkv, "cshift": cshift}
    if cache is None:
        return x, new
    for name, t in new.items():
        cache[name].copy_(t)
    return x, cache


# ---------------------------------------------------------------------------
# forward (prefill) / logits
# ---------------------------------------------------------------------------


def _stacked_specs(layout, *path) -> Optional[Params]:
    """The specs of the stacked leaves under ``path`` (a group offset's
    layer, ``blocks/l{off}``, or the encoder's, ``enc_blocks``) with the
    stacked dim dropped (those of one layer), or None without a layout."""
    if layout is None:
        return None
    node = layout.tree
    for key in path:
        node = node[key]
    return _tree_map(lambda sp: tuple(sp[1:]), node)


def _unstack(tree: Params) -> list:
    """The per-layer trees of a stacked tree (one ``unbind`` a leaf, whose
    backward stacks the layers' gradients once)."""
    leaves = tree_paths(tree)
    cols = [t.unbind(0) for t in leaves.values()]
    return [tree_from_paths(dict(zip(leaves, row))) for row in zip(*cols)]


def encode(arch: ArchConfig, params: Params, frames: torch.Tensor,
           st: ModelSettings, layout=None, train: bool = False) -> torch.Tensor:
    """The encoder (the reference's frontend is a stub: ``frames`` are
    frame embeddings (B, F, d_model)): the frames in the compute dtype
    plus the fp32 sinusoidal table, the encoder layers (in training each
    recomputed in the backward as ``st.remat`` says), the final norm.
    With a ``layout`` the leaves are this member's blocks, each layer's
    FSDP blocks gathered on use (inside the recomputed function in
    training, so that a remat gathers them again in the backward)."""
    x = frames.to(st.cdt())
    x = x + L.sinusoidal_positions(x.shape[1], arch.d_model, x.device).to(x.dtype)
    enc_arch = arch.replace(positional="none")
    specs = _stacked_specs(layout, "enc_blocks")
    fsdp = layout.fsdp if layout is not None else None
    for lp in _unstack(params["enc_blocks"]):
        def layer(x_, lp=lp):
            return _apply_encoder_layer(enc_arch, _gather_fsdp(lp, specs, fsdp),
                                        x_, st, specs)
        x = _remat(st, layer, x) if train else layer(x)
    return L.apply_norm(arch, params["enc_final_norm"], x)


def _positions_table(params: Params, layout=None) -> torch.Tensor:
    """The learned positions (max_seq, d), their d columns gathered where a
    layout splits them (the reference's rule: over the model axis)."""
    pe = params["pos_embed"]
    if layout is not None:
        pe = prims.gather_replicated(pe, layout.tree["pos_embed"][1], 1)
    return pe


def _positions(params: Params, seq_len: int, dtype, layout=None,
               sp: Optional[str] = None) -> torch.Tensor:
    """The learned positions of the first ``seq_len`` rows, under ``sp``
    this member's rows of them (``split_replicated``)."""
    pe = _positions_table(params, layout)[:seq_len].to(dtype)
    return prims.split_replicated(pe, sp, 0)


def _embed(params: Params, tokens: torch.Tensor, st: ModelSettings,
           layout=None, sp: Optional[str] = None) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype: under a layout from
    this member's vocab rows (``L.embed_lookup``), its FSDP blocks
    gathered; under ``sp`` the member's rows of the sequence."""
    if layout is None:
        return params["embed"][tokens].to(st.cdt())
    espec = layout.tree["embed"]
    return L.embed_lookup(_gather_fsdp(params["embed"], espec, layout.fsdp),
                          tokens, espec[0], seq_axis=sp).to(st.cdt())


def _sp_axis(st: ModelSettings, layout, seq_len: int,
             row_axes: Tuple[str, ...]) -> Optional[str]:
    """The axis over which the residual stream holds each member's rows of
    the sequence: ``st.seq_axis`` where the layout splits it, else None.
    ``st.batch_axes`` must name DP axes (``pod``, ``host``, ``data``) that
    are among ``row_axes`` (the axes the caller split the batch's rows
    over) or have one member here: the reference constrains the batch
    there, which the rows already are."""
    if layout is None:
        return None
    if st.batch_axes:
        bad = [a for a in st.batch_axes if a not in prims.MESH_AXES[:-1]
               or (layout.split(a) and a not in row_axes)]
        if bad:
            raise ValueError(
                f"batch_axes {tuple(st.batch_axes)}: {bad} do not split this "
                f"step's rows (they split over {tuple(row_axes) or 'no axis'} "
                f"on {layout.sizes})")
    axis = st.seq_axis
    if axis is None or not layout.split(axis):
        return None
    if axis != layout.tp:
        raise ValueError(f"seq_axis {axis!r}: the sequence splits over the "
                         f"model axis {layout.tp!r} only")
    if seq_len % layout.sizes[axis]:
        raise ValueError(f"seq {seq_len} does not split over the "
                         f"{layout.sizes[axis]} members of {axis!r}")
    return axis


def _layer_params(params: Params, off: int, gi: int, specs, fsdp) -> Params:
    """Layer ``gi`` of group offset ``off``, its FSDP blocks gathered (one
    layer's at a time)."""
    lp = _tree_map(lambda a: a[gi], params["blocks"][f"l{off}"])
    return _gather_fsdp(lp, specs, fsdp)


def forward(arch: ArchConfig, params: Params, tokens: torch.Tensor,
            st: ModelSettings, frames: Optional[torch.Tensor] = None,
            layout=None, token_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill forward.  Returns (hidden (B,S,d), the cache: for each
    within-group offset ``l{off}``, that layer's cache stacked over groups:
    {'k','v': (G,B,S,KV,hd)} for attention layers, with {'xk','xv':
    (G,B,F,KV,hd)} for cross attention, {'tshift','cshift': (G,B,d), 'wkv':
    (G,B,H,hd,hd)} for RWKV, {'conv': (G,B,d_conv-1,di), 'ssm':
    (G,B,di,ds)} for Mamba).  An encoder-decoder needs ``frames``.  With a
    ``layout`` the leaves are this member's blocks, each layer's FSDP
    blocks gathered on use, and the cache holds this member's heads and
    channels (all kv heads where they stay whole); ``token_axes``: the DP
    axes over which the members' rows (``tokens``) form the batch.  Under
    ``st.seq_axis`` (``_sp_axis``) the residual stream holds the member's
    rows of the sequence between the sublayers, gathered before the final
    norm; the cache holds the whole sequence."""
    B, Sq = tokens.shape
    sp = _sp_axis(st, layout, Sq, token_axes)
    x = _embed(params, tokens, st, layout, sp)
    if arch.positional == "learned":
        x = x + _positions(params, Sq, x.dtype, layout, sp)
    positions = torch.arange(Sq, device=tokens.device)[None, :].expand(B, Sq)
    enc_out = _encoder_output(arch, params, frames, st, layout)
    fsdp = layout.fsdp if layout is not None else None
    g = group_size(arch)
    specs = [_stacked_specs(layout, "blocks", f"l{off}") for off in range(g)]
    caches = [[] for _ in range(g)]  # [offset][group]
    for gi in range(n_groups(arch)):
        for off, per_group in enumerate(caches):
            lp = _layer_params(params, off, gi, specs[off], fsdp)
            x, _, c = _apply_layer(arch, lp, x, positions, st, off,
                                   specs=specs[off], token_axes=token_axes,
                                   enc_out=enc_out, sp_axis=sp)
            per_group.append(c)
    x = L.apply_norm(arch, params["final_norm"], prims.gather_replicated(x, sp, 1))
    return x, {f"l{off}": {name: torch.stack([c[name] for c in cs])
                           for name in cs[0]}
               for off, cs in enumerate(caches)}


def _encoder_output(arch: ArchConfig, params: Params,
                    frames: Optional[torch.Tensor], st: ModelSettings,
                    layout=None, train: bool = False) -> Optional[torch.Tensor]:
    """:func:`encode` of ``frames`` for an encoder-decoder, else None."""
    if not arch.is_encdec:
        return None
    if frames is None:
        raise ValueError(f"{arch.name} is an encoder-decoder: it needs frame "
                         f"embeddings (B, {arch.encoder.n_frames}, "
                         f"{arch.d_model})")
    return encode(arch, params, frames, st, layout, train)


def logits_from_hidden(arch: ArchConfig, params: Params, x: torch.Tensor,
                       layout=None) -> torch.Tensor:
    """fp32 logits over the whole vocab: under a vocab-split layout each
    member's columns, gathered over the axis (the layout of the JAX
    package's ``jit`` output)."""
    if layout is None:
        head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
        return (x @ head.to(x.dtype)).float()
    head, vocab = _head(arch, params, layout)
    logits = (x @ head.to(x.dtype)).float()
    return prims.all_gather_tiled(logits, vocab, -1) if vocab else logits


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def check_trainable(arch: ArchConfig, st: ModelSettings) -> None:
    """Raise for what the port cannot train yet: what it cannot run
    (``check_supported``: fp32 parameters with a bf16 compute dtype), or
    an unknown remat policy."""
    check_supported(arch, st)
    if st.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {st.remat!r} (none | full | dots)")


#: the products ``remat="dots"`` keeps: JAX's
#: ``dots_with_no_batch_dims_saveable``, as torch dispatches them
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(st: ModelSettings, fn, *args):
    """``fn(*args)``, recomputed in the backward as ``st.remat`` says:
    ``full`` keeps nothing (``jax.checkpoint`` with ``nothing_saveable``),
    ``dots`` keeps the outputs of ``mm`` and ``addmm`` and recomputes the
    rest, ``bmm`` included (``dots_with_no_batch_dims_saveable``)."""
    if st.remat == "none":
        return fn(*args)
    if st.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(
                              _keep_dots))
    return checkpoint(fn, *args, use_reentrant=False)


def _gather_fsdp(p: Params, specs: Optional[Params],
                 fsdp: Optional[str]) -> Params:
    """Every leaf of ``p`` with the dims its spec gives the FSDP axis
    gathered (``prims.gather_on_use``: the backward reduce-scatters the
    gradient back onto the blocks); the dims of other axes stay local."""
    if fsdp is None or specs is None:
        return p
    if isinstance(p, dict):
        return {k: _gather_fsdp(v, specs[k], fsdp) for k, v in p.items()}
    for d, entry in enumerate(specs):
        if entry == fsdp:
            p = prims.gather_on_use(p, fsdp, d)
    return p


def _head(arch: ArchConfig, params: Params, layout) -> Tuple[torch.Tensor, Optional[str]]:
    """The (d, vocab) output head (this member's vocab columns under a
    vocab-sharded layout, its FSDP blocks gathered) and the axis that
    splits its vocab, or None."""
    name = "embed" if arch.tie_embeddings else "lm_head"
    head = params[name]
    spec = layout.tree[name] if layout is not None else None
    head = _gather_fsdp(head, spec, layout.fsdp if layout is not None else None)
    head = head.T if arch.tie_embeddings else head
    vocab = None if spec is None else (spec[0] if arch.tie_embeddings else spec[1])
    return head, vocab


def forward_train(arch: ArchConfig, params: Params, tokens: torch.Tensor,
                  st: ModelSettings, layout=None,
                  frames: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode forward: (the final-normed hidden states (B, S, d), the
    sum of the MoE layers' aux losses, fp32), each layer recomputed in the
    backward as ``st.remat`` says (the JAX package checkpoints each
    scanned group, and each encoder layer).  With a ``layout`` the leaves
    are this member's blocks; each layer's FSDP blocks are gathered inside
    the recomputed function, so that a remat gathers them again in the
    backward.  An encoder-decoder needs ``frames``.  Under ``st.seq_axis``
    (``_sp_axis``: the rows split over the layout's loss axes, those of the
    GSPMD step) the residual stream holds the member's rows of the
    sequence between the sublayers and is gathered before the final norm,
    whose consumer, the loss, every member computes alike."""
    check_trainable(arch, st)
    B, Sq = tokens.shape
    fsdp = layout.fsdp if layout is not None else None
    token_axes = layout.loss_axes if layout is not None else ()
    sp = _sp_axis(st, layout, Sq, token_axes)
    x = _embed(params, tokens, st, layout, sp)
    if arch.positional == "learned":
        x = x + _positions(params, Sq, x.dtype, layout, sp)
    positions = torch.arange(Sq, device=tokens.device)[None, :].expand(B, Sq)
    enc_out = _encoder_output(arch, params, frames, st, layout, train=True)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    g = group_size(arch)
    layers = [_unstack(params["blocks"][f"l{off}"]) for off in range(g)]
    specs = [_stacked_specs(layout, "blocks", f"l{off}") for off in range(g)]
    for gi in range(n_groups(arch)):
        for off in range(g):
            lp = layers[off][gi]

            def layer(x_, enc_, lp=lp, off=off):  # (x, aux): the cache is dropped
                lp_ = _gather_fsdp(lp, specs[off], fsdp)
                return _apply_layer(arch, lp_, x_, positions, st, off,
                                    specs=specs[off], token_axes=token_axes,
                                    enc_out=enc_, sp_axis=sp)[:2]

            x, a = _remat(st, layer, x, enc_out)
            if a is not None:
                aux = aux + a
    # final_norm is never split; its input is the whole sequence
    x = prims.gather_replicated(x, sp, 1)
    return L.apply_norm(arch, params["final_norm"], x), aux


def _ce_chunk(hc: torch.Tensor, yc: torch.Tensor, head: torch.Tensor):
    logits = (hc @ head.to(hc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc.clamp_min(0)[..., None])[..., 0]
    valid = (yc >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _ce_chunk_vocab(hc: torch.Tensor, yc: torch.Tensor, head: torch.Tensor,
                    axis: str):
    """:func:`_ce_chunk` with ``head`` this member's vocab columns: the
    max, the sum of exponentials and the target logit (which lies on one
    member; the others mask it) are taken over the members, so that no
    member holds the whole (B, c, vocab) logits."""
    logits = (prims.to_parallel(hc, axis) @ head.to(hc.dtype)).float()
    Vl = logits.shape[-1]
    m = prims.pmax(logits.detach().amax(dim=-1), axis)
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    lse = m + torch.log(prims.psum_replicated(se, axis))
    local = yc - prims.axis_rank(axis) * Vl
    inside = (local >= 0) & (local < Vl)
    gold = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = prims.psum_replicated(torch.where(inside, gold, 0.0), axis)
    valid = (yc >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def ce_loss_chunked(arch: ArchConfig, params: Params, hidden: torch.Tensor,
                    labels: torch.Tensor, st: ModelSettings,
                    layout=None) -> torch.Tensor:
    """Mean token cross-entropy, chunked over the sequence so the
    (B, S, V) logits never materialize: each chunk's logits are recomputed
    in the backward (``jax.checkpoint`` in the JAX package).  Under a
    vocab-sharded layout each member computes its vocab columns' logits
    (:func:`_ce_chunk_vocab`); with ``layout.loss_axes`` the token count
    is the whole batch's, summed over those axes, so that the members'
    losses add up to the batch mean."""
    B, Sq, d = hidden.shape
    chunk = min(st.loss_chunk, Sq)
    if Sq % chunk:
        raise ValueError(f"seq {Sq} is not a multiple of loss_chunk {chunk}")
    head, vocab = _head(arch, params, layout)
    vocab = vocab if vocab is not None and prims.axis_size(vocab) > 1 else None
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, Sq, chunk):
        args = (hidden[:, c:c + chunk], labels[:, c:c + chunk], head)
        if vocab is None:
            t, n = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            t, n = checkpoint(_ce_chunk_vocab, *args, vocab, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    if layout is not None and layout.loss_axes:
        cnt = prims.psum(cnt, layout.loss_axes)
    return tot / torch.clamp_min(cnt, 1.0)


def train_loss(arch: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
               st: ModelSettings, layout=None) -> torch.Tensor:
    """Mean token cross-entropy, plus 0.01 x the MoE aux loss a MoE layer
    (the JAX package's weighting).  With ``layout.loss_axes`` this is the
    member's share of the batch's loss: its tokens' part of the mean, and
    the batch's aux loss (the same on every member) over the members."""
    hidden, aux = forward_train(arch, params, batch["tokens"], st, layout,
                                frames=batch.get("frames"))
    loss = ce_loss_chunked(arch, params, hidden, batch["labels"], st, layout)
    if arch.moe is not None:
        n = (math.prod(prims.axis_size(a) for a in layout.loss_axes)
             if layout is not None else 1)
        loss = loss + 0.01 * aux / max(len(arch.moe_layer_ids()), 1) / n
    return loss


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def init_cache(arch: ArchConfig, batch: int, max_seq: int, st: ModelSettings,
               device, n_frames: Optional[int] = None) -> Params:
    """Zeroed cache, stacked over groups, for each within-group offset
    ``l{off}``: {'k','v': (G,B,S,KV,hd)} for attention layers, with
    {'xk','xv': (G,B,F,KV,hd)} for cross attention (F ``n_frames``, or the
    config's frame count when None); {'tshift','cshift': (G,B,d) in the compute
    dtype, 'wkv': (G,B,H,hd,hd) fp32} for RWKV; {'conv': (G,B,d_conv-1,di)
    in the compute dtype, 'ssm': (G,B,di,ds) fp32} for Mamba (``max_seq``
    is used by attention only)."""
    G, dt = n_groups(arch), st.cdt()

    def zeros(shape, dtype=dt):
        return torch.zeros((G, batch) + shape, dtype=dtype, device=device)

    def layer_cache(off: int) -> Params:
        kind = layer_kind(arch, off)
        if kind == "rwkv":
            hs = arch.rwkv.head_size
            return {"tshift": zeros((arch.d_model,)),
                    "wkv": zeros((arch.d_model // hs, hs, hs), torch.float32),
                    "cshift": zeros((arch.d_model,))}
        if kind == "mamba":
            m = arch.mamba
            di = m.expand * arch.d_model
            return {"conv": zeros((m.d_conv - 1, di)),
                    "ssm": zeros((di, m.d_state), torch.float32)}
        kv = (arch.n_kv_heads, arch.resolved_head_dim)
        c = {"k": zeros((max_seq,) + kv), "v": zeros((max_seq,) + kv)}
        if arch.is_encdec:
            frames = (n_frames or arch.encoder.n_frames,) + kv
            c.update(xk=zeros(frames), xv=zeros(frames))
        return c

    return {f"l{off}": layer_cache(off) for off in range(group_size(arch))}


def decode_step(arch: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int, st: ModelSettings,
                layout=None, token_axes: Tuple[str, ...] = (),
                seq_axis: Optional[str] = None, xseq_axis: Optional[str] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) integer; pos: tokens already in the
    cache.  Writes the new kv at ``pos`` (or the new recurrent states) in
    place and returns (logits (B, V) fp32, cache).  Cross attention reads
    the cache's ``xk``/``xv`` and leaves them as they are.  With a
    ``layout``: as :func:`forward`, the cache this member's blocks under
    ``sharding.cache_specs``, its attention sequence split over
    ``seq_axis`` and its cross-attention frames over ``xseq_axis`` when
    those are not None."""
    pos = int(pos)
    B = tokens.shape[0]
    x = _embed(params, tokens, st, layout)
    if arch.positional == "learned":
        # row ``pos``, clamped into the table as lax.dynamic_slice clamps it
        pe = _positions_table(params, layout)
        x = x + pe[min(pos, pe.shape[0] - 1)].to(x.dtype)
    positions = torch.full((B, 1), pos, device=tokens.device)
    fsdp = layout.fsdp if layout is not None else None
    g = group_size(arch)
    specs = [_stacked_specs(layout, "blocks", f"l{off}") for off in range(g)]
    for gi in range(n_groups(arch)):
        for off in range(g):
            lp = _layer_params(params, off, gi, specs[off], fsdp)
            lc = _tree_map(lambda a: a[gi], cache[f"l{off}"])
            x, _, _ = _apply_layer(arch, lp, x, positions, st, off, lc, pos=pos,
                                   specs=specs[off], token_axes=token_axes,
                                   seq_axis=seq_axis, xseq_axis=xseq_axis)
    x = L.apply_norm(arch, params["final_norm"], x)
    return logits_from_hidden(arch, params, x, layout)[:, 0], cache


def prefill(arch: ArchConfig, params: Params, tokens: torch.Tensor,
            st: ModelSettings, frames: Optional[torch.Tensor] = None,
            layout=None, token_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill forward: returns (last-position logits (B, V), cache); with
    a ``layout`` as :func:`forward`."""
    hidden, cache = forward(arch, params, tokens, st, frames, layout, token_axes)
    return logits_from_hidden(arch, params, hidden[:, -1:], layout)[:, 0], cache
