"""Model primitives: norms, RoPE and sinusoidal positions, attention, MLP
and the mixture-of-experts layer — ``repro.models.layers`` in PyTorch.

Parameters are nested dicts of tensors, as in the JAX package: every layer
has an ``init_*`` that returns them and an ``apply`` function over them.
Attention is GQA-aware; ``attend`` has two implementations here:

  * ``masked`` — chunked online-softmax attention in plain PyTorch (the
                 JAX package's default path),
  * ``kernel`` — the hand-written CUDA flash-attention kernel
                 (``kernels/flash_attention``); the twin of the JAX
                 package's ``pallas``.  On CPU tensors it runs the kernel's
                 plain version.

and ``tri`` (the static triangular decomposition of causal attention)
is the JAX package's, in plain PyTorch.

The MoE layer (``apply_moe``) is the JAX package's capacity-based
gather/scatter dispatch: its expert products are plain batched matmuls,
and a planned dispatch schedule is executed as the same slice/concat
walk, with no collective.  Where the reference scatter-adds the experts'
outputs back to their tokens, the port gathers each token's k slots and
sums them in one reduction over k, so that the layer and its backward
repeat bit for bit on the card.  Under a model axis the experts split
over it (``dispatch_spec``): every member routes its tokens alike, runs
its own experts' slabs, and the members' combined outputs are summed.

Tensor parallelism.  The functions here take this member's blocks of the
leaves; where a caller splits heads, d_ff, experts or the vocab over a
mesh axis it names that axis, and the collectives of ``core.prims`` that
carry gradients (``to_parallel``, ``psum_replicated``) go where GSPMD
puts them for the JAX package.

Products of mixed float dtypes (``mm``, ``einsum``) promote as jnp does:
with bf16 parameters and an fp32 compute dtype, the bf16 weight is cast
up, exactly, where torch would raise on the mixed matmul.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prims

Params = Dict[str, Any]


def _promoted(a: torch.Tensor, b: torch.Tensor):
    if a.dtype == b.dtype:  # no op on the host where nothing is promoted
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (jnp's rule)."""
    a, b = _promoted(a, b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands in their promoted dtype."""
    return torch.einsum(eq, *_promoted(a, b))

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)  # in place: one fp32 copy at a time


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 vocab_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None) -> torch.Tensor:
    """``table[tokens]``; with ``vocab_axis`` the table is this member's
    rows of the vocab, the lookup reads only those (the others give
    zeros, and their gradient is zero) and the members' rows are summed:
    every token's row comes from the one member that holds it.  With
    ``seq_axis`` (the same axis as a split vocab) each member keeps its
    rows of the sequence (dim 1 of ``tokens``): the sum is a
    reduce-scatter (``prims.scatter_sum``), and a whole table's lookup is
    cut (``prims.split_replicated``)."""
    if vocab_axis is None or prims.axis_size(vocab_axis) == 1:
        return prims.split_replicated(table[tokens], seq_axis, 1)
    n = table.shape[0]
    local = tokens - prims.axis_rank(vocab_axis) * n
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], table[local.clamp(0, n - 1)], 0.0)
    if seq_axis is None:
        return prims.psum_replicated(rows, vocab_axis)
    if seq_axis != vocab_axis:
        raise ValueError(f"the sequence splits over {seq_axis!r}, the vocab "
                         f"over {vocab_axis!r}: one axis is ported")
    return prims.scatter_sum(rows, vocab_axis, 1)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(arch: ArchConfig, shape, dtype, device) -> Params:
    """``shape`` is the leading stacked dims plus the normalized dim."""
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if arch.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(arch: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if arch.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + arch.norm_eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + arch.norm_eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """qk-norm: rmsnorm over head_dim."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary / positional embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """The (n, d) fp32 table of the encoder's fixed positions: sin on the
    even columns, cos on the odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(arch: ArchConfig, gen: torch.Generator, lead: Tuple[int, ...],
                   dtype, device) -> Params:
    """``lead`` is the stacked-group prefix of every leaf's shape."""
    d, H, KV, hd = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    p = {
        "wq": dense_init(gen, lead + (d, H, hd), d, dtype, device),
        "wk": dense_init(gen, lead + (d, KV, hd), d, dtype, device),
        "wv": dense_init(gen, lead + (d, KV, hd), d, dtype, device),
        "wo": dense_init(gen, lead + (H, hd, d), H * hd, dtype, device),
    }
    if arch.qkv_bias:
        p["bq"] = torch.zeros(lead + (H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (KV, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (KV, hd), dtype=dtype, device=device)
    if arch.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
    return p


def _attn_rect_chunked(q, k, v, *, q_chunk: int, kv_chunk: int, scale: float,
                       mask: Optional[str] = None):
    """Rectangular attention, returns softmax partials (m, l, o).

    q: (B, Sq, KV, G, hd) grouped-query layout; k/v: (B, Sk, KV, hd).
    Memory is bounded by q_chunk x kv_chunk.  Online softmax in fp32.
    """
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    assert Sq % q_chunk == 0 and Sk % kv_chunk == 0
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    ms, ls, os_ = [], [], []
    for i in range(Sq // q_chunk):
        qi = qf[:, i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((B, KV, G, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((B, KV, G, q_chunk), device=dev)
        o = torch.zeros((B, KV, G, q_chunk, hd), device=dev)
        for j in range(Sk // kv_chunk):
            kj = kf[:, j * kv_chunk:(j + 1) * kv_chunk]
            vj = vf[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kj) * scale
            if mask == "causal":
                qpos = i * q_chunk + torch.arange(q_chunk, device=dev)
                kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
                s = s.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
            mnew = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            mnew_safe = torch.where(torch.isfinite(mnew), mnew, 0.0)
            p = torch.exp(s - mnew_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - mnew_safe), 0.0)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vj)
            m = mnew
        ms.append(m)
        ls.append(l)
        os_.append(o)
    return torch.cat(ms, dim=-1), torch.cat(ls, dim=-1), torch.cat(os_, dim=-2)


def _merge_softmax(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partials (m: max, l: sumexp, o: weighted
    sum)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def _causal_tri(q, k, v, *, block: int, scale: float, q_chunk: int,
                kv_chunk: int):
    """Static triangular decomposition of causal attention.

    Splits the sequence in halves: the second half's queries attend the
    first half's keys as a dense rectangle (no masked waste), and both
    halves recurse.  Leaf blocks (<= block) run dense-masked.  A diagonal
    block's queries and keys start at the same position, so the relative
    causal mask of ``_attn_rect_chunked`` is the reference's offset one."""
    S = q.shape[1]
    if S <= block:
        return _attn_rect_chunked(q, k, v, q_chunk=S, kv_chunk=S, scale=scale,
                                  mask="causal")
    h = S // 2
    q1, q2 = q[:, :h], q[:, h:]
    k1, k2 = k[:, :h], k[:, h:]
    v1, v2 = v[:, :h], v[:, h:]
    m1, l1, o1 = _causal_tri(q1, k1, v1, block=block, scale=scale,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
    mr, lr, or_ = _attn_rect_chunked(q2, k1, v1, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk, scale=scale)
    m2, l2, o2 = _causal_tri(q2, k2, v2, block=block, scale=scale,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
    m2, l2, o2 = _merge_softmax(m2, l2, o2, mr, lr, or_)
    return (torch.cat([m1, m2], dim=-1), torch.cat([l1, l2], dim=-1),
            torch.cat([o1, o2], dim=-2))


def _finalize(m, l, o, dtype):
    l = torch.clamp(l, min=1e-30)
    out = o / l[..., None]
    # (B, KV, G, S, hd) -> (B, S, KV, G, hd)
    return out.movedim(3, 1).to(dtype)


def _fit(n: int, want: int) -> int:
    c = min(want, n)
    while c > 1 and n % c != 0:
        c -= 1
    return max(c, 1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
           impl: str = "masked", block: int = 1024, q_chunk: int = 1024,
           kv_chunk: int = 1024, gqa_repeat: bool = False) -> torch.Tensor:
    """Multi-head attention core.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); H = KV * G.
    Returns (B, Sq, H, hd).  ``impl="kernel"`` is the twin of the JAX
    package's ``impl="pallas"``; ``impl="tri"`` decomposes causal
    self-attention whose length is a multiple of ``block`` above it, and
    runs ``masked`` otherwise, as the reference does.  ``gqa_repeat``:
    k/v repeated per query head (KV = H, G = 1) before the core, as the
    reference lays them out when the kv heads do not split over its model
    axis; the same function.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if gqa_repeat and G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        KV, G = H, 1
    qg = q.reshape(B, Sq, KV, G, hd)
    if impl == "kernel":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(qg, k, v, causal=causal).reshape(B, Sq, H, hd)
    if impl not in ("masked", "tri"):
        raise ValueError(f"unknown attention impl {impl!r} (masked | tri | "
                         f"kernel; 'kernel' is the twin of the JAX 'pallas')")
    scale = 1.0 / math.sqrt(hd)
    if causal and impl == "tri" and Sq == k.shape[1] and Sq > block \
            and Sq % block == 0:
        m, l, o = _causal_tri(qg, k, v, block=block, scale=scale,
                              q_chunk=_fit(Sq, q_chunk),
                              kv_chunk=_fit(Sq, kv_chunk))
    else:
        mask = "causal" if (causal and Sq == k.shape[1]) else None
        m, l, o = _attn_rect_chunked(qg, k, v, q_chunk=_fit(Sq, q_chunk),
                                     kv_chunk=_fit(k.shape[1], kv_chunk),
                                     scale=scale, mask=mask)
    return _finalize(m, l, o, q.dtype).reshape(B, Sq, H, hd)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: torch.Tensor, seq_axis: Optional[str] = None) -> torch.Tensor:
    """Single-token decode attention over a (B, S_max, KV, hd) cache.

    ``pos`` (B,) integer: number of valid cache entries (the new token's
    kv must already be written).  Masked softmax over S_max, in fp32.

    ``seq_axis``: the cache holds this member's rows ``[r S, (r+1) S)`` of
    the sequence (S its local length, r its index on the axis), as
    ``sharding.cache_specs`` splits a long cache.  The softmax is then
    taken in two stages over the members: the global max (``prims.pmax``),
    then the sums of exp(s - max) and of their products with v
    (``prims.psum``), divided.  A member whose rows all lie past ``pos``
    adds zeros: it subtracts the global max, never its own -inf.
    """
    B, Sq, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache.float()) * scale
    S = k_cache.shape[1]
    split = seq_axis is not None and prims.axis_size(seq_axis) > 1
    start = prims.axis_rank(seq_axis) * S if split else 0
    rows = start + torch.arange(S, device=q.device)
    valid = rows[None, :] < pos[:, None]  # (B, S)
    s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    if not split:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bkgqh", p, v_cache.float())
    else:
        m = prims.pmax(s.amax(dim=-1, keepdim=True), seq_axis)
        e = torch.exp(s - m)
        den = prims.psum(e.sum(dim=-1, keepdim=True), seq_axis)
        o = prims.psum(torch.einsum("bkgqs,bskh->bkgqh", e, v_cache.float()),
                       seq_axis) / den
    return o.movedim(3, 1).to(q.dtype).reshape(B, Sq, H, hd)


def attention_qkv(arch: ArchConfig, p: Params, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to q, k, v with bias / qk-norm / rope per the arch."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if arch.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if arch.qk_norm:
        q = rms_head_norm(q, p["q_norm"], arch.norm_eps)
        k = rms_head_norm(k, p["k_norm"], arch.norm_eps)
    if arch.positional == "rope":
        q = apply_rope(q, positions, arch.rope_theta)
        k = apply_rope(k, positions, arch.rope_theta)
    return q, k, v


def attention_out(p: Params, o: torch.Tensor) -> torch.Tensor:
    return einsum("bshk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def init_mlp(arch: ArchConfig, gen: torch.Generator, lead: Tuple[int, ...],
             dtype, device, d_ff: Optional[int] = None) -> Params:
    d, f = arch.d_model, d_ff or arch.d_ff
    p = {"wi": dense_init(gen, lead + (d, f), d, dtype, device),
         "wo": dense_init(gen, lead + (f, d), f, dtype, device)}
    if arch.glu:
        p["wg"] = dense_init(gen, lead + (d, f), d, dtype, device)
    return p


def apply_mlp(arch: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _act(arch.activation, mm(x, p["wi"]))
    if arch.glu:
        h = h * mm(x, p["wg"])
    return mm(h, p["wo"])


def apply_mlp_tp(arch: ArchConfig, p: Params, x: torch.Tensor,
                 ff_axis: Optional[str],
                 seq_axis: Optional[str] = None) -> torch.Tensor:
    """:func:`apply_mlp` on this member's d_ff columns of ``wi``/``wg``
    and rows of ``wo`` (column- then row-parallel), the members' outputs
    summed over ``ff_axis``; with no axis, the whole MLP.

    With ``seq_axis`` (sequence parallelism; ``x`` holds this member's
    rows of the sequence, dim 1): a split MLP (``ff_axis`` the same axis)
    reads the gathered sequence (``gather_on_use``) and its outputs are
    summed and scattered back (``scatter_sum``); a whole MLP runs on the
    member's rows alone, each weight entering through ``to_parallel`` so
    that its gradient sums the members' rows."""
    if seq_axis is None:
        return prims.psum_replicated(
            apply_mlp(arch, p, prims.to_parallel(x, ff_axis)), ff_axis)
    if ff_axis is None:
        return apply_mlp(arch, {k: prims.to_parallel(w, seq_axis)
                                for k, w in p.items()}, x)
    if ff_axis != seq_axis:
        raise ValueError(f"the sequence splits over {seq_axis!r}, d_ff over "
                         f"{ff_axis!r}: one axis is ported")
    return prims.scatter_sum(
        apply_mlp(arch, p, prims.gather_on_use(x, seq_axis, 1)), seq_axis, 1)


def sublayer_out(out: torch.Tensor, split: Optional[str],
                 sp: Optional[str]) -> torch.Tensor:
    """A sublayer's output onto the residual stream: the members' partial
    outputs of a sublayer split over ``split`` summed
    (``psum_replicated``), under a sequence split ``sp`` summed and
    scattered onto the members' rows (``scatter_sum``, the Megatron-SP
    scatter point); a whole sublayer's output, alike on every member, cut
    to the member's rows (``split_replicated``)."""
    if sp is None:
        return prims.psum_replicated(out, split)
    return (prims.scatter_sum(out, sp, 1) if split
            else prims.split_replicated(out, sp, 1))


# ---------------------------------------------------------------------------
# MoE (capacity-based gather/scatter dispatch)
# ---------------------------------------------------------------------------

# When a list, every ``_moe_dispatch`` appends its count of dropped (token,
# k) slots per group, a (G,) tensor (no host sync); None records nothing.
DROP_LOG: Optional[list] = None


def moe_capacity(tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Per-group expert capacity ``C`` — the formula the dispatch pads to,
    shared with the dispatch planner (``moe_dispatch_schedule``) so the
    planned per-expert flow sizes are exactly what ``_moe_dispatch``
    moves."""
    C = int(max(8, math.ceil(tokens * top_k / num_experts
                             * capacity_factor)))
    return min(C, tokens)


def moe_expert_capacities(counts, tokens: int,
                          capacity_factor: float) -> Tuple[int, ...]:
    """Per-expert twin of :func:`moe_capacity`: expert ``e``'s slab sized
    from its measured routed-token count instead of the uniform
    ``tokens * top_k / num_experts`` prior (to which it reduces under
    uniform counts)."""
    return tuple(min(int(max(8, math.ceil(float(c) * capacity_factor))),
                     tokens) for c in counts)


def moe_dispatch_schedule(arch: ArchConfig, tokens_per_member: int,
                          planner, groups: int = 1, router_logits=None):
    """Planner-searched all-to-all schedule for the MoE dispatch: the
    ``(G, E, C, d)`` dispatch buffer with the experts spread over the ``n``
    members of the planner's DP domain, member *r* owning ``E // n`` expert
    slabs, so row *r* of the exchange is ``groups * (E // n) * C * d``
    elements.  ``planner`` is a :class:`repro_torch.core.planner.Planner`;
    the result is its ``plan_all_to_all`` schedule, which
    ``apply_moe(dispatch_schedule=...)`` executes and checks for capacity
    drift.

    ``router_logits`` (optional, ``(tokens_per_member, E)`` or
    ``(G, tokens_per_group, E)``, numpy or a CPU tensor): measured router
    logits.  Each expert's slab is then sized from its own routed-token
    count (:func:`moe_expert_capacities`, max over groups), the buffer pads
    to ``C_exec = max_e C_e``, and the schedule carries per-member
    ``dest_sizes``.  ``None`` keeps the uniform prior."""
    moe = arch.moe
    G = max(groups, 1)
    tokens_per_group = tokens_per_member // G
    n = planner.domain_size
    if n > 1 and moe.num_experts % n != 0:
        raise ValueError(
            f"num_experts={moe.num_experts} does not divide over the "
            f"{n}-member DP domain — expert parallelism needs "
            f"E % members == 0 to plan per-expert flows")
    experts_per_member = max(moe.num_experts // max(n, 1), 1)
    if router_logits is None:
        C = moe_capacity(tokens_per_group, moe.top_k, moe.num_experts,
                         moe.capacity_factor)
        shape = (n, G * experts_per_member * C * arch.d_model)
        return planner.plan_all_to_all(shape)
    import numpy as np
    from repro_torch.core.cost_model import dtype_itemsize
    lg = np.asarray(router_logits, dtype=np.float32)
    if lg.ndim == 2:
        lg = lg.reshape(G, tokens_per_group, -1)
    if lg.shape != (G, tokens_per_group, moe.num_experts):
        raise ValueError(
            f"router_logits shape {np.asarray(router_logits).shape} does "
            f"not cover ({tokens_per_member}, {moe.num_experts}) tokens x "
            f"experts in {G} group(s)")
    # per-group top-k routing counts (the top-k of the logits is the top-k
    # of the softmaxed probabilities the layer routes on)
    k = moe.top_k
    top = np.argpartition(-lg, k - 1, axis=-1)[..., :k]  # (G, Tl, k)
    caps = np.zeros(moe.num_experts, dtype=np.int64)
    for g in range(G):
        cnt = np.bincount(top[g].ravel(), minlength=moe.num_experts)
        caps = np.maximum(caps, moe_expert_capacities(
            cnt, tokens_per_group, moe.capacity_factor))
    c_exec = int(caps.max())
    shape = (n, G * experts_per_member * c_exec * arch.d_model)
    esz = dtype_itemsize("float32")
    dest_sizes = [
        float(G * int(caps[r * experts_per_member:
                           (r + 1) * experts_per_member].sum())
              * arch.d_model * esz)
        for r in range(n)]
    return planner.plan_all_to_all(shape, dest_sizes=dest_sizes)


def init_moe(arch: ArchConfig, gen: torch.Generator, lead: Tuple[int, ...],
             dtype, device) -> Params:
    """The router is fp32 whatever ``dtype`` is, as in the JAX package."""
    moe = arch.moe
    d, f, E = arch.d_model, moe.expert_d_ff, moe.num_experts
    p = {"router": dense_init(gen, lead + (d, E), d, torch.float32, device),
         "we_in": dense_init(gen, lead + (E, d, f), d, dtype, device),
         "we_out": dense_init(gen, lead + (E, f, d), f, dtype, device)}
    if arch.glu:
        p["we_gate"] = dense_init(gen, lead + (E, d, f), d, dtype, device)
    if moe.num_shared_experts:
        p["shared"] = init_mlp(arch, gen, lead, dtype, device,
                               d_ff=f * moe.num_shared_experts)
    return p


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: values descending, ties to the
    lowest index (a stable descending sort; ``torch.topk`` leaves the order
    of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(arch: ArchConfig, p: Params, x: torch.Tensor, groups: int = 1,
              dispatch_spec=None, dispatch_schedule=None,
              shared_axis: Optional[str] = None,
              token_axes: Tuple[str, ...] = (),
              seq_axis: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_load_balance_loss).  x: (B, S, d).

    ``groups`` > 1 splits the tokens into independent dispatch groups
    (routing, cumsum and capacity per group; the aux loss is the mean of
    the groups'), run as one batched group dim where the JAX package
    vmaps.  The groups are contiguous runs of the batch's token order
    (``groups`` of them where they divide its count, else one); with
    ``token_axes`` of the global batch, so a group may hold several
    members' rows, lie inside one member's, or straddle two members.

    ``dispatch_spec``: (dp, tp), the JAX package's placement of the
    dispatched (G, E, C, d) buffers: groups over ``dp``, experts over
    ``tp``.  Here each DP member already holds its own rows, so ``dp``
    is where they lie; ``tp`` names the mesh axis the experts split over:
    ``we_in``/``we_gate``/``we_out`` are then this member's ``E / n``
    experts (``n`` members of ``tp``), the tokens route alike on every
    member (the router stays replicated and fp32), each member runs its
    experts' slabs only, and the members' outputs are summed.  Without a
    ``tp`` the leaves must hold every expert.  ``shared_axis`` names the
    axis that splits the shared experts' d_ff (as a dense MLP's), if any.

    ``token_axes``: DP axes whose members' rows form one batch, in
    member order (the GSPMD step's: the JAX package's ``jax.jit`` sees the
    global batch there), split into its dispatch groups: each group's
    capacity is the group's, a slot's place in its expert's slab counts
    the slots that earlier tokens of its group, on this member or earlier
    ones, send to that expert, and the aux loss is each group's over its
    tokens (:func:`_moe_dispatch`).  Each member still gathers and
    computes its own rows' slots only.

    ``seq_axis`` (the sequence split): ``x`` holds this member's rows of
    the sequence (dim 1); they are gathered once (``gather_replicated``:
    the router's gradient is whole on every member, the experts' path
    enters through ``to_parallel``), the gathered tokens are routed, at the
    gathered token count's capacity, and the output is scattered back onto
    the member's rows (:func:`sublayer_out`); the shared experts take
    :func:`apply_mlp_tp`'s split path.  The aux loss, taken on the
    gathered tokens, is the same on every member of the axis.

    ``dispatch_schedule``: the planner's ``kind="all_to_all"`` schedule for
    this layer's dispatch (:func:`moe_dispatch_schedule`), planned for the
    whole batch's (G, E, C, d) buffer.  It is executed: the dispatch buffer
    walks the plan's slow-leg chunk split, issue order and reassembly
    (:func:`_execute_dispatch`), bitwise the unscheduled dispatch; with
    the experts split a member walks its experts' slabs only, and under
    ``token_axes`` its share of each group's slab.  A skew-planned
    schedule (per-member ``dest_sizes``) carries the capacity ``C_exec``,
    at which the layer dispatches.  A schedule whose payload does not
    match the dispatch buffer (capacity drift) raises."""
    moe = arch.moe
    x_rows = x
    x = prims.gather_replicated(x, seq_axis, 1)
    expert_axis = dispatch_spec[1] if dispatch_spec is not None else None
    n_ex = prims.axis_size(expert_axis) if expert_axis is not None else 1
    El = p["we_in"].shape[-3]
    if El * n_ex != moe.num_experts:
        raise ValueError(
            f"{El} experts on each of {n_ex} member(s) of "
            f"{expert_axis or 'no axis'}: the layer has {moe.num_experts}")
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    token_axes = tuple(a for a in token_axes if prims.axis_size(a) > 1)
    T_all = T * math.prod(prims.axis_size(a) for a in token_axes)
    G = groups if (groups > 1 and T_all % groups == 0) else 1
    # the member's tokens in runs of c that each lie in one group: its
    # whole groups, or its part of one (c = T / G and T without token_axes)
    c = math.gcd(T, T_all // G)
    sched_capacity = None
    if dispatch_schedule is not None:
        if dispatch_schedule.kind != "all_to_all":
            raise ValueError(
                f"dispatch_schedule must be an all_to_all schedule, got "
                f"kind={dispatch_schedule.kind!r}")
        n = int(dispatch_schedule.shape[0])
        if n > 1 and moe.num_experts % n != 0:
            raise ValueError(
                f"num_experts={moe.num_experts} does not divide over the "
                f"schedule's {n}-member domain — per-expert flows need "
                f"E % members == 0")
        epm = max(moe.num_experts // max(n, 1), 1)
        skewed = any(getattr(leg, "dest_sizes", None) is not None
                     for leg in dispatch_schedule.legs)
        if skewed:
            # skew-planned: the schedule owns the capacity (C_exec = max_e
            # C_e from measured routing); recover it from the payload
            denom = n * G * epm * d
            c_exec = dispatch_schedule.numel // denom
            if c_exec < 1 or c_exec * denom != dispatch_schedule.numel:
                raise ValueError(
                    f"dispatch_schedule planned for a different dispatch "
                    f"buffer: schedule carries {dispatch_schedule.numel} "
                    f"elements, not divisible into (G={G}, "
                    f"E={moe.num_experts}, d={d}, members={n}) expert "
                    f"slabs — rebuild with moe_dispatch_schedule()")
            sched_capacity = int(c_exec)
        else:
            C = moe_capacity(T_all // G, moe.top_k, moe.num_experts,
                             moe.capacity_factor)
            want = n * G * epm * C * d
            if dispatch_schedule.numel != want:
                raise ValueError(
                    f"dispatch_schedule planned for a different dispatch "
                    f"buffer: schedule carries {dispatch_schedule.numel} "
                    f"elements, this layer dispatches {want} "
                    f"(G={G}, E={moe.num_experts}, C={C}, d={d}, "
                    f"members={n}) — rebuild with moe_dispatch_schedule()")
    y, aux = _moe_dispatch(arch, p, xt.reshape(T // c, c, d),
                           capacity=sched_capacity,
                           dispatch_schedule=dispatch_schedule,
                           expert_axis=expert_axis if n_ex > 1 else None,
                           token_axes=token_axes, groups=G)
    y = sublayer_out(y.reshape(B, S, d), expert_axis if n_ex > 1 else None,
                     seq_axis)
    if moe.num_shared_experts:  # d_ff read from the leaves
        y = y + apply_mlp_tp(arch, p["shared"], x_rows, shared_axis,
                             seq_axis=seq_axis)
    return y, aux.mean()


def _execute_dispatch(schedule, xe: torch.Tensor, e0: int = 0,
                      E: Optional[int] = None) -> torch.Tensor:
    """Run the (G, El, C, d) dispatch buffer of experts ``[e0, e0 + El)``
    of the ``E`` (all of them by default) through ``schedule``'s slow-leg
    walk: the whole buffer's member-major view (schedule member r's row
    holding experts ``[r E/n, (r+1) E/n)``) split at the plan's chunk
    boundaries, sub-flows taken in the plan's issue order, each cut to
    the part of it this buffer holds, then reassembled by row and chunk
    index, as ``collectives.lower_all_to_all``'s slow stage does.  The walk
    is a pure slice/concat identity, so the output is bitwise ``xe``.

    Chunk bounds are proportional (``(j * cols) // chunks``) so a buffer
    that does not divide evenly still reassembles exactly."""
    G, El, C, d = xe.shape
    E = E or El
    n = int(schedule.shape[0])
    slow = schedule.slow_legs
    if n <= 1 or E % n != 0 or not slow:
        return xe
    # the whole buffer's member-major rows, flat: expert e's (G, C, d) at
    # e G C d; this buffer's span [lo, lo + numel) of it
    flat = xe.permute(1, 0, 2, 3).reshape(-1)
    lo, cols = e0 * G * C * d, E // n * G * C * d
    k = len(slow)
    bounds = [(j * cols) // k for j in range(k + 1)]
    pieces = {}
    for leg in slow:  # issue order; payload slice picked by index
        j = leg.index
        for r in range(n):
            a = max(r * cols + bounds[j], lo)
            b = min(r * cols + bounds[j + 1], lo + flat.numel())
            if a < b:
                pieces[(r, j)] = flat[a - lo:b - lo]
    flat = torch.cat([pieces[key] for key in sorted(pieces)])
    return flat.reshape(El, G, C, d).permute(1, 0, 2, 3)


def _slab_positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """For each (token, k) slot of each group (G, N), the number of earlier
    slots, in token-major then k order, routed to the same expert: its
    position in that expert's slab.  The JAX package counts them with a
    cumsum of the (G, N, E) one-hot; a stable sort by expert gives the same
    integers without scanning that tensor along N (that scan took 13 ms a
    deepseek-moe-16b layer at N = 49152 on an NVIDIA H100 80GB HBM3 at
    700 W, measured with ``launch/profile.py``)."""
    G, N = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    counts = torch.zeros((G, E), dtype=torch.long, device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(dim=1) - counts  # (G, E): the slab's first slot
    rank = torch.arange(N, device=flat_e.device).expand(G, N)
    in_slab = rank - torch.gather(starts, 1, torch.gather(flat_e, 1, order))
    return torch.empty_like(flat_e).scatter_(1, order, in_slab)


def _moe_dispatch(arch: ArchConfig, p: Params, xg: torch.Tensor,
                  capacity: Optional[int] = None, dispatch_schedule=None,
                  expert_axis: Optional[str] = None,
                  token_axes: Tuple[str, ...] = (), groups: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k dispatch on grouped (G, Tl, d) token slabs;
    returns (y (G, Tl, d), aux (groups,)).

    Every group routes on its own: an fp32 router (x cast up), softmax,
    top-k with ties to the lowest index, gates renormalised over the k and
    a Switch-style aux loss per group; then each (token, k) slot takes its
    position in its expert's slab by a cumsum in token-major, then k,
    order, slots at ``pos >= C`` are dropped, empty slots point at a zero
    sentinel row ``Tl``, and the (G, E, C, d) gather feeds three batched
    expert products.  Each token then gathers its k slots' outputs, gates
    them (a dropped slot weighs 0 and reads slot 0) and sums them over k
    in one reduction, where the reference scatter-adds the gated
    slots into the tokens: the same terms, summed in an order fixed by the
    shapes.  Both gathers' backwards are gathers and sums too
    (``_GatherRows``), so no step of the layer adds by atomics in an order
    the card may change.

    ``capacity`` overrides :func:`moe_capacity` with a planned ``C_exec``;
    ``dispatch_schedule`` routes each group's buffer through the planned
    chunk walk (:func:`_execute_dispatch`).

    With ``expert_axis`` this member holds experts ``[e0, e0 + El)`` of
    the ``E``: routing, positions and capacity are the whole layer's, the
    gather builds the (G, El, C, d) slabs of those experts only, a slot
    of another member's expert reads nothing here, and ``y`` is this
    member's part (:func:`apply_moe` sums the parts).  The tokens and the
    gates enter the experts' part through ``to_parallel``, so their
    gradients are the sum of every member's experts'; the router and the
    aux loss, computed alike on every member, are not summed.

    With ``token_axes`` the rows of every member of those axes are one
    batch, in row order (the axes slowest first), cut into ``groups``
    contiguous dispatch groups, and the G slabs of ``xg`` are this
    member's runs of tokens, each inside one group (the batch's chunks
    ``rank G .. rank G + G - 1``, member-major): C is a group's capacity;
    a slot's place in its expert's slab is its place among its run's
    slots plus the slots that the group's earlier runs, here or on
    earlier members, route to that expert (one sum of the (n, G, E)
    counts over the axes, then a running sum over the runs of each
    group), and a slot drops at a place >= C; each run's kept slots fill
    its slab at their places among its own slots, so the slab is C deep
    still.  Each group's aux loss is E * sum(me * ce) of that group's
    means: the runs' router sums summed over the axes (whose backward is
    a sum too, so that each member's router probabilities get the
    gradient of every member's use of the group's aux) and their top-1
    counts likewise.  Without ``token_axes`` the G slabs are the groups."""
    moe = arch.moe
    G, Tl, d = xg.shape
    E, k = moe.num_experts, moe.top_k
    El = p["we_in"].shape[0]
    e0 = prims.axis_rank(expert_axis) * El if expert_axis is not None else 0
    dev = xg.device

    logits = xg.float() @ p["router"]  # (G, Tl, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topk_idx = top_k(probs, k)  # (G, Tl, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style), one per group
    top1 = F.one_hot(topk_idx[..., 0], E).float()
    n_tok, rank = 1, 0  # members whose rows are one batch; this one's place
    for a in token_axes:
        n_tok, rank = n_tok * prims.axis_size(a), rank * prims.axis_size(a) + prims.axis_rank(a)
    Q = n_tok * G  # the batch's runs, member-major; each group holds runs_g
    runs_g = Q // groups if token_axes else 1
    Tg = Tl * runs_g  # tokens a group
    if token_axes:
        gid = (rank * G + torch.arange(G, device=dev)) // runs_g  # each run's group

        def by_group(t):  # (G, E) of the runs -> (groups, E)
            return t.new_zeros((groups,) + t.shape[1:]).index_add(0, gid, t)

        me = prims.psum_shared(by_group(probs.sum(dim=1)), token_axes) / Tg
        ce = prims.psum(by_group(top1.sum(dim=1)), token_axes) / Tg
    else:
        me = probs.mean(dim=1)  # (G, E)
        ce = top1.mean(dim=1)
    aux = E * (me * ce).sum(dim=-1)

    C = capacity if capacity is not None \
        else moe_capacity(Tg, k, E, moe.capacity_factor)

    flat_e = topk_idx.reshape(G, Tl * k)
    flat_g = prims.to_parallel(gate_vals.reshape(G, Tl * k), expert_axis)
    tok_id = torch.arange(Tl, device=dev).repeat_interleave(k).expand(G, -1)
    pos = _slab_positions(flat_e, E)  # (G, Tl*k), among this member's slots
    place = pos
    if token_axes:  # plus the slots of the group's earlier runs
        counts = torch.zeros((n_tok, G, E), dtype=torch.long, device=dev)
        counts[rank].scatter_add_(1, flat_e, torch.ones_like(flat_e))
        counts = prims.psum(counts, token_axes).reshape(Q, E)
        earlier = counts.cumsum(dim=0) - counts  # every earlier run's
        first = torch.arange(Q, device=dev) // runs_g * runs_g  # its group's
        before = (earlier - earlier[first])[rank * G:(rank + 1) * G]  # (G, E)
        place = pos + torch.gather(before, 1, flat_e)
    if DROP_LOG is not None:
        DROP_LOG.append((place >= C).sum(dim=1))

    # per-group token ids and (token, k) pair ids into (G, El, C) of this
    # member's experts; an overflowing slot (place >= C), or one of another
    # member's expert, goes to a dump column El*C that is cut off
    kept = (place < C) & (flat_e >= e0) & (flat_e < e0 + El)  # (G, Tl*k)
    slot = torch.where(kept, (flat_e - e0) * C + pos, El * C)
    dis = torch.full((G, El * C + 1), Tl, dtype=torch.long, device=dev)
    dis = dis.scatter_(1, slot, tok_id)[:, :El * C].reshape(G, El, C)
    g_off = torch.arange(G, device=dev)[:, None]
    # each pair's slot in the flat (G*El*C, d) buffer: slot 0 when dropped
    pair_slot = torch.where(kept, slot, 0) + g_off * (El * C)  # (G, Tl*k)

    def token_slots():  # each token's k slots; the sentinel row reads none
        pad = (0, 0, 0, 1)
        return (F.pad(pair_slot.reshape(G, Tl, k), pad).reshape(-1, k),
                F.pad(kept.reshape(G, Tl, k), pad).reshape(-1, k))

    def slot_pairs():  # each slot's one pair (none for an empty slot)
        pair_id = torch.arange(Tl * k, device=dev) + g_off * (Tl * k)
        inv = torch.zeros((G, El * C + 1), dtype=torch.long, device=dev)
        filled = torch.zeros((G, El * C + 1), dtype=torch.bool, device=dev)
        return (inv.scatter_(1, slot, pair_id)[:, :El * C].reshape(-1, 1),
                filled.scatter_(1, slot, kept)[:, :El * C].reshape(-1, 1))

    # group-global flat gather, the sentinel row Tl of each group zero; a
    # token row's gradient is the sum of its kept slots', the sentinel's 0
    xp = prims.to_parallel(xg, expert_axis)
    x_pad = torch.cat([xp, xp.new_zeros(G, 1, d)], dim=1)
    xf = x_pad.reshape(G * (Tl + 1), d)
    gidx = dis + (torch.arange(G, device=dev) * (Tl + 1))[:, None, None]
    xe = _GatherRows.apply(xf, gidx.reshape(-1), token_slots).reshape(G, El, C, d)
    if dispatch_schedule is not None:
        # the planned walk runs on each group's buffer, as under JAX's vmap
        xe = torch.cat([_execute_dispatch(dispatch_schedule, xe[g:g + 1], e0, E)
                        for g in range(G)])

    h = _act(arch.activation, einsum("gecd,edf->gecf", xe, p["we_in"]))
    if arch.glu:
        h = h * einsum("gecd,edf->gecf", xe, p["we_gate"])
    ye = einsum("gecf,efd->gecd", h, p["we_out"])  # (G, El, C, d)

    # combine: each token's k slot outputs, gated, summed over k in one
    # reduction; a slot's gradient is its one pair's (0 for an empty slot)
    rows = _GatherRows.apply(ye.reshape(G * El * C, d), pair_slot.reshape(-1),
                             slot_pairs)
    gate = torch.where(kept, flat_g, 0.0).to(ye.dtype)
    y = rows.reshape(G, Tl, k, d).mul(gate.reshape(G, Tl, k, 1)).sum(dim=2)
    return y, aux


class _GatherRows(torch.autograd.Function):
    """``src[index]`` (rows of a 2-d tensor) whose backward is a gather and
    a sum as well: row r of the gradient is the sum of ``grad[inverse[r,
    j]]`` over the j where ``keep[r, j]``, in one reduction over j.  The
    autograd of an index would scatter-add the gradient rows, on the card
    by atomics in no fixed order.  ``inverse_of()`` returns (inverse,
    keep): for each source row, the output rows that read it; it is built
    only when ``src`` needs a gradient."""

    @staticmethod
    def forward(ctx, src, index, inverse_of):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(*inverse_of())
        return src.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        inverse, keep = ctx.saved_tensors
        R, J = inverse.shape
        rows = grad.index_select(0, inverse.reshape(-1)).reshape(R, J, -1)
        return torch.where(keep[..., None], rows, 0.0).sum(dim=1), None, None
