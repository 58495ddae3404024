"""Model primitives: norms, RoPE, attention, MLP — the dense subset of
``repro.models.layers`` in PyTorch.

Parameters are nested dicts of tensors, as in the JAX package: every layer
has an ``init_*`` that returns them and an ``apply`` function over them.
Attention is GQA-aware; ``attend`` has two implementations here:

  * ``masked`` — chunked online-softmax attention in plain PyTorch (the
                 JAX package's default path),
  * ``kernel`` — the hand-written CUDA flash-attention kernel
                 (``kernels/flash_attention``); the twin of the JAX
                 package's ``pallas``.  On CPU tensors it runs the kernel's
                 plain version.

The JAX package's ``tri`` (static triangular decomposition) is not ported
yet and raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


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
# rotary embeddings
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
           impl: str = "masked", q_chunk: int = 1024,
           kv_chunk: int = 1024) -> torch.Tensor:
    """Multi-head attention core.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); H = KV * G.
    Returns (B, Sq, H, hd).  ``impl="kernel"`` is the twin of the JAX
    package's ``impl="pallas"``.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    if impl == "kernel":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(qg, k, v, causal=causal).reshape(B, Sq, H, hd)
    if impl == "tri":
        raise NotImplementedError(
            "attn_impl='tri' (static triangular decomposition) is not ported "
            "yet: ROADMAP.md queue 1, the dense-model training slice")
    if impl != "masked":
        raise ValueError(f"unknown attention impl {impl!r} (masked | kernel; "
                         f"'kernel' is the twin of the JAX 'pallas')")
    mask = "causal" if (causal and Sq == k.shape[1]) else None
    m, l, o = _attn_rect_chunked(qg, k, v, q_chunk=_fit(Sq, q_chunk),
                                 kv_chunk=_fit(k.shape[1], kv_chunk),
                                 scale=1.0 / math.sqrt(hd), mask=mask)
    return _finalize(m, l, o, q.dtype).reshape(B, Sq, H, hd)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention over a (B, S_max, KV, hd) cache.

    ``pos`` (B,) integer: number of valid cache entries (the new token's
    kv must already be written).  Masked softmax over S_max, in fp32.
    """
    B, Sq, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache.float()) * scale
    S = k_cache.shape[1]
    valid = torch.arange(S, device=q.device)[None, :] < pos[:, None]  # (B, S)
    s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v_cache.float())
    return o.movedim(3, 1).to(q.dtype).reshape(B, Sq, H, hd)


def attention_qkv(arch: ArchConfig, p: Params, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to q, k, v with bias / qk-norm / rope per the arch."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
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
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


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
    h = _act(arch.activation, x @ p["wi"])
    if arch.glu:
        h = h * (x @ p["wg"])
    return h @ p["wo"]
