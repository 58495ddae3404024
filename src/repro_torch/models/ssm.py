"""Attention-free sequence mixers — the RWKV6 ("Finch") half of
``repro.models.ssm`` in PyTorch.

  * ``init_rwkv_*``   parameter construction (the JAX tree's keys and shapes)
  * ``apply_rwkv_*``  the full-sequence form, which is also the decode step
                      (S = 1) with explicit shift and wkv states

The recurrence runs through ``kernels/wkv6`` when ``use_kernel`` (the twin
of the JAX ``use_pallas``), else through the sequential ``wkv6_scan_ref``.
The Mamba half (Jamba's SSM, kernel K4) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]

# ===========================================================================
# RWKV6
# ===========================================================================


def init_rwkv_time_mix(arch: ArchConfig, gen: torch.Generator,
                       lead: Tuple[int, ...], dtype, device) -> Params:
    """``lead`` is the stacked-group prefix of every leaf's shape."""
    d, r = arch.d_model, arch.rwkv
    H, hd = d // r.head_size, r.head_size

    def full(value, shape):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    def dense(shape, in_dim):
        return dense_init(gen, lead + shape, in_dim, dtype, device)

    u = torch.randn(lead + (H, hd), generator=gen, device=device) * 0.1
    return {
        "x_maa": full(0.0, (d,)),
        "w_maa": full(0.0, (d,)),
        "k_maa": full(0.0, (d,)),
        "v_maa": full(0.0, (d,)),
        "r_maa": full(0.0, (d,)),
        "g_maa": full(0.0, (d,)),
        "tm_w1": dense((d, 5 * r.mix_lora), d),
        "tm_w2": dense((5, r.mix_lora, d), r.mix_lora),
        "td_w1": dense((d, r.decay_lora), d),
        "td_w2": dense((r.decay_lora, d), r.decay_lora),
        "w0": full(-6.0, (d,)),  # decay base (very slow decay init)
        "u": u.to(dtype),
        "wr": dense((d, d), d),
        "wk": dense((d, d), d),
        "wv": dense((d, d), d),
        "wg": dense((d, d), d),
        "wo": dense((d, d), d),
        "ln_scale": full(1.0, (d,)),
        "ln_bias": full(0.0, (d,)),
    }


def _rwkv_projections(arch: ArchConfig, p: Params, x: torch.Tensor,
                      x_prev: torch.Tensor):
    """Data-dependent token-shift mixing + projections.

    x: (B, S, d); x_prev: x shifted right by one (B, S, d).
    Returns r, k, v, g, w — each (B, S, H, hd) except g (B, S, d); r, k, v,
    g in x's dtype, w in fp32.
    """
    d = arch.d_model
    H, hd = d // arch.rwkv.head_size, arch.rwkv.head_size
    B_, S_ = x.shape[:2]
    dx = x_prev - x
    xxx = x + dx * p["x_maa"]
    # 5-way low-rank mixing coefficients
    mix = torch.tanh(xxx @ p["tm_w1"]).reshape(B_, S_, 5, -1)
    mix = torch.einsum("bstl,tld->bstd", mix, p["tm_w2"])  # (B, S, 5, d)
    mw, mk, mv, mr, mg = mix.unbind(dim=2)
    xw = x + dx * (p["w_maa"] + mw)
    xk = x + dx * (p["k_maa"] + mk)
    xv = x + dx * (p["v_maa"] + mv)
    xr = x + dx * (p["r_maa"] + mr)
    xg = x + dx * (p["g_maa"] + mg)

    r = (xr @ p["wr"]).reshape(B_, S_, H, hd)
    k = (xk @ p["wk"]).reshape(B_, S_, H, hd)
    v = (xv @ p["wv"]).reshape(B_, S_, H, hd)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw))), in fp32
    ww = p["w0"] + torch.tanh(xw @ p["td_w1"]) @ p["td_w2"]
    w = torch.exp(-torch.exp(ww.float())).reshape(B_, S_, H, hd)
    return r, k, v, g, w


def _wkv_groupnorm(arch: ArchConfig, p: Params, y: torch.Tensor) -> torch.Tensor:
    """Per-head groupnorm of the wkv output. y: (B, S, H, hd) -> (B, S, d)
    fp32.  The population variance and eps 64e-5, as in the reference."""
    B_, S_, H, hd = y.shape
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yn = ((yf - mean) * torch.rsqrt(var + 64e-5)).reshape(B_, S_, H * hd)
    return yn * p["ln_scale"].float() + p["ln_bias"].float()


def wkv6_scan_ref(r, k, v, w, u, state=None):
    """Sequential WKV6 recurrence in the model layout (the oracle;
    ``kernels/wkv6`` is the kernel path).

    r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) or None.
    Returns y (B, S, H, hd) fp32, final state.
    """
    B, S, H, hd = r.shape
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    y, state = wkv6_ref(*(a.transpose(1, 2) for a in (r, k, v, w)), u, state)
    return y.transpose(1, 2), state


def apply_rwkv_time_mix(arch: ArchConfig, p: Params, x: torch.Tensor,
                        shift_state: Optional[torch.Tensor] = None,
                        wkv_state: Optional[torch.Tensor] = None,
                        use_kernel: bool = False):
    """Full time-mix block. Returns (out, (new_shift, new_wkv)); new_shift
    is a view of x."""
    B, S, d = x.shape
    if shift_state is None:
        shift_state = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    r, k, v, g, w = _rwkv_projections(arch, p, x, x_prev)
    u = p["u"].float()
    if use_kernel:
        y, new_state = wkv_ops.wkv6(r, k, v, w, u, state=wkv_state)
    else:
        y, new_state = wkv6_scan_ref(r.float(), k.float(), v.float(), w, u,
                                     state=wkv_state)
    y = _wkv_groupnorm(arch, p, y.to(x.dtype))
    out = (y.to(x.dtype) * g) @ p["wo"]
    return out, (x[:, -1], new_state)


def init_rwkv_channel_mix(arch: ArchConfig, gen: torch.Generator,
                          lead: Tuple[int, ...], dtype, device) -> Params:
    d, f = arch.d_model, arch.d_ff
    return {
        "k_maa": torch.zeros(lead + (d,), dtype=dtype, device=device),
        "r_maa": torch.zeros(lead + (d,), dtype=dtype, device=device),
        "wk": dense_init(gen, lead + (d, f), d, dtype, device),
        "wv": dense_init(gen, lead + (f, d), f, dtype, device),
        "wr": dense_init(gen, lead + (d, d), d, dtype, device),
    }


def apply_rwkv_channel_mix(arch: ArchConfig, p: Params, x: torch.Tensor,
                           shift_state: Optional[torch.Tensor] = None):
    """Channel mix with squared relu, whatever ``arch.activation`` says.
    Returns (out, new_shift); new_shift is a view of x."""
    B, S, d = x.shape
    if shift_state is None:
        shift_state = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    dx = x_prev - x
    xk = x + dx * p["k_maa"]
    xr = x + dx * p["r_maa"]
    h = F.relu(xk @ p["wk"])
    v = (h * h) @ p["wv"]
    return torch.sigmoid(xr @ p["wr"]) * v, x[:, -1]
