"""Attention-free sequence mixers — ``repro.models.ssm`` in PyTorch:
RWKV6 ("Finch") and Mamba (Jamba's SSM).

  * ``init_*``   parameter construction (the JAX tree's keys and shapes)
  * ``apply_*``  the full-sequence form, which is also the decode step
                 (S = 1) with explicit states (shift and wkv for RWKV6,
                 conv and ssm for Mamba)

Each recurrence runs through its kernel when ``use_kernel`` (the twin of
the JAX ``use_pallas``): ``kernels/wkv6`` and ``kernels/mamba_scan``;
else through the sequential ``wkv6_scan_ref`` and ``mamba_scan_ref``.

Tensor parallelism (training): with ``axis`` a mixer's leaves are this
member's blocks under the sharding rules (``models/sharding.py``) and it
computes its heads or channels, with the collectives GSPMD puts in for
the JAX package.  A replicated tensor used on local channels enters
through ``prims.to_parallel`` (its gradient summed over the members), and
a row-parallel product's output leaves through ``prims.psum_replicated``.
RWKV6's time mix runs the wkv recurrence on its heads, between the
column-split ``wr``/``wk``/``wv``/``wg`` and the row-parallel ``wo``; where
the heads do not split over the axis but d does (``u`` and the ``wkv``
state whole on every member, as the reference's rules give), r, k, v and
w are gathered to whole heads (``prims.gather_on_use``,
whose reduce-scatter backward sums the members' parts of each column's
gradient), every member runs the recurrence and the groupnorm on every
head, and keeps its columns for the affine, the gate and ``wo``; its
channel mix is column- then row-parallel with the replicated ``wr`` gate
applied after the sum; Mamba runs the conv and the scan on its channels of
``d_inner`` between the paired ``w_in`` cut and the row-parallel ``w_x``
and ``w_out``.

The sequence split (``sp``: the axis over which ``x`` holds this member's
rows of the sequence, the model axis): each mixer gathers the rows
(``prims.gather_replicated``) before its token shift or conv, which cross
the members' row boundaries, and runs on the gathered sequence; its
gradient is already whole on every member there (its inner
``to_parallel`` sums the members' parts), so the gather's backward keeps
the member's rows.  The last row-parallel product is reduce-scattered
onto the member's rows (``layers.sublayer_out``); the channel mix's
``wr`` gate is taken on the member's rows, where it meets ``v``'s.  The
shift and conv states returned are the whole sequence's last rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prims
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref as _scan_ref
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models.layers import dense_init, einsum, mm, sublayer_out

Params = Dict[str, Any]


def _local(t: torch.Tensor, axis: Optional[str], dim: int = -1) -> torch.Tensor:
    """This member's channels (dim ``dim``) of a replicated ``t``, entered
    through ``to_parallel``; all of ``t`` without an axis."""
    if axis is None:
        return t
    n = t.shape[dim] // prims.axis_size(axis)
    return prims.to_parallel(t, axis).narrow(dim, prims.axis_rank(axis) * n, n)

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
                      x_prev: torch.Tensor, axis: Optional[str] = None,
                      whole_heads: bool = False):
    """Data-dependent token-shift mixing + projections.

    x: (B, S, d); x_prev: x shifted right by one (B, S, d).
    Returns r, k, v, g, w — each (B, S, H, hd) except g (B, S, d); r, k, v,
    g in x's dtype, w in fp32.  With ``axis`` the mixing stays replicated
    and each output holds this member's heads (channels of g); with
    ``whole_heads`` too, r, k, v and w are this member's columns gathered
    over ``axis`` into every head.
    """
    hd = arch.rwkv.head_size
    B_, S_ = x.shape[:2]
    dx = x_prev - x
    xxx = x + dx * p["x_maa"]
    # 5-way low-rank mixing coefficients
    mix = torch.tanh(mm(xxx, p["tm_w1"])).reshape(B_, S_, 5, -1)
    mix = einsum("bstl,tld->bstd", mix, p["tm_w2"])  # (B, S, 5, d)
    mw, mk, mv, mr, mg = mix.unbind(dim=2)
    xw = x + dx * (p["w_maa"] + mw)
    xk = x + dx * (p["k_maa"] + mk)
    xv = x + dx * (p["v_maa"] + mv)
    xr = x + dx * (p["r_maa"] + mr)
    xg = x + dx * (p["g_maa"] + mg)

    def column(xi, name):  # this member's columns of a (d, d) leaf
        return mm(prims.to_parallel(xi, axis), p[name])

    def heads(t):  # (B, S, columns) -> (B, S, heads, hd)
        if whole_heads:  # the gathered columns, laid out as the kernel reads them
            t = prims.gather_on_use(t, axis, 2).contiguous()
        return t.reshape(B_, S_, -1, hd)

    r = heads(column(xr, "wr"))
    k = heads(column(xk, "wk"))
    v = heads(column(xv, "wv"))
    g = F.silu(column(xg, "wg"))
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw))), in fp32,
    # on this member's channels
    lora = prims.to_parallel(torch.tanh(mm(xw, p["td_w1"])), axis)
    ww = _local(p["w0"], axis) + mm(lora, _local(p["td_w2"], axis))
    w = heads(torch.exp(-torch.exp(ww.float())))
    return r, k, v, g, w


def _wkv_groupnorm(arch: ArchConfig, p: Params, y: torch.Tensor,
                   axis: Optional[str] = None,
                   whole_heads: bool = False) -> torch.Tensor:
    """Per-head groupnorm of the wkv output. y: (B, S, H, hd) -> (B, S, d)
    fp32.  The population variance and eps 64e-5, as in the reference.
    With ``axis`` y holds this member's heads, and the affine its
    channels; with ``whole_heads`` y holds every head, normalised whole,
    and this member's channels are kept for the affine."""
    B_, S_, H, hd = y.shape
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yn = ((yf - mean) * torch.rsqrt(var + 64e-5)).reshape(B_, S_, H * hd)
    if whole_heads:
        n = H * hd // prims.axis_size(axis)
        yn = yn.narrow(-1, prims.axis_rank(axis) * n, n)
    return (yn * _local(p["ln_scale"], axis).float()
            + _local(p["ln_bias"], axis).float())


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
                        use_kernel: bool = False, axis: Optional[str] = None,
                        sp: Optional[str] = None):
    """Full time-mix block. Returns (out, (new_shift, new_wkv)); new_shift
    is a view of x.  With ``axis`` the recurrence runs on this member's
    heads (``u`` holds them) and ``wo`` is row-parallel, or, where ``u``
    holds every head (the heads do not split over ``axis``), on every head
    (the state whole, ``u``'s gradient summed over ``axis``); with ``sp``
    on the gathered sequence, ``out`` the member's rows."""
    x = prims.gather_replicated(x, sp, 1)
    B, S, d = x.shape
    whole_heads = axis is not None and p["u"].shape[-2] * arch.rwkv.head_size == d
    if shift_state is None:
        shift_state = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    r, k, v, g, w = _rwkv_projections(arch, p, x, x_prev, axis, whole_heads)
    u = (prims.to_parallel(p["u"], axis) if whole_heads else p["u"]).float()
    if use_kernel:
        y, new_state = wkv_ops.wkv6(r, k, v, w, u, state=wkv_state)
    else:
        y, new_state = wkv6_scan_ref(r.float(), k.float(), v.float(), w, u,
                                     state=wkv_state)
    y = _wkv_groupnorm(arch, p, y.to(x.dtype), axis, whole_heads)
    out = sublayer_out(mm(y.to(x.dtype) * g, p["wo"]), axis, sp)
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
                           shift_state: Optional[torch.Tensor] = None,
                           axis: Optional[str] = None, sp: Optional[str] = None):
    """Channel mix with squared relu, whatever ``arch.activation`` says.
    Returns (out, new_shift); new_shift is a view of x.  With ``axis``
    ``wk`` is column- and ``wv`` row-parallel, the gate replicated.  With
    ``sp`` the gate is taken on the member's rows of ``xr`` (entered
    through ``to_parallel``, as ``wr`` is: their gradients are the members'
    rows' sum), where it meets the scattered ``v``."""
    Sl = x.shape[1]
    x = prims.gather_replicated(x, sp, 1)
    B, S, d = x.shape
    if shift_state is None:
        shift_state = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
    dx = x_prev - x
    xk = x + dx * p["k_maa"]
    xr = x + dx * p["r_maa"]
    h = F.relu(mm(prims.to_parallel(xk, axis), p["wk"]))
    v = sublayer_out(mm(h * h, p["wv"]), axis, sp)
    wr = p["wr"]
    if sp is not None:
        xr = prims.to_parallel(xr, sp).narrow(1, prims.axis_rank(sp) * Sl, Sl)
        wr = prims.to_parallel(wr, sp)
    return torch.sigmoid(mm(xr, wr)) * v, x[:, -1]


# ===========================================================================
# Mamba (selective SSM, as used by Jamba)
# ===========================================================================


def init_mamba(arch: ArchConfig, gen: torch.Generator, lead: Tuple[int, ...],
               dtype, device) -> Params:
    """``A_log`` and ``D`` are fp32 whatever ``dtype`` is, as in JAX."""
    m, d = arch.mamba, arch.d_model
    di, dtr = m.expand * d, m.resolved_dt_rank(d)

    def dense(shape, in_dim):
        return dense_init(gen, lead + shape, in_dim, dtype, device)

    A = torch.arange(1, m.d_state + 1, dtype=torch.float32, device=device)
    return {
        "w_in": dense((d, 2 * di), d),
        "conv_w": dense((m.d_conv, di), m.d_conv),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "w_x": dense((di, dtr + 2 * m.d_state), di),
        "w_dt": dense((dtr, di), dtr),
        # softplus^-1 around 0.018
        "dt_bias": torch.full(lead + (di,), math.log(math.e - 1) - 4.0,
                              dtype=dtype, device=device),
        "A_log": torch.log(A).expand(lead + (di, m.d_state)).clone(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=device),
        "w_out": dense((di, d), di),
    }


def _mamba_conv_train(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time with left padding. x: (B, S, di).
    The window's products are summed in fp32 and rounded once to x's dtype;
    then the bias is added in x's dtype."""
    d_conv, di = p["conv_w"].shape
    S = x.shape[1]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    w = p["conv_w"].to(x.dtype).float()
    out = xp[:, 0:S].float() * w[0]
    for k in range(1, d_conv):
        out = out + xp[:, k:k + S].float() * w[k]
    return out.to(x.dtype) + p["conv_b"]


def mamba_scan_ref(u, delta, A, Bc, Cc, D, state=None):
    """Sequential selective scan (the oracle; ``kernels/mamba_scan`` is the
    kernel path).

    u, delta: (B, S, di); A: (di, ds); Bc, Cc: (B, S, ds); D: (di,);
    state: (B, di, ds) or None.  Returns y (B, S, di) fp32, final state.
    """
    B, S, di = u.shape
    if state is None:
        state = torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                            device=u.device)
    return _scan_ref(u, delta, A, Bc, Cc, D, state)


def apply_mamba(arch: ArchConfig, p: Params, x: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False, axis: Optional[str] = None,
                sp: Optional[str] = None):
    """Full Mamba block over a sequence; with states it is also the decode
    step (S = 1).  Returns (out, (conv_state, ssm_state)); the new conv
    state is a view of this call's activations.  With ``axis`` the layer
    runs on this member's channels of d_inner: ``w_in`` holds them in
    ``xs`` and in ``z`` (its paired cut), ``w_x`` and ``w_out`` are
    row-parallel, and dt_r, B and C, summed over the whole sequence, are
    used on them; with ``sp`` on the gathered sequence, ``out`` the
    member's rows."""
    x = prims.gather_replicated(x, sp, 1)
    m = arch.mamba
    dtr = m.resolved_dt_rank(arch.d_model)

    # (B, S, di) each, this member's channels under an axis
    xs, z = mm(prims.to_parallel(x, axis), p["w_in"]).chunk(2, dim=-1)
    if conv_state is not None:
        xs_ext = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
        conv = _mamba_conv_train(p, xs_ext)[:, conv_state.shape[1]:]
    else:
        xs_ext = xs
        conv = _mamba_conv_train(p, xs)
    new_conv_state = xs_ext[:, -(m.d_conv - 1):] if m.d_conv > 1 else None
    h = F.silu(conv)

    # (B, S, dtr + 2 ds), whole on every member
    xdbl = prims.to_parallel(prims.psum_replicated(mm(h, p["w_x"]), axis), axis)
    dt_r = xdbl[..., :dtr]
    Bc = xdbl[..., dtr:dtr + m.d_state]
    Cc = xdbl[..., dtr + m.d_state:]
    # softplus as JAX writes it, logaddexp(x, 0), with no linear cut-off
    delta = torch.logaddexp(mm(dt_r, p["w_dt"]) + p["dt_bias"],
                            xdbl.new_zeros(()))
    A = -torch.exp(p["A_log"])

    if use_kernel:
        y, new_ssm = ms_ops.mamba_scan(h, delta, A, Bc, Cc, p["D"],
                                       state=ssm_state)
    else:
        y, new_ssm = mamba_scan_ref(h, delta, A, Bc, Cc, p["D"],
                                    state=ssm_state)
    y = y.to(x.dtype) * F.silu(z)
    return (sublayer_out(mm(y, p["w_out"]), axis, sp),
            (new_conv_state, new_ssm))
