"""Config-driven model assembly — the dense-attention and RWKV6 subset of
``repro.models.transformer`` in PyTorch.

The parameter tree is the JAX package's, leaf for leaf and shape for shape:
layers are stacked over groups (a leading group dim on every ``blocks/``
leaf), and a Python loop over that dim takes the place of ``lax.scan``.
Every dense or RWKV group holds one layer, ``blocks/l0``.  MoE, hybrid
(Mamba) and encoder-decoder families are not ported yet and raise.

Modes:
  * prefill — forward returning logits of the last position + the cache
              (KV for attention layers; token-shift and wkv states for RWKV)
  * decode  — single-token step over a preallocated cache, updated in place
              (the JAX step returns a new cache; here the one cache is
              written where it lies and returned, to save a copy per step)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelSettings:
    """The fields of the JAX ``ModelSettings`` that this slice uses."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "masked"  # masked | kernel (twin of the JAX "pallas")
    attn_chunk: int = 1024
    use_kernel_ssm: bool = False  # the wkv6 kernel (twin of use_pallas_ssm)

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
    """Raise for what the port does not run yet."""
    if (arch.is_hybrid or arch.moe is not None or arch.is_encdec
            or arch.positional not in ("rope", "none")):
        raise NotImplementedError(
            f"{arch.name} ({arch.family}) is not ported yet: the port runs "
            f"dense attention and RWKV6 models (ROADMAP.md queue 1)")
    if st.pdt() != st.cdt():
        raise NotImplementedError(
            "param_dtype != compute_dtype (mixed precision) is not ported yet")


def n_groups(arch: ArchConfig) -> int:
    """Stacked groups: one layer each in the dense and RWKV families."""
    return arch.n_layers


def layer_kind(arch: ArchConfig) -> str:
    """Every layer of a ported family is of one kind (the JAX function also
    tells Jamba's attention and Mamba layers apart, by layer id)."""
    return "rwkv" if arch.attn_free else "attn"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(arch: ArchConfig, gen: torch.Generator, st: ModelSettings,
                device) -> Params:
    """The JAX tree (``repro.models.transformer.init_params``), drawn from
    ``gen``: the same paths, shapes and init scales; other numbers."""
    check_supported(arch, st)
    dt, d = st.pdt(), arch.d_model
    lead = (n_groups(arch),)
    p: Params = {"embed": L.embed_init(gen, (arch.vocab, d), dt, device)}
    layer = {"ln1": L.init_norm(arch, lead + (d,), dt, device),
             "ln2": L.init_norm(arch, lead + (d,), dt, device)}
    if layer_kind(arch) == "rwkv":
        layer["tmix"] = SSM.init_rwkv_time_mix(arch, gen, lead, dt, device)
        layer["cmix"] = SSM.init_rwkv_channel_mix(arch, gen, lead, dt, device)
    else:
        layer["attn"] = L.init_attention(arch, gen, lead, dt, device)
        layer["mlp"] = L.init_mlp(arch, gen, lead, dt, device)
    p["blocks"] = {"l0": layer}
    p["final_norm"] = L.init_norm(arch, (d,), dt, device)
    if not arch.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, arch.vocab), d, dt, device)
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _apply_layer(arch: ArchConfig, p: Params, x: torch.Tensor, positions,
                 st: ModelSettings, cache: Optional[Params] = None,
                 pos: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """Prefill (``cache`` None) or one decode step at ``pos`` (the new kv,
    or the new RWKV states, are written into ``cache`` in place).  Returns
    (x, the layer's cache)."""
    if layer_kind(arch) == "rwkv":
        return _apply_rwkv_layer(arch, p, x, st, cache)
    h = L.apply_norm(arch, p["ln1"], x)
    q, k, v = L.attention_qkv(arch, p["attn"], h, positions)
    if cache is None:
        o = L.attend(q, k, v, causal=True, impl=st.attn_impl,
                     q_chunk=st.attn_chunk, kv_chunk=st.attn_chunk)
        cache = {"k": k, "v": v}
    else:
        kc, vc = cache["k"], cache["v"]
        kc[:, pos:pos + 1] = k.to(kc.dtype)
        vc[:, pos:pos + 1] = v.to(vc.dtype)
        lens = torch.full((x.shape[0],), pos + 1, device=x.device)
        o = L.attend_decode(q, kc, vc, lens)
    x = x + L.attention_out(p["attn"], o)
    h = L.apply_norm(arch, p["ln2"], x)
    x = x + L.apply_mlp(arch, p["mlp"], h)
    return x, cache


def _apply_rwkv_layer(arch: ArchConfig, p: Params, x: torch.Tensor,
                      st: ModelSettings, cache: Optional[Params] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """Time mix then channel mix, each from its state in ``cache`` (zeros
    when None).  In decode the new states are copied into ``cache``; the
    shifts returned by the mixers are views of their inputs."""
    state = cache or {}
    h = L.apply_norm(arch, p["ln1"], x)
    out, (tshift, wkv) = SSM.apply_rwkv_time_mix(
        arch, p["tmix"], h, shift_state=state.get("tshift"),
        wkv_state=state.get("wkv"), use_kernel=st.use_kernel_ssm)
    x = x + out
    h = L.apply_norm(arch, p["ln2"], x)
    out, cshift = SSM.apply_rwkv_channel_mix(
        arch, p["cmix"], h, shift_state=state.get("cshift"))
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


def forward(arch: ArchConfig, params: Params, tokens: torch.Tensor,
            st: ModelSettings) -> Tuple[torch.Tensor, Params]:
    """Prefill forward.  Returns (hidden (B,S,d), the cache stacked over
    groups: {'l0': {'k','v': (G,B,S,KV,hd)}} for attention layers,
    {'l0': {'tshift','cshift': (G,B,d), 'wkv': (G,B,H,hd,hd)}} for RWKV)."""
    B, Sq = tokens.shape
    x = params["embed"][tokens].to(st.cdt())
    positions = torch.arange(Sq, device=tokens.device)[None, :].expand(B, Sq)
    caches = []
    for gi in range(n_groups(arch)):
        lp = _tree_map(lambda a: a[gi], params["blocks"]["l0"])
        x, c = _apply_layer(arch, lp, x, positions, st)
        caches.append(c)
    x = L.apply_norm(arch, params["final_norm"], x)
    return x, {"l0": {name: torch.stack([c[name] for c in caches])
                      for name in caches[0]}}


def logits_from_hidden(arch: ArchConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def init_cache(arch: ArchConfig, batch: int, max_seq: int, st: ModelSettings,
               device) -> Params:
    """Zeroed cache, stacked over groups: {'l0': {'k','v': (G,B,S,KV,hd)}}
    for attention layers; {'l0': {'tshift','cshift': (G,B,d) in the compute
    dtype, 'wkv': (G,B,H,hd,hd) fp32}} for RWKV (``max_seq`` unused)."""
    G, dt = n_groups(arch), st.cdt()
    if layer_kind(arch) == "rwkv":
        hs = arch.rwkv.head_size
        shift = (G, batch, arch.d_model)
        return {"l0": {
            "tshift": torch.zeros(shift, dtype=dt, device=device),
            "wkv": torch.zeros((G, batch, arch.d_model // hs, hs, hs),
                               dtype=torch.float32, device=device),
            "cshift": torch.zeros(shift, dtype=dt, device=device)}}
    shape = (G, batch, max_seq, arch.n_kv_heads, arch.resolved_head_dim)
    return {"l0": {"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)}}


def decode_step(arch: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int, st: ModelSettings
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) integer; pos: tokens already in the
    cache.  Writes the new kv at ``pos`` (or the new RWKV states) in place
    and returns (logits (B, V) fp32, cache)."""
    pos = int(pos)
    B = tokens.shape[0]
    x = params["embed"][tokens].to(st.cdt())
    positions = torch.full((B, 1), pos, device=tokens.device)
    for gi in range(n_groups(arch)):
        lp = _tree_map(lambda a: a[gi], params["blocks"]["l0"])
        lc = _tree_map(lambda a: a[gi], cache["l0"])
        x, _ = _apply_layer(arch, lp, x, positions, st, lc, pos=pos)
    x = L.apply_norm(arch, params["final_norm"], x)
    return logits_from_hidden(arch, params, x)[:, 0], cache


def prefill(arch: ArchConfig, params: Params, tokens: torch.Tensor,
            st: ModelSettings) -> Tuple[torch.Tensor, Params]:
    """Prefill forward: returns (last-position logits (B, V), cache)."""
    hidden, cache = forward(arch, params, tokens, st)
    return logits_from_hidden(arch, params, hidden[:, -1:])[:, 0], cache
