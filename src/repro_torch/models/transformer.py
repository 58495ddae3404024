"""Config-driven model assembly — the dense-attention subset of
``repro.models.transformer`` in PyTorch.

The parameter tree is the JAX package's, leaf for leaf and shape for shape:
layers are stacked over groups (a leading group dim on every ``blocks/``
leaf), and a Python loop over that dim takes the place of ``lax.scan``.
Every dense group holds one layer, ``blocks/l0``.  MoE, SSM, hybrid and
encoder-decoder families are not ported yet and raise.

Modes:
  * prefill — forward returning logits of the last position + KV cache
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

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelSettings:
    """The fields of the JAX ``ModelSettings`` that this slice uses."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "masked"  # masked | kernel (twin of the JAX "pallas")
    attn_chunk: int = 1024

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
    if (arch.attn_free or arch.is_hybrid or arch.moe is not None
            or arch.is_encdec or arch.positional not in ("rope", "none")):
        raise NotImplementedError(
            f"{arch.name} ({arch.family}) is not ported yet: this slice runs "
            f"dense attention models (ROADMAP.md queue 1)")
    if st.pdt() != st.cdt():
        raise NotImplementedError(
            "param_dtype != compute_dtype (mixed precision) is not ported yet")


def n_groups(arch: ArchConfig) -> int:
    """Stacked groups: one layer each in the dense family."""
    return arch.n_layers


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
    p["blocks"] = {"l0": {
        "ln1": L.init_norm(arch, lead + (d,), dt, device),
        "ln2": L.init_norm(arch, lead + (d,), dt, device),
        "attn": L.init_attention(arch, gen, lead, dt, device),
        "mlp": L.init_mlp(arch, gen, lead, dt, device),
    }}
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
    """Prefill (``cache`` None) or one decode step at ``pos`` (the new kv is
    written into ``cache`` in place).  Returns (x, the layer's cache)."""
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


# ---------------------------------------------------------------------------
# forward (prefill) / logits
# ---------------------------------------------------------------------------


def forward(arch: ArchConfig, params: Params, tokens: torch.Tensor,
            st: ModelSettings) -> Tuple[torch.Tensor, Params]:
    """Prefill forward.  Returns (hidden (B,S,d), the KV cache stacked
    over groups: {'l0': {'k','v': (G,B,S,KV,hd)}})."""
    B, Sq = tokens.shape
    x = params["embed"][tokens].to(st.cdt())
    positions = torch.arange(Sq, device=tokens.device)[None, :].expand(B, Sq)
    ks, vs = [], []
    for gi in range(n_groups(arch)):
        lp = _tree_map(lambda a: a[gi], params["blocks"]["l0"])
        x, c = _apply_layer(arch, lp, x, positions, st)
        ks.append(c["k"])
        vs.append(c["v"])
    x = L.apply_norm(arch, params["final_norm"], x)
    return x, {"l0": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def logits_from_hidden(arch: ArchConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def init_cache(arch: ArchConfig, batch: int, max_seq: int, st: ModelSettings,
               device) -> Params:
    """Zeroed cache, stacked over groups: {'l0': {'k','v': (G,B,S,KV,hd)}}."""
    shape = (n_groups(arch), batch, max_seq, arch.n_kv_heads,
             arch.resolved_head_dim)
    return {"l0": {"k": torch.zeros(shape, dtype=st.cdt(), device=device),
                   "v": torch.zeros(shape, dtype=st.cdt(), device=device)}}


def decode_step(arch: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int, st: ModelSettings
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) integer; pos: tokens already in the
    cache.  Writes the new kv at ``pos`` in place and returns
    (logits (B, V) fp32, cache)."""
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
