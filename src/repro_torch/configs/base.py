"""Architecture & shape configuration for the PyTorch port.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``);
the two must stay field-for-field equal, which ``tests/test_torch_serve.py``
checks.  Every assigned architecture is expressed as an :class:`ArchConfig` with the
exact published numbers.  A parallel ``smoke()`` constructor produces a
reduced config of the same *family* (same code paths, tiny dims) for CPU
tests.  Shapes are the four assigned workload cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    # capacity factor used for expert-parallel dispatch buffers
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    @property
    def active_expert_frac(self) -> float:
        return self.top_k / self.num_experts


@dataclass(frozen=True)
class MambaConfig:
    """Mamba (selective SSM) block configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default: ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, d_model // 16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 ("Finch") time-mix configuration."""

    head_size: int = 64
    # low-rank dims for the data-dependent decay / token-shift projections
    decay_lora: int = 64
    mix_lora: int = 32


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) archs.

    The modality frontend (mel conv) is a STUB per the brief:
    ``input_specs`` provides precomputed frame embeddings of shape
    ``(batch, n_frames, d_model)``.
    """

    n_layers: int
    n_frames: int = 1500  # whisper: 30 s audio -> 1500 frames after conv


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_free: bool = False  # RWKV: no attention layers at all

    # mlp details
    activation: str = "silu"  # silu | gelu | relu2
    glu: bool = True  # gated (SwiGLU-style) MLP

    # norms / embeddings
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    positional: str = "rope"  # rope | learned | sinusoidal | none

    # family extensions
    moe: Optional[MoEConfig] = None
    moe_every: int = 1  # MoE applied every k-th layer (jamba: 2)
    mamba: Optional[MambaConfig] = None
    attn_every: int = 0  # hybrid: 1 attention layer per this many (jamba: 8)
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None  # enc-dec archs

    # provenance
    source: str = ""
    verified: str = "unverified"
    notes: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def is_hybrid(self) -> bool:
        return self.mamba is not None and not self.attn_free and self.attn_every > 0

    @property
    def subquadratic(self) -> bool:
        """True if the arch can run 500k-token decode (SSM / hybrid)."""
        return self.attn_free or self.is_hybrid

    def attn_layer_ids(self) -> Tuple[int, ...]:
        """Indices of attention layers (hybrid interleave)."""
        if self.attn_free:
            return ()
        if self.attn_every <= 0:
            return tuple(range(self.n_layers))
        # jamba: one attention layer per attn_every block (at offset attn_every//2)
        off = self.attn_every // 2
        return tuple(i for i in range(self.n_layers) if i % self.attn_every == off)

    def moe_layer_ids(self) -> Tuple[int, ...]:
        if self.moe is None:
            return ()
        return tuple(i for i in range(self.n_layers) if i % self.moe_every == self.moe_every - 1)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes (assigned workload cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, with a reason if skipped."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{arch.name} is pure full-attention (skip noted in DESIGN.md §5)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}
_SMOKE_REGISTRY: dict = {}


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    assert cfg.family in FAMILIES, cfg.family
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    return _SMOKE_REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import all config modules for registration side effects; each
    # arch registers here in the slice of the port that runs it
    from repro_torch.configs import (  # noqa: F401
        chameleon_34b,
        deepseek_moe_16b,
        jamba_1_5_large_398b,
        moonshot_v1_16b_a3b,
        nemotron_4_340b,
        qwen2_0_5b,
        qwen3_1_7b,
        rwkv6_1_6b,
        stablelm_12b,
        whisper_medium,
    )
