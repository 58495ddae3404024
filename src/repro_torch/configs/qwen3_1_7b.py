"""qwen3-1.7b — dense GQA transformer with QK-norm.

[hf:Qwen/Qwen3-8B; hf] 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    qkv_bias=False,
    activation="silu",
    glu=True,
    norm="rmsnorm",
    norm_eps=1e-6,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-1.7B",
    verified="hf",
    notes="qk_norm, GQA",
)

SMOKE = FULL.replace(
    name="qwen3-1.7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
)

register(FULL, SMOKE)
