"""qwen2-0.5b — dense GQA transformer with QKV bias.

[arXiv:2407.10671; hf] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    activation="silu",
    glu=True,
    norm="rmsnorm",
    norm_eps=1e-6,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
    verified="hf",
    notes="GQA, QKV bias",
)

SMOKE = FULL.replace(
    name="qwen2-0.5b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
)

register(FULL, SMOKE)
