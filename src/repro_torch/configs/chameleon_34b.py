"""chameleon-34b — early-fusion VLM over VQ image tokens.

[arXiv:2405.09818; unverified] 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536. Early fusion: image tokens are ordinary entries in the unified
vocab (the VQ tokenizer frontend is a stub — inputs arrive as token ids).
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    head_dim=128,
    qk_norm=True,  # chameleon uses qk-norm for stability
    activation="silu",
    glu=True,
    norm="rmsnorm",
    norm_eps=1e-5,
    rope_theta=10000.0,
    source="arXiv:2405.09818",
    verified="unverified",
    notes="early-fusion, VQ image tokens",
)

SMOKE = FULL.replace(
    name="chameleon-34b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
)

register(FULL, SMOKE)
