"""nemotron-4-340b — dense GQA transformer with squared-ReLU MLP.

[arXiv:2402.16819; unverified] 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    head_dim=192,
    activation="relu2",
    glu=False,  # nemotron uses squared-ReLU, non-gated MLP
    norm="layernorm",
    norm_eps=1e-5,
    rope_theta=10000.0,
    source="arXiv:2402.16819",
    verified="unverified",
    notes="GQA, squared-ReLU",
)

SMOKE = FULL.replace(
    name="nemotron-4-340b-smoke",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    head_dim=24,
    d_ff=256,
    vocab=512,
)

register(FULL, SMOKE)
