"""stablelm-12b — dense GQA transformer.

[hf:stabilityai/stablelm-2-1_6b; hf] 40L d_model=5120 32H (GQA kv=8)
d_ff=13824 vocab=100352
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    head_dim=160,
    activation="silu",
    glu=True,
    norm="layernorm",
    norm_eps=1e-5,
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-12b",
    verified="hf",
)

SMOKE = FULL.replace(
    name="stablelm-12b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab=512,
)

register(FULL, SMOKE)
