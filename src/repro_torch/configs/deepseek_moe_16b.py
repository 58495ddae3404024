"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed, top-6.

[arXiv:2401.06066; hf] 28L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408
vocab=102400, MoE 64e top-6
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    activation="silu",
    glu=True,
    norm="rmsnorm",
    norm_eps=1e-6,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408, num_shared_experts=2),
    source="arXiv:2401.06066",
    verified="hf",
    notes="2 shared + 64 routed top-6, fine-grained",
)

SMOKE = FULL.replace(
    name="deepseek-moe-16b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab=512,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32, num_shared_experts=2),
)

register(FULL, SMOKE)
