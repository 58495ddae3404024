"""moonshot-v1-16b-a3b (kimi/moonlight) — fine-grained MoE, 64e top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (GQA kv=16)
d_ff=1408 vocab=163840, MoE 64e top-6
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    head_dim=128,
    activation="silu",
    glu=True,
    norm="rmsnorm",
    norm_eps=1e-5,
    rope_theta=50000.0,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408, num_shared_experts=2),
    source="hf:moonshotai/Moonlight-16B-A3B",
    verified="hf",
    notes="kimi/moonlight, 64e top-6",
)

SMOKE = FULL.replace(
    name="moonshot-v1-16b-a3b-smoke",
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
