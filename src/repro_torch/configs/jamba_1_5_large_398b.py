"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7) with MoE.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2. Attention every 8th layer, MoE every other
layer (Jamba block structure).
"""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig, register

FULL = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    activation="silu",
    glu=True,
    norm="rmsnorm",
    norm_eps=1e-6,
    positional="none",  # jamba uses no positional encoding (mamba provides order)
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    moe_every=2,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    source="arXiv:2403.19887",
    verified="hf",
    notes="Mamba+attn 1:7 interleave, MoE 16e top-2",
)

SMOKE = FULL.replace(
    name="jamba-1.5-large-398b-smoke",
    n_layers=8,  # one full jamba block: 7 mamba + 1 attn, MoE every 2
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=128),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
)

register(FULL, SMOKE)
