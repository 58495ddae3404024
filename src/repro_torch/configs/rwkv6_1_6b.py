"""rwkv6-1.6b ("Finch") — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; unverified] 24L d_model=2048 (attn-free) d_ff=7168
vocab=65536
"""
from repro_torch.configs.base import ArchConfig, RWKVConfig, register

FULL = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads = d_model / head_size(64)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    head_dim=64,
    attn_free=True,
    activation="relu2",  # rwkv channel-mix uses squared relu
    glu=False,
    norm="layernorm",
    norm_eps=1e-5,
    positional="none",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    source="arXiv:2404.05892",
    verified="unverified",
    notes="Finch — data-dependent decay",
)

SMOKE = FULL.replace(
    name="rwkv6-1.6b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    rwkv=RWKVConfig(head_size=16, decay_lora=16, mix_lora=8),
)

register(FULL, SMOKE)
