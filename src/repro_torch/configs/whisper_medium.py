"""whisper-medium — encoder-decoder with conv frontend (stub).

[arXiv:2212.04356; unverified] 24L d_model=1024 16H (GQA kv=16 = MHA)
d_ff=4096 vocab=51865. The conv/mel frontend is a STUB per the brief —
``input_specs`` provides precomputed frame embeddings (batch, 1500, d_model).
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig, register

FULL = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    head_dim=64,
    qkv_bias=True,
    activation="gelu",
    glu=False,
    norm="layernorm",
    norm_eps=1e-5,
    positional="learned",
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    source="arXiv:2212.04356",
    verified="unverified",
    notes="enc-dec, conv frontend (stub)",
)

SMOKE = FULL.replace(
    name="whisper-medium-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    encoder=EncoderConfig(n_layers=2, n_frames=16),
)

register(FULL, SMOKE)
