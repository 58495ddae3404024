from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    EncoderConfig,
    MambaConfig,
    MoEConfig,
    RWKVConfig,
    ShapeConfig,
    get_arch,
    get_smoke_arch,
    list_archs,
    shape_applicable,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "EncoderConfig",
    "MambaConfig",
    "MoEConfig",
    "RWKVConfig",
    "ShapeConfig",
    "get_arch",
    "get_smoke_arch",
    "list_archs",
    "shape_applicable",
]
