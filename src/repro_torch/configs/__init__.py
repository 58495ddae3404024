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
from repro_torch.configs.one_card import one_card_arch, one_card_train_arch

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
    "one_card_arch",
    "one_card_train_arch",
    "shape_applicable",
]
