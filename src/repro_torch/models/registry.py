"""Public model API: ``Model`` (an ``nn.Module``), ``build_model`` and
``count_params`` — the port of ``repro.models.registry``.

``Model`` registers its parameters under the JAX tree's paths, with ``/``
read as ``.`` (``blocks/l0/attn/wq`` is ``blocks.l0.attn.wq``), and with
the JAX shapes, so ``convert.load_jax_params`` can load a JAX tree leaf by
leaf.  The layer code works on the nested dict that ``params()`` returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelSettings
from repro_torch.utils.trees import tree_from_paths, tree_paths

__all__ = ["ModelSettings", "build_model", "Model", "count_params",
           "resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; CUDA without a card raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev


class Model(nn.Module):
    def __init__(self, arch: ArchConfig, settings: ModelSettings,
                 device: torch.device, seed: int = 0):
        super().__init__()
        self.arch = arch
        self.settings = settings
        gen = torch.Generator(device=device).manual_seed(seed)
        for path, leaf in tree_paths(T.init_params(arch, gen, settings,
                                                   device)).items():
            node = self
            *parents, name = path.split("/")
            for part in parents:
                if part not in node._modules:
                    node.add_module(part, nn.Module())
                node = node._modules[part]
            node.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def params(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested dict tree."""
        return tree_from_paths({n.replace(".", "/"): p
                                for n, p in self.named_parameters()})

    # --- steps ---------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        return T.prefill(self.arch, self.params(), tokens, self.settings)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        return T.decode_step(self.arch, self.params(), cache, tokens, pos,
                             self.settings)

    def init_cache(self, batch: int, max_seq: int):
        return T.init_cache(self.arch, batch, max_seq, self.settings,
                            self.device)


def build_model(arch: ArchConfig, settings: Optional[ModelSettings] = None, *,
                device="cuda", seed: int = 0, **overrides) -> Model:
    """A model with weights drawn from ``seed``, on ``device``."""
    dev = resolve_device(device)
    st = settings or ModelSettings()
    if overrides:
        st = dataclasses.replace(st, **overrides)
    return Model(arch, st, dev, seed=seed)


def count_params(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())
