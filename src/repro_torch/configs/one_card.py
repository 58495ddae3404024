"""The configuration of each registered arch that one card serves.

Most archs run as registered.  Two do not fit one 80 GB card, so they run
cut, with every width kept at the published value:

  * jamba-1.5-large-398b (about 796 GB of bf16 weights, and about 90 GB for
    one 8-layer block with its 16-expert MoE layers):

      - depth: 72 layers to 8, one Jamba block (Mamba layers 0-3 and 5-7,
        attention at offset 4);
      - experts: no MoE; the four would-be MoE layers take the dense SwiGLU
        feed-forward (d_ff 24576) that Jamba's other layers have.

    That leaves 8,999,034,880 parameters, 18.0 GB in bf16.  The smoke config
    keeps its depth (one block already) and drops its experts the same way.

  * nemotron-4-340b (341 B parameters, 682 GB in bf16): depth 96 layers to
    4.  Its untied 256000 x 18432 embedding and head are 9.44 B parameters
    and each layer 3.45 B, so 4 layers come to 23.25 B, 46.5 GB in bf16.
    The smoke config keeps its depth.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ArchConfig, get_arch, get_smoke_arch

JAMBA = "jamba-1.5-large-398b"
NEMOTRON = "nemotron-4-340b"
NEMOTRON_LAYERS = 4


def one_card_arch(name: str, smoke: bool = False
                  ) -> Tuple[ArchConfig, Tuple[str, ...]]:
    """(the config one card runs, the cuts made to the registered one, each
    as 'field: from -> to'); no cuts for an arch that runs as registered."""
    arch = get_smoke_arch(name) if smoke else get_arch(name)
    if name == NEMOTRON:
        if arch.n_layers <= NEMOTRON_LAYERS:
            return arch, ()
        return arch.replace(n_layers=NEMOTRON_LAYERS), (
            f"n_layers: {arch.n_layers} -> {NEMOTRON_LAYERS}",)
    if name != JAMBA:
        return arch, ()
    block, moe = arch.attn_every, arch.moe
    cuts = [] if arch.n_layers == block else [
        f"n_layers: {arch.n_layers} -> {block} (one Jamba block)"]
    cuts.append(f"moe: {moe.num_experts} experts top-{moe.top_k} every "
                f"{arch.moe_every} layers -> none (dense SwiGLU, d_ff {arch.d_ff})")
    return arch.replace(n_layers=block, moe=None), tuple(cuts)
