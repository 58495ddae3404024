"""The configuration of each registered arch that one card serves.

Most archs run as registered.  jamba-1.5-large-398b does not fit one
80 GB card (about 796 GB of bf16 weights, and about 85 GB for one 8-layer
block with its 16-expert MoE layers), so it runs cut, with every width
kept at the published value:

  * depth: 72 layers to 8, one Jamba block (Mamba layers 0-3 and 5-7,
    attention at offset 4);
  * experts: no MoE; the four would-be MoE layers take the dense SwiGLU
    feed-forward (d_ff 24576) that Jamba's other layers have.

That leaves 8,999,034,880 parameters, 18.0 GB in bf16.  The smoke config
keeps its depth (one block already) and drops its experts the same way.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ArchConfig, get_arch, get_smoke_arch

JAMBA = "jamba-1.5-large-398b"


def one_card_arch(name: str, smoke: bool = False
                  ) -> Tuple[ArchConfig, Tuple[str, ...]]:
    """(the config one card runs, the cuts made to the registered one, each
    as 'field: from -> to'); no cuts for an arch that runs as registered."""
    arch = get_smoke_arch(name) if smoke else get_arch(name)
    if name != JAMBA:
        return arch, ()
    block, moe = arch.attn_every, arch.moe
    cuts = [] if arch.n_layers == block else [
        f"n_layers: {arch.n_layers} -> {block} (one Jamba block)"]
    cuts.append(f"moe: {moe.num_experts} experts top-{moe.top_k} every "
                f"{arch.moe_every} layers -> none (dense SwiGLU, d_ff {arch.d_ff})")
    return arch.replace(n_layers=block, moe=None), tuple(cuts)
