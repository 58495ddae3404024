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

Training on one card (``one_card_train_arch``) holds, for each of two
data-parallel ranks, bf16 parameters and gradients, fp32 AdamW moments and
the int8 slow tier's fp32 error feedback, none of them sharded when the
fast tier has one member: about 16 bytes a parameter a rank.  One more
arch is cut for that:

  * deepseek-moe-16b (16.88 B parameters): depth 28 layers to
    ``DEEPSEEK_TRAIN_LAYERS``, every width kept.  A layer (64 routed
    experts of 1408 and 2 shared, attention 16 x 128) is 588 M parameters
    and the untied 102400 x 2048 embedding and head 419 M, so each layer
    adds about 18.8 GB over the two ranks; the deepest of 4, 3 or 2 layers
    whose measured peak (``chip_smoke.py`` ``[train-moe]``) leaves 10 GB
    of the card free.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ArchConfig, get_arch, get_smoke_arch

JAMBA = "jamba-1.5-large-398b"
NEMOTRON = "nemotron-4-340b"
NEMOTRON_LAYERS = 4
DEEPSEEK = "deepseek-moe-16b"
DEEPSEEK_TRAIN_LAYERS = 2
#: whisper-medium's published text context (arXiv:2212.04356): the decoder
#: length its card runs prefill and train at, which also sizes its learned
#: positions (``ModelSettings.max_seq``)
WHISPER_TEXT_CONTEXT = 448


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


def one_card_train_arch(name: str) -> Tuple[ArchConfig, Tuple[str, ...]]:
    """(the config two data-parallel ranks train on one card, the cuts made
    to the registered one, each as 'field: from -> to'): deepseek-moe-16b
    cut in depth, every other arch as ``one_card_arch`` serves it."""
    if name != DEEPSEEK:
        return one_card_arch(name)
    arch = get_arch(name)
    return arch.replace(n_layers=DEEPSEEK_TRAIN_LAYERS), (
        f"n_layers: {arch.n_layers} -> {DEEPSEEK_TRAIN_LAYERS}",)
