#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per kernel, all started together), holds each against its plain
PyTorch version, then drives the port's eight serving paths at full width
(random weights from a seed), each through ``Model.prefill`` (bf16, B=4,
S=2048, launches asserted; then fp32 kernel-vs-plain and prefill-vs-decode
checks) and ``DecodeServer`` answering 16 requests:

  * qwen2-0.5b, with the flash-attention kernel (K1) in every prefill layer;
    its fp32 checks on a 4-layer model;
  * rwkv6-1.6b, with the WKV6 kernel (K3) in every layer of every prefill
    and decode step;
  * jamba-1.5-large-398b cut to one card (one 8-layer Jamba block, no
    experts, every width published: ``configs.one_card_arch``), with the
    selective-scan kernel (K4) in its 7 Mamba layers of every prefill and
    decode step and K1 in its attention layer's prefill; its fp32 checks on
    a Mamba layer and the attention layer;
  * deepseek-moe-16b at 14 of its 28 layers (64 routed experts top-6 and
    2 shared in each; 16.88 B parameters whole), with K1 in every prefill layer,
    the (token, k) slots each MoE layer drops at that shape, and its fp32
    router checked; its fp32 checks on a 2-layer model;
  * qwen3-1.7b (qk-norm), with K1 in every prefill layer;
  * stablelm-12b at 20 of its 40 layers (LayerNorm, head_dim 160), with
    K1 in every prefill layer; its fp32 checks on a 4-layer model;
  * nemotron-4-340b cut to 2 layers (every width published), with K1 at
    head_dim 192 in every prefill layer, LayerNorm and squared ReLU; its
    fp32 checks on a 1-layer model, after the bf16 model is freed;
  * whisper-medium whole (``[whisper]``: 24 encoder and 24 decoder
    layers), its prefill at B=4 over its 448-token text context
    (``configs.one_card.WHISPER_TEXT_CONTEXT``) with frame embeddings
    (4, 1500, 1024) drawn from the seed, K1 in every decoder layer's
    causal self-attention and no other kernel (the encoder and the cross attention are masked, as in the
    reference); fp32 kernel vs plain logits, and prefill(447) then one
    decode step from its cache (``xk``/``xv`` included) against
    prefill(448); the server decodes against a zeroed cross cache, as the
    reference's does;

then the int8 quantize + error-feedback kernel (K2) against its plain
version, bit for bit, and the training path: ``repro_torch.launch.train``
with two ranks sharing the card over gloo, mesh (pod, data, model) =
(2, 1, 1), full-width qwen2-0.5b in fp32 with the int8 slow tier, K1 in
every layer's forward and K2 in every slow-tier leg, 4 steps with a
checkpoint every 2 (``[train]``, run (a)); then ``[ckpt]``: (b) the same
run with a failure injected after the step-2 save and a restart in new
ranks that restores step 2 and runs steps 2-3, held to (a); (c) that
step-2 checkpoint restored on one rank (mesh (1, 1, 1), this process)
for one step.
The checkpoints (≈ 7.9 GB a step) go under ``build/ckpt_smoke`` and are
deleted after the phase; too little free disk there raises.

Then ``[train3]``: 8 ranks share the card over gloo, mesh (pod, host,
data, model) = (2, 2, 2, 1), full-width qwen2-0.5b in fp32, B=1 S=512 a
rank: (a) the CLI with ``--codec topk`` for 1 step (24 K1 launches a rank
a step, no K2); (b) ``make_sync_plan(..., mid_codec="int8")`` on
``three_tier_fabric(2, 2, 2)`` and ``make_dfabric_train_step`` for 1 step
(K2 on every mid-coded leg and int8 slow chunk, as many launches as the
plan says); parameters bit-equal over the 8 ranks after every step; (c)
``dfabric_all_to_all`` of one deepseek-moe-16b dispatch buffer (64 x 960 x
2048 bf16) a rank at chunks 1/2/4 and every lane offset, bit-equal to one
flat ``all_to_all_single``; (d) ``ring_all_reduce`` of embed's gradient
size on a second mesh, ``{"data": 8}``, bit-equal to ``prims.psum``; (e)
RWKV6's time mix split inside its heads, on a third mesh of the same
ranks: rwkv6-1.6b's smoke (4 heads of 16, d 64) on (pod, data, model) =
(1, 1, 8), each member holding 8 columns (half a head) of the time mix's
projections and running every head's recurrence (K3 over all 4, ``u`` and
the ``wkv`` state whole), fp32, 8 rows of 32: the DFabric and the GSPMD
step with and without the sequence split, 2 steps each, the losses within
1e-5 relative of the same runs on one member (in this process, a world of
one), K3 2 a rank a step, the blocks two members hold alike bit-equal;
then prefill of 4 rows of 32 on (data, model) = (1, 8) with and without
the split and 4 decode steps, the logits within 1e-4 of the one-member
run's, the ``wkv`` state bit-equal on the 8 members.  The gloo
collectives move the card's tensors through host memory: their times are
not fabric bandwidth.

Then ``[examples]``: the four examples' twins (``examples/*_torch.py``) in
turn through their ``main(argv)`` in one spawned process, each starting
and ending a world of its own (nccl, one member): quickstart (60 steps;
the loss falls), elastic_restart (crash at step 10, restart from step 8,
every restarted step's loss equal to the uninterrupted run's, the restore
giving step 16), ddp_train (300 steps of its 67.1M-parameter model, the
newest checkpoint at step 300 under ``build/ckpt_examples``, deleted
after; the preemption handler installed, the straggler events printed)
and serve_decode on the qwen2-0.5b, rwkv6-1.6b, jamba-1.5-large-398b and
whisper-medium smokes (12/12 requests each); K1 in every attention layer's
training forward, K3 and K4 in every RWKV6 and Mamba layer's decode step,
each counted from 0 just before each ``main``, no K2.

Then the training phases beyond dense fp32 (``FAMILY_RUNS``), each on two
ranks sharing the card over gloo, mesh (2, 1, 1), the int8 slow tier (K2 on
every slow chunk) and ZeRO-1 AdamW, with every kernel's launches a rank a
step checked against the count the code gives, finite losses, parameters
bit-equal over the ranks after every step, step times, tokens a second and
peak memory a rank: ``[train-bf16]`` full-width qwen2-0.5b, B=2 S=2048 a
rank, 2 steps each of (a) bf16/bf16 and (b) bf16 parameters with fp32
compute, both ``remat="full"`` (K1's bf16 body in (a), its fp32 body in
(b), 48 a rank a step), a bf16 checkpoint at step 2 restored on a fresh
model bit for bit; ``[train-moe]`` deepseek-moe-16b at every published
width, cut to 2 layers (``configs.one_card_train_arch``: a third adds
about 18.8 GB over the two ranks), bf16, B=1 S=2048 a rank, 1 step, its
CE and aux parts and dropped slots; ``[train-rwkv]`` rwkv6-1.6b at every
width, cut to 2 of its 24 layers,
bf16, B=1 S=1024 a rank, 1 step, K3 in every layer's forward and
recompute (4 a rank a step; the backward recomputes the plain
recurrence); ``[train-jamba]`` one full-width Mamba
layer of the jamba cut (B=1 S=1024), forward and backward through K4's autograd wrapper
against the plain path's gradients in fp32 and bf16, then the jamba smoke
model with its experts, 1 step, K4 and K1 in the forward and recompute;
``[train-whisper]`` whisper-medium at every width, cut to 2 of its 24
encoder and 24 decoder layers, in fp32, ``remat="full"``, B=2 S=448 a
rank with its frames from the data pipeline, 2 steps, K1's fp32 body in
every decoder layer's forward and recompute (4 a rank a step), step 0's
loss held to the masked step's at 1e-4 relative, an fp32 checkpoint at
step 2 restored bit for bit.

Last, tensor parallelism and the GSPMD step, four ranks sharing the card
over gloo, each holding its block of every leaf: ``[train-tp]`` the CLI
with a model axis of 2, full-width qwen2-0.5b in fp32 on (pod, data,
model) = (2, 1, 2), the int8 slow tier on each member's local blocks, 1
step of ``[train]``'s global batch, K1 on 7 local heads (24 a rank a
step) and K2 as the local plan counts it, step 0's loss held to
``[train]``'s at 1e-4; ``[train-gspmd]`` qwen3-1.7b at every width, cut
to 2 of its 28 layers, in bf16, ``remat="full"``, FSDP over data x TP
over model on (1, 2, 2), B=1 S=2048 a DP member, 2 steps, K1 on 8 local
heads (8 a rank a step), step 0's loss held to one unsharded forward and
backward on the global batch at 1e-3 and its gradient norms (the whole
model's and the leaves nearest the loss) at 1e-2 relative, and its
step-2 checkpoint (under ``build/ckpt_gspmd``, deleted after) restored
into a fresh model bit for bit; ``[train-gspmd-rwkv]`` full-width
rwkv6-1.6b at 2 of its 24 layers, bf16 parameters with fp32 compute, FSDP x TP on (1, 2,
2), B=1 S=512 a DP member, 2 steps, K3 on 16 local heads (4 a rank a
step), step 0's loss held to an unsharded step's at 1e-3, its gradient
norm one layer from the loss at 1e-2 and the whole model's at 3e-2, each
layer's printed (``grad_norms``); and
``[train-tp-hybrid]``: (a) the jamba smoke with its experts in the
DFabric step on (2, 1, 2) with the int8 slow tier, (b) in the GSPMD step
on (1, 2, 2), (c) the rwkv6 smoke in the DFabric step on (2, 1, 2), 2
steps each, every kernel's launches checked; (d) one full-width Mamba
layer of the jamba cut over model = 2 (8192 channels a member, K4 on
them), fp32 on one DP member and bf16 on the other, its gradients put
together against the unsharded layer's with K4 in this process (1e-4 and
2e-2); (e) one deepseek-moe-16b MoE layer in fp32 under FSDP x TP, each DP
member one row of a 2-row batch routed as one batch: the members' dropped
slots summed equal to the unsharded layer's, the output within 1e-5.
Every block that two members hold alike (the replicated leaves over the
model members, every leaf over the pod members) is compared bit for bit
after every step.

Last, ``[cells]``: (a) the dry-run (``repro_torch.launch.dryrun``) of
every (arch x applicable shape) cell on both two-tier production meshes
with the default flags, 64 cells built on the meta device, one line each
(argument GB a member, model flops, collective bytes a member by tier; no
seconds); (b) one DP member's share of four cells of (pod, data, model) =
(2, 16, 16) at full width, the model axis folded onto the card, each with
the cell's settings and step kind (``Cell.bind``): qwen2-0.5b's
prefill_32k (B=1 S=32768 bf16, K1 in each of its 24 layers, then in fp32
at 4 layers held to the masked path at 1e-3), decode_32k (B=4 over a
32768-long cache, 8 steps, no kernel, finite logits, TPOT), rwkv6-1.6b's
long_500k (B=1, 8 steps at pos 524280 with K3, 24 a step, each launch
held to the plain recurrence on its own inputs at ``[K3]``'s tolerance;
then in fp32 each layer's drift between the K3 and the plain path at 24
layers, and the logits of the two paths held at 1e-3 at 4 layers) and
qwen2-0.5b's train_4k (two DP members over gloo on (2, 1, 1), 8 rows x
4096 a rank in 2 microbatches, bf16, ``remat="full"``, no codec, 1 step,
K1 96 a rank a step, parameters bit-equal over the ranks).

Last, ``[serve-mesh]``: serving over a mesh, 4 ranks sharing the card over
gloo in one spawn, each run one DP member's share of a cell of (pod, data,
model) = (2, 16, 16) with the cell's settings (``attn_impl="kernel"`` for
the prefill, ``use_kernel_ssm`` for the recurrences), its model axis cut
to the 4 ranks: (a) qwen3-1.7b's prefill_32k on (data, model) = (1, 4),
B=1 S=32768 bf16 at 4 of its 28 layers, K1 on each rank's 4 query heads
with the kv repeated (``gqa_repeat``), 4 a prefill; (b) its decode_32k at
that depth, B=4 over a
32768-long cache, 4 steps; (c) rwkv6-1.6b's long_500k, 4 steps, K3 on 8
of 32 heads, 24 a step, every launch against the plain recurrence; (d) the
jamba block's long_500k on (2, 2) under FSDP over data x TP, B=1, the
attention cache's 524,288 rows split over data (262,144 a member) and
its softmax combined over data, K4 on 8192 of 16384 channels, 7 a step,
1 step; the combine beside the whole ``attend_decode`` on random caches;
(e) the ``DecodeServer`` over (2, 2), 8 requests on 8 slots (4 a data
member), 8 new tokens each, every member's outputs equal.  Each run is
held against the one-member run on the card in fp32 at 2 layers (jamba:
a Mamba and its attention layer), at 1e-4 (rwkv6: 1e-3, each layer's
drift printed first; the server: the tokens equal); the bf16 gap of (a)
is printed; every run's check runs before the phase fails.

Last, ``[seq-par]``: the sequence split, the context-parallel cell and
MoE dispatch groups, 4 ranks sharing the card over gloo in one spawn,
published widths, K1 on the gathered sequence: (a) qwen2-0.5b's train_4k
cell with ``seq_shard`` at 12 of its 24 layers (the DFabric step with the
cell's settings, the residual stream's sequence split over model) on
(pod, data, model) = (1, 2, 2), B=1 S=4096 a DP member, bf16,
``remat="full"``, 1 step, K1 24 a rank a step at (1,7,4096,64); (b) qwen3-1.7b's train_4k cell with
``context_parallel`` (the GSPMD step, every block whole on both model
members, the fp32 moments under ``zero_moment_specs``) at 2 of its 28
layers on (1, 2, 2), 2 steps, K1 4 a rank a step at (1,16,4096,128),
each moment's block against its stand-in's; (c) qwen3-1.7b at 2 layers
under FSDP over data x TP over model with the nemotron cell's settings (``seq_axis``, ``batch_axes``),
fp32, 1 step; each of (a)-(c) with the blocks two members hold alike
bit-equal after every step and, in fp32 at 2 layers, step 0's loss within
1e-5 and gradient norm within 1e-4 of the same step without the split;
(d) qwen3-1.7b's prefill_32k cell with ``seq_shard`` at 2 of its 28
layers, one DP member on (data, model) = (1, 4), B=1 S=32768 bf16 timed
once, K1 2 a rank, the
cache the whole sequence, and in fp32 at 2 layers the logits within
atol = rtol = 1e-5 of the same prefill without the split; (e) one
deepseek-moe-16b MoE layer in fp32 in 2 dispatch groups of a 4-row global
batch over 4 DP members (each group spans two), the members' dropped slots
summed equal to the whole grouped layer's and each member's output within
1e-5 of its largest value.  Then the sequence split of the other
families, K1, K3 and K4 on the gathered sequence: (f) deepseek-moe-16b's
train_4k cell with ``seq_shard`` at 2 of its 28 layers and (g)
rwkv6-1.6b's at 2 of 24 (S=1024), the DFabric step on (1, 2, 2), bf16, 1
step, each with its fp32 hold at 2 layers ((f): the dropped slots equal
without the split, layer by layer); (h) the jamba smoke with its experts
under the GSPMD step with the split, 1 step, then one full-width Mamba
layer over model = 2 with the split (B=1 S=1024, each member's rows),
its assembled gradients through K4 against the plain layer's; (i)
whisper-medium at 2 + 2 of its 24 + 24 layers under the GSPMD step (FSDP
x TP) with the split, bf16, B=2 S=448 a DP member over its frames, 2
steps, its checkpoint restored bit for bit, and in fp32 at 2 + 2 layers
step 0's loss within 1e-5 of the DFabric step without the split; (j)
rwkv6-1.6b's prefill_32k cell with ``seq_shard`` on (1, 4) at 8 of its 24
layers, K3 8 a rank, and the jamba block's prefill at S=4096 on (1, 4), K4 7 and
K1 1 a rank, each in fp32 (rwkv6 at 4 layers over 8192 tokens, jamba a
Mamba layer and the attention layer) against the prefill without the
split (each recurrence's drift printed, the recurrent states in the
cache the whole sequence's); and one deepseek MoE layer with its experts
over model and each DP member's row routed with the batch's, through a
planned dispatch schedule (chunks 2, lane offset 1), bit-equal to the
unscheduled layer.

The ranks start once for each set of phases that share a world: the
``FAMILY_RUNS`` and ``[cells]``' train_4k share (2 ranks), and
``[train-tp]``, ``[train-gspmd]``, ``[train-gspmd-rwkv]``,
``[train-tp-hybrid]``, ``[serve-mesh]`` and ``[seq-par]`` (4 ranks, run
last, after ``[cells]``); each phase is checked in turn after its spawn.

Any failure raises and exits non-zero.  The last lines are the card
(``nvidia-smi``), one JSON object describing each kernel, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# NVIDIA H100 SXM data-sheet peaks (dense): FLOP/s by input type, bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SEED = 0
# exps a clock on the special-function units: 16 on each of the 132 SMs;
# at the 1.98 GHz boost clock unless a clock is measured
SFU_EXPS_PER_CLOCK = 16 * 132
BOOST_HZ = 1.98e9
B_MAIN, S_MAIN = 4, 2048  # the prefill shape of every path
#: the layers the MoE slice's decoders are served at, cut for the card's
#: time (PERF.md section 4 lists the cuts)
SERVE_LAYERS = {"deepseek-moe-16b": 14, "stablelm-12b": 20, "nemotron-4-340b": 2}
# each kernel's CUDA entry points (a regex), as ptxas names their
# instantiations, and the name of their integer template parameter; K1 has
# two bodies, the bf16 one on the tensor cores and the fp32 one on the CUDA
# cores
PTXAS_ENTRY = {"flash_attention_fwd": ("fa_(?:bf16_wgmma|f32_simt)_kernel", "hd"),
               "wkv6_fwd": ("wkv6_fwd_kernel", "hd"),
               "mamba_scan_fwd": ("mamba_scan_fwd_kernel", "ds"),
               "quantize_ef_fwd": ("quantize_ef_fwd_kernel", "block")}
# the training phase (``launch.train.ONE_CARD_RUN``): two ranks share the
# card, 4 steps of a 4 x 2048-token global batch, a checkpoint every 2; the
# checkpoint phase's crash comes right after the step-2 save
TRAIN_RANKS, TRAIN_STEPS, TRAIN_TOKENS = 2, 4, 4 * 2048
CKPT_EVERY, FAIL_AT = 2, 2
# the three-tier phase: 8 ranks share the card, mesh (pod, host, data,
# model) = (2, 2, 2, 1), full-width qwen2-0.5b in fp32, B=1 S=512 a rank;
# (a) the CLI with the top-k slow codec, (b) the mid-tier int8 codec
# through make_sync_plan + make_dfabric_train_step, then the collectives
# (a)'s steps cut from 3 to 2 to make room for whisper's phases, to 1 for
# the cells' phase; (b) keeps 2, so error feedback and the moments cross a
# step
TRAIN3_STEPS = 1
TRAIN3_ARGV = ["--arch", "qwen2-0.5b", "--mesh", "2,2,2,1", "--codec", "topk",
               "--steps", str(TRAIN3_STEPS), "--batch", "8", "--seq", "512",
               "--backend", "gloo", "--device", "cuda"]
TRAIN3_RANKS, TRAIN3_TOKENS, TRAIN3_MID_STEPS = 8, 8 * 512, 1
# one deepseek-moe-16b MoE layer's dispatch buffer at the serving shape
# (B=4 S=2048): 64 experts x C 960 x d_model 2048, bf16, as 8 rows
A2A_SHAPE = (64, 960, 2048)
RING_NUMEL = 151936 * 896  # qwen2-0.5b's embed gradient
# [train3] (e): RWKV6's time mix split inside its heads, in the same 8-rank
# world: rwkv6-1.6b's smoke (4 heads of 16, d 64) on a model axis of 8, each
# member holding 8 columns (half a head) of ``wr``/``wk``/``wv``/``wg`` and
# running every head's recurrence (K3 over all 4), fp32; its full-width form
# starts at a model axis of 64.  The DFabric and the GSPMD step with and
# without the sequence split, 8 rows of 32 (one DP member) for 2 steps, then
# prefill of 4 rows of 32 on (data, model) = (1, 8), with and without the
# split, and 4 decode steps; each held to the one-member run in the parent
SPLIT_HEADS_ARCH = "rwkv6-1.6b"
SPLIT_HEADS_SIZES = {"pod": 1, "data": 1, "model": 8}
SPLIT_HEADS_RUNS = {"dfabric": ("dfabric", {}),
                    "dfabric-sp": ("dfabric", dict(seq_axis="model")),
                    "gspmd": ("gspmd", {}),
                    "gspmd-sp": ("gspmd", dict(seq_axis="model",
                                               batch_axes=("pod", "data")))}
SPLIT_HEADS_ROWS, SPLIT_HEADS_SEQ, SPLIT_HEADS_STEPS = 8, 32, 2
SPLIT_HEADS_SERVE_ROWS, SPLIT_HEADS_DECODE = 4, 4
# [examples]: the four examples' twins (``examples/*_torch.py``), in one
# spawned process through their ``main(argv)``; ddp_train's checkpoints
# (≈ 0.8 GB each, 3 kept) go under build/
EXAMPLES_DIR = os.path.join(HERE, "examples")
EXAMPLES_SERVE_ARCHS = ("qwen2-0.5b", "rwkv6-1.6b", "jamba-1.5-large-398b",
                        "whisper-medium")
EXAMPLES_DDP_STEPS = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(text: str, kernel: str, param: str) -> str:
    """'<dtype> <param><N>[ <R>x<C>]: <regs> regs, <spill> B spilled' for
    each instantiation of the ``kernel<dtype, N, ...>`` template in ``nvcc
    -Xptxas -v`` output (the kernel's own name where the template has no
    dtype; further integer parameters, K3's micro-tile, joined by 'x')."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search("(" + kernel + r")I(f|13__nv_bfloat16)?Li(\d+)E((?:Li\d+E)*)(Lb([01])E)?",
                      line)
        if "Compiling entry function" in line and m:
            dtype = {"f": "fp32", "13__nv_bfloat16": "bf16", None: m.group(1)}[m.group(2)]
            name = f"{dtype} {param}{m.group(3)}"
            if m.group(4):
                name += " " + "x".join(re.findall(r"Li(\d+)E", m.group(4)))
            if m.group(6) is not None:
                name += " vec" if m.group(6) == "1" else " scalar"
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} regs, {spill} B spilled")
            name = None
    return "; ".join(out)


def spill_check(summary: str, key: str, what: str) -> None:
    """Raise unless every instantiation in ``summary`` (``ptxas_summary``)
    whose name holds ``key`` compiled without spilling."""
    entries = [e for e in summary.split("; ") if key in e]
    if not entries:
        raise AssertionError(f"no {what} instantiation in ptxas' output: {summary}")
    spilled = [e for e in entries if not e.endswith(" 0 B spilled")]
    if spilled:
        raise AssertionError(f"{what} instantiations spill: {spilled}")


def k3_spill_check(summary: str) -> None:
    """Raise unless every hd-64 instantiation of K3 (the rwkv6 path's)
    compiled without spilling."""
    spill_check(summary, " hd64 ", "K3 hd-64")


def k4_spill_check(summary: str) -> None:
    """Raise unless every d_state-16 instantiation of K4 (the jamba path's)
    compiled without spilling."""
    spill_check(summary, " ds16 ", "K4 ds-16")


def sm_clock_mhz(fn, dev, seconds: float = 0.5) -> list:
    """The SM clock of the card ``dev`` names (``nvidia-smi`` clocks.sm,
    MHz, the card found by its UUID), sampled every ~50 ms while ``fn``
    runs back to back for ``seconds``."""
    import threading
    import torch
    uuid = str(torch.cuda.get_device_properties(dev).uuid).removeprefix("GPU-")

    def read() -> int:
        out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,clocks.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout
        rows = [r.split(",") for r in out.strip().splitlines()]
        mhz = [int(c) for u, c in rows if u.strip().removeprefix("GPU-") == uuid]
        if len(mhz) != 1:
            raise RuntimeError(f"no card of UUID {uuid} in nvidia-smi's {out!r}")
        return mhz[0]

    read()  # the card is found before the sampling starts
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(read())
            time.sleep(0.05)

    thread = threading.Thread(target=sample)
    thread.start()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        fn()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    return samples


def k1_sass_check(lib) -> str:
    """Count, in K1's compiled library (``cuobjdump -sass``), the tensor-core
    (HGMMA, HMMA), TMA-load (UTMALDG), async-copy (LDGSTS) and FFMA
    instructions of each instantiation; raises unless every bf16 one issues
    wgmma and TMA loads and no fp32 one touches a tensor core."""
    from repro_torch.kernels._build import find_nvcc
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "FFMA")
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*(fa_(?:bf16_wgmma|f32_simt))_kernelILi(\d+)E", line)
        if m:
            fn = f"{m.group(1)} hd{m.group(2)}"
            counts[fn] = dict.fromkeys(ops, 0)
        elif "Function :" in line:
            fn = None
        elif fn:
            for op in ops:
                counts[fn][op] += len(re.findall(r"\b" + op + r"\b", line))
    if len(counts) != 14:
        raise AssertionError(f"K1's library holds {sorted(counts)}, not 7 head "
                             f"dims x 2 bodies")
    for fn, c in counts.items():
        bf16 = fn.startswith("fa_bf16")
        if (bf16 and not (c["HGMMA"] and c["UTMALDG"])) or \
                (not bf16 and (c["HGMMA"] or c["HMMA"])):
            raise AssertionError(f"K1 {fn}: {c}")
    return "; ".join(f"{fn} " + " ".join(f"{op}={n}" for op, n in c.items() if n)
                     for fn, c in sorted(counts.items()))


def time_ms(fn, iters: int, warmup: int = 2, repeats: int = 3) -> float:
    """Device time of one call: the mean over ``iters`` calls between CUDA
    events, taken ``repeats`` times; the median of those, so that a batch
    run while the card's clocks still ramp up does not count."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_ms(fn, n: int) -> list:
    """Host wall time of ``n`` calls, each ending in a synchronize."""
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def bound(flops: float, nbytes: float, flops_type: str):
    """(least ms for the work, what bounds it): the larger of the operations
    over the peak rate for their type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[flops_type], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound_ms(B, H, KV, S, hd, causal, dtype_name):
    """Each input read once, the output written once, and 4*hd FLOPs per
    (query, key) pair that the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * B * H * S * hd + 2 * B * KV * S * hd) * itemsize
    return bound(4.0 * B * H * hd * pairs, nbytes, dtype_name)


def wkv6_bound_ms(B, H, S, hd, dtype_name):
    """r, k, v in ``dtype_name`` and w fp32 read once, y fp32 written once,
    s0 read and sT written once (fp32), u read once; 5 fp32 FLOPs per
    (t, i, j): the multiply-add of y's dot product over the state, and the
    state's decay multiply-add with the k v^T outer product's multiply."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    n = B * H * S * hd
    nbytes = 3 * n * itemsize + 2 * n * 4 + 2 * B * H * hd * hd * 4 + H * hd * 4
    return bound(5.0 * n * hd, nbytes, "float32")


def mamba_scan_bound_ms(B, S, di, ds, dtype_name, clock_hz=BOOST_HZ):
    """u, dt, B, C in ``dtype_name`` and A, D, h0 fp32 read once, y fp32 and
    hT written once; 6 fp32 FLOPs per (b, t, d, s): dt*A, the state's
    multiply-add, dt*u*B's multiply, and y's multiply-add over the state.
    Also returns the SFU floor at ``clock_hz``: one exp per (b, t, d, s) on
    the special-function units (not part of the bound)."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    n = B * S * di
    nbytes = (2 * n + 2 * B * S * ds) * itemsize + 4 * n \
        + 2 * B * di * ds * 4 + di * ds * 4 + di * 4
    bound_ms, bound_by = bound(6.0 * n * ds, nbytes, "float32")
    return bound_ms, bound_by, n * ds / (SFU_EXPS_PER_CLOCK * clock_hz) * 1e3


def drive_path(counters: dict, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before it;
    returns (fn's result, {kernel name: launches in that run})."""
    import torch
    for mod in counters.values():
        mod.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: mod.LAUNCHES for name, mod in counters.items()}


def serve(model, arch, counters):
    """16 requests of 4-token prompts, 8 slots, max_seq 256, 32 new tokens,
    greedy; returns (server, launches) after checking every request ended."""
    import numpy as np
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    server = DecodeServer(model, "cuda", batch_slots=8, max_seq=256)
    rng = np.random.default_rng(SEED)
    for i in range(16):
        server.submit(Request(uid=i, prompt=rng.integers(0, arch.vocab, 4).astype(np.int32),
                              max_new=32))
    outs, launches = drive_path(counters, lambda: server.run(max_steps=255))
    if not (len(outs) == 16 and all(r.done and len(r.generated) == 32
                                    for r in server.all_requests)):
        raise AssertionError(f"{arch.name}: not every served request finished")
    return server, launches


def serve_line(name, server, launches) -> str:
    lat = server.latency_summary()
    return (f"[serve] {name} 16 requests, 8 slots, max_seq 256, max_new 32, "
            f"greedy, bf16: tokens={server.stats['tokens']} "
            f"steps={server.stats['steps']} wall_s={server.stats['wall']:.3f} "
            f"tok/s={server.throughput():.1f} "
            f"ttft_p50_ms={lat['ttft_p50_s'] * 1e3:.2f} ttft_p99_ms={lat['ttft_p99_s'] * 1e3:.2f} "
            f"tpot_p50_ms={lat['tpot_p50_s'] * 1e3:.2f} tpot_p99_ms={lat['tpot_p99_s'] * 1e3:.2f} "
            f"launches={launches}")


def check_flash_attention(torch, gen, dev, arch, jamba, mains=(), trains=(),
                          locals_=()):
    """K1 against its plain version at the qwen2 and jamba paths' prefill
    shapes, at those of ``mains`` ((case name, arch) of the other serving
    paths), at the training paths' ``trains`` ((case name, rows a rank,
    arch, seq, dtype)), at ``locals_`` ((case name, B, local heads, local
    kv heads, seq, head dim, dtype) of a model member under TP) and others.
    Returns the per-case results."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    H, KV, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    cases = [  # name, B, H, KV, S, hd, causal, dtype
        ("main-bf16", B_MAIN, H, KV, S_MAIN, hd, True, "bfloat16"),
        ("main-fp32", B_MAIN, H, KV, S_MAIN, hd, True, "float32"),
        # the training path's shape: 2 rows a rank, fp32
        ("main-train-fp32", 2, H, KV, S_MAIN, hd, True, "float32"),
        # the three-tier path's (TRAIN3_ARGV): 1 row of 512 a rank, fp32
        ("main-train3-fp32", 1, H, KV, 512, hd, True, "float32"),
        ("main-jamba", B_MAIN, jamba.n_heads, jamba.n_kv_heads, S_MAIN,
         jamba.resolved_head_dim, True, "bfloat16"),
        *((name, B_MAIN, a.n_heads, a.n_kv_heads, S_MAIN, a.resolved_head_dim,
           True, "bfloat16") for name, a in mains),
        *((name, B, a.n_heads, a.n_kv_heads, S, a.resolved_head_dim, True, dt)
          for name, B, a, S, dt in trains),
        *((name, B, Hl, KVl, S, d, True, dt) for name, B, Hl, KVl, S, d, dt in locals_),
        ("hd128", 2, 8, 2, 1024, 128, True, "float32"),
        ("hd192", 1, 8, 1, 512, 192, True, "bfloat16"),
        ("hd160", 1, 4, 2, 130, 160, True, "bfloat16"),
        ("hd24", 1, 4, 2, 100, 24, False, "float32"),
        ("hd16", 2, 4, 2, 64, 16, True, "float32"),
        ("ragged-S200", 2, H, KV, 200, hd, True, "float32"),
        ("noncausal", 2, H, KV, 512, hd, False, "bfloat16"),
        ("G1", 2, 4, 4, 333, hd, True, "float32"),
        # the bf16 body's other swizzle widths and its padded head dims
        ("hd16-bf16", 2, 4, 2, 256, 16, True, "bfloat16"),
        ("hd24-bf16", 1, 4, 2, 100, 24, False, "bfloat16"),
        ("hd32-bf16", 2, 8, 2, 333, 32, True, "bfloat16"),
        ("hd128-bf16", 2, 8, 2, 1024, 128, True, "bfloat16"),
        # ragged S just past a 64-row q tile and a 128-key kv tile
        ("ragged-S65", 2, H, KV, 65, hd, True, "bfloat16"),
        ("ragged-S129", 2, H, KV, 129, hd, True, "bfloat16"),
    ]
    results = {}
    for name, B, Hc, KVc, S, d, causal, dt_name in cases:
        dt = getattr(torch, dt_name)
        main = name.startswith("main")

        def draw(heads):
            # the main-path cases take the strided (B, heads, S, hd) views of
            # (B, S, heads, hd) memory that prefill hands the kernel
            if main:
                t = torch.randn(B, S, heads, d, generator=gen, device=dev)
                return t.to(dt).transpose(1, 2)
            return torch.randn(B, heads, S, d, generator=gen, device=dev).to(dt)

        q, k, v = draw(Hc), draw(KVc), draw(KVc)
        # attention_ref holds B x H x S x S fp32 scores; past 16 GB (the
        # prefill_32k cell's 60 GB) the plain version is the chunked masked
        # attention that the model's plain prefill runs, on the same views
        chunked = B * Hc * S * S * 4 > 16e9

        def plain():
            if chunked:
                from repro_torch.models import layers as L
                return L.attend(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                impl="masked").transpose(1, 2)
            return attention_ref(q, k, v, causal=causal)

        out = fa_kernel.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol[dt_name],
                                   rtol=tol[dt_name], msg=lambda m: f"{name}: {m}")
        kernel_ms = time_ms(lambda: fa_kernel.flash_attention_fwd(q, k, v, causal=causal),
                            iters=20 if main else 10)
        # the chunked plain version (0.7-0.9 s a call), warm from the check
        # above, is timed once
        plain_ms = (time_ms(plain, iters=1, warmup=0, repeats=1) if chunked else
                    time_ms(plain, iters=5 if main else 10))
        # yardstick only: one PyTorch call for the same function (SDPA on
        # k/v repeated per q head beforehand); the port never calls it
        kr = k.repeat_interleave(Hc // KVc, dim=1)
        vr = v.repeat_interleave(Hc // KVc, dim=1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=causal), iters=20 if main else 10)
        bound_ms, bound_by = attention_bound_ms(B, Hc, KVc, S, d, causal, dt_name)
        results[name] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
        log(f"[K1] {name:14s} q=({B},{Hc},{S},{d}){' strided' if main else ''} "
            f"kv={KVc} causal={causal}{' plain=chunked masked' if chunked else ''} "
            f"{dt_name}: max_err={err:.3e} (tol {tol[dt_name]}) "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} ratio_to_library={kernel_ms / library_ms:.3f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
        del q, k, v, kr, vr, out, ref
    return results


def check_wkv6(torch, gen, dev, arch):
    """K3 against its plain version at the rwkv6 path's shapes (prefill at
    B=4 and B=1, and decode), ragged S and the other head sizes.  Returns
    the per-case results."""
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.configs import get_smoke_arch
    H, hd = arch.d_model // arch.rwkv.head_size, arch.rwkv.head_size
    smoke = get_smoke_arch(SPLIT_HEADS_ARCH)
    Hs, hds = smoke.d_model // smoke.rwkv.head_size, smoke.rwkv.head_size
    S_member = GSPMD_RUNS["train-gspmd-rwkv"]["seq"]
    cases = [  # name, B, H, S, hd, r/k/v dtype; every case in the model layout
        ("main-bf16", B_MAIN, H, S_MAIN, hd, "bfloat16"),
        ("main-fp32", B_MAIN, H, S_MAIN, hd, "float32"),
        ("decode-S1", 8, H, 1, hd, "bfloat16"),
        ("main-cells-long", 1, H, 1, hd, "bfloat16"),  # [cells] long_500k's row
        # [serve-mesh] (c): that row on a model member's 8 heads of 32
        ("main-serve-mesh-long", 1, H // 4, 1, hd, "bfloat16"),
        ("prefill-B1", 1, H, S_MAIN, hd, "bfloat16"),  # splits each head's columns
        # [train-gspmd-rwkv]: a model member's 16 heads at that run's S,
        # fp32 compute (its main path), and bf16
        ("main-train-member", 1, H // 2, S_member, hd, "float32"),
        ("member-bf16", 1, H // 2, S_member, hd, "bfloat16"),
        # [seq-par] (g): a model member's 16 heads over the gathered
        # sequence, and its fp32 hold's; (j): 8 heads at model = 4 over the
        # gathered 32768 of the prefill_32k cell, bf16 and the fp32 hold's
        ("main-seq-par-g", 1, H // 2, SEQ_PAR_TRAIN["g"].seq, hd, "bfloat16"),
        ("main-seq-par-g-fp32", 1, H // 2, SEQ_PAR_TRAIN["g"].fp32_seq, hd, "float32"),
        ("main-seq-par-j", 1, H // 4, 32768, hd, "bfloat16"),
        ("main-seq-par-j-fp32", 1, H // 4, SEQ_PAR_RWKV_FP32_SEQ, hd, "float32"),
        # [train3] (e): every head of the smoke on every member of model = 8,
        # fp32; [examples]: a decode step of serve_decode_torch's 4 slots
        ("main-split-heads", SPLIT_HEADS_ROWS, Hs, SPLIT_HEADS_SEQ, hds, "float32"),
        ("main-examples-serve", 4, Hs, 1, hds, "float32"),
        ("ragged-S40", 2, H, 40, hd, "float32"),
        ("ragged-S100", 2, H, 100, hd, "bfloat16"),
        ("ragged-S333", 2, H, 333, hd, "float32"),
        ("hd16", 2, 8, 256, 16, "float32"),
        ("hd32", 2, 8, 256, 32, "bfloat16"),
    ]
    results = {}
    for name, B, Hc, S, d, dt_name in cases:
        dt = getattr(torch, dt_name)

        def draw(scale=1.0):
            # (B, S, H, hd) memory viewed as (B, H, S, hd), as prefill does
            return (torch.randn(B, S, Hc, d, generator=gen, device=dev) * scale
                    ).transpose(1, 2)

        r, k, v = draw().to(dt), draw().to(dt), draw().to(dt)
        w = torch.exp(-torch.exp(draw(0.5)))  # the JAX test's decay draw
        u = torch.randn(Hc, d, generator=gen, device=dev) * 0.1
        s0 = torch.randn(B, Hc, d, d, generator=gen, device=dev) * 0.1
        y, sT = wkv_kernel.wkv6_fwd(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ey, es = wkv6_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        check_ms = (time.perf_counter() - t0) * 1e3
        err = max((y - ey).abs().max().item(), (sT - es).abs().max().item())
        # tests/test_kernels.py::test_wkv6's tolerance, scaled by the output
        atol = 2e-5 * (ey.abs().max().item() + 1.0)
        for got, exp in ((y, ey), (sT, es)):
            torch.testing.assert_close(got, exp, rtol=1e-4, atol=atol,
                                       msg=lambda m: f"{name}: {m}")
        kernel_ms = time_ms(lambda: wkv_kernel.wkv6_fwd(r, k, v, w, u, s0),
                            iters=20)
        # the plain recurrence is a loop over S: from S=1000 on (0.1-0.3 s a
        # call) timed once, warm from the check; past S=4096 (1-3.5 s a
        # call) the check's own call, cold
        cold = S > 4096
        plain_ms = check_ms if cold else time_ms(
            lambda: wkv6_ref(r, k, v, w, u, s0),
            **(dict(iters=1, warmup=0, repeats=1) if S >= 1000
               else dict(iters=3, warmup=1)))
        bound_ms, bound_by = wkv6_bound_ms(B, Hc, S, d, dt_name)
        results[name] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
        cfg = wkv_kernel.launch_config(B, Hc, S, d, dt)
        log(f"[K3] {name:12s} (B,H,S,hd)=({B},{Hc},{S},{d}) strided r/k/v "
            f"{dt_name}: max_err={err:.3e} (atol {atol:.2e}, rtol 1e-4) "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f}{' (cold)' if cold else ''} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) "
            f"ratio_to_bound={kernel_ms / bound_ms:.2f} | {cfg.rows}x{cfg.cols} "
            f"nj={cfg.nj} tile={cfg.tile} stages={cfg.stages} "
            f"threads={cfg.threads} blocks={cfg.blocks}")
        del r, k, v, w, u, s0, y, sT, ey, es
    return results


def check_mamba_scan(torch, gen, dev, arch):
    """K4 against its plain version at the jamba path's shapes (prefill and
    decode, B and C as the strided column slices of the model's projection),
    ragged S and the other state sizes, drawn as the JAX test draws.
    Returns the per-case results."""
    import torch.nn.functional as F
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    m = arch.mamba
    di, dtr = m.expand * arch.d_model, m.resolved_dt_rank(arch.d_model)
    cases = [  # name, B, S, di, ds, u/dt/B/C dtype
        ("main-bf16", B_MAIN, S_MAIN, di, m.d_state, "bfloat16"),
        ("main-fp32", B_MAIN, S_MAIN, di, m.d_state, "float32"),
        # [train-jamba]: one full-width layer's training shape, and the
        # smoke model's (d_model 64, d_state 4, 2 rows of 512 a rank)
        ("main-train-B1", 1, MAMBA_LAYER_SEQ, di, m.d_state, "bfloat16"),
        ("main-train-smoke", 2, 512, 128, 4, "bfloat16"),
        # [train-tp-hybrid] (d): a model member's 8192 channels of that layer
        # ([seq-par] (h) over the gathered sequence too), and in fp32
        ("main-train-member", 1, MAMBA_LAYER_SEQ, di // 2, m.d_state, "bfloat16"),
        ("main-seq-par-h-fp32", 1, MAMBA_LAYER_SEQ, di // 2, m.d_state, "float32"),
        # [seq-par] (h): the jamba smoke's 64 of 128 channels, 2 rows of 512;
        # (j): the block's prefill, 4096 channels at model = 4 over the
        # gathered 4096, bf16 and the fp32 hold's
        ("main-seq-par-h-smoke", 2, 512, 64, 4, "bfloat16"),
        ("main-seq-par-j", 1, SEQ_PAR_JAMBA_PREFILL_SEQ, di // 4, m.d_state, "bfloat16"),
        ("main-seq-par-j-fp32", 1, SEQ_PAR_JAMBA_PREFILL_SEQ, di // 4, m.d_state,
         "float32"),
        ("decode-S1", 8, 1, di, m.d_state, "bfloat16"),
        # [examples]: a decode step of serve_decode_torch's 4 slots on the
        # jamba smoke (d_model 64: 128 channels, d_state 4), fp32
        ("main-examples-serve", 4, 1, 128, 4, "float32"),
        # [serve-mesh] (d): a decode step of one row on a member's channels
        ("main-serve-mesh-long", 1, 1, di // 2, m.d_state, "bfloat16"),
        ("ragged-S40", 2, 40, di, m.d_state, "float32"),
        ("ragged-S100", 2, 100, di, m.d_state, "bfloat16"),
        ("ragged-S333", 2, 333, di, m.d_state, "float32"),
        ("ds4", 2, 256, 4096, 4, "float32"),
        ("ds8", 2, 256, 4096, 8, "bfloat16"),
        # the model's long-memory draw (models/ssm.py's init: A = -(1..16),
        # dt ~ 0.018), where the exps' errors are summed longest
        ("long-memory", 2, S_MAIN, di, m.d_state, "float32"),
    ]
    results = {}
    for name, B, S, d, ds, dt_name in cases:
        dt = getattr(torch, dt_name)
        u = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
        if name == "long-memory":
            delta = F.softplus(-4 + 0.1 * torch.randn(B, S, d, generator=gen, device=dev)).to(dt)
            A = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).repeat(d, 1)
        else:
            delta = F.softplus(torch.randn(B, S, d, generator=gen, device=dev) - 2).to(dt)
            A = -torch.exp(torch.randn(d, ds, generator=gen, device=dev) * 0.3)
        # B and C: column slices of a (B, S, dt_rank + 2 ds) projection
        xdbl = torch.randn(B, S, dtr + 2 * ds, generator=gen, device=dev).to(dt)
        Bc, Cc = xdbl[..., dtr:dtr + ds], xdbl[..., dtr + ds:]
        D = torch.ones(d, device=dev)
        h0 = torch.randn(B, d, ds, generator=gen, device=dev) * 0.1
        args = (u, delta, A, Bc, Cc, D, h0)
        y, hT = ms_kernel.mamba_scan_fwd(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ey, eh = mamba_scan_ref(*args)
        torch.cuda.synchronize()
        check_ms = (time.perf_counter() - t0) * 1e3
        err = max((y - ey).abs().max().item(), (hT - eh).abs().max().item())
        for got, exp in ((y, ey), (hT, eh)):  # tests/test_kernels.py's tolerance
            torch.testing.assert_close(got, exp, rtol=1e-4, atol=1e-4,
                                       msg=lambda msg: f"{name}: {msg}")
        kernel_ms = time_ms(lambda: ms_kernel.mamba_scan_fwd(*args), iters=20)
        # from S=1000 on (0.2-0.4 s a call) timed once, warm from the check;
        # past S=4096 (1-1.4 s a call) the check's own call, cold
        cold = S > 4096
        plain_ms = check_ms if cold else time_ms(
            lambda: mamba_scan_ref(*args),
            **(dict(iters=1, warmup=0, repeats=1) if S >= 1000
               else dict(iters=3, warmup=1)))
        bound_ms, bound_by, sfu_ms = mamba_scan_bound_ms(B, S, d, ds, dt_name)
        results[name] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
        cfg = ms_kernel.launch_config(B, S, d, ds, dt)
        line = (f"[K4] {name:12s} (B,S,di,ds)=({B},{S},{d},{ds}) strided B/C "
                f"{dt_name}: max_err={err:.3e} (atol=rtol=1e-4) "
                f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f}{' (cold)' if cold else ''} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) "
                f"ratio_to_bound={kernel_ms / bound_ms:.2f} "
                f"sfu_floor_ms={sfu_ms:.4f} (at 1.98 GHz)")
        if name.startswith("main"):
            # the SM clock the kernel runs at, and the SFU floor there
            mhz = sm_clock_mhz(lambda: ms_kernel.mamba_scan_fwd(*args), dev)
            clock = statistics.median(mhz)
            at_clock = mamba_scan_bound_ms(B, S, d, ds, dt_name, clock * 1e6)[2]
            line += (f" sm_clock_mhz median={clock:.0f} samples={mhz} "
                     f"sfu_floor_ms_at_clock={at_clock:.4f}")
        log(line + f" | KP={cfg.poly} threads={cfg.threads} "
            f"tile={cfg.tile} smem={cfg.smem} blocks={cfg.blocks}")
        del u, delta, A, xdbl, Bc, Cc, D, h0, y, hT, ey, eh
    x = torch.linspace(-126.0, 127.0, 2_000_001, device=dev)
    rel = ((ms_kernel.exp2_poly(x).double() - torch.exp2(x.double())).abs()
           / torch.exp2(x.double())).max().item()
    ends = ms_kernel.exp2_poly(torch.tensor([128.0, -127.0, 0.0], device=dev)).tolist()
    log(f"[K4] exp2_poly on the card: max rel err {rel:.3e} over [-126, 127] "
        f"(limit 3e-7); 2^128, 2^-127, 2^0 = {ends}")
    if rel > 3e-7 or ends != [float("inf"), 0.0, 1.0]:
        raise AssertionError("the kernel's polynomial exp2 is off")
    return results


def quantize_bound_ms(n, block, dtype_name):
    """x read once, q, the scales and err written once; ~3 fp32 FLOPs an
    element (a division, a rounding, a multiply-subtract)."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    return bound(3.0 * n, n * itemsize + n + 4 * (n // block) + 4 * n, "float32")


def qwen_plan(sizes):
    """The shared planner's int8 plan for full-width qwen2-0.5b (fp32) on a
    mesh of ``sizes``, built on the meta device (no memory); with a model
    axis its sections come from each model member's local shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.core.topology import topology_from_mesh_sizes
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import make_sync_plan
    model = build_model(get_arch("qwen2-0.5b"),
                        ModelSettings(param_dtype="float32", compute_dtype="float32"),
                        device="meta")
    plan, _ = make_sync_plan(model, sizes, topology_from_mesh_sizes(sizes),
                             codec="int8")
    return plan


def plan_slow_chunks(sizes) -> int:
    """The int8 slow chunks (K2 launches) of one training step of
    full-width qwen2-0.5b on a mesh of ``sizes``."""
    return sum(len(s.schedule.slow_legs) for s in qwen_plan(sizes).sections)


def train_sections():
    """The padded slow-leg sizes of the training path's 9 sections: the
    plan for full-width qwen2-0.5b on (pod, data, model) = (2, 1, 1)."""
    plan = qwen_plan({"pod": 2, "data": 1, "model": 1})
    return {s.name: s.numel + (-s.numel) % s.sync.codec_block
            for s in plan.sections}


def train3_k2_sizes():
    """{case: padded input size} of every K2 launch in ``[train3]`` (b):
    each section's host reduce-scatter (its data-scattered shard) and
    slow chunk (its fully scattered shard over the chunks), from
    ``mid_tier_plans``' run plan for full-width qwen2-0.5b (meta device)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ModelSettings, build_model
    sizes = {"pod": 2, "host": 2, "data": 2, "model": 1}
    model = build_model(get_arch("qwen2-0.5b"),
                        ModelSettings(param_dtype="float32", compute_dtype="float32"),
                        device="meta")
    _, plan, _ = mid_tier_plans(model, sizes)
    out = {}
    for sec in plan.sections:
        sc, block = sec.schedule, sec.sync.codec_block
        for what, n in (("host", sc.numel // sizes["data"]),
                        ("slow", sc.numel // sc.scattered_prod // len(sc.slow_legs))):
            out[f"train3-{what}-{sec.name}"] = n + (-n) % block
    return out


def family_k2_sizes():
    """{case: padded input size} of every K2 launch of the ``FAMILY_RUNS``
    (each section's int8 slow chunks on (2, 1, 1)), from the plans of the
    runs' models built on the meta device; the largest of each run is
    timed."""
    from repro_torch.core.topology import topology_from_mesh_sizes
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import make_sync_plan
    out, largest = {}, set()
    for tag in FAMILY_RUNS:
        run = family_run(tag)
        model = build_model(family_arch(run.arch, run.depth)[0],
                            ModelSettings(**run.fields), device="meta")
        plan, _ = make_sync_plan(model, FAMILY_SIZES,
                                 topology_from_mesh_sizes(FAMILY_SIZES), codec="int8")
        sizes = {}
        for sec in plan.sections:
            n = sec.schedule.numel // len(sec.schedule.slow_legs)
            sizes[n + (-n) % sec.sync.codec_block] = sec.name
        seen = set(out.values())
        out.update({f"{tag}-{name}"[:60]: n for n, name in sizes.items()
                    if n not in seen})
        if max(sizes) not in seen:
            largest.add(f"{tag}-{sizes[max(sizes)]}"[:60])
    return out, largest


def check_quantize(torch, gen, dev):
    """K2 against its plain version, bit for bit on q, scales and err: the
    JAX test's sweep, the training path's 9 section sizes, those of the
    three-tier path's mid-codec run, exact halves with an all-zero block,
    an unaligned view and bf16 input.  Returns the per-case results."""
    from repro_torch.kernels.quantize import kernel as q_kernel
    from repro_torch.kernels.quantize.ref import quantize_ef_ref
    sections = train_sections()
    if len(sections) != 9 or sum(sections.values()) != 494_032_896:
        raise AssertionError(f"training plan changed: {sections}")
    cases = [(f"sweep-{n}-{b}", n, b, "float32", "randn") for n, b in
             ((8192, 512), (4096, 2048), (2048, 128))]
    cases += [(f"sec-{name}", n, 2048, "float32", "grad")
              for name, n in sorted(sections.items(), key=lambda kv: -kv[1])]
    cases += [(name, n, 2048, "float32", "grad")
              for name, n in sorted(train3_k2_sizes().items(), key=lambda kv: -kv[1])]
    fam_sizes, fam_timed = family_k2_sizes()
    cases += [(name, n, 2048, "float32", "grad")
              for name, n in sorted(fam_sizes.items(), key=lambda kv: -kv[1])]
    tp_sizes = tp_k2_sizes()
    fam_timed = set(fam_timed) | {max(tp_sizes, key=tp_sizes.get)}
    cases += [(name, n, 2048, "float32", "grad")
              for name, n in sorted(tp_sizes.items(), key=lambda kv: -kv[1])]
    cases += [("halves-512", 16 * 512, 512, "float32", "halves"),
              ("unaligned-512", 64 * 512, 512, "float32", "unaligned"),
              ("bf16-8192-512", 8192, 512, "bfloat16", "randn"),
              ("bf16-embed", sections["embed"], 2048, "bfloat16", "grad")]
    results = {}
    for name, n, block, dt_name, kind in cases:
        dt = getattr(torch, dt_name)
        if kind == "halves":  # x / scale = k + 0.5 exactly; block 0 all zero
            c = torch.exp2(torch.randint(-8, 4, (n // block, 1), generator=gen,
                                         device=dev).float())
            k = torch.randint(-127, 127, (n // block, block), generator=gen,
                              device=dev).float() + 0.5
            k[:, 0] = 127.0
            x = (k * c).reshape(-1)
            x[:block] = 0.0
        elif kind == "unaligned":  # a view 4 bytes past an aligned base
            x = torch.randn(n + 1, generator=gen, device=dev)[1:]
        else:  # gradients are small: scale like them
            x = torch.randn(n, generator=gen, device=dev) * (3.0 if kind == "randn" else 1e-3)
        x = x.to(dt)
        got = q_kernel.quantize_ef_fwd(x, block=block)
        torch.cuda.synchronize()
        want = quantize_ef_ref(x, block=block)
        for what, a, b in zip(("q", "scales", "err"), got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"[K2] {name}: {what} not bit-equal to the "
                                     f"plain version")
        err = (got[2] - want[2]).abs().max().item()
        line = (f"[K2] {name:30s} n={n} block={block} {dt_name}: q, scales, err "
                f"bit-equal (max_abs_err={err:.1e})")
        if name in ("sec-embed", "bf16-embed") or name in fam_timed:
            kernel_ms = time_ms(lambda: q_kernel.quantize_ef_fwd(x, block=block), iters=20)
            plain_ms = time_ms(lambda: quantize_ef_ref(x, block=block), iters=5)
            bound_ms, bound_by = quantize_bound_ms(n, block, dt_name)
            results[name] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=None)
            line += (f" kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                     f"bound_ms={bound_ms:.4f} ({bound_by})")
        log(line)
        del x, got, want
    return results


def train_args(ckpt_dir, mode):
    """The CLI arguments of a training-phase run: ``launch.train``'s
    ``ONE_CARD_RUN`` for 4 steps, checkpointing every 2 into ``ckpt_dir``
    (the elastic run on one rank, mesh (1, 1, 1))."""
    from repro_torch.launch import train as train_cli
    argv = train_cli.ONE_CARD_RUN + ["--steps", str(TRAIN_STEPS), "--ckpt-dir",
                                     ckpt_dir, "--ckpt-every", str(CKPT_EVERY)]
    if mode == "elastic":
        argv += ["--mesh", "1,1,1"]
    return train_cli.resolve_args(train_cli.build_parser().parse_args(argv))


def train_rank(rank, world, init_method, ckpt_dir, mode):
    """One rank of a training-phase run, the CLI's path (``run_rank``) with
    hooks that check it.  ``mode``: "ref" (the uninterrupted run), "crash"
    (``fail_at_step`` 2: ``SimulatedFailure`` after the step-2 save),
    "restart" (new ranks, which restore step 2) or "elastic" (one rank
    restores step 2 and runs one step).  Before training ("ref" only): the
    step-0 loss with the masked attention on the same weights and batch;
    then every launch count set to 0.  After each step: its K1 and K2
    launches, a finite loss, every rank's parameters bit-equal and a
    nonzero EF state."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.quantize import kernel as q_kernel
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime.train_loop import SimulatedFailure
    from repro_torch.utils.trees import tree_paths
    args = train_args(ckpt_dir, mode)
    rec = {"steps": [], "error": None}
    live = {}

    def before_train(trainer, params, opt):
        live["trainer"] = trainer
        if mode == "crash":
            trainer.cfg = dataclasses.replace(trainer.cfg, fail_at_step=FAIL_AT)
        if mode == "ref":
            model = trainer.model
            batch = {k: torch.from_numpy(v).to(model.device) for k, v in
                     trainer.local_batch(0).items()}
            kernel_st = model.settings
            model.settings = dataclasses.replace(kernel_st, attn_impl="masked")
            fa_before = fa_kernel.LAUNCHES
            with torch.no_grad():
                loss = model.loss(params, batch)
            model.settings = kernel_st
            if fa_kernel.LAUNCHES != fa_before:
                raise AssertionError("the masked path launched K1")
            dist.all_reduce(loss)
            rec["masked_loss0"] = loss.item() / world
        rec["mem_after_init_gb"] = torch.cuda.memory_allocated() / 1e9
        rec["restore_s"] = trainer.restore_s
        torch.cuda.reset_peak_memory_stats()
        fa_kernel.LAUNCHES = q_kernel.LAUNCHES = 0  # just before the path
        rec["last"] = (0, 0)
        live["t"] = time.perf_counter()

    def on_step(step, params, opt, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        launches = (fa_kernel.LAUNCHES - rec["last"][0],
                    q_kernel.LAUNCHES - rec["last"][1])
        equal = True
        for p in tree_paths(params).values():  # the DP invariant, exactly
            both = torch.empty((world * p.numel(),), dtype=p.dtype,
                               device=p.device)
            dist.all_gather_into_tensor(both, p.detach().reshape(-1))
            both = both.view(world, -1)
            equal = equal and all(torch.equal(both[0], both[r])
                                  for r in range(1, world))
            del both
        efs = [e["ef"] for e in opt["sections"].values() if "ef" in e]
        rec["steps"].append(dict(
            step=step, loss=metrics["loss"], grad_norm=metrics["grad_norm"],
            dt=metrics["dt"], wall=now - live["t"], fa=launches[0],
            q=launches[1], params_equal=equal, n_ef=len(efs),
            ef_nonzero=all(bool((e != 0).any()) for e in efs),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        rec["last"] = (fa_kernel.LAUNCHES, q_kernel.LAUNCHES)
        if mode == "elastic":  # one step, then stop (no save: step 3 is odd)
            live["trainer"].cfg = dataclasses.replace(live["trainer"].cfg,
                                                      steps=step + 1)
        live["t"] = time.perf_counter()

    try:
        train_cli.run_rank(args, rank, world, init_method, on_step=on_step,
                           before_train=before_train)
    except SimulatedFailure as exc:
        if mode != "crash":
            raise
        rec["error"] = type(exc).__name__
    trainer = live.pop("trainer")
    rec["fa_total"], rec["q_total"] = rec.pop("last")
    rec["n_params"] = sum(p.numel() for p in trainer.model.parameters())
    rec["n_sections"] = len(trainer.plan.sections)
    rec["slow_chunks"] = sum(len(s.schedule.slow_legs) for s in trainer.plan.sections)
    rec["ckpt_log"] = trainer.ckpt_log
    rec["writes"] = trainer.ckpt.stats  # member 0's
    return rec


def check_train_steps(tag, recs, world, slow_chunks):
    """Log and check each step of a training-phase run: 24 K1 launches a
    rank a step, ``slow_chunks`` K2 launches (9 on the two-rank mesh),
    finite losses, parameters bit-equal over the ranks, 9 nonzero EF
    states, and every rank agreeing on the (pmean) loss."""
    qwen_layers = 24
    for rank, rec in enumerate(recs):
        for st in rec["steps"]:
            log(f"[{tag}] rank {rank} step {st['step']}: loss={st['loss']:.6f} "
                f"grad_norm={st['grad_norm']:.4f} step_s={st['dt']:.3f} "
                f"tok/s={TRAIN_TOKENS / st['dt']:.0f} (global batch, "
                f"{world} rank{'s' if world > 1 else ''}) "
                f"launches flash_attention_fwd={st['fa']} quantize_ef_fwd={st['q']} "
                f"params_bit_equal={st['params_equal']} ef_nonzero={st['ef_nonzero']} "
                f"peak_mem_gb={st['peak_gb']:.2f}")
            if not (st["fa"] == qwen_layers and st["q"] == slow_chunks
                    and rec["slow_chunks"] == slow_chunks):
                raise AssertionError(f"[{tag}] rank {rank} step {st['step']} "
                                     f"launched K1 {st['fa']}, K2 {st['q']}; "
                                     f"expected {qwen_layers} and {slow_chunks}")
            if not (math.isfinite(st["loss"]) and st["params_equal"]
                    and st["ef_nonzero"] and st["n_ef"] == rec["n_sections"] == 9):
                raise AssertionError(f"[{tag}] rank {rank} step {st['step']}: {st}")
        if rec["n_params"] != 494_032_768:
            raise AssertionError(f"[{tag}] rank {rank}: {rec}")
    if any(abs(a["loss"] - b["loss"]) > 0
           for r in recs[1:] for a, b in zip(recs[0]["steps"], r["steps"])):
        raise AssertionError(f"[{tag}] the ranks disagree on the (pmean) loss")


def run_training(ckpt_root):
    """The training phase, run (a) of the checkpoint phase: two spawned
    ranks on the one card, 4 steps, a checkpoint every 2; returns the
    per-rank records after checking them."""
    from repro_torch.launch import train as train_cli
    recs = train_cli.run_ranks(train_rank, TRAIN_RANKS, os.path.join(ckpt_root, "ref"),
                               "ref", timeout=900)
    check_train_steps("train", recs, TRAIN_RANKS, 9)
    for rank, rec in enumerate(recs):
        if [st["step"] for st in rec["steps"]] != list(range(TRAIN_STEPS)):
            raise AssertionError(f"rank {rank}: {rec}")
        loss0 = rec["steps"][0]["loss"]
        rel = abs(rec["masked_loss0"] - loss0) / abs(loss0)
        log(f"[train] rank {rank}: step-0 loss with K1 {loss0!r}, with the masked "
            f"attention {rec['masked_loss0']!r} (rel diff {rel:.2e}, tol 1e-4); "
            f"memory after init {rec['mem_after_init_gb']:.2f} GB")
        if rel > 1e-4:
            raise AssertionError("the kernel path's step-0 loss is off the masked one")
    return recs


def plan_k2_launches(plan) -> int:
    """K2 launches a rank a step of ``plan``: one a mid-coded down leg and
    one an int8 slow chunk, each lowered once (true of ``mid_tier_plans``'
    run plan, whose sections all take the ZeRO-1 path; a pipelined
    all-reduce would lower its down legs once a chunk)."""
    return sum(1 for sec in plan.sections
               for leg in sec.schedule.down_legs + sec.schedule.slow_legs
               if leg.codec == "int8")


def mid_tier_plans(model, sizes):
    """Run (b)'s plans: the reference's call, ``make_sync_plan(model, sizes,
    three_tier_fabric(2, 2, 2), codec="int8", mid_codec="int8",
    strategy="hier_striped")``, and the plan (b) runs: the same sections,
    chunks, lane offsets and staging with every fast tier scattered (the
    host reduce-scatter int8-coded).  The planner codes the host tier as an
    unscattered psum, which sends those sections down the all-reduce path
    with AdamW moments of full size: ≈ 11 GB a rank, which 8 ranks on one
    80 GB card cannot hold; scattered, they take the ZeRO-1 path, as in (a).
    Returns (the planner's plan, the run's plan, the sync settings)."""
    from repro_torch.core.planner import SyncPlan
    from repro_torch.core.schedule import build_schedule
    from repro_torch.core.topology import three_tier_fabric
    from repro_torch.runtime.train_loop import make_sync_plan
    fab = three_tier_fabric(num_pods=sizes["pod"], hosts_per_pod=sizes["host"],
                            chips_per_host=sizes["data"])
    plan, ss = make_sync_plan(model, sizes, fab, codec="int8", mid_codec="int8",
                              strategy="hier_striped")
    sections = []
    for sec in plan.sections:
        cfg = dataclasses.replace(sec.sync, scatter_depth=-1, mid_codec="int8")
        sched = build_schedule(fab, cfg, sec.schedule.shape, max(sec.scatter_dim, 0),
                               dtype=sec.schedule.dtype,
                               fast_sizes=tuple(sizes[a] for a in ss.fast))
        sched = sched.with_lane_offset(sec.schedule.lane_offset) \
            .with_staging(sec.schedule.staging)
        sections.append(dataclasses.replace(sec, sync=cfg, schedule=sched))
    return plan, SyncPlan(sections), ss


def params_bit_equal(params) -> bool:
    """Every parameter's bytes equal to member 0's: member 0 broadcasts
    each leaf's bytes in 64 MB pieces (bytes, so that any dtype crosses
    gloo) and every member compares."""
    import torch
    import torch.distributed as dist
    from repro_torch.utils.trees import tree_paths
    equal = True
    for p in tree_paths(params).values():
        flat = p.detach().contiguous().view(torch.uint8).reshape(-1)
        for i in range(0, flat.numel(), 1 << 26):
            part = flat[i:i + (1 << 26)]
            buf = part.clone()
            dist.broadcast(buf, 0)
            equal = equal and torch.equal(buf, part)
    return equal


def train3_rank(rank, world, init_method):
    """One rank of the three-tier phase, in one process group:
    (a) ``launch.train``'s path with ``TRAIN3_ARGV`` (the top-k slow
    codec), each step's K1 and K2 launches, loss, parameters against
    member 0's, EF states and peak memory recorded; (b) the trainer's
    state freed, then ``TRAIN3_MID_STEPS`` steps of
    ``make_dfabric_train_step`` on the same model with ``mid_tier_plans``'
    run plan, recorded alike; (c) ``dfabric_all_to_all`` of a deepseek
    dispatch buffer at chunks 1/2/4 and every lane offset against one flat
    ``all_to_all_single``; (d) ``ring_all_reduce`` against ``prims.psum``
    on a second mesh, ``{"data": 8}``; (e) :func:`split_heads_runs` on a
    third, the model axis over all 8."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.core.collectives import dfabric_all_to_all, ring_all_reduce
    from repro_torch.core.schedule import SyncConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.quantize import kernel as q_kernel
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import grad_sync
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.runtime.train_loop import local_rows, make_dfabric_train_step

    args = train_cli.resolve_args(train_cli.build_parser().parse_args(TRAIN3_ARGV))
    rec = {"a": [], "b": []}
    live = {}

    def step_record(step, loss, dt, params, opt):
        torch.cuda.synchronize()
        launches = (fa_kernel.LAUNCHES - live["last"][0],
                    q_kernel.LAUNCHES - live["last"][1])
        t0 = time.perf_counter()
        equal = params_bit_equal(params)
        efs = [e["ef"] for e in opt["sections"].values() if "ef" in e]
        out = dict(step=step, loss=loss, dt=dt, fa=launches[0], q=launches[1],
                   params_equal=equal, check_s=time.perf_counter() - t0,
                   n_ef=len(efs), ef_nonzero=all(bool((e != 0).any()) for e in efs),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        live["last"] = (fa_kernel.LAUNCHES, q_kernel.LAUNCHES)
        return out

    def before_train(trainer, params, opt):
        torch.cuda.reset_peak_memory_stats()
        fa_kernel.LAUNCHES = q_kernel.LAUNCHES = 0  # just before the path
        live["last"] = (0, 0)

    def on_step(step, params, opt, metrics):
        rec["a"].append(step_record(step, metrics["loss"], metrics["dt"], params, opt))

    # (a) top-k through the CLI's path
    trainer, out = train_cli.run_rank(args, rank, world, init_method,
                                      on_step=on_step, before_train=before_train,
                                      keep_group=True)
    try:
        mesh, model, dev = trainer.mesh, trainer.model, trainer.model.device
        rec["a_sections"] = len(trainer.plan.sections)
        rec["a_codecs"] = sorted({s.sync.codec for s in trainer.plan.sections})
        rec["a_fa_total"], rec["a_q_total"] = live["last"]
        del trainer, out
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the mid-tier int8 codec, the reference's step API
        planned, plan, ss = mid_tier_plans(model, mesh.sizes)
        with prims.bind(mesh):
            for tag, pl in (("planned", planned), ("run", plan)):
                st = grad_sync.init_sync_state(pl, model.param_shapes(), ss,
                                               torch.device("meta"))
                rec[f"b_{tag}_state_gb"] = sum(
                    t.numel() * 4 for e in st["sections"].values()
                    for t in e.values()) / 1e9
        rec["b_planned"] = [s.schedule.describe() for s in planned.sections]
        rec["b_run"] = [s.schedule.describe() for s in plan.sections]
        rec["b_mid_legs"] = sum(1 for s in plan.sections for l in s.schedule.down_legs
                                if l.codec == "int8")
        rec["b_planned_mid_legs"] = sum(1 for s in planned.sections
                                        for l in s.schedule.down_legs if l.codec == "int8")
        rec["b_expected_q"] = plan_k2_launches(plan)
        step_fn, init_state = make_dfabric_train_step(
            model, mesh, plan, ss, AdamWConfig(),
            cosine_schedule(args.lr, 1, TRAIN3_MID_STEPS))
        model.requires_grad_(True)
        params, state = model.params(), init_state()
        pipe = TokenPipeline(model.arch, ShapeConfig("custom", args.seq, args.batch,
                                                     "train"), DataConfig(seed=0))
        torch.cuda.reset_peak_memory_stats()
        fa_kernel.LAUNCHES = q_kernel.LAUNCHES = 0  # just before the path
        live["last"] = (0, 0)
        for step in range(TRAIN3_MID_STEPS):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in local_rows(pipe.batch_at(step), mesh).items()}
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch, step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            rec["b"].append(step_record(step, loss, dt, params, state))
        rec["b_q_total"] = live["last"][1]
        del params, state, step_fn, init_state, model
        gc.collect()
        torch.cuda.empty_cache()

        # (c) all-to-all of a deepseek dispatch buffer, 8 rows a rank
        gen = torch.Generator(device=dev).manual_seed(SEED + rank)
        x = torch.randn(A2A_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
        x = x.view(world, -1)
        rec["a2a_bytes"] = x.numel() * x.element_size()

        def timed(fn):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize()
            return y, time.perf_counter() - t0

        def flat_a2a():
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            return y

        ref, flat_s = timed(flat_a2a)
        rec["a2a_flat_s"], rec["a2a"] = [flat_s], []
        with prims.bind(mesh):
            for chunks in (1, 2, 4):
                for off in range(chunks):
                    y, dt = timed(lambda: dfabric_all_to_all(
                        x, ("data", "host"), "pod", SyncConfig(chunks=chunks),
                        lane_offset=off))
                    rec["a2a"].append((chunks, off, dt, torch.equal(y, ref)))
                    del y
        again, flat_s = timed(flat_a2a)
        rec["a2a_flat_s"].append(flat_s)
        rec["a2a_flat_repeat_equal"] = torch.equal(again, ref)
        del x, ref, again

        # (d) ring all-reduce on a second mesh over the same ranks
        ring_mesh = prims.Mesh({"data": world})
        xr = torch.randint(-64, 64, (RING_NUMEL,), generator=gen, device=dev).float()
        with prims.bind(ring_mesh):
            ring, rec["ring_s"] = timed(lambda: ring_all_reduce(xr, "data", world))
            psum, rec["psum_s"] = timed(lambda: prims.psum(xr, "data"))
        rec["ring_equal"] = torch.equal(ring, psum)
        rec["ring_bytes"] = xr.numel() * 4
        del xr, ring, psum
        gc.collect()
        torch.cuda.empty_cache()

        # (e) RWKV6's time mix split inside its heads, model axis 8
        t0 = time.perf_counter()
        rec["e"] = split_heads_runs(torch, world)
        rec["e_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return rec


def run_train3(card):
    """The three-tier phase (``train3_rank`` on 8 ranks sharing the card):
    checks and logs each run."""
    import math as _m
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    recs = train_cli.run_ranks(train3_rank, TRAIN3_RANKS, timeout=900)
    log(f"[train3] 8 ranks on (pod, host, data, model) = (2, 2, 2, 1), full-width "
        f"qwen2-0.5b fp32, B=1 S=512 a rank: {time.perf_counter() - t0:.1f} s wall "
        f"(spawn, runs a-d) | {card}")
    qwen_layers = 24
    for run, want_q in (("a", None), ("b", recs[0]["b_expected_q"])):
        for rank, rec in enumerate(recs):
            for st in rec[run]:
                log(f"[train3] ({run}) rank {rank} step {st['step']}: loss={st['loss']:.6f} "
                    f"step_s={st['dt']:.3f} tok/s={TRAIN3_TOKENS / st['dt']:.0f} (global "
                    f"batch, 8 ranks) launches flash_attention_fwd={st['fa']} "
                    f"quantize_ef_fwd={st['q']} params_bit_equal={st['params_equal']} "
                    f"(checked in {st['check_s']:.2f} s) ef_nonzero={st['ef_nonzero']} "
                    f"n_ef={st['n_ef']} peak_mem_gb={st['peak_gb']:.2f}")
                q_ok = st["q"] == (0 if run == "a" else want_q)
                if not (st["fa"] == qwen_layers and q_ok and _m.isfinite(st["loss"])
                        and st["params_equal"] and st["ef_nonzero"] and st["n_ef"] > 0):
                    raise AssertionError(f"[train3] ({run}) rank {rank}: {st}")
        if any(a["loss"] != b["loss"] for r in recs[1:]
               for a, b in zip(recs[0][run], r[run])):
            raise AssertionError(f"[train3] ({run}) the ranks disagree on the loss")
    r0 = recs[0]
    if r0["a_codecs"] != ["topk"] or len(r0["a"]) != TRAIN3_STEPS:
        raise AssertionError(f"[train3] (a) plan codecs {r0['a_codecs']}")
    log(f"[train3] (a) {r0['a_sections']} sections, codec topk on every slow leg; "
        f"K1 {r0['a_fa_total']}, K2 {r0['a_q_total']} launches a rank in "
        f"{TRAIN3_STEPS} steps")
    log(f"[train3] (b) the planner's plan (three_tier_fabric(2, 2, 2), int8 + mid "
        f"int8, hier_striped): {r0['b_planned_mid_legs']} mid-coded legs, sync state "
        f"{r0['b_planned_state_gb']:.2f} GB a rank; e.g. {r0['b_planned'][-2]}")
    log(f"[train3] (b) the plan run (every fast tier scattered): {r0['b_mid_legs']} "
        f"mid-coded legs, sync state {r0['b_run_state_gb']:.2f} GB a rank; e.g. "
        f"{r0['b_run'][-2]}; K2 a rank a step {r0['b_expected_q']} (mid legs + int8 "
        f"slow chunks), {r0['b_q_total']} in {TRAIN3_MID_STEPS} steps")
    if not (r0["b_mid_legs"] > 0 and r0["b_planned_mid_legs"] > 0
            and r0["b_expected_q"] > 0):
        raise AssertionError("[train3] (b) no mid-coded leg in the plan")
    for rank, rec in enumerate(recs):
        bad = [(c, o) for c, o, _, eq in rec["a2a"] if not eq]
        if bad or not rec["a2a_flat_repeat_equal"] or len(rec["a2a"]) != 7:
            raise AssertionError(f"[train3] (c) rank {rank}: all-to-all differs at {bad}")
        if not rec["ring_equal"]:
            raise AssertionError(f"[train3] (d) rank {rank}: ring != psum")
    for chunks, off, dt, _ in r0["a2a"]:
        log(f"[train3] (c) dfabric_all_to_all chunks={chunks} lane_offset={off}: "
            f"{dt:.3f} s, bit-equal to the flat all_to_all_single on all 8 ranks")
    log(f"[train3] (c) flat all_to_all_single over the world: "
        f"{', '.join(f'{t:.3f}' for t in r0['a2a_flat_s'])} s (before, after); "
        f"{r0['a2a_bytes']} bytes a rank (64 x 960 x 2048 bf16), gloo through host "
        f"memory | {card}")
    log(f"[train3] (d) ring_all_reduce over {{'data': 8}}: {r0['ring_s']:.3f} s, "
        f"prims.psum {r0['psum_s']:.3f} s, {r0['ring_bytes']} bytes a rank, bit-equal "
        f"on all 8 ranks; gloo through host memory (ppermute staged on the host) | {card}")
    return recs


def split_heads_runs(torch, model_axis):
    """[train3] (e) on this member of a model axis of ``model_axis`` over
    the world (1: the one-member reference, in a world of one): each
    ``SPLIT_HEADS_RUNS`` ``Trainer`` run of the rwkv6 smoke in fp32 with K3
    (each step recorded by :func:`step_recorder`), then prefill on (data,
    model) = (1, ``model_axis``) with and without the sequence split, and
    ``SPLIT_HEADS_DECODE`` decode steps from the first one's cache: the
    logits, each call's K3 launches (counted from 0 just before it) and
    milliseconds, the ``wkv`` states."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig, mesh_info
    from repro_torch.utils.trees import tree_paths
    arch = get_smoke_arch(SPLIT_HEADS_ARCH)
    fp32 = dict(param_dtype="float32", compute_dtype="float32", use_kernel_ssm=True)
    out = {}
    for tag, (mode, fields) in SPLIT_HEADS_RUNS.items():
        rec = out[tag] = {"steps": []}
        start, on_step = step_recorder(rec)
        trainer = Trainer(
            build_model(arch, ModelSettings(**fp32, remat="none", **fields),
                        device="cuda", seed=SEED),
            prims.Mesh(dict(SPLIT_HEADS_SIZES, model=model_axis)),
            ShapeConfig("split-heads", SPLIT_HEADS_SEQ, SPLIT_HEADS_ROWS, "train"),
            TrainerConfig(steps=SPLIT_HEADS_STEPS, lr=3e-4, warmup=1, log_every=0,
                          mode=mode))
        params, opt, step0 = trainer.init_state()
        rec["specs"] = {k: sp for k, sp in trainer.model.layout.specs.items()
                        if k.endswith(("tmix/wr", "tmix/u"))}
        start(trainer)
        trainer.train(params, opt, step0, on_step=on_step)
        del trainer, params, opt, start, on_step
        gc.collect()
    kernels = kernel_modules()
    sizes = {"data": 1, "model": model_axis}
    mesh = prims.Mesh(sizes)
    B, S, n = SPLIT_HEADS_SERVE_ROWS, SPLIT_HEADS_SEQ, SPLIT_HEADS_DECODE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    toks = torch.randint(0, arch.vocab, (B, S + n), generator=gen, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.LAUNCHES = 0  # just before the path
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, ((time.perf_counter() - t0) * 1e3,
                     {name: mod.LAUNCHES for name, mod in kernels.items()})

    for tag, fields in (("prefill", {}),
                        ("prefill-sp", dict(seq_axis="model", batch_axes=("data",)))):
        model = build_model(arch, ModelSettings(**fp32, max_seq=S + n, **fields),
                            device="cuda", seed=SEED)
        model.shard(mesh_info(sizes), sizes, mesh.coords)
        rec = out[tag] = {"calls": []}
        with prims.bind(mesh):
            (logits, cache), call = timed(lambda: model.prefill(toks[:, :S], batch=B))
            rec["calls"].append(call)
            rec["logits"] = [logits.cpu().numpy()]
            for t in range(n if tag == "prefill" else 0):
                (logits, cache), call = timed(lambda: model.decode_step(
                    cache, toks[:, S + t:S + t + 1], S + t, batch=B, max_seq=S + n))
                rec["calls"].append(call)
                rec["logits"].append(logits.cpu().numpy())
        rec["wkv"] = {k: v.cpu().numpy() for k, v in tree_paths(cache).items()
                      if k.endswith("wkv")}
        del model, cache
    return out


def split_heads_check(recs, ref, card):
    """Log and check [train3] (e) (each rank's :func:`split_heads_runs`
    record) against the one-member run ``ref``: the projections split over
    model and ``u`` whole; every step's K3 launches as
    ``expected_launches`` (no K2: one DP member), the ranks' losses equal
    and within 1e-5 relative of ``ref``'s, the blocks two members hold alike
    bit-equal; each prefill's and decode step's K3 launches (one a layer),
    its logits within atol = rtol = 1e-4 of ``ref``'s (``[serve-mesh]``'s
    tolerance), and the ``wkv`` states bit-equal on every member and
    within 1e-4 of ``ref``'s."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_arch
    layers = get_smoke_arch(SPLIT_HEADS_ARCH).n_layers
    tokens = SPLIT_HEADS_ROWS * SPLIT_HEADS_SEQ
    for tag in SPLIT_HEADS_RUNS:
        r0 = recs[0][tag]
        specs = r0["specs"]
        if not (all("model" in sp for k, sp in specs.items() if k.endswith("wr"))
                and not any("model" in sp for k, sp in specs.items() if k.endswith("u"))):
            raise AssertionError(f"[train3] (e) {tag}: layout {specs}")
        want = dict(r0["expected"], quantize_ef_fwd=0)
        for rank, rec in enumerate(recs):
            for st in rec[tag]["steps"]:
                if rank == 0:
                    log(f"[train3] (e) {tag} step {st['step']}: loss={st['loss']:.7f} "
                        f"grad_norm={st['grad_norm']:.5f} step_s={st['dt']:.3f} "
                        f"tok/s={tokens / st['dt']:.0f} launches={st['launches']} "
                        f"(expected {want}) TP collectives {st['calls']} "
                        f"blocks_bit_equal={st['agree']} ({st['shared']} blocks held "
                        f"by 2+ members) peak_mem_gb={st['peak_gb']:.3f} | {card}")
                if not (st["launches"] == want and st["agree"] and st["shared"] > 0
                        and math.isfinite(st["loss"])):
                    raise AssertionError(f"[train3] (e) {tag} rank {rank}: {st}")
            if [a["loss"] for a in rec[tag]["steps"]] != [a["loss"] for a in r0["steps"]]:
                raise AssertionError(f"[train3] (e) {tag}: rank {rank} disagrees on the loss")
        mine = [st["loss"] for st in r0["steps"]]
        one = [st["loss"] for st in ref[tag]["steps"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(mine, one))
        log(f"[train3] (e) {tag}: losses {mine} on (1, 1, 8) against {one} on one "
            f"member: max rel diff {rel:.2e} (tol 1e-5); one member's step_s "
            f"{[round(st['dt'], 3) for st in ref[tag]['steps']]}")
        if len(mine) != SPLIT_HEADS_STEPS or not rel <= 1e-5:
            raise AssertionError(f"[train3] (e) {tag}: losses off the one-member run")
    for tag in ("prefill", "prefill-sp"):
        errs = []
        for rank, rec in enumerate(recs):
            for t, (got, want) in enumerate(zip(rec[tag]["logits"], ref[tag]["logits"])):
                errs.append(float(np.abs(got - want).max()))
                torch.testing.assert_close(
                    torch.from_numpy(got), torch.from_numpy(want), atol=1e-4, rtol=1e-4,
                    msg=lambda m: f"[train3] (e) {tag} rank {rank} call {t}: {m}")
            for k, v in rec[tag]["wkv"].items():
                np.testing.assert_array_equal(v, recs[0][tag]["wkv"][k],
                                              err_msg=f"[train3] (e) {tag} {k}")
                torch.testing.assert_close(torch.from_numpy(v),
                                           torch.from_numpy(ref[tag]["wkv"][k]),
                                           atol=1e-4, rtol=1e-4)
            for ms, launches in rec[tag]["calls"]:
                if launches != {"flash_attention_fwd": 0, "wkv6_fwd": layers,
                                "mamba_scan_fwd": 0, "quantize_ef_fwd": 0}:
                    raise AssertionError(f"[train3] (e) {tag} rank {rank}: {launches}")
        calls = recs[0][tag]["calls"]
        log(f"[train3] (e) {tag} on (data, model) = (1, 8), B={SPLIT_HEADS_SERVE_ROWS} "
            f"S={SPLIT_HEADS_SEQ} fp32: prefill {calls[0][0]:.2f} ms"
            + (f", decode steps {', '.join(f'{ms:.2f}' for ms, _ in calls[1:])} ms"
               if len(calls) > 1 else "")
            + f"; K3 {layers} a call; logits max_abs_diff {max(errs):.3e} from the "
            f"one-member run (atol = rtol = 1e-4), the wkv state (every head) "
            f"bit-equal on the 8 members | {card}")


def split_heads_reference(torch):
    """:func:`split_heads_runs` on one member, in a world of this process
    alone (the runs bind their meshes to it)."""
    from repro_torch.launch.mesh import one_process_mesh
    with one_process_mesh((1,), ("data",), "cuda"):
        out = split_heads_runs(torch, 1)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def examples_rank(rank, world, init_method, ckpt_dir):
    """[examples] in a spawned process that joins no group: the four twins
    in turn through their ``main(argv)`` on the card (each starts and ends a
    world of its own), every kernel's launches counted from 0 just before
    each ``main``; the wall of each, what it printed and the numbers the
    checks read.  The per-step launches each twin's settings give come
    from its ``build`` on the meta device."""
    import contextlib
    import io
    import signal
    import torch
    sys.path.insert(0, EXAMPLES_DIR)
    import ddp_train_torch as ddp
    import elastic_restart_torch as er
    import quickstart_torch as qs
    import serve_decode_torch as sd
    from repro_torch.models import count_params
    kernels = kernel_modules()

    def run(mod, argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        for m in kernels.values():
            m.LAUNCHES = 0  # just before the path
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        torch.cuda.synchronize()
        return res, dict(wall=time.perf_counter() - t0, text=buf.getvalue(),
                         launches={n: m.LAUNCHES for n, m in kernels.items()})

    def per_step(model):
        return expected_launches(model.arch, model.settings)

    out = {}
    res, rec = run(qs, [])
    out["quickstart"] = dict(rec, per_step=per_step(qs.build("meta")[0]),
                             losses=[m["loss"] for m in res["metrics"]],
                             dts=[m["dt"] for m in res["metrics"]],
                             tokens=qs.Shape.global_batch * qs.Shape.seq_len)
    (ref, restarted, restored), rec = run(er, [])
    out["elastic_restart"] = dict(
        rec, per_step=per_step(er.build("meta")), ref=[m["loss"] for m in ref["metrics"]],
        restarted=[(m["step"], m["loss"]) for m in restarted["metrics"]],
        restored_step=restored[2], dts=[m["dt"] for m in ref["metrics"]],
        tokens=er.Shape.global_batch * er.Shape.seq_len)
    handler = signal.getsignal(signal.SIGTERM)
    (trainer, res), rec = run(ddp, ["--steps", str(EXAMPLES_DDP_STEPS),
                                    "--ckpt-dir", ckpt_dir])
    installed = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, handler)
    model = ddp.build("meta")
    out["ddp_train"] = dict(
        rec, per_step=per_step(model), n_params=count_params(model), step=res["step"],
        losses=[m["loss"] for m in res["metrics"]], dts=[m["dt"] for m in res["metrics"]],
        latest=trainer.ckpt.latest_step(), stragglers=len(res["straggler_events"]),
        handler=getattr(installed, "__qualname__", repr(installed)),
        saves=[dict(c) for c in trainer.ckpt_log],
        tokens=ddp.Shape.global_batch * ddp.Shape.seq_len)
    del trainer, res
    for name in EXAMPLES_SERVE_ARCHS:
        (server, outs), rec = run(sd, ["--arch", name])
        out[f"serve_decode {name}"] = dict(
            rec, per_step=per_step(sd.build(name, "meta")[1]),
            done=sum(len(t) >= 24 for t in outs.values()), requests=len(outs),
            steps=server.stats["steps"], tok_s=server.throughput(),
            lat=server.latency_summary())
        del server
    return out


def examples_k1_cases() -> tuple:
    """K1's cases at the training twins' shapes: (case name, rows, arch,
    seq, dtype) from each twin's ``Shape`` and model (its ``build`` on the
    meta device)."""
    sys.path.insert(0, EXAMPLES_DIR)
    import ddp_train_torch as ddp
    import elastic_restart_torch as er
    import quickstart_torch as qs
    return tuple((f"main-examples-{tag}", mod.Shape.global_batch, model.arch,
                  mod.Shape.seq_len, model.settings.compute_dtype)
                 for tag, mod, model in (("quickstart", qs, qs.build("meta")[0]),
                                         ("elastic", er, er.build("meta")),
                                         ("ddp", ddp, ddp.build("meta"))))


def run_examples(card):
    """[examples]: :func:`examples_rank` in one spawned process, then each
    twin's checks: quickstart's loss falls over its 60 steps; the restarted
    elastic run ends on the uninterrupted run's loss, from its restored
    step on, and the restore gives step 16; ddp_train reaches step 300 with
    its newest checkpoint at 300, the preemption handler installed and the
    straggler events printed; every served arch completes 12/12; every
    kernel's launches as the settings give them (K1 in each attention
    layer's training forward, K3 and K4 in each RWKV6 and Mamba layer's
    decode step, K2 never)."""
    from repro_torch.launch import train as train_cli
    ckpt_dir = os.path.join(HERE, "build", "ckpt_examples")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    out = train_cli.run_ranks(examples_rank, 1, ckpt_dir, timeout=900)[0]
    log(f"[examples] the four twins in one process: {time.perf_counter() - t0:.1f} s "
        f"wall (spawn included) | {card}")
    for name, rec in out.items():
        for line in rec["text"].splitlines():
            if line.strip():
                log(f"[examples] {name} | {line}")

    def launches_ok(name, steps):
        rec = out[name]
        want = {k: v * steps for k, v in rec["per_step"].items()}
        want["quantize_ef_fwd"] = 0
        if name.startswith("serve_decode"):
            want["flash_attention_fwd"] = 0  # decode attention is plain PyTorch
        if rec["launches"] != want:
            raise AssertionError(f"[examples] {name} launched {rec['launches']}, "
                                 f"expected {want}")
        return want

    def steps_line(name, rec, steps):
        dts = rec["dts"][1:] or rec["dts"]
        med = statistics.median(dts)
        return (f"[examples] {name}: {rec['wall']:.1f} s wall, {steps} steps, step 0 "
                f"{rec['dts'][0]:.3f} s, median step {med * 1e3:.2f} ms, "
                f"{rec['tokens'] / med:.0f} tok/s")

    q = out["quickstart"]
    want = launches_ok("quickstart", len(q["losses"]))
    log(steps_line("quickstart", q, len(q["losses"])) + f"; loss {q['losses'][0]:.4f} -> "
        f"{q['losses'][-1]:.4f}; launches {want} | {card}")
    if not (len(q["losses"]) == 60 and q["losses"][-1] < q["losses"][0]):
        raise AssertionError("[examples] quickstart: the loss did not fall over 60 steps")
    e = out["elastic_restart"]
    crash = int(re.search(r"injected failure at step (\d+)", e["text"]).group(1))
    first = e["restarted"][0][0]
    want = launches_ok("elastic_restart", len(e["ref"]) + crash + len(e["restarted"]))
    same = [loss for _, loss in e["restarted"]] == e["ref"][first:]
    log(steps_line("elastic_restart", e, len(e["ref"])) + f" (the reference run); "
        f"crashed at {crash}, restarted from step {first}: final loss "
        f"{e['restarted'][-1][1]!r} vs {e['ref'][-1]!r}, every restarted step's loss "
        f"equal: {same}; restored step {e['restored_step']}; launches {want} | {card}")
    if not (same and e["restored_step"] == 16):
        raise AssertionError("[examples] elastic_restart: the restart left the "
                             "uninterrupted trajectory")
    d = out["ddp_train"]
    want = launches_ok("ddp_train", d["step"])
    saves = ", ".join(f"{c['step']}: {c['blocking_s']:.3f}" for c in d["saves"])
    log(steps_line("ddp_train", d, d["step"]) + f"; {d['n_params']} parameters; loss "
        f"{d['losses'][0]:.4f} -> {d['losses'][-1]:.4f}; newest checkpoint step "
        f"{d['latest']}; blocking s a save ({saves}); SIGTERM handler {d['handler']}; "
        f"straggler events {d['stragglers']}; launches {want} | {card}")
    if not (d["step"] == EXAMPLES_DDP_STEPS and d["latest"] == EXAMPLES_DDP_STEPS
            and "install_preemption_handler" in d["handler"]
            and f"straggler events = {d['stragglers']}" in d["text"]):
        raise AssertionError(f"[examples] ddp_train: {d['step']}, {d['latest']}, "
                             f"{d['handler']}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    for name in EXAMPLES_SERVE_ARCHS:
        s = out[f"serve_decode {name}"]
        want = launches_ok(f"serve_decode {name}", s["steps"])
        lat = s["lat"]
        log(f"[examples] serve_decode {name}: {s['wall']:.1f} s wall, "
            f"{s['done']}/{s['requests']} completed in {s['steps']} steps, "
            f"{s['tok_s']:.1f} tok/s, ttft p50 {lat['ttft_p50_s'] * 1e3:.1f} ms, tpot p50 "
            f"{lat.get('tpot_p50_s', 0) * 1e3:.2f} ms p99 "
            f"{lat.get('tpot_p99_s', 0) * 1e3:.2f} ms; launches {want} | {card}")
        if not s["done"] == s["requests"] == 12:
            raise AssertionError(f"[examples] serve_decode {name}: {s['done']}/12")
    return out


# ---------------------------------------------------------------------------
# training beyond dense fp32: bf16, experts, RWKV6, Jamba (two ranks)
# ---------------------------------------------------------------------------

class FamilyRun(NamedTuple):
    """A run of ``FAMILY_RUNS``: its arch, ``ModelSettings`` fields, rows a
    rank, sequence (None: whisper's text context), steps, checkpoint step
    and the layers kept when cut in depth; ``masked_step0``: step 0's loss
    is held to the same step with masked attention, within 1e-4 relative
    (fp32: K1's fp32 body is exact fp32 arithmetic in another order).
    Every run: mesh (pod, data, model) = (2, 1, 1), two ranks sharing the
    card over gloo, the int8 slow tier, ZeRO-1 AdamW."""
    arch: str
    fields: dict
    rows: int
    seq: Optional[int]
    steps: int
    ckpt_at: Optional[int]
    depth: Optional[int] = None
    masked_step0: bool = False


BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# 1 step a run for the card's time, but for the int8 bf16 runs and
# whisper's, which keep 2 so that error feedback and the moments cross a
# step; each
# checkpoint is written after its run's last step
FAMILY_RUNS = {
    "train-bf16-a": FamilyRun("qwen2-0.5b", dict(BF16, remat="full", attn_impl="kernel"),
                              2, 2048, 2, 2),
    "train-bf16-b": FamilyRun("qwen2-0.5b",
                              dict(param_dtype="bfloat16", compute_dtype="float32",
                                   remat="full", attn_impl="kernel"), 2, 2048, 2, 2),
    "train-moe": FamilyRun("deepseek-moe-16b",
                           dict(BF16, remat="full", attn_impl="kernel"), 1, 2048, 1, None),
    # rwkv6-1.6b at 2 of its 24 layers, S=1024: the backward recomputes
    # the plain recurrence step by step
    "train-rwkv": FamilyRun("rwkv6-1.6b", dict(BF16, remat="full", use_kernel_ssm=True),
                            1, 1024, 1, None, depth=2),
    "train-jamba": FamilyRun("jamba-1.5-large-398b-smoke",
                             dict(BF16, remat="full", attn_impl="kernel",
                                  use_kernel_ssm=True), 2, 512, 1, None),
    # whisper-medium at every width, 2 of its 24 + 24 layers (for the
    # card's time), fp32, K1's fp32 body in each decoder layer's
    # forward and recompute, the encoder and the cross attention masked;
    # remat: without it each rank would keep every encoder layer's fp32
    # score chunks over 1500 frames
    "train-whisper": FamilyRun("whisper-medium",
                               dict(param_dtype="float32", compute_dtype="float32",
                                    remat="full", attn_impl="kernel"),
                               2, None, 2, 2, depth=2, masked_step0=True),
}
FAMILY_SIZES = {"pod": 2, "data": 1, "model": 1}


def whisper_seq():
    """whisper-medium's text context, the decoder length of its prefill and
    training here, which also sizes its learned positions."""
    from repro_torch.configs.one_card import WHISPER_TEXT_CONTEXT
    return WHISPER_TEXT_CONTEXT


def family_run(tag) -> FamilyRun:
    """``FAMILY_RUNS[tag]`` with its sequence resolved and ``max_seq`` (which
    sizes learned positions only) set to it, as the train CLI sets it from
    ``--seq``."""
    run = FAMILY_RUNS[tag]
    seq = run.seq or whisper_seq()
    return run._replace(seq=seq, fields=dict(run.fields, max_seq=seq))


def family_arch(name, depth=None):
    """(the arch a family run trains, its cuts): the registered smoke
    config for a ``-smoke`` name (jamba's with its experts), else
    ``one_card_train_arch``; cut to ``depth`` layers if given (an
    encoder-decoder's encoder too)."""
    from repro_torch.configs import get_smoke_arch, one_card_train_arch
    if name.endswith("-smoke"):
        arch, cuts = get_smoke_arch(name[:-len("-smoke")]), ()
    else:
        arch, cuts = one_card_train_arch(name)
    if depth is not None and depth < arch.n_layers:
        cuts = cuts + (f"n_layers: {arch.n_layers} -> {depth}",)
        arch = arch.replace(n_layers=depth)
    if depth is not None and arch.is_encdec and depth < arch.encoder.n_layers:
        cuts = cuts + (f"encoder.n_layers: {arch.encoder.n_layers} -> {depth}",)
        arch = arch.replace(encoder=dataclasses.replace(arch.encoder, n_layers=depth))
    return arch, cuts


def expected_launches(arch, st) -> dict:
    """Kernel launches a rank a training step, from the code: K1 in each
    attention layer's forward (``attn_impl="kernel"``), K3 in each RWKV
    layer's and K4 in each Mamba layer's (``use_kernel_ssm``), each once
    more in the ``remat="full"`` recompute; K2 is the plan's count."""
    from repro_torch.models.transformer import layer_kind, n_groups
    kinds = [layer_kind(arch, off) for off in range(arch.n_layers // n_groups(arch))]
    per = n_groups(arch) * (2 if st.remat == "full" else 1)
    ssm = st.use_kernel_ssm
    return {"flash_attention_fwd": per * kinds.count("attn") * (st.attn_impl == "kernel"),
            "wkv6_fwd": per * kinds.count("rwkv") * ssm,
            "mamba_scan_fwd": per * kinds.count("mamba") * ssm}


def leaf_digests(params) -> dict:
    """{path: sha256 of the leaf's bytes}, for bit-for-bit comparisons."""
    import hashlib
    import torch
    from repro_torch.utils.trees import tree_paths
    out = {}
    for path, p in tree_paths(params).items():
        raw = p.detach().contiguous().view(torch.uint8).reshape(-1).cpu().numpy()
        out[path] = hashlib.sha256(raw.tobytes()).hexdigest()
    return out


def family_rank(rank, world, init_method, ckpt_root):
    """One of the two ranks of every ``FAMILY_RUNS`` run in turn, then of
    ``[cells]``' train_4k share (one spawn, so the ranks start once): {tag:
    :func:`family_run_rank`'s record, "cells-train":
    :func:`cells_train_run`'s, each with the run's seconds}."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, world_size=world,
                            rank=rank)
    out = {}
    try:
        for tag in FAMILY_RUNS:
            t0 = time.perf_counter()
            out[tag] = family_run_rank(torch, rank, world, tag,
                                       os.path.join(ckpt_root, tag))
            out[tag]["s"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["cells-train"] = cells_train_run(torch, rank, cells_train_rows(),
                                             CELL_TRAIN_STEPS, CELL_TRAIN_MICROBATCHES)
        out["cells-train"]["s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return out


def family_run_rank(torch, rank, world, tag, ckpt_dir):
    """This rank's part of a ``FAMILY_RUNS`` run: the model drawn from seed
    0 on the card, the ``Trainer`` on (2, 1, 1) with the int8 slow tier,
    each step's launches of every kernel, loss (and for experts its CE and
    aux parts, this rank's, and the (token, k) slots the forward dropped),
    parameters against member 0's, step time and peak memory recorded; at
    the checkpoint step, member 0 records each leaf's digest."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_active_params, count_params
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    arch_name, fields, rows, seq, steps, ckpt_at, depth, masked_step0 = family_run(tag)
    kernels = kernel_modules()
    rec = {"steps": []}
    real_forward = T.forward_train
    try:
        arch, _ = family_arch(arch_name, depth)
        st = ModelSettings(loss_chunk=min(2048, seq), **fields)
        model = build_model(arch, st, device="cuda", seed=0)
        rec.update(n_params=count_params(model), n_active=count_active_params(model),
                   dtypes=sorted({str(p.dtype) for p in model.parameters()}))
        cfg = TrainerConfig(steps=steps, lr=3e-4, warmup=1, codec="int8", zero1=True,
                            ckpt_dir=ckpt_dir if ckpt_at else None,
                            ckpt_every=ckpt_at or 0)
        trainer = Trainer(model, prims.Mesh(FAMILY_SIZES),
                          ShapeConfig("custom", seq, rows * world, "train"), cfg)
        rec["slow_chunks"] = sum(len(s.schedule.slow_legs) for s in trainer.plan.sections)
        rec["sections"] = len(trainer.plan.sections)
        params, opt, start = trainer.init_state()
        if masked_step0:  # the masked forward of step 0's rows
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in trainer.local_batch(0).items()}
            model.settings = dataclasses.replace(st, attn_impl="masked")
            with torch.no_grad():
                masked = model.loss(params, batch).detach()
            model.settings = st
            dist.all_reduce(masked)  # the pmean, as the step's
            rec["masked_loss0"] = float(masked) / world
            del batch, masked
        n_moe = len(arch.moe_layer_ids()) if arch.moe is not None else 0
        auxes = []

        def recording(*a, **k):  # the aux term, apart from the CE
            hidden, aux = real_forward(*a, **k)
            auxes.append(aux.detach())
            return hidden, aux

        T.forward_train = recording
        L.DROP_LOG = [] if n_moe else None
        torch.cuda.synchronize()
        rec["mem_after_init_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        for mod in kernels.values():
            mod.LAUNCHES = 0  # just before the path
        last = {name: 0 for name in kernels}

        def on_step(step, params, opt, metrics):
            torch.cuda.synchronize()
            launches = {name: mod.LAUNCHES - last[name] for name, mod in kernels.items()}
            last.update({name: mod.LAUNCHES for name, mod in kernels.items()})
            t0 = time.perf_counter()
            equal = params_bit_equal(params)
            check_s = time.perf_counter() - t0
            out = dict(step=step, loss=metrics["loss"], dt=metrics["dt"],
                       grad_norm=metrics["grad_norm"], launches=launches,
                       params_equal=equal, check_s=check_s,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            if n_moe:
                aux = float(auxes[-1])
                out["aux_term"] = 0.01 * aux / n_moe
                drops = [int(d.sum()) for d in L.DROP_LOG[:n_moe]]  # the forward's
                out["dropped"] = sum(drops)
                L.DROP_LOG.clear()
            auxes.clear()
            if ckpt_at and step + 1 == ckpt_at and rank == 0:
                rec["ckpt_digests"] = leaf_digests(params)
            efs = [e["ef"] for e in opt["sections"].values() if "ef" in e]
            out["ef_nonzero"] = bool(efs) and all(bool((e != 0).any()) for e in efs)
            rec["steps"].append(out)

        out = trainer.train(params, opt, start, on_step=on_step)
        rec["expected"] = expected_launches(arch, st)
        rec["tokens"] = rows * world * seq
        if trainer.ckpt is not None:
            trainer.ckpt.wait()
            rec["writes"] = trainer.ckpt.stats
        del out, trainer, params, opt
    finally:
        T.forward_train = real_forward
        L.DROP_LOG = None
    return rec


def check_family(tag, recs, card, ckpt_root):
    """A ``FAMILY_RUNS`` run's two ranks' records: checks and logs each
    step, and a checkpoint run's step restored bit for bit on a fresh
    model in this process."""
    import torch
    arch_name, fields, rows, seq, steps, ckpt_at, depth, masked_step0 = family_run(tag)
    arch, cuts = family_arch(arch_name, depth)
    ckpt_dir = os.path.join(ckpt_root, tag)
    r0 = recs[0]
    log(f"[{tag}] {arch.name}{' (cut: ' + '; '.join(cuts) + ')' if cuts else ''} "
        f"{fields}, 2 ranks (2,1,1) int8 slow tier ZeRO-1, B={rows} S={seq} a rank, "
        f"{steps} steps: {r0['s']:.1f} s on rank 0; params "
        f"{r0['n_params']} (active {r0['n_active']}) {r0['dtypes']}; memory after "
        f"init {r0['mem_after_init_gb']:.2f} GB a rank; {r0['sections']} sections, "
        f"{r0['slow_chunks']} int8 slow chunks | {card}")
    want = dict(r0["expected"], quantize_ef_fwd=r0["slow_chunks"])
    for rank, rec in enumerate(recs):
        if len(rec["steps"]) != steps:
            raise AssertionError(f"[{tag}] rank {rank} ran {len(rec['steps'])} steps")
        for st in rec["steps"]:
            extra = ""
            if "aux_term" in st:
                extra = (f" ce={st['loss'] - st['aux_term']:.6f} (this rank's) "
                         f"aux_term={st['aux_term']:.6f} (0.01 x aux / MoE layers, "
                         f"this rank's) dropped_slots={st['dropped']}")
            log(f"[{tag}] rank {rank} step {st['step']}: loss={st['loss']:.6f} "
                f"(pmean){extra} grad_norm={st['grad_norm']:.4f} "
                f"step_s={st['dt']:.3f} tok/s={rec['tokens'] / st['dt']:.0f} (global "
                f"batch) launches={st['launches']} params_bit_equal="
                f"{st['params_equal']} (checked in {st['check_s']:.2f} s) "
                f"ef_nonzero={st['ef_nonzero']} peak_mem_gb={st['peak_gb']:.2f} | {card}")
            if st["launches"] != want:
                raise AssertionError(f"[{tag}] rank {rank} step {st['step']} launched "
                                     f"{st['launches']}, expected {want}")
            if not (math.isfinite(st["loss"]) and st["params_equal"] and st["ef_nonzero"]):
                raise AssertionError(f"[{tag}] rank {rank} step {st['step']}: {st}")
    if any(a["loss"] != b["loss"] for a, b in zip(recs[0]["steps"], recs[1]["steps"])):
        raise AssertionError(f"[{tag}] the ranks disagree on the (pmean) loss")
    if masked_step0:
        got, want = r0["steps"][0]["loss"], r0["masked_loss0"]
        rel = abs(got - want) / abs(want)
        log(f"[{tag}] step 0 loss with K1 {got:.8f} vs the masked forward's "
            f"{want:.8f}: relative {rel:.3e} (tol 1e-4) | {card}")
        if rel > 1e-4:
            raise AssertionError(f"[{tag}] step 0 is {rel:.3e} off the masked step")
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    peaks = sum(max(st["peak_gb"] for st in rec["steps"]) for rec in recs)
    log(f"[{tag}] the card's {total:.2f} GB less both ranks' peaks ({peaks:.2f} GB "
        f"allocated): {total - peaks:.2f} GB free of allocations | {card}")
    if ckpt_at:
        check_restore(tag, arch, fields, ckpt_dir, ckpt_at, r0, card)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return recs


def check_restore(tag, arch, fields, ckpt_dir, step, r0, card):
    """The step-``step`` checkpoint of a family run: its bf16 leaves are
    recorded as the reference records them, and it restores into a fresh
    model on the card (``load_jax_params``, the ``Trainer``'s restore)
    bit for bit against member 0's digests at that step."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import load_jax_params
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.utils.trees import tree_paths
    index = json.load(open(os.path.join(ckpt_dir, f"step_{step:08d}", "index.json")))
    dtypes = sorted({e["dtype"] for e in index["trees"]["params"].values()})
    t0 = time.perf_counter()
    out = CheckpointManager(ckpt_dir, read_only=True).restore(step)
    model = build_model(arch, ModelSettings(**fields), device="cuda", seed=1)
    load_jax_params(model, tree_paths(out["params"]))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = leaf_digests(model.params())
    bad = [k for k, v in r0["ckpt_digests"].items() if got.get(k) != v]
    write = r0["writes"][0]
    log(f"[{tag}] checkpoint step {step}: {dir_bytes(os.path.join(ckpt_dir, f'step_{step:08d}'))} "
        f"bytes, parameter dtypes in index.json {dtypes}, snapshot "
        f"{write['snapshot_s']:.3f} s, writer {write['write_s']:.3f} s; restored on a "
        f"fresh model in {restore_s:.2f} s: {len(got) - len(bad)} of {len(got)} leaves "
        f"bit-equal to member 0's at step {step} | {card}")
    if bad or set(got) != set(r0["ckpt_digests"]) or dtypes != [fields["param_dtype"]]:
        raise AssertionError(f"[{tag}] the restore differs at {bad[:5]} (dtypes {dtypes})")
    del model, out


def jamba_layer_check(torch, gen, dev, card):
    """One full-width Mamba layer of the jamba cut (d_model 8192, d_inner
    16384, d_state 16), B=1 S=MAMBA_LAYER_SEQ, forward and backward through K4's
    autograd wrapper (``use_kernel=True``: K4 forward, the plain scan
    recomputed in the backward) against the plain path's, in fp32 (K4's
    tolerance, 1e-4) and bf16 (the JAX tests' bf16 tolerance, 2e-2), each
    parameter's gradient and the input's."""
    from repro_torch.configs import one_card_arch
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.models import ssm as SSM
    from repro_torch.utils.trees import tree_paths
    arch = one_card_arch("jamba-1.5-large-398b")[0]
    for dt_name, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        dt = getattr(torch, dt_name)
        p = SSM.init_mamba(arch, gen, (), dt, dev)
        x = (torch.randn(1, MAMBA_LAYER_SEQ, arch.d_model, generator=gen, device=dev)
             * 0.5).to(dt)
        gy = torch.randn(1, MAMBA_LAYER_SEQ, arch.d_model, generator=gen, device=dev).to(dt)
        leaves = tree_paths(p)
        grads, times = {}, {}
        for use_kernel in (False, True):  # the first grows the allocator's pool
            xi = x.clone().requires_grad_(True)
            for t in leaves.values():
                t.requires_grad_(True)
            before = ms_kernel.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, _ = SSM.apply_mamba(arch, p, xi, use_kernel=use_kernel)
            g = torch.autograd.grad(y, [xi] + list(leaves.values()), gy)
            torch.cuda.synchronize()
            times[use_kernel] = time.perf_counter() - t0
            launched = ms_kernel.LAUNCHES - before
            if launched != (1 if use_kernel else 0):
                raise AssertionError(f"[train-jamba] layer: {launched} K4 launches")
            grads[use_kernel] = dict(zip(["x"] + list(leaves), g))
            del y, g, xi
        worst = 0.0
        for k, g in grads[True].items():
            ref = grads[False][k]
            torch.testing.assert_close(g.float(), ref.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"[train-jamba] layer {dt_name} d{k}: {m}")
            worst = max(worst, (g.float() - ref.float()).abs().max().item())
        log(f"[train-jamba] one Mamba layer at full width (d_model {arch.d_model}, "
            f"d_inner {arch.mamba.expand * arch.d_model}, d_state {arch.mamba.d_state}) "
            f"{dt_name} B=1 S={MAMBA_LAYER_SEQ}: forward + backward plain {times[False]:.3f} s "
            f"(run first), with K4 {times[True]:.3f} s; the input's and {len(leaves)} parameter "
            f"gradients within {tol} (max abs diff {worst:.3e}) | {card}")
        del p, x, gy, grads, leaves
        torch.cuda.empty_cache()


def family_phases(torch, gen, dev, card, phase_done):
    """``[train-bf16]``, ``[train-moe]``, ``[train-rwkv]``, ``[train-jamba]``,
    ``[train-whisper]``, and ``[cells]``' train_4k share run by the same
    spawn; returns {tag: per-rank records} ("cells-train" for the
    latter, checked by ``cells_phase``)."""
    import gc
    root = os.path.join(HERE, "build", "ckpt_family")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # bf16 params + fp32 m, v, EF, twice, beside whisper's fp32 checkpoint
    # (at most its 811.8 M parameters at 16 bytes): every run's checkpoint
    # is written before the first is checked
    need = 2 * 494_032_768 * (2 + 12) + 811_792_384 * 16
    free = shutil.disk_usage(root).free
    if free < need:
        raise RuntimeError(f"{free} bytes free under {root}; [train-bf16] needs {need}")
    from repro_torch.launch import train as train_cli
    jamba_layer_check(torch, gen, dev, card)
    phase_done("train-jamba: one Mamba layer through K4 vs plain")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = train_cli.run_ranks(family_rank, 2, root, timeout=1800)
    log(f"[train-family] 2 ranks, every run in turn: {time.perf_counter() - t0:.1f} s "
        f"wall | {card}")
    phase_done("train-family: 2 ranks, the runs")
    out = {}
    for tag in FAMILY_RUNS:
        out[tag] = [r[tag] for r in recs]
        check_family(tag, out[tag], card, root)
        phase_done(tag)
    shutil.rmtree(root, ignore_errors=True)
    out["cells-train"] = [r["cells-train"] for r in recs]
    return out


# ---------------------------------------------------------------------------
# tensor parallelism and the GSPMD step: four ranks share the card over gloo
# ---------------------------------------------------------------------------

#: ``[train-tp]``: the CLI's run with a model axis of 2, full-width
#: qwen2-0.5b in fp32, mesh (pod, data, model) = (2, 1, 2), the int8 slow
#: tier, ZeRO-1, B=2 S=2048 a DP member (``[train]``'s global batch), 1
#: step
TP_ARGV = ["--arch", "qwen2-0.5b", "--mesh", "2,1,2", "--codec", "int8",
           "--steps", "1", "--batch", "4", "--seq", "2048",
           "--backend", "gloo", "--device", "cuda"]
TP_RANKS, TP_TOKENS = 4, 4 * 2048
GSPMD_SIZES = {"pod": 1, "data": 2, "model": 2}
#: the GSPMD step's runs, FSDP over data x TP over model on (1, 2, 2), B=1 a
#: DP member (rows: the global batch's), at every published width:
#: ``[train-gspmd]`` qwen3-1.7b cut to 2 of its 28 layers (at 28 the script
#: took 1170 s of its 1200 s limit on an H100 host), in bf16,
#: ``remat="full"``, S=2048, 2 steps, a checkpoint at step 2;
#: ``[train-gspmd-rwkv]`` rwkv6-1.6b cut to 2 of its 24 layers (at 24:
#: 106-136 s), bf16 parameters with
#: fp32 compute (in bf16 compute the unsharded step's own gradient norm is
#: 1.9x its fp32 one), K3 on each member's 16 heads, S=512 (the plain
#: recurrence's backward is a Python loop over the sequence), 2
#: steps, ``remat="none"`` (four peaks leave more than 10 GB of the card
#: free).  ``gnorm_tol``: step 0's gradient norms (``grad_norms``) held to
#: the unsharded step's, relative: the whole model's, and ``tail``, the
#: leaves nearest the loss.  A deep random RWKV6's backward amplifies
#: rounding layer by layer (at 24 layers its whole-model norm moved 1.03%,
#: its layers' up to 2.9%, growing with the distance from the loss: the
#: printed profile); at 2 layers it moves far less, and both runs are held
#: to 1e-2
GSPMD_RUNS = {
    "train-gspmd": dict(arch="qwen3-1.7b", depth=2, sizes=GSPMD_SIZES, rows=2,
                        seq=2048, steps=2, ckpt=2,
                        gnorm_tol=dict(whole=1e-2, tail=1e-2),
                        fields=dict(BF16, remat="full", attn_impl="kernel",
                                    loss_chunk=2048)),
    "train-gspmd-rwkv": dict(arch="rwkv6-1.6b", depth=2, sizes=GSPMD_SIZES, rows=2,
                             seq=512, steps=2, ckpt=None,
                             gnorm_tol=dict(whole=1e-2, tail=1e-2),
                             fields=dict(param_dtype="bfloat16",
                                         compute_dtype="float32", remat="none",
                                         use_kernel_ssm=True, loss_chunk=1024)),
}


def gspmd_arch(run):
    """The arch of a ``GSPMD_RUNS`` run, cut to its ``depth`` if it has one."""
    from repro_torch.configs import get_arch
    arch = get_arch(run["arch"])
    return arch.replace(n_layers=run["depth"]) if run.get("depth") else arch


def grad_norms(grads, specs=None) -> dict:
    """Norms of a step's gradients ({path: tensor}): ``whole`` over every
    leaf, ``tail`` over the leaves nearest the loss (every leaf but the
    embedding, a stacked leaf at its last layer only) and ``layers``, each
    layer's stacked leaves, first to last.  With ``specs`` ({path: spec})
    the tensors are this member's blocks, as ``adamw.global_norm`` takes
    them (the mesh bound)."""
    from repro_torch.optim.adamw import global_norm
    stacked = [k for k in grads if k.startswith("blocks/")]

    def norm(tree):
        cut = None if specs is None else {
            k: tuple(specs[k][1:]) if k.startswith("blocks/") else specs[k]
            for k in tree}
        return global_norm(tree, cut).item()

    tail = {k: (g[-1] if k.startswith("blocks/") else g)
            for k, g in grads.items() if k != "embed"}
    return dict(whole=global_norm(grads, specs).item(), tail=norm(tail),
                layers=[norm({k: grads[k][i] for k in stacked})
                        for i in range(grads[stacked[0]].shape[0])])


def tp_k2_sizes():
    """{case: padded input size} of every K2 launch of ``[train-tp]``: each
    section's int8 slow chunks on a model member's local blocks."""
    sizes = {"pod": 2, "data": 1, "model": 2}
    out = {}
    for sec in qwen_plan(sizes).sections:
        n = sec.schedule.numel // len(sec.schedule.slow_legs)
        out.setdefault(n + (-n) % sec.sync.codec_block, f"tp-{sec.name}"[:60])
    return {name: n for n, name in out.items()}


def blocks_agree(params, layout, mesh):
    """Whether every two members that hold the same block of a leaf (a
    leaf replicated over the model members, every leaf over the pod
    members) hold it bit for bit: each member's leaf digests and block
    coords gathered to all.  Returns (agree, the groups of two or more
    members compared)."""
    import torch.distributed as dist
    from repro_torch.models.sharding import block_coords
    mine = {k: (block_coords(layout.specs[k], mesh.coords, mesh.sizes), d)
            for k, d in leaf_digests(params).items()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    groups = {}
    for rec in everyone:
        for k, (idx, d) in rec.items():
            groups.setdefault((k, idx), set()).add(d)
    members = {}
    for rec in everyone:
        for k, (idx, _) in rec.items():
            members[(k, idx)] = members.get((k, idx), 0) + 1
    shared = [g for g, n in members.items() if n > 1]
    return all(len(groups[g]) == 1 for g in groups), len(shared)


def step_recorder(rec, tag=None, ckpt_at=None):
    """(start(trainer), on_step) for a ``Trainer`` run on this rank: from
    ``start`` (every count set to 0 just before the path) each step
    appends to ``rec["steps"]`` every kernel's launches, the collectives
    of the model's TP/FSDP Functions, loss, step time, peak memory and
    whether the members' blocks agree; at step ``ckpt_at`` the digests of
    this member's blocks go to ``rec["ckpt_digests"]``."""
    import torch
    from repro_torch.core import prims
    from repro_torch.models.registry import count_params
    kernels = kernel_modules()
    live = {}

    def start(trainer):
        live["trainer"] = trainer
        torch.cuda.synchronize()
        rec["mem_after_init_gb"] = torch.cuda.memory_allocated() / 1e9
        rec["local_params"] = sum(p.numel() for p in trainer.model.parameters())
        rec["n_params"] = count_params(trainer.model)
        rec["plan_k2"] = (sum(len(s.schedule.slow_legs) for s in trainer.plan.sections)
                          if trainer.plan is not None else 0)
        rec["expected"] = expected_launches(trainer.model.arch, trainer.model.settings)
        rec["coords"] = trainer.mesh.coords
        torch.cuda.reset_peak_memory_stats()
        for mod in kernels.values():
            mod.LAUNCHES = 0  # just before the path
        for k in prims.TP_CALLS:
            prims.TP_CALLS[k] = 0
        live["last"] = {name: 0 for name in kernels}
        live["calls"] = dict(prims.TP_CALLS)

    def on_step(step, params, opt, metrics):
        torch.cuda.synchronize()
        launches = {name: mod.LAUNCHES - live["last"][name]
                    for name, mod in kernels.items()}
        live["last"] = {name: mod.LAUNCHES for name, mod in kernels.items()}
        calls = {k: v - live["calls"][k] for k, v in prims.TP_CALLS.items()}
        live["calls"] = dict(prims.TP_CALLS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        trainer = live["trainer"]
        agree, shared = blocks_agree(params, trainer.model.layout, trainer.mesh)
        rec["steps"].append(dict(step=step, loss=metrics["loss"], dt=metrics["dt"],
                                 grad_norm=metrics["grad_norm"], launches=launches,
                                 calls=calls, agree=agree, shared=shared,
                                 check_s=time.perf_counter() - t0, peak_gb=peak))
        if ckpt_at is not None and step + 1 == ckpt_at:
            rec["ckpt_digests"] = state_digests(params, opt)

    return start, on_step


def kernel_modules() -> dict:
    """{kernel name: its module}, each module's ``LAUNCHES`` its count."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.kernels.quantize import kernel as q_kernel
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    return {"flash_attention_fwd": fa_kernel, "wkv6_fwd": wkv_kernel,
            "mamba_scan_fwd": ms_kernel, "quantize_ef_fwd": q_kernel}


def four_rank(rank, world, init_method, ckpt_dir, out_dir, inputs):
    """One of the 4 ranks sharing the card over gloo for ``[train-tp]`` (the
    CLI's ``run_rank`` with ``TP_ARGV``, whose process group the rest
    keeps), the ``GSPMD_RUNS`` runs, ``[train-tp-hybrid]``,
    ``[serve-mesh]`` and ``[seq-par]``, in turn (one spawn, so the ranks
    start once): {"train-tp": its :func:`step_recorder` record, tag:
    :func:`gspmd_run`'s, "hybrid": :func:`hybrid_runs`', "serve-mesh":
    :func:`serve_mesh_runs`', "seq-par": :func:`seq_par_runs`'}."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as train_cli
    out = {"train-tp": {"steps": []}}
    start, on_step = step_recorder(out["train-tp"])
    args = train_cli.resolve_args(train_cli.build_parser().parse_args(TP_ARGV))
    try:
        trainer, result = train_cli.run_rank(
            args, rank, world, init_method, on_step=on_step, keep_group=True,
            before_train=lambda trainer, params, opt: start(trainer))
        # the recorder's closures hold the trainer: all of it freed here
        del trainer, result, start, on_step
        for tag in GSPMD_RUNS:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out[tag] = gspmd_run(torch, tag, ckpt_dir)
            out[tag]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        out["hybrid"] = hybrid_runs(torch, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels = kernel_modules()
        out["serve-mesh"] = serve_mesh_runs(torch, kernels, inputs)
        gc.collect()
        torch.cuda.empty_cache()
        out["seq-par"] = seq_par_runs(torch, kernels, inputs, out["serve-mesh"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def gspmd_run(torch, tag, ckpt_dir):
    """This rank's part of a ``GSPMD_RUNS`` run (the ``Trainer`` in GSPMD
    mode; one with a checkpoint step then restores that checkpoint into a
    fresh model and state on this rank), recorded by
    :func:`step_recorder`."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.utils.trees import tree_paths
    rec = {"steps": []}
    run = GSPMD_RUNS[tag]
    start, on_step = step_recorder(rec, tag, run["ckpt"])

    def on_step_norms(step, params, opt, metrics):
        if step == 0:
            # AdamW's first moment after step 0 is (1 - b1) x clip x the
            # gradient: its norms, scaled to the step's own grad_norm
            with prims.bind(trainer.mesh):
                n = grad_norms(tree_paths(opt["m"]), trainer.moment_specs)
            s = metrics["grad_norm"] / n["whole"]
            rec["norms0"] = dict(whole=metrics["grad_norm"], tail=n["tail"] * s,
                                 layers=[x * s for x in n["layers"]])
        on_step(step, params, opt, metrics)

    mesh = prims.Mesh(run["sizes"])
    arch = gspmd_arch(run)
    st = ModelSettings(**run["fields"])
    shape = ShapeConfig("custom", run["seq"], run["rows"], "train")
    cfg = TrainerConfig(steps=run["steps"], lr=3e-4, warmup=1, mode="gspmd",
                        ckpt_dir=ckpt_dir if run["ckpt"] else None,
                        ckpt_every=run["ckpt"] or 0)
    trainer = Trainer(build_model(arch, st, device="cuda", seed=0), mesh, shape, cfg)
    params, opt, step0 = trainer.init_state()
    start(trainer)
    trainer.train(params, opt, step0, on_step=on_step_norms)
    if run["ckpt"]:
        rec["ckpt_log"], rec["writes"] = trainer.ckpt_log, trainer.ckpt.stats
    del trainer, params, opt
    torch.cuda.empty_cache()
    if run["ckpt"]:
        # the checkpoint into a fresh model (other seed) and state
        fresh = Trainer(build_model(arch, st, device="cuda", seed=1), mesh, shape, cfg)
        params, opt, step = fresh.try_restore()
        got = state_digests(params, opt)
        rec["restore"] = dict(step=step, restore_s=fresh.restore_s, leaves=len(got),
                              equal=sum(got[k] == v
                                        for k, v in rec["ckpt_digests"].items()))
        del fresh, params, opt
    return rec


def state_digests(params, opt) -> dict:
    """Digests of the parameters and the GSPMD moments (this member's
    blocks), and the step."""
    out = {f"p/{k}": v for k, v in leaf_digests(params).items()}
    for key in ("m", "v"):
        out.update({f"{key}/{k}": v for k, v in leaf_digests(opt[key]).items()})
    out["step"] = str(opt["step"])
    return out


def gspmd_reference(torch, tag):
    """Step 0's loss and :func:`grad_norms` of the ``GSPMD_RUNS`` run
    ``tag`` from one unsharded model on this process (seed 0, its
    settings, its kernels in the forward and any recompute), on the same
    global batch: the reference its four ranks are held to."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.utils.trees import tree_paths
    run = GSPMD_RUNS[tag]
    arch = gspmd_arch(run)
    st = ModelSettings(**run["fields"])
    model = build_model(arch, st, device="cuda", seed=0)
    pipe = TokenPipeline(arch, ShapeConfig("custom", run["seq"], run["rows"], "train"),
                         DataConfig(seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(0).items()}
    kernels = kernel_modules()
    before = {name: mod.LAUNCHES for name, mod in kernels.items()}
    params = tree_paths(model.params())
    for t in params.values():
        t.requires_grad_(True)
    loss = model.loss(model.params(), batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    grads = dict(zip(params, grads))
    norms = grad_norms(grads)
    launched = {name: mod.LAUNCHES - before[name] for name, mod in kernels.items()}
    if launched != dict(expected_launches(arch, st), quantize_ef_fwd=0):
        raise AssertionError(f"the reference step launched {launched}")
    del model, batch, params, grads
    torch.cuda.empty_cache()
    return loss.item(), norms


def check_tp_steps(tag, recs, card, tokens, want_loss0=None, tol=None,
                   want_gnorm0=None, gnorm_tol=None):
    """Log and check every rank's steps of a TP/GSPMD phase: launches as
    ``expected_launches`` and the plan's K2 count give them, finite
    losses the ranks agree on, the members' blocks bit-equal, and, given,
    step 0's loss within ``tol`` relative of ``want_loss0`` and its
    gradient norm within ``gnorm_tol`` relative of ``want_gnorm0``; then
    the card's memory left beside the four peaks."""
    import torch
    r0 = recs[0]
    want = dict(r0["expected"], quantize_ef_fwd=r0["plan_k2"])
    for rank, rec in enumerate(recs):
        for st in rec["steps"]:
            log(f"[{tag}] rank {rank} {rec['coords']} step {st['step']}: "
                f"loss={st['loss']:.6f} grad_norm={st['grad_norm']:.4f} "
                f"step_s={st['dt']:.3f} tok/s={tokens / st['dt']:.0f} (global batch) "
                f"launches={st['launches']} (expected {want}) TP/FSDP collectives "
                f"{st['calls']} blocks_bit_equal={st['agree']} ({st['shared']} "
                f"blocks held by 2+ members; checked in {st['check_s']:.2f} s) "
                f"peak_mem_gb={st['peak_gb']:.2f} | {card}")
            if st["launches"] != want:
                raise AssertionError(f"[{tag}] rank {rank} step {st['step']} launched "
                                     f"{st['launches']}, expected {want}")
            if not (math.isfinite(st["loss"]) and st["agree"] and st["shared"] > 0):
                raise AssertionError(f"[{tag}] rank {rank} step {st['step']}: {st}")
        if [a["loss"] for a in rec["steps"]] != [a["loss"] for a in r0["steps"]]:
            raise AssertionError(f"[{tag}] rank {rank} disagrees on the loss")
    log(f"[{tag}] params {r0['n_params']}, {r0['local_params']} a rank; memory "
        f"after init {r0['mem_after_init_gb']:.2f} GB a rank")
    if want_loss0 is not None:
        loss0 = r0["steps"][0]["loss"]
        rel = abs(loss0 - want_loss0) / abs(want_loss0)
        log(f"[{tag}] step-0 loss {loss0!r} against {want_loss0!r}: rel diff "
            f"{rel:.2e} (tol {tol})")
        if not rel <= tol:
            raise AssertionError(f"[{tag}] step 0's loss is off its reference")
    if want_gnorm0 is not None:
        gnorm0 = r0["steps"][0]["grad_norm"]
        rel = abs(gnorm0 - want_gnorm0) / abs(want_gnorm0)
        log(f"[{tag}] step-0 grad_norm {gnorm0!r} against {want_gnorm0!r}: rel diff "
            f"{rel:.2e} (tol {gnorm_tol})")
        if not rel <= gnorm_tol:
            raise AssertionError(f"[{tag}] step 0's gradient norm is off its reference")
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    peaks = [max(st["peak_gb"] for st in rec["steps"]) for rec in recs]
    log(f"[{tag}] the card's {total:.2f} GB less the four ranks' peaks "
        f"({', '.join(f'{p:.2f}' for p in peaks)} GB allocated): "
        f"{total - sum(peaks):.2f} GB free of allocations | {card}")


def four_rank_phases(torch, card, train_recs, phase_done):
    """One spawn of 4 ranks sharing the card (:func:`four_rank`), then each
    phase's checks in turn: ``[train-tp]`` against ``[train]``'s step-0
    loss, ``[train-gspmd]`` against one unsharded forward (its step-2
    checkpoint restored bit for bit), ``[train-gspmd-rwkv]``,
    ``[train-tp-hybrid]``, ``[serve-mesh]`` and ``[seq-par]``."""
    from repro_torch.launch import train as train_cli
    ckpt_dir = os.path.join(HERE, "build", "ckpt_gspmd")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    need = int(1_720_574_976 * (2 + 8) * 1.25)  # bf16 params, fp32 m and v, uncut

    free = shutil.disk_usage(ckpt_dir).free
    if free < need:
        raise RuntimeError(f"{free} bytes free under {ckpt_dir}; [train-gspmd] needs {need}")
    out_dir = os.path.join(HERE, "build", "mamba_cut")
    for path in (out_dir, SEQ_PAR_DIR):
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
    refs = {}
    for tag, run in GSPMD_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        refs[tag] = gspmd_reference(torch, tag)
        log(f"[{tag}] unsharded {run['arch']} forward and backward on the global batch "
            f"({run['rows']} x {run['seq']}), its kernels in the forward, this process: "
            f"loss {refs[tag][0]!r}, grad_norm {refs[tag][1]['whole']!r}, tail norm "
            f"{refs[tag][1]['tail']!r} in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    inputs = sm_inputs()
    t0 = time.perf_counter()
    recs = train_cli.run_ranks(four_rank, TP_RANKS, ckpt_dir, out_dir, inputs,
                               timeout=2400)
    log(f"[train-tp] [train-gspmd] [train-gspmd-rwkv] [train-tp-hybrid] [serve-mesh] "
        f"[seq-par] four ranks over gloo on one card: "
        f"{time.perf_counter() - t0:.1f} s wall | {card}")
    phase_done("train-tp, train-gspmd, train-gspmd-rwkv, train-tp-hybrid, serve-mesh, "
               "seq-par: the 4 ranks' runs")

    tp = [r["train-tp"] for r in recs]
    log(f"[train-tp] qwen2-0.5b fp32 (pod, data, model) = (2, 1, 2), int8 slow tier, "
        f"ZeRO-1, B=2 S=2048 a DP member, {len(tp[0]['steps'])} step(s) through the "
        f"CLI's run_rank; "
        f"{tp[0]['plan_k2']} int8 slow chunks a rank a step (the plan on local "
        f"shapes) | {card}")
    check_tp_steps("train-tp", tp, card, TP_TOKENS,
                   train_recs[0]["steps"][0]["loss"], 1e-4)
    phase_done("train-tp: qwen2-0.5b at TP 2, 4 ranks")

    tag = "train-gspmd"
    gspmd_check(card, tag, [r[tag] for r in recs], *refs[tag])
    ckpt = GSPMD_RUNS[tag]["ckpt"]
    step_dir = os.path.join(ckpt_dir, f"step_{ckpt:08d}")
    save = recs[0][tag]["ckpt_log"][0]
    write = recs[0][tag]["writes"][0]
    log(f"[train-gspmd] checkpoint step {ckpt}: {dir_bytes(step_dir)} bytes; "
        f"gather to member 0 {save['gather_s']:.2f} s, blocking {save['blocking_s']:.2f} s, "
        f"writer {write['write_s']:.2f} s | {card}")
    for rank, rec in enumerate(r[tag] for r in recs):
        r = rec["restore"]
        log(f"[train-gspmd] rank {rank}: restored step {r['step']} into a fresh model "
            f"in {r['restore_s']:.2f} s; {r['equal']} of {r['leaves']} blocks "
            f"(parameters, m, v, step) bit-equal to this rank's at step {ckpt}")
        if r["step"] != ckpt or r["equal"] != r["leaves"] \
                or r["leaves"] != len(rec["ckpt_digests"]):
            raise AssertionError(f"[train-gspmd] rank {rank}'s restore differs: {r}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    phase_done(f"train-gspmd: qwen3-1.7b ({GSPMD_RUNS['train-gspmd']['depth']} layers) "
               f"FSDP x TP, 4 ranks, checkpoint")

    tag = "train-gspmd-rwkv"
    gspmd_check(card, tag, [r[tag] for r in recs], *refs[tag])
    phase_done(f"train-gspmd-rwkv: rwkv6-1.6b ({GSPMD_RUNS['train-gspmd-rwkv']['depth']} "
               f"layers) FSDP x TP, 4 ranks")
    hybrid_phase(torch, card, [r["hybrid"] for r in recs], out_dir)
    phase_done("train-tp-hybrid: jamba and rwkv6 under a model axis, "
               "one Mamba layer and one MoE layer cut, 4 ranks")
    serve_mesh_phase(torch, card, phase_done, [r["serve-mesh"] for r in recs], inputs)
    seq_par_phase(torch, card, phase_done, [r["seq-par"] for r in recs], inputs)


def gspmd_check(card, tag, recs, ref, want):
    """A ``GSPMD_RUNS`` run's four ranks' records, checked by
    :func:`check_tp_steps` against one unsharded step of the same global
    batch (``ref`` its loss, ``want`` its :func:`grad_norms`): step 0's
    loss to 1e-3 and its gradient norms to the run's ``gnorm_tol``,
    relative; each layer's is printed beside the reference's."""
    run = GSPMD_RUNS[tag]
    ckpt = f", a checkpoint at step {run['ckpt']}" if run["ckpt"] else ""
    cut = f" cut to {run['depth']} layers" if run.get("depth") else ""
    log(f"[{tag}] {run['arch']}{cut} {run['fields']} GSPMD (pod, data, model) = "
        f"{tuple(run['sizes'].values())}, FSDP over data x TP over model, B=1 "
        f"S={run['seq']} a DP member, {run['steps']} steps{ckpt}: "
        f"{recs[0]['s']:.1f} s on rank 0 | {card}")
    tol = run["gnorm_tol"]
    check_tp_steps(tag, recs, card, run["rows"] * run["seq"], ref, 1e-3,
                   want["whole"], tol["whole"])
    got = recs[0]["norms0"]
    rel = abs(got["tail"] - want["tail"]) / want["tail"]
    layers = " ".join(f"{abs(a - b) / b:.2e}"
                      for a, b in zip(got["layers"], want["layers"]))
    log(f"[{tag}] step-0 tail norm (the leaves nearest the loss) {got['tail']!r} "
        f"against {want['tail']!r}: rel diff {rel:.2e} (tol {tol['tail']}); each "
        f"layer's gradient norm against the unsharded step's, rel diff, first layer "
        f"to last: {layers}")
    if any(r["norms0"] != got for r in recs) or not rel <= tol["tail"]:
        raise AssertionError(f"[{tag}] step 0's tail norm is off its reference")


#: ``[train-tp-hybrid]`` (a)-(c): {part: (arch, mesh sizes, mode)}, the smoke
#: configs with their experts (``get_smoke_arch``) on four ranks, B=2 S=512
#: a DP member, 1 step,
#: bf16,
#: ``remat="full"``, K1, K3 and K4 in the forward
#: and the recompute, the int8 slow tier in the DFabric step
HYBRID_RUNS = {
    "a": ("jamba-1.5-large-398b", {"pod": 2, "data": 1, "model": 2}, "dfabric"),
    "b": ("jamba-1.5-large-398b", GSPMD_SIZES, "gspmd"),
    "c": ("rwkv6-1.6b", {"pod": 2, "data": 1, "model": 2}, "dfabric"),
}
HYBRID_FIELDS = dict(BF16, remat="full", attn_impl="kernel", use_kernel_ssm=True)
HYBRID_ROWS, HYBRID_SEQ, HYBRID_STEPS = 2, 512, 1
#: (d) one full-width Mamba layer of the jamba cut over model = 2, one dtype
#: a DP member of ``GSPMD_SIZES``: (dtype, seed, tolerance of the assembled
#: gradients against the unsharded layer's, ``jamba_layer_check``'s).  In
#: bf16 the atol is that share of each leaf's largest value (the form of
#: ``tests/test_torch_tp.py``'s), and each leaf's relative error
#: ||g - g_ref|| / ||g_ref|| is held to 3e-2 (``test_torch_train_mixed.py``'s
#: bf16 bound): ``w_in``'s gradient sums 2048 tokens' bf16 products, whose
#: rounding puts elements that cancel 0.0625 off at values near 1
MAMBA_CUT = {0: ("float32", 11, 1e-4), 1: ("bfloat16", 12, 2e-2)}
BF16_LEAF_REL = 3e-2
MOE_CUT_SEED = 13
#: the sequence (B=1) of the full-width Mamba layer that ``[train-jamba]``,
#: ``[train-tp-hybrid]`` (d) and ``[seq-par]`` (h) hold against the plain layer
MAMBA_LAYER_SEQ = 1024


def mamba_layer(torch, dt_name, seed):
    """(the jamba cut's arch, one full-width Mamba layer's leaves in
    ``dt_name``, an input and an output cotangent, B=1 S=MAMBA_LAYER_SEQ),
    drawn on the card from ``seed``."""
    from repro_torch.configs import one_card_arch
    from repro_torch.models import ssm as SSM
    arch = one_card_arch("jamba-1.5-large-398b")[0]
    dt, dev = getattr(torch, dt_name), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = SSM.init_mamba(arch, gen, (), dt, dev)
    x = (torch.randn(1, MAMBA_LAYER_SEQ, arch.d_model, generator=gen, device=dev)
         * 0.5).to(dt)
    gy = torch.randn(1, MAMBA_LAYER_SEQ, arch.d_model, generator=gen, device=dev).to(dt)
    return arch, p, x, gy


def layer_specs(arch, parent, leaves, sizes, fsdp=None):
    """{leaf: spec} of one layer's ``leaves`` ({path: tensor} under the
    layer kind ``parent``, "mamba" or "moe") by the sharding rules, TP over
    ``model`` (FSDP over ``fsdp``)."""
    from repro_torch.models import sharding
    specs = sharding.param_specs(arch, {f"{parent}/{k}": tuple(t.shape)
                                        for k, t in leaves.items()},
                                 sharding.MeshInfo(sizes, fsdp_axis=fsdp))
    return {k: specs[f"{parent}/{k}"] for k in leaves}


def mamba_member_grads(torch, mesh, out_dir, sp=None):
    """(d) on this rank: its block of the Mamba layer of ``MAMBA_CUT`` (its
    DP member's dtype) over ``model``, forward with K4 on its 8192
    channels and backward; the input's and its blocks' gradients saved
    under ``out_dir`` for the parent.  With ``sp`` (``[seq-par]`` (h)) the
    input and the output cotangent are this member's rows of the
    sequence, which the layer gathers.  Returns K4's launches and the
    seconds."""
    from repro_torch.core import prims
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.models import sharding
    from repro_torch.models import ssm as SSM
    dt_name, seed, _ = MAMBA_CUT[mesh.coords["data"]]
    arch, p, x, gy = mamba_layer(torch, dt_name, seed)
    specs = layer_specs(arch, "mamba", p, mesh.sizes)
    local = {k: sharding.local_block(t, specs[k], mesh.coords, mesh.sizes)
             .contiguous().requires_grad_(True) for k, t in p.items()}
    del p
    if sp is not None:
        n = x.shape[1] // mesh.sizes[sp]
        x, gy = (t.narrow(1, mesh.coords[sp] * n, n).contiguous() for t in (x, gy))
    x.requires_grad_(True)
    torch.cuda.synchronize()
    before, t0 = ms_kernel.LAUNCHES, time.perf_counter()
    with prims.bind(mesh):
        y, _ = SSM.apply_mamba(arch, local, x, use_kernel=True, axis="model", sp=sp)
        grads = torch.autograd.grad(y, [x] + list(local.values()), gy)
    torch.cuda.synchronize()
    out = dict(dtype=dt_name, launches=ms_kernel.LAUNCHES - before,
               s=time.perf_counter() - t0, channels=local["A_log"].shape[0],
               rows=x.shape[1])
    torch.save({k: g.cpu() for k, g in zip(["x"] + list(local), grads)},
               os.path.join(out_dir, f"{'sp_' if sp else ''}{dt_name}_"
                                     f"{mesh.coords['model']}.pt"))
    return out


def moe_member(torch, mesh):
    """(e) on this rank: one deepseek-moe-16b MoE layer in fp32 and a 2-row
    global batch (S=2048), whole (output, aux loss, dropped slots), then
    under FSDP x TP: each leaf this member's block, the FSDP blocks
    gathered on use, the experts split over ``model``, this DP member's
    row routed with the whole batch (``token_axes``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prims
    from repro_torch.models import layers as L
    from repro_torch.models import sharding
    from repro_torch.models.transformer import _gather_fsdp
    from repro_torch.utils.trees import tree_from_paths, tree_paths
    arch, dev = get_arch("deepseek-moe-16b"), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(MOE_CUT_SEED)
    p = tree_paths(L.init_moe(arch, gen, (), torch.float32, dev))
    # a direction shared by every token (as a model's hidden states have)
    # skews the routing past the capacity: about a fifth of the slots drop
    x = (torch.randn((2, S_MAIN, arch.d_model), generator=gen, device=dev)
         + 0.5 * torch.randn(arch.d_model, generator=gen, device=dev))
    L.DROP_LOG = []
    try:
        with torch.no_grad():
            whole, whole_aux = L.apply_moe(arch, tree_from_paths(p), x)
        whole_drops = int(L.DROP_LOG.pop().sum())
        specs = layer_specs(arch, "moe", p, mesh.sizes, fsdp="data")
        local = {k: sharding.local_block(t, specs[k], mesh.coords, mesh.sizes).contiguous()
                 for k, t in p.items()}
        del p
        row = mesh.coords["data"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prims.bind(mesh), torch.no_grad():
            pl = _gather_fsdp(tree_from_paths(local), tree_from_paths(specs), "data")
            y, aux = L.apply_moe(arch, pl, x[row:row + 1], dispatch_spec=(None, "model"),
                                 shared_axis="model", token_axes=("data",))
        torch.cuda.synchronize()
        drops = int(L.DROP_LOG.pop().sum())
    finally:
        L.DROP_LOG = None
    return dict(drops=drops, whole_drops=whole_drops, s=time.perf_counter() - t0,
                err=(y[0] - whole[row]).abs().max().item(),
                scale=whole.abs().max().item(), aux=aux.item(),
                whole_aux=whole_aux.item(), experts=pl["we_in"].shape[0],
                local_params=sum(t.numel() for t in local.values()))


def hybrid_runs(torch, out_dir):
    """This rank's ``[train-tp-hybrid]``: the ``HYBRID_RUNS`` (each recorded
    by :func:`step_recorder`), then (d) and (e) on ``GSPMD_SIZES``."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig, dp_axes_of
    out = {}
    for part, (name, sizes, mode) in HYBRID_RUNS.items():
        rec = out[part] = {"steps": []}
        start, on_step = step_recorder(rec)
        n_dp = math.prod(sizes[a] for a in dp_axes_of(sizes))
        cfg = TrainerConfig(steps=HYBRID_STEPS, lr=3e-4, warmup=1, mode=mode,
                            codec="int8" if mode == "dfabric" else None)
        trainer = Trainer(build_model(get_smoke_arch(name),
                                      ModelSettings(**HYBRID_FIELDS),
                                      device="cuda", seed=0),
                          prims.Mesh(sizes),
                          ShapeConfig("custom", HYBRID_SEQ, HYBRID_ROWS * n_dp,
                                      "train"), cfg)
        params, opt, step0 = trainer.init_state()
        start(trainer)
        trainer.train(params, opt, step0, on_step=on_step)
        del trainer, params, opt
    mesh = prims.Mesh(GSPMD_SIZES)
    out["d"] = mamba_member_grads(torch, mesh, out_dir)
    torch.cuda.empty_cache()
    out["e"] = moe_member(torch, mesh)
    out["coords"] = mesh.coords
    return out


def check_mamba_cut(torch, recs, out_dir, card, sp=False):
    """(d) in this process: the unsharded Mamba layer of each ``MAMBA_CUT``
    dtype with K4, its input's and parameters' gradients against the two
    members' put together (``sharding.assemble``: ``w_in`` from the
    members' channels of both halves).  With ``sp`` (``[seq-par]`` (h):
    the members' layer under the sequence split, the input's gradient
    their rows, joined) against the unsharded layer through the plain
    scan."""
    from repro_torch.kernels.mamba_scan import kernel as ms_kernel
    from repro_torch.models import sharding
    from repro_torch.models import ssm as SSM
    sizes = {"model": 2}
    tag, key = ("[seq-par] (h)", "mamba") if sp else ("[train-tp-hybrid] (d)", "d")
    for data, (dt_name, seed, tol) in MAMBA_CUT.items():
        members = [r[key] for r in recs if r["coords"]["data"] == data]
        arch, p, x, gy = mamba_layer(torch, dt_name, seed)
        x.requires_grad_(True)
        for t in p.values():
            t.requires_grad_(True)
        torch.cuda.synchronize()
        before, t0 = ms_kernel.LAUNCHES, time.perf_counter()
        y, _ = SSM.apply_mamba(arch, p, x, use_kernel=not sp)
        ref = dict(zip(["x"] + list(p), torch.autograd.grad(y, [x] + list(p.values()), gy)))
        torch.cuda.synchronize()
        ref_s, launched = time.perf_counter() - t0, ms_kernel.LAUNCHES - before
        specs = layer_specs(arch, "mamba", p, sizes)
        del y, p
        blocks = [torch.load(os.path.join(out_dir, f"{'sp_' if sp else ''}{dt_name}_{m}.pt"))
                  for m in (0, 1)]
        if sp:
            gx = torch.cat([blocks[0]["x"], blocks[1]["x"]], 1)
        elif torch.equal(blocks[0]["x"], blocks[1]["x"]):
            gx = blocks[0]["x"]
        else:
            raise AssertionError(f"{tag} {dt_name}: the members' input gradients differ")
        worst, worst_rel, past = 0.0, 0.0, 0
        for k, want in ref.items():
            got = gx if k == "x" else sharding.assemble(
                {(("model", m),): blocks[m][k] for m in (0, 1)}, specs[k],
                want.shape, sizes, lambda ps, d: torch.cat(ps, d))
            got, want = got.to(want.device).float(), want.float()
            diff = (got - want).abs()
            atol = tol if dt_name == "float32" else tol * want.abs().max().item()
            torch.testing.assert_close(got, want, rtol=tol, atol=atol,
                                       msg=lambda m: f"{tag} {dt_name} d{k}: {m}")
            rel = ((got - want).double().norm() / want.double().norm()).item()
            if dt_name != "float32" and not rel <= BF16_LEAF_REL:
                raise AssertionError(f"{tag} {dt_name} d{k}: relative error {rel:.3e}")
            worst, worst_rel = max(worst, diff.max().item()), max(worst_rel, rel)
            past += int((diff > tol + tol * want.abs()).sum())
            del got, diff
        scope = "" if dt_name == "float32" else " of each leaf's largest value"
        split = (f", the sequence split: {members[0]['rows']} rows a member, gathered"
                 if sp else "")
        log(f"{tag} one Mamba layer of the jamba cut at full width "
            f"(d_model {arch.d_model}, d_inner {arch.mamba.expand * arch.d_model}, "
            f"d_state {arch.mamba.d_state}) {dt_name} B=1 S={MAMBA_LAYER_SEQ} over model = 2"
            f"{split}: "
            f"{members[0]['channels']} channels a member, K4 launches a member "
            f"{[m['launches'] for m in members]}, forward + backward "
            f"{', '.join(format(m['s'], '.3f') for m in members)} s a member; unsharded "
            f"{'through the plain scan' if sp else 'with K4'} ({launched} K4 launch) "
            f"{ref_s:.3f} s in this process; the input's and "
            f"{len(ref) - 1} parameter gradients put together within rtol {tol}, atol "
            f"{tol}{scope} "
            f"(max abs diff {worst:.3e}; {past} elements past atol = rtol = {tol}; worst "
            f"leaf relative error {worst_rel:.2e}) | {card}")
        if launched != (0 if sp else 1) or any(m["launches"] != 1 for m in members):
            raise AssertionError(f"{tag}: K4 did not run once a member")
        del ref, blocks, x, gy
        torch.cuda.empty_cache()


def hybrid_phase(torch, card, recs, out_dir):
    """``[train-tp-hybrid]`` (``recs``: each rank's :func:`hybrid_runs`):
    (a)-(c) checked by :func:`check_tp_steps`; (d) by
    :func:`check_mamba_cut`; (e) the members' dropped slots summed equal to
    the unsharded layer's on the 2-row batch, the output within 1e-5 of
    its largest value (fp32) and the aux loss within 1e-6."""
    for part, (name, sizes, mode) in HYBRID_RUNS.items():
        tag = f"train-tp-hybrid ({part})"
        log(f"[{tag}] {name} smoke with its experts, {mode} on (pod, data, model) = "
            f"{tuple(sizes.values())}{', int8 slow tier' if mode == 'dfabric' else ''}, "
            f"{HYBRID_FIELDS}, B={HYBRID_ROWS} S={HYBRID_SEQ} a DP member, "
            f"{HYBRID_STEPS} steps | {card}")
        check_tp_steps(tag, [r[part] for r in recs], card,
                       HYBRID_ROWS * 2 * HYBRID_SEQ)
    check_mamba_cut(torch, recs, out_dir, card)
    shutil.rmtree(out_dir, ignore_errors=True)
    members = [r["e"] for r in recs if r["coords"]["model"] == 0]
    drops = sum(m["drops"] for m in members)
    for rank, r in enumerate(recs):
        e = r["e"]
        aux_rel = abs(e["aux"] - e["whole_aux"]) / e["whole_aux"]
        log(f"[train-tp-hybrid] (e) rank {rank} {r['coords']}: deepseek-moe-16b MoE "
            f"layer fp32 under FSDP x TP, {e['experts']} of 64 experts, "
            f"{e['local_params']} parameters held; its row of the 2 x {S_MAIN} batch: "
            f"{e['drops']} slots dropped (the unsharded layer {e['whole_drops']}), "
            f"output max abs diff {e['err']:.3e} of {e['scale']:.3e}, aux rel diff "
            f"{aux_rel:.2e}, {e['s']:.3f} s | {card}")
        if not (e["err"] <= 1e-5 * e["scale"] and aux_rel <= 1e-6 and e["experts"] == 32):
            raise AssertionError(f"[train-tp-hybrid] (e) rank {rank}: {e}")
    whole = members[0]["whole_drops"]
    log(f"[train-tp-hybrid] (e) the DP members' dropped slots {drops} (sum) against the "
        f"unsharded layer's {whole} on the 2-row batch")
    if drops != whole or whole == 0:
        raise AssertionError("[train-tp-hybrid] (e): the drops differ from the "
                             "unsharded layer's")


def dir_bytes(path) -> int:
    return sum(e.stat().st_size for e in os.scandir(os.path.join(path, "arrays"))) \
        + os.path.getsize(os.path.join(path, "index.json"))


def compare_checkpoints(a, b):
    """{kind: (elements that differ, all elements, max |a - b|)} over the
    leaves of two checkpoint step dirs, by kind: params, m, v, ef (the
    data state's integers under their own names)."""
    import numpy as np
    out = {}
    for name in sorted(os.listdir(os.path.join(a, "arrays"))):
        kind = ("params" if name.startswith("params__") else
                name.rsplit("__", 1)[-1][:-len(".npy")])
        x = np.load(os.path.join(a, "arrays", name), mmap_mode="r")
        y = np.load(os.path.join(b, "arrays", name), mmap_mode="r")
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}: {x.shape} {x.dtype} vs {y.shape} {y.dtype}")
        d = np.subtract(x, y)
        n, tot, mx = out.get(kind, (0, 0, 0.0))
        out[kind] = (n + int(np.count_nonzero(d)), tot + x.size,
                     max(mx, float(np.abs(d).max())))
        del x, y, d
    return out


def run_checkpoint_phase(ckpt_root, ref_recs, card):
    """The checkpoint phase, after the training phase (run a): (b) the
    same run with a failure injected after the step-2 save, then a restart
    in new ranks that restores step 2 and runs steps 2-3; (c) an elastic
    restart of that step-2 checkpoint on one rank (mesh (1, 1, 1), the
    whole global batch) for one step.  Checks and prints what each
    restored, its losses against (a), the checkpoint's bytes on disk and
    its save and restore seconds."""
    import numpy as np
    import torch
    from repro_torch.launch import train as train_cli
    ref_dir, ft_dir = (os.path.join(ckpt_root, d) for d in ("ref", "ft"))
    ref_loss = {st["step"]: st["loss"] for st in ref_recs[0]["steps"]}
    n_params = ref_recs[0]["n_params"]
    want_bytes = 4 * n_params * 4  # params, m, v, EF in fp32

    # the uninterrupted run's saves: size, blocking part, writer, step time
    for w, blk in zip(ref_recs[0]["writes"], ref_recs[0]["ckpt_log"]):
        log(f"[ckpt] (a) save of step {w['step']}: {w['bytes']} bytes snapshot "
            f"(expected ≈ 4 x {n_params} x 4 = {want_bytes}); blocking "
            f"{blk['blocking_s']:.3f} s (gather {blk['gather_s']:.3f} s, host "
            f"snapshot {w['snapshot_s']:.3f} s); writer thread {w['write_s']:.3f} s "
            f"({w['bytes'] / w['write_s'] / 1e9:.2f} GB/s) | {card}")
    on_disk = dir_bytes(os.path.join(ref_dir, f"step_{TRAIN_STEPS:08d}"))
    log(f"[ckpt] (a) bytes on disk of step {TRAIN_STEPS}: {on_disk} ({on_disk / 1e9:.2f} GB)")
    if abs(on_disk - want_bytes) > 0.01 * want_bytes:
        raise AssertionError(f"checkpoint holds {on_disk} bytes, expected ≈ {want_bytes}")
    steps = ref_recs[0]["steps"]
    for st in steps:
        saved = st["step"] + 1 in {w["step"] for w in ref_recs[0]["writes"]}
        log(f"[ckpt] (a) step {st['step']}: step_s {st['dt']:.3f}, wall from the "
            f"previous step's end {st['wall']:.3f} s"
            + (" (ends in a save)" if saved else ""))
    shutil.rmtree(os.path.join(ref_dir, f"step_{CKPT_EVERY:08d}"))  # disk

    # (b) the crash: SimulatedFailure right after the step-2 save
    t0 = time.perf_counter()
    crash = train_cli.run_ranks(train_rank, TRAIN_RANKS, ft_dir, "crash", timeout=900)
    log(f"[ckpt] (b) crash run: {time.perf_counter() - t0:.1f} s wall, ranks "
        f"started, two steps, the save and its drain")
    check_train_steps("ckpt crash", crash, TRAIN_RANKS, 9)
    if not all(r["error"] == "SimulatedFailure" and len(r["steps"]) == FAIL_AT
               for r in crash):
        raise AssertionError(f"the injected failure did not fire after step {FAIL_AT}")
    with open(os.path.join(ft_dir, "LATEST")) as f:
        latest = f.read().strip()
    if latest != f"step_{FAIL_AT:08d}" or dir_bytes(os.path.join(ft_dir, latest)) != on_disk:
        raise AssertionError(f"the crash left LATEST={latest!r}, not a complete step {FAIL_AT}")
    log(f"[ckpt] (b) crash: SimulatedFailure after the step-{FAIL_AT} save on both "
        f"ranks; the write was drained first: {latest} complete, "
        f"{dir_bytes(os.path.join(ft_dir, latest))} bytes")

    # (c) elastic: restore step 2 on one rank, the whole global batch, one
    # step; the rank is this process (a world of one, no spawn), which holds
    # no model here, and keeps its SIGTERM handler
    t0 = time.perf_counter()
    handler = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as tmp:
        el = [train_rank(0, 1, f"file://{os.path.join(tmp, 'store')}", ft_dir, "elastic")]
    signal.signal(signal.SIGTERM, handler)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ckpt] (c) elastic run in this process: {time.perf_counter() - t0:.1f} s wall")
    check_train_steps("ckpt elastic", el, 1,
                      plan_slow_chunks({"pod": 1, "data": 1, "model": 1}))
    st = el[0]["steps"]
    if [s["step"] for s in st] != [FAIL_AT] or el[0]["restore_s"] is None:
        raise AssertionError(f"the elastic run did not restore step {FAIL_AT}: {st}")
    ok = abs(st[0]["loss"] - ref_loss[FAIL_AT]) <= 1e-4 + 5e-3 * abs(ref_loss[FAIL_AT])
    log(f"[ckpt] (c) elastic: mesh (1,1,1) restored step {FAIL_AT} in "
        f"{el[0]['restore_s']:.3f} s and ran it: loss {st[0]['loss']!r} vs (a) "
        f"{ref_loss[FAIL_AT]!r} (rel {abs(st[0]['loss'] / ref_loss[FAIL_AT] - 1):.2e}; "
        f"tol rtol 5e-3 atol 1e-4: {'ok' if ok else 'FAIL'}); K1 {st[0]['fa']}, "
        f"K2 {st[0]['q']} (the plan's slow chunks on one rank: "
        f"{el[0]['slow_chunks']}); step_s {st[0]['dt']:.3f}, peak "
        f"{st[0]['peak_gb']:.2f} GB | {card}")
    if not ok:
        raise AssertionError("the elastic step's loss is off the reference")

    # (b) the restart in new ranks: restore step 2, run steps 2-3
    t0 = time.perf_counter()
    out = train_cli.run_ranks(train_rank, TRAIN_RANKS, ft_dir, "restart", timeout=900)
    log(f"[ckpt] (b) restart run: {time.perf_counter() - t0:.1f} s wall")
    check_train_steps("ckpt restart", out, TRAIN_RANKS, 9)
    for rank, rec in enumerate(out):
        if [s["step"] for s in rec["steps"]] != [FAIL_AT, FAIL_AT + 1]:
            raise AssertionError(f"rank {rank} did not resume at step {FAIL_AT}")
        log(f"[ckpt] (b) restart rank {rank}: restored step {FAIL_AT} in "
            f"{rec['restore_s']:.3f} s | {card}")
    for s in out[0]["steps"]:
        diff = abs(s["loss"] - ref_loss[s["step"]])
        log(f"[ckpt] (b) step {s['step']}: loss {s['loss']!r} vs (a) "
            f"{ref_loss[s['step']]!r} (abs diff {diff:.3e}, "
            f"{'bit-equal' if diff == 0 else 'differs'})")
        if diff > 1e-5 + 1e-4 * abs(ref_loss[s["step"]]):  # the JAX test's
            raise AssertionError(f"restart step {s['step']} loss is off the reference")
    if out[0]["steps"][0]["loss"] != ref_loss[FAIL_AT]:
        raise AssertionError("the restored parameters give another step-2 loss")
    final = f"step_{TRAIN_STEPS:08d}"
    t0 = time.perf_counter()
    diff = compare_checkpoints(os.path.join(ref_dir, final), os.path.join(ft_dir, final))
    log(f"[ckpt] (b) step-{TRAIN_STEPS} checkpoints compared in "
        f"{time.perf_counter() - t0:.1f} s")
    for kind, (n, tot, mx) in diff.items():
        log(f"[ckpt] (b) step-{TRAIN_STEPS} checkpoint vs (a): {kind} "
            f"{'bit-equal' if n == 0 else f'{n} of {tot} elements differ, max abs diff {mx:.3e}'}")
    bound = 2 * train_args(ft_dir, "restart").lr * TRAIN_STEPS  # as the trainer tests
    if diff["params"][2] > bound:
        raise AssertionError(f"restart parameters moved {diff['params'][2]} from (a)")
    if any(n for n, _, _ in diff.values()):
        log("[ckpt] (b) cause: the checkpoint holds pod 0's int8 error feedback "
            "only (the JAX format: the EF spec names no pod axis), so rank 1 "
            "restarts with rank 0's residual and its step-2 slow leg rounds "
            "differently; the step-2 loss, before that sync, is bit-equal")
    return el, out


def prefill_checks(torch, gen, dev, arch, settings, counters, expected,
                   n_plain, seq=S_MAIN):
    """The full-width bf16 prefill of B_MAIN x ``seq`` tokens (and for an
    encoder-decoder frame embeddings drawn from the seed) through the
    kernels, each launched as often as ``expected`` ({kernel: launches per
    prefill}) says and the others not at all (asserted), its times and
    ``n_plain`` times of the plain path; for an arch with experts, the
    (token, k) slots each MoE layer dropped in that prefill.  Returns (the
    bf16 model, launches per prefill)."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    expected = {k: expected.get(k, 0) for k in counters}
    kernel_st, plain_st = settings("bfloat16", True), settings("bfloat16", False)
    model = build_model(arch, kernel_st, device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, arch.vocab, (B_MAIN, seq), generator=gen, device=dev)
    frames = (torch.randn(B_MAIN, arch.encoder.n_frames, arch.d_model, generator=gen,
                          device=dev) if arch.is_encdec else None)
    L.DROP_LOG = [] if arch.moe is not None else None
    try:
        (logits, cache), launches = drive_path(counters,
                                               lambda: model.prefill(tokens, frames))
        drops = [int(d.sum()) for d in L.DROP_LOG or ()]
    finally:
        L.DROP_LOG = None
    if launches != expected:
        raise AssertionError(f"{arch.name} prefill launched {launches}, "
                             f"expected {expected}")
    if logits.shape != (B_MAIN, arch.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch.name} prefill logits bad: {tuple(logits.shape)}")
    shapes = {off: {k: tuple(v.shape) for k, v in c.items()}
              for off, c in cache.items()}
    log(f"[prefill] {arch.name} cache shapes {shapes}")
    del logits, cache
    if arch.moe is not None:
        moe, T = arch.moe, B_MAIN * S_MAIN
        C = L.moe_capacity(T // model.settings.moe_groups, moe.top_k,
                           moe.num_experts, moe.capacity_factor)
        if len(drops) != len(arch.moe_layer_ids()):
            raise AssertionError(f"{len(drops)} MoE layers recorded drops, "
                                 f"expected {len(arch.moe_layer_ids())}")
        log(f"[moe] {arch.name} bf16 prefill B={B_MAIN} S={S_MAIN}: T={T} tokens "
            f"x top-{moe.top_k} = {T * moe.top_k} (token, k) slots a layer over "
            f"{moe.num_experts} experts at C={C} (capacity_factor "
            f"{moe.capacity_factor}); dropped per MoE layer {drops}: total "
            f"{sum(drops)} of {T * moe.top_k * len(drops)} "
            f"({sum(drops) / (T * moe.top_k * len(drops)):.4%}), max layer "
            f"{max(drops)} ({max(drops) / (T * moe.top_k):.4%})")

    before = {k: mod.LAUNCHES for k, mod in counters.items()}
    kernel_runs = host_ms(lambda: model.prefill(tokens, frames), 5)
    if any(mod.LAUNCHES - before[k] != 5 * expected[k]
           for k, mod in counters.items()):
        raise AssertionError("LAUNCHES did not grow as expected per prefill")
    model.settings = plain_st
    plain_runs = host_ms(lambda: model.prefill(tokens, frames), n_plain)
    model.settings = kernel_st
    prefill_ms = statistics.median(kernel_runs)
    per_prefill = {k: n for k, n in launches.items() if n}
    enc = (f" frames=({B_MAIN},{arch.encoder.n_frames},{arch.d_model}) "
           f"through {arch.encoder.n_layers} encoder layers" if arch.is_encdec else "")
    log(f"[prefill] {arch.name} full width ({n_params} params) bf16 B={B_MAIN} "
        f"S={seq}{enc}: launches/prefill={per_prefill} "
        f"prefill_ms median={prefill_ms:.2f} runs={[round(t, 2) for t in kernel_runs]} "
        f"tok/s={B_MAIN * seq / prefill_ms * 1e3:.0f}; plain path "
        f"median={statistics.median(plain_runs):.2f} ms "
        f"runs={[round(t, 2) for t in plain_runs]}")
    return model, per_prefill


def fp32_checks(torch, gen, dev, arch, settings, fp32_layers=None,
                full_depth=True):
    """In fp32 at S=256: the kernel path's logits against the plain path's
    beside the model's fp32 noise floor, at full depth unless
    ``full_depth`` is False; then the checks, kernel vs plain logits and
    prefill(32) vs 32 decode steps, on the first ``fp32_layers`` layers
    (all when None; without the full-depth model, the model is built at
    that depth directly).  An arch with experts runs the prefill-decode
    check at capacity_factor num_experts / top_k, where C = T and nothing
    drops: at its own capacity prefill(32) drops slots that decode, one
    token a slot, never does, so the two are different functions.  An
    encoder-decoder takes frame embeddings drawn from the seed, and its
    prefill-decode check is prefill(S - 1) then one decode step from that
    cache (its ``xk``/``xv`` the encoder's) against prefill(S), S its text
    context (``whisper_seq``): decode from a zeroed cache runs no encoder."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    gc.collect()  # a freed model can sit in a reference cycle until collected
    torch.cuda.empty_cache()
    toks256 = torch.randint(0, arch.vocab, (2, 256), generator=gen, device=dev)
    frames = (torch.randn(2, arch.encoder.n_frames, arch.d_model, generator=gen,
                          device=dev) if arch.is_encdec else None)

    def kernel_vs_plain(arch):
        """(the fp32 model, its kernel-path logits, its plain-path logits),
        logged beside the noise floor and both paths' times."""
        model32 = build_model(arch, settings("float32", True), device="cuda", seed=SEED)
        lk, _ = model32.prefill(toks256, frames)
        k_runs = host_ms(lambda: model32.prefill(toks256, frames), 3)
        model32.settings = settings("float32", False)
        lm, _ = model32.prefill(toks256, frames)
        p_runs = host_ms(lambda: model32.prefill(toks256, frames), 1)
        # the fp32 noise floor at this depth: how far the plain logits move
        # when the embedding table changes by a relative 1e-7 (about one
        # fp32 ulp); the table waits on the host and the noise is drawn a
        # block of rows at a time, so a large table needs no second copy
        # on the card
        with torch.no_grad():
            embed = model32.embed.cpu()
            for rows in model32.embed.split(8192):
                rows.mul_(1 + 1e-7 * torch.randn(rows.shape, generator=gen, device=dev))
            ln, _ = model32.prefill(toks256, frames)
            model32.embed.copy_(embed)
        del embed
        model32.settings = settings("float32", True)
        log(f"[prefill] {arch.name} fp32 B=2 S=256, {arch.n_layers} layers: kernel vs "
            f"plain logits max_abs_diff={(lk - lm).abs().max().item():.3e}; fp32 noise "
            f"floor (plain vs plain with embed x (1 + 1e-7 N(0,1))) "
            f"{(ln - lm).abs().max().item():.3e}; kernel path "
            f"{statistics.median(k_runs):.2f} ms, plain path {p_runs[0]:.2f} ms")
        return model32, lk, lm

    if full_depth:
        model32, lk, lm = kernel_vs_plain(arch)
    if fp32_layers is not None:
        # a depth at which fp32 rounding is not amplified past the tolerance
        # (or, built directly, one that fits beside the bf16 model)
        if full_depth:
            del model32
            gc.collect()
            torch.cuda.empty_cache()
        arch = arch.replace(n_layers=fp32_layers)
        model32, lk, lm = kernel_vs_plain(arch)
    torch.testing.assert_close(lk, lm, atol=1e-3, rtol=1e-3)
    log(f"[prefill] {arch.name} fp32 B=2 S=256, {arch.n_layers} layers: kernel vs "
        f"plain logits max_abs_diff={(lk - lm).abs().max().item():.3e} "
        f"(atol=rtol=1e-3)")

    note = ""
    if arch.moe is not None:
        moe = arch.moe
        model32.arch = arch.replace(moe=dataclasses.replace(
            moe, capacity_factor=moe.num_experts / moe.top_k))
        C = L.moe_capacity(64, moe.top_k, moe.num_experts,
                           model32.arch.moe.capacity_factor)
        if C != 64:
            raise AssertionError(f"the full-capacity copy has C={C}, not T=64")
        note = (f" (experts at capacity_factor {moe.num_experts}/{moe.top_k}: "
                f"C = T = 64 in prefill, so no slot drops)")
    if arch.is_encdec:
        n = whisper_seq()
        prompt = torch.randint(0, arch.vocab, (2, n), generator=gen, device=dev)
        pre_logits, pre_cache = model32.prefill(prompt, frames)
        _, part = model32.prefill(prompt[:, :-1], frames)
        dcache = model32.init_cache(2, n)
        for name, leaf in part["l0"].items():
            dcache["l0"][name][:, :, :leaf.shape[2]].copy_(leaf)
        del part
        dec_logits, dcache = model32.decode_step(dcache, prompt[:, -1:], n - 1)
        what = f"prefill({n - 1}) + 1 decode step from its cache (xk/xv included) vs prefill({n})"
    else:
        prompt = torch.randint(0, arch.vocab, (2, 32), generator=gen, device=dev)
        pre_logits, pre_cache = model32.prefill(prompt)
        dcache = model32.init_cache(2, 33)
        for t in range(32):
            dec_logits, dcache = model32.decode_step(dcache, prompt[:, t:t + 1], t)
        what = "prefill(32) vs 32 decode steps"
    torch.testing.assert_close(dec_logits, pre_logits, atol=2e-3, rtol=2e-3)
    log(f"[consistency] {arch.name} fp32, {arch.n_layers} layers: {what} max_abs_diff="
        f"{(dec_logits - pre_logits).abs().max().item():.3e} (atol=rtol=2e-3){note}")
    del model32, dcache, pre_cache
    torch.cuda.empty_cache()


def attention_settings(dtype, use_kernel):
    """A decoder-only attention model's settings: K1 in prefill, or the
    plain (masked) attention."""
    from repro_torch.models import ModelSettings
    return ModelSettings(param_dtype=dtype, compute_dtype=dtype,
                         attn_impl="kernel" if use_kernel else "masked")


def whisper_settings(dtype, use_kernel):
    """whisper-medium's: ``attention_settings`` with its learned positions
    sized to the text context."""
    return dataclasses.replace(attention_settings(dtype, use_kernel),
                               max_seq=whisper_seq())


def decoder_path(torch, gen, dev, arch, counters, fp32_layers=None,
                 full_depth=True, fp32_last=False, settings=None, seq=S_MAIN):
    """An attention path, dense, with experts or an encoder-decoder, at
    full width: the bf16 prefill (``seq`` tokens) with K1 in every
    (decoder) layer and no other kernel (asserted), the parameter count
    and peak card memory, the fp32 checks, then 16 served requests, whose
    decode launches no kernel (its attention is plain PyTorch).  With
    ``fp32_last`` the fp32 checks run after the bf16 model and its server
    are freed.  ``settings(dtype, use_kernel)`` gives the model settings
    (``attention_settings`` unless given).  Returns the launches per
    prefill."""
    settings = settings or attention_settings
    from repro_torch.models import layers as L
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[params] {arch.name}: card memory in use before the build "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    model, launches = prefill_checks(torch, gen, dev, arch, settings,
                                     counters, {"flash_attention_fwd": arch.n_layers}, 1,
                                     seq=seq)
    n_params = sum(p.numel() for p in model.parameters())
    line = (f"[params] {arch.name}: {n_params} parameters, "
            f"{sum(p.numel() * p.element_size() for p in model.parameters())} bytes; "
            f"peak card memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            f"(build and bf16 prefills)")
    if arch.moe is not None:
        routers = {n: p.dtype for n, p in model.named_parameters()
                   if n.endswith("moe.router")}
        if not routers or set(routers.values()) != {torch.float32}:
            raise AssertionError(f"{arch.name} routers {routers}: not all fp32")
        line += f"; router leaves {sorted(routers)} fp32 in the bf16 model"
    log(line)
    if not fp32_last:
        fp32_checks(torch, gen, dev, arch, settings, fp32_layers, full_depth)
    server, served = serve(model, arch, counters)
    if any(served.values()):
        raise AssertionError(f"{arch.name} decode launched {served}: expected "
                             f"no kernel")
    note = " (decode attention is plain PyTorch)"
    if arch.is_encdec:
        note += (f"; as the reference's server, no encoder runs: decode reads a "
                 f"zeroed cross cache of {arch.encoder.n_frames} frames")
    if arch.moe is not None:
        moe = arch.moe
        C = L.moe_capacity(8, moe.top_k, moe.num_experts, moe.capacity_factor)
        if C != 8:
            raise AssertionError(f"decode capacity {C} != T = 8")
        note += f"; each MoE decode step routes T=8 tokens at C={C} = T: no slot drops"
    log(serve_line(arch.name, server, served) + note)
    del model, server
    torch.cuda.empty_cache()
    if fp32_last:
        fp32_checks(torch, gen, dev, arch, settings, fp32_layers, full_depth)
    return launches


# ---------------------------------------------------------------------------
# the cells: the dry-run of every cell, and one DP member's share of four
# ---------------------------------------------------------------------------

#: the multi-pod production mesh, (pod, data, model) = (2, 16, 16), whose
#: DP members' shares run here with the model axis folded onto the card
CELL_MESH = {"pod": 2, "data": 16, "model": 16}
#: the train_4k cell's run: two DP members over gloo on the card, each
#: member's 8 rows in 2 microbatches of 4 (the cell's 1 does not fit: with
#: the model axis folded a member's loss chunk holds all 151,936 vocab
#: columns, 16 members' worth, and the two ranks ran out of the card's
#: 80 GB in the backward, 34.10 GiB allocated by the failing one; at 2 the
#: peak is 32.06 GB a rank)
CELL_TRAIN_SIZES = {"pod": 2, "data": 1, "model": 1}
CELL_TRAIN_MICROBATCHES = 2
CELL_DECODE_STEPS = 8
CELL_TRAIN_STEPS = 1
#: the depth of the fp32 holds of prefill_32k and long_500k (the bf16 runs
#: are at full depth): at 24 random layers rwkv6's fp32 rounding is
#: amplified past 1e-3, as in rwkv6's ``[prefill]`` checks, and qwen2's fp32
#: masked prefill at S=32768 takes ~18 s of the time limit
CELL_FP32_LAYERS = 4


def member_rows(cell) -> int:
    """The rows one DP member holds of the cell's tokens, from the
    stand-in's spec."""
    arg = cell.args[1] if cell.mode == "prefill" else cell.args[2]
    tokens = arg["tokens"] if isinstance(arg, dict) else arg
    return tokens.local_shape(cell.sizes)[0]


def dryrun_cells(card) -> int:
    """(a) Every (arch x applicable shape) cell on both two-tier production
    meshes with the default flags, on the meta device: one line a cell;
    returns the count.  No seconds: the records are spec-free."""
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs.base import SHAPES, shape_applicable
    from repro_torch.launch import dryrun
    t0, n = time.perf_counter(), 0
    for multi in (False, True):
        for arch in list_archs():
            for shape in SHAPES:
                if not shape_applicable(get_arch(arch), SHAPES[shape])[0]:
                    continue
                rec = dryrun.run_cell(arch, shape, multi_pod=multi)
                n += 1
                name = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                log(f"[cells] dry-run {dryrun.summary_line(name, rec)}")
                if not rec["ok"]:
                    raise AssertionError(f"[cells] {name}: {rec['error']}\n"
                                         f"{rec['traceback']}")
    log(f"[cells] dry-run: {n} default cells built on the meta device on "
        f"(data, model) = (16, 16) and (pod, data, model) = (2, 16, 16) in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    if n != 64:
        raise AssertionError(f"[cells] {n} default cells, expected 64")
    return n


def cells_prefill(torch, gen, dev, counters, card):
    """qwen2-0.5b's prefill_32k cell, one DP member's share (B=1, S=32768)
    at full width, the model axis folded: bf16 with K1 in every layer
    (launches asserted), its time, tokens/s and peak; then the same
    prefill in fp32 on the first CELL_FP32_LAYERS layers, K1 against the
    masked path at ``[prefill]``'s 1e-3 (in bf16 the two paths' roundings
    part through 24 layers, to about 6e-02 in the logits), and the masked
    path's time."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    cell = build_cell("qwen2-0.5b", "prefill_32k", CELL_MESH, attn_impl="kernel")
    rows, S, arch, st = member_rows(cell), cell.shape.seq_len, cell.arch, cell.model.settings
    torch.cuda.reset_peak_memory_stats()
    bound = cell.bind(device="cuda", seed=SEED)
    tokens = torch.randint(0, arch.vocab, (rows, S), generator=gen, device=dev)
    (logits, cache), launches = drive_path(counters, lambda: bound.run(tokens))
    want = {k: 0 for k in counters}
    want["flash_attention_fwd"] = arch.n_layers
    if launches != want:
        raise AssertionError(f"[cells] prefill_32k launched {launches}, expected {want}")
    if logits.shape != (rows, arch.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"[cells] prefill_32k logits {tuple(logits.shape)}")
    del cache
    runs = host_ms(lambda: bound.run(tokens), 3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(runs)
    log(f"[cells] qwen2-0.5b prefill_32k, one DP member of {CELL_MESH} (model "
        f"axis folded): B={rows} S={S} bf16 attn_chunk={st.attn_chunk}: "
        f"launches/prefill={{'flash_attention_fwd': {launches['flash_attention_fwd']}}} "
        f"prefill_ms median={ms:.2f} runs={[round(t, 2) for t in runs]} "
        f"tok/s={rows * S / ms * 1e3:.0f} peak_gb={peak:.2f} | {card}")
    del bound, logits
    gc.collect()
    torch.cuda.empty_cache()
    st32 = dataclasses.replace(st, param_dtype="float32", compute_dtype="float32")
    arch32 = arch.replace(n_layers=CELL_FP32_LAYERS)
    model32 = build_model(arch32, st32, device="cuda", seed=SEED)
    out = {}

    def prefill32(impl):  # one run, its logits kept
        model32.settings = dataclasses.replace(st32, attn_impl=impl)
        out[impl] = model32.prefill(tokens)[0]

    k_ms = host_ms(lambda: prefill32("kernel"), 1)[0]
    p_ms = host_ms(lambda: prefill32("masked"), 1)[0]
    lk, lm = out["kernel"], out["masked"]
    err = (lk - lm).abs().max().item()
    log(f"[cells] qwen2-0.5b prefill_32k fp32, B={rows} S={S}, {arch32.n_layers} "
        f"of {arch.n_layers} layers: K1 vs masked logits max_abs_diff={err:.3e} (atol=rtol=1e-3); "
        f"K1 path {k_ms:.2f} ms, masked path {p_ms:.2f} ms | {card}")
    torch.testing.assert_close(lk, lm, atol=1e-3, rtol=1e-3)
    del model32, lk, lm
    return {"ms": ms, "launches": launches["flash_attention_fwd"]}


def cells_decode(torch, gen, dev, counters, card):
    """qwen2-0.5b's decode_32k cell, one DP member's share: B=4 rows over a
    32768-long cache, CELL_DECODE_STEPS steps from a zeroed cache at the
    cache's last positions; no kernel (decode takes none), finite logits,
    the step times (TPOT)."""
    from repro_torch.launch.cells import build_cell
    gc.collect()
    torch.cuda.empty_cache()
    cell = build_cell("qwen2-0.5b", "decode_32k", CELL_MESH)
    rows, S, arch = member_rows(cell), cell.shape.seq_len, cell.arch
    torch.cuda.reset_peak_memory_stats()
    bound = cell.bind(device="cuda", seed=SEED)
    cache = bound.init(rows, S)
    toks = torch.randint(0, arch.vocab, (rows, CELL_DECODE_STEPS), generator=gen, device=dev)
    start = S - CELL_DECODE_STEPS
    times, out = [], []

    def steps():
        for t in range(CELL_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bound.run(cache, toks[:, t:t + 1], start + t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append(logits)

    _, launches = drive_path(counters, steps)
    if any(launches.values()):
        raise AssertionError(f"[cells] decode_32k launched {launches}: expected none")
    if not all(lg.shape == (rows, arch.vocab) and bool(torch.isfinite(lg).all())
               for lg in out):
        raise AssertionError("[cells] decode_32k logits not finite")
    p50 = statistics.median(times)
    log(f"[cells] qwen2-0.5b decode_32k, one DP member of {CELL_MESH}: B={rows}, "
        f"cache {S} long (bf16), {CELL_DECODE_STEPS} steps at pos {start}..{S - 1}: "
        f"launches={launches} tpot_p50_ms={p50:.2f} "
        f"tpot_max_ms={max(times):.2f} step_ms={[round(t, 2) for t in times]} "
        f"tok/s={rows * CELL_DECODE_STEPS / sum(times) * 1e3:.1f} "
        f"peak_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} | {card}")
    del bound, cache, out
    return {"tpot_p50_ms": p50}


def cells_long(torch, gen, dev, counters, card):
    """rwkv6-1.6b's long_500k cell, one DP member's share: B=1 (the batch
    of 1 stays whole), CELL_DECODE_STEPS decode steps from a zeroed state
    at pos 524272 (the recurrent state is the cache; no position enters),
    with K3 in every layer (the cell's settings with ``use_kernel_ssm``,
    the twin of the reference's ``use_pallas_ssm``): launches, step times;
    then every K3 launch of the same steps against the plain recurrence on
    its own inputs at ``[K3]``'s tolerance, and the plain path's logits."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.launch.cells import build_cell
    gc.collect()
    torch.cuda.empty_cache()
    cell = build_cell("rwkv6-1.6b", "long_500k", CELL_MESH)
    rows, S, arch, st = member_rows(cell), cell.shape.seq_len, cell.arch, cell.model.settings
    torch.cuda.reset_peak_memory_stats()
    bound = cell.bind(device="cuda", seed=SEED)
    kernel_st = dataclasses.replace(st, use_kernel_ssm=True)
    toks = torch.randint(0, arch.vocab, (rows, CELL_DECODE_STEPS), generator=gen, device=dev)
    start = S - CELL_DECODE_STEPS

    def run(settings, record=None):
        bound.model.settings = settings
        cache = bound.init(rows, S)
        out = []
        for t in range(CELL_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bound.run(cache, toks[:, t:t + 1], start + t)
            torch.cuda.synchronize()
            if record is not None:
                record.append((time.perf_counter() - t0) * 1e3)
            out.append(logits)
        return out

    times = []
    lk, launches = drive_path(counters, lambda: run(kernel_st, times))
    want = {k: 0 for k in counters}
    want["wkv6_fwd"] = arch.n_layers * CELL_DECODE_STEPS
    if launches != want:
        raise AssertionError(f"[cells] long_500k launched {launches}, expected {want}")
    if not all(bool(torch.isfinite(lg).all()) for lg in lk):
        raise AssertionError("[cells] long_500k logits not finite")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # each K3 launch of the same steps against the plain recurrence on the
    # launch's own inputs (the plain runs here are no launches)
    real, errs = wkv_ops.wkv6_fwd, []

    def checked(r, k, v, w, u, s0):
        y, sT = real(r, k, v, w, u, s0)
        ey, es = wkv6_ref(r, k, v, w, u, s0)
        atol = 2e-5 * (ey.abs().max().item() + 1.0)
        for got, exp in ((y, ey), (sT, es)):
            torch.testing.assert_close(got, exp, rtol=1e-4, atol=atol)
        errs.append(max((y - ey).abs().max().item(), (sT - es).abs().max().item()))
        return y, sT

    wkv_ops.wkv6_fwd = checked
    try:
        run(kernel_st)
    finally:
        wkv_ops.wkv6_fwd = real
    if len(errs) != arch.n_layers * CELL_DECODE_STEPS:
        raise AssertionError(f"[cells] {len(errs)} K3 launches checked")
    plain_times = []
    lp = run(st, plain_times)
    diff = max((a - b).abs().max().item() for a, b in zip(lk, lp))
    p50 = statistics.median(times)
    log(f"[cells] rwkv6-1.6b long_500k, one DP member of {CELL_MESH}: B={rows}, "
        f"{CELL_DECODE_STEPS} steps at pos {start}..{S - 1} from a zeroed state, "
        f"bf16: launches={{'wkv6_fwd': {launches['wkv6_fwd']}}} "
        f"({arch.n_layers} a step) tpot_p50_ms={p50:.2f} step_ms="
        f"{[round(t, 2) for t in times]} tok/s={rows * CELL_DECODE_STEPS / sum(times) * 1e3:.1f} "
        f"peak_gb={peak:.2f}; every K3 launch vs plain on its inputs: max_err="
        f"{max(errs):.3e} (rtol 1e-4, atol 2e-5 x (max|y|+1)); plain path "
        f"tpot_p50_ms={statistics.median(plain_times):.2f}, logits vs K3's "
        f"max_abs_diff={diff:.3e} (bf16 through {arch.n_layers} layers) | {card}")
    bound.model.settings = st
    del bound, lk, lp
    cells_long_fp32(torch, arch, st, toks, rows, S, start, card)
    return {"tpot_p50_ms": p50, "launches": launches["wkv6_fwd"]}


def cells_long_fp32(torch, arch, st, toks, rows, S, start, card):
    """long_500k's steps in fp32, K3's path against the plain one: at full
    depth each layer's drift (the largest difference of the layer's
    recurrence input ``r`` and of its output ``y`` over the steps, over the
    plain path's largest value), which shows where the two paths part; then
    at CELL_FP32_LAYERS layers every step's logits held at 1e-3, as rwkv6's
    fp32 ``[prefill]`` checks are."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.models import build_model, ssm
    gc.collect()
    torch.cuda.empty_cache()
    st32 = dataclasses.replace(st, param_dtype="float32", compute_dtype="float32")
    real = {"kernel": wkv_ops.wkv6, "plain": ssm.wkv6_scan_ref}
    seen = {"kernel": [], "plain": []}

    def recording(path):
        def call(r, k, v, w, u, state=None):
            y, sT = real[path](r, k, v, w, u, state=state)
            seen[path].append((r.detach().float().clone(), y.detach().clone()))
            return y, sT
        return call

    def run(model, path):
        model.settings = dataclasses.replace(st32, use_kernel_ssm=path == "kernel")
        cache, out = model.init_cache(rows, S), []
        for t in range(CELL_DECODE_STEPS):
            logits, cache = model.decode_step(cache, toks[:, t:t + 1], start + t)
            out.append(logits)
        return torch.stack(out)

    def both(depth):
        model = build_model(arch.replace(n_layers=depth), st32, device="cuda", seed=SEED)
        for v in seen.values():
            v.clear()
        wkv_ops.wkv6, ssm.wkv6_scan_ref = recording("kernel"), recording("plain")
        try:
            return run(model, "kernel"), run(model, "plain")
        finally:
            wkv_ops.wkv6, ssm.wkv6_scan_ref = real["kernel"], real["plain"]
            del model
            gc.collect()
            torch.cuda.empty_cache()

    lk, lp = both(arch.n_layers)
    n = arch.n_layers
    if len(seen["kernel"]) != n * CELL_DECODE_STEPS or len(seen["plain"]) != len(seen["kernel"]):
        raise AssertionError(f"[cells] long_500k fp32: {len(seen['kernel'])} and "
                             f"{len(seen['plain'])} recurrence calls recorded")
    drift = {}
    for i, name in enumerate(("r", "y")):
        diff, scale = [0.0] * n, [0.0] * n
        for c, (a, b) in enumerate(zip(seen["kernel"], seen["plain"])):
            diff[c % n] = max(diff[c % n], (a[i] - b[i]).abs().max().item())
            scale[c % n] = max(scale[c % n], b[i].abs().max().item())
        drift[name] = [d / max(m, 1e-30) for d, m in zip(diff, scale)]
    full_gap = (lk - lp).abs().max().item()
    log(f"[cells] rwkv6-1.6b long_500k fp32, {n} layers, the same {CELL_DECODE_STEPS} "
        f"steps: logits K3 path vs plain max_abs_diff={full_gap:.3e} (max|logits| "
        f"{lp.abs().max().item():.3e}); each layer's relative drift, recurrence "
        f"input r: {[float(f'{d:.2e}') for d in drift['r']]}; output y: "
        f"{[float(f'{d:.2e}') for d in drift['y']]} | {card}")
    del lk, lp
    lk, lp = both(CELL_FP32_LAYERS)
    err = (lk - lp).abs().max().item()
    log(f"[cells] rwkv6-1.6b long_500k fp32, {CELL_FP32_LAYERS} of {n} layers: every "
        f"step's logits K3 path vs plain max_abs_diff={err:.3e} (atol=rtol=1e-3) | {card}")
    torch.testing.assert_close(lk, lp, atol=1e-3, rtol=1e-3)
    del lk, lp


def cells_train_run(torch, rank, rows, steps, microbatches):
    """This rank, one DP member of qwen2-0.5b's train_4k cell on (2, 1, 1):
    the cell bound to this rank's mesh (the DFabric step, ZeRO-1, the
    cell's settings with K1), ``rows`` x 4096 tokens a step from
    ``Model.synthetic_batch`` with a seed a rank, ``steps`` steps: each
    step's launches, loss, time, peak, parameters against member 0's."""
    from repro_torch.core import prims
    from repro_torch.launch.cells import build_cell
    kernels = kernel_modules()
    rec = {"steps": []}
    cell = build_cell("qwen2-0.5b", "train_4k", CELL_TRAIN_SIZES,
                      attn_impl="kernel", microbatches=microbatches)
    mesh = prims.Mesh(cell.sizes)
    bound = cell.bind(mesh, device="cuda", seed=SEED)
    model = bound.model
    model.requires_grad_(True)
    params, state = model.params(), bound.init()
    share = dataclasses.replace(cell.shape, global_batch=rows)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1 + rank)
    per = expected_launches(cell.arch, cell.model.settings)
    rec.update(expected={k: n * cell.microbatches for k, n in per.items()},
               microbatches=cell.microbatches, settings=dataclasses.asdict(
                   cell.model.settings), sections=len(cell.plan.sections),
               mem_after_init_gb=torch.cuda.memory_allocated() / 1e9)
    torch.cuda.reset_peak_memory_stats()
    for step in range(steps):
        batch = model.synthetic_batch(gen, share)
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.LAUNCHES = 0  # just before the path
        t0 = time.perf_counter()
        params, state, metrics = bound.run(params, state, batch, step)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
        rec["steps"].append(dict(step=step, loss=loss, dt=dt, launches=launches,
                                 params_equal=params_bit_equal(params),
                                 peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        del batch
    return rec


def cells_train_rows() -> int:
    """The rows one DP member holds of qwen2-0.5b's train_4k cell on the
    multi-pod mesh."""
    from repro_torch.launch.cells import build_cell
    return member_rows(build_cell("qwen2-0.5b", "train_4k", CELL_MESH))


def cells_train(card, recs):
    """qwen2-0.5b's train_4k cell: two DP members sharing the card over
    gloo (run in the family spawn, :func:`family_rank`), each with a
    member's share of the multi-pod mesh's rows."""
    rows = cells_train_rows()
    r0 = recs[0]
    log(f"[cells] qwen2-0.5b train_4k, two DP members on {CELL_TRAIN_SIZES} over "
        f"gloo, each a member's share of {CELL_MESH} (model axis folded): "
        f"B={rows} S=4096 a rank, the DFabric step (ZeRO-1, codec None, "
        f"{r0['sections']} sections), microbatches {r0['microbatches']}, "
        f"remat {r0['settings']['remat']}, {r0['settings']['param_dtype']}: "
        f"{r0['s']:.1f} s on rank 0; memory after init "
        f"{r0['mem_after_init_gb']:.2f} GB a rank | {card}")
    want = dict(r0["expected"], quantize_ef_fwd=0)
    for rank, rec in enumerate(recs):
        for st in rec["steps"]:
            log(f"[cells] train_4k rank {rank} step {st['step']}: loss={st['loss']:.6f} "
                f"(pmean) step_s={st['dt']:.3f} tok/s={2 * rows * 4096 / st['dt']:.0f} "
                f"(both members) launches={st['launches']} params_bit_equal="
                f"{st['params_equal']} peak_mem_gb={st['peak_gb']:.2f} | {card}")
            if st["launches"] != want:
                raise AssertionError(f"[cells] train_4k rank {rank} step {st['step']} "
                                     f"launched {st['launches']}, expected {want}")
            if not (math.isfinite(st["loss"]) and st["params_equal"]):
                raise AssertionError(f"[cells] train_4k rank {rank}: {st}")
        if len(rec["steps"]) != CELL_TRAIN_STEPS:
            raise AssertionError(f"[cells] train_4k rank {rank} ran {len(rec['steps'])} steps")
    return recs


def cells_phase(torch, gen, dev, counters, card, phase_done, train_recs):
    """``[cells]``: (a) the dry-run of the 64 default cells; (b) one DP
    member's share of four cells on the card (train_4k's two ranks'
    records ``train_recs``, run by the family spawn)."""
    dryrun_cells(card)
    phase_done("cells: dry-run of 64 cells")
    cells_prefill(torch, gen, dev, counters, card)
    cells_decode(torch, gen, dev, counters, card)
    cells_long(torch, gen, dev, counters, card)
    phase_done("cells: prefill_32k, decode_32k, long_500k")
    cells_train(card, train_recs)
    phase_done("cells: train_4k, 2 ranks (run in the family spawn)")


# ---------------------------------------------------------------------------
# [serve-mesh]: serving over a mesh, four cells' shares and the DecodeServer
# ---------------------------------------------------------------------------

#: one DP member of CELL_MESH with its model axis cut to the 4 ranks that
#: share the card: TP over model for (a)-(c), FSDP over data x TP for (d)
#: and the server's two data members for (e)
SERVE_MESH_TP = {"data": 1, "model": 4}
SERVE_MESH_FSDP = {"data": 2, "model": 2}
SERVE_MESH_RANKS = 4
#: decode steps of (b) and (c) (16 in the cells; cut for time)
SERVE_MESH_STEPS = 4
#: (a) and (b)'s depth: 4 of qwen3's 28 layers, for the card's time
SERVE_MESH_QWEN3_LAYERS = 4
#: (d)'s decode steps in bf16 and in fp32 (16 in the cell): every step
#: gathers the member's FSDP blocks of the whole block (4.5 GB a rank in
#: bf16) over gloo, which copies them through host memory, 9.65 s a step
#: (p50 of 16 in the first chip call of the phase)
SERVE_MESH_JAMBA_STEPS = (1, 1)
#: the fp32 holds' depth: 2 layers for qwen3 and rwkv6; for jamba a Mamba
#: layer and the attention layer (attn_every 2), every width
SERVE_MESH_FP32_LAYERS = 2
SERVE_MESH_JAMBA_FP32 = dict(n_layers=2, attn_every=2)
#: (e): 8 requests (one for each slot) of 8 new tokens (16 of 32 in the
#: earlier phases' servers; cut for time: a step is ~0.25 s over gloo)
SERVE_MESH_SERVER = dict(requests=8, slots=8, max_seq=256, max_new=8)


def sm_inputs():
    """The token ids of every run, drawn on the host from the seed (the
    ranks and the one-member references read the same ones)."""
    import torch
    g = torch.Generator().manual_seed(SEED + 27)
    qv, rv = 151936, 65536  # qwen3's vocab; rwkv6's and jamba's

    def draw(vocab, shape):
        return torch.randint(0, vocab, shape, generator=g)

    return {"a": draw(qv, (1, 32768)), "b": draw(qv, (4, SERVE_MESH_STEPS)),
            "c": draw(rv, (1, SERVE_MESH_STEPS)), "d": draw(rv, (1, SERVE_MESH_STEPS)),
            "e": [draw(qv, (4,)).int().numpy()
                  for _ in range(SERVE_MESH_SERVER["requests"])],
            "j": draw(rv, (1, 32768))}


def sm_model(torch, mesh, arch, st, fsdp=False, turns=1):
    """The model built from the seed on the card and cut for this member of
    ``mesh`` (FSDP over data when ``fsdp``); ``turns`` > 1: the ranks build
    in that many turns, one after another, so that a turn's uncut models
    at a time are on the card."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import mesh_info
    model = None
    for turn in range(turns):
        if dist.get_rank() % turns == turn:
            model = build_model(arch, st, device="cuda", seed=SEED)
            model.shard(mesh_info(mesh.sizes, fsdp=fsdp), mesh.sizes, mesh.coords)
            gc.collect()
            torch.cuda.empty_cache()
        if turns > 1:
            dist.barrier()
    return model


def sm_fp32(st):
    return dataclasses.replace(st, param_dtype="float32", compute_dtype="float32")


def tree_bytes(tree) -> int:
    from repro_torch.utils.trees import tree_paths
    return sum(t.numel() * t.element_size() for t in tree_paths(tree).values())


def sm_steps(torch, model, cache, toks, start, batch, max_seq, times=None):
    """Decode ``toks``' columns from ``start``; every step's logits (a numpy
    array on the host, stacked) and, given ``times``, each step's ms."""
    out = []
    for t in range(toks.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.decode_step(cache, toks[:, t:t + 1], start + t, batch=batch,
                                      max_seq=max_seq)
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
    return torch.stack(out).numpy()


def sm_qwen3(torch, mesh, kernels, inputs):
    """(a) qwen3-1.7b prefill_32k and (b) decode_32k, one DP member's share
    each, on (data, model) = (1, 4): each rank's 4 query heads (of 16) and
    2 kv heads (of 8), the kv repeated per query head (``gqa_repeat``, as at
    model 16) before K1."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import prims
    from repro_torch.launch.cells import build_cell
    pre = build_cell("qwen3-1.7b", "prefill_32k", CELL_MESH, attn_impl="kernel")
    dec = build_cell("qwen3-1.7b", "decode_32k", CELL_MESH)
    arch, st = pre.arch.replace(n_layers=SERVE_MESH_QWEN3_LAYERS), pre.model.settings
    rec = {"a": {}, "b": {}}
    toks = inputs["a"].cuda()
    rows = toks.shape[0]
    torch.cuda.reset_peak_memory_stats()
    model = sm_model(torch, mesh, arch, st)
    with prims.bind(mesh):
        dist.barrier()
        t0 = time.perf_counter()
        (logits, cache), launches = drive_path(
            kernels, lambda: model.prefill(toks, batch=rows))
        runs = [(time.perf_counter() - t0) * 1e3]  # one run: ~20 s of gloo sums
        del cache
        rec["a"].update(launches=launches, runs=runs, logits=logits.float().cpu().numpy(),
                        shape=tuple(logits.shape), settings=dataclasses.asdict(st),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        # (b): the decode cell's settings on the same cut
        model.settings = dec.model.settings
        btoks, brows, S = inputs["b"].cuda(), member_rows(dec), dec.shape.seq_len
        start = S - SERVE_MESH_STEPS
        torch.cuda.reset_peak_memory_stats()
        cache = model.init_cache(brows, S)
        times = []
        lg, launches = drive_path(kernels, lambda: sm_steps(
            torch, model, cache, btoks, start, brows, S, times))
        rec["b"].update(launches=launches, times=times, rows=brows, start=start,
                        finite=bool(np.isfinite(lg).all()), cache_gb=tree_bytes(cache) / 1e9,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, cache, lg
        gc.collect()
        torch.cuda.empty_cache()
        # fp32 at SERVE_MESH_FP32_LAYERS layers: both runs' logits
        model = sm_model(torch, mesh, arch.replace(n_layers=SERVE_MESH_FP32_LAYERS),
                         sm_fp32(st))
        rec["a"]["fp32"] = model.prefill(toks, batch=rows)[0].cpu().numpy()
        model.settings = sm_fp32(dec.model.settings)
        rec["b"]["fp32"] = sm_steps(torch, model, model.init_cache(brows, S), btoks,
                                    start, brows, S)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sm_rwkv(torch, mesh, kernels, inputs):
    """(c) rwkv6-1.6b long_500k, one DP member's share (B=1), on (1, 4):
    each rank's 8 of 32 heads through K3, 24 a step; every launch of a
    second run against the plain recurrence on its own inputs; fp32 at
    SERVE_MESH_FP32_LAYERS layers, each recurrence's input and output
    recorded (``sm_recorded``) for the layers' drift."""
    import numpy as np
    from repro_torch.core import prims
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.launch.cells import build_cell
    cell = build_cell("rwkv6-1.6b", "long_500k", CELL_MESH)
    arch, S = cell.arch, cell.shape.seq_len
    st = dataclasses.replace(cell.model.settings, use_kernel_ssm=True)
    toks, rows = inputs["c"].cuda(), member_rows(cell)
    start = S - SERVE_MESH_STEPS
    torch.cuda.reset_peak_memory_stats()
    model = sm_model(torch, mesh, arch, st)
    rec = {}
    with prims.bind(mesh):
        times = []
        lg, launches = drive_path(kernels, lambda: sm_steps(
            torch, model, model.init_cache(rows, S), toks, start, rows, S, times))
        rec.update(launches=launches, times=times, finite=bool(np.isfinite(lg).all()),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        real, errs, shapes = wkv_ops.wkv6_fwd, [], set()

        def checked(r, k, v, w, u, s0):
            y, sT = real(r, k, v, w, u, s0)
            ey, es = wkv6_ref(r, k, v, w, u, s0)
            atol = 2e-5 * (ey.abs().max().item() + 1.0)
            for got, exp in ((y, ey), (sT, es)):
                torch.testing.assert_close(got, exp, rtol=1e-4, atol=atol)
            errs.append(max((y - ey).abs().max().item(), (sT - es).abs().max().item()))
            shapes.add(tuple(r.shape))
            return y, sT

        wkv_ops.wkv6_fwd = checked
        try:
            sm_steps(torch, model, model.init_cache(rows, S), toks, start, rows, S)
        finally:
            wkv_ops.wkv6_fwd = real
        rec.update(checked=len(errs), max_err=max(errs), k3_shapes=sorted(shapes))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model = sm_model(torch, mesh, arch.replace(n_layers=SERVE_MESH_FP32_LAYERS),
                         sm_fp32(st))
        rec["fp32"], rec["seen"] = sm_recorded(lambda: sm_steps(
            torch, model, model.init_cache(rows, S), toks, start, rows, S))
        rec["heads"] = prims.axis_rank("model") * (arch.n_heads // prims.axis_size("model"))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sm_recorded(fn):
    """``fn()`` with every call of a recurrence (K3's or K4's wrapper, in
    layer order) recorded: (its result, [(its input r or u, y) of each
    call, fp32 numpy])."""
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    real, seen = (wkv_ops.wkv6, ms_ops.mamba_scan), []

    def recorded(f):
        def call(x, *args, **kw):
            y, sT = f(x, *args, **kw)
            seen.append((x.detach().float().cpu().numpy(),
                         y.detach().float().cpu().numpy()))
            return y, sT
        return call

    wkv_ops.wkv6, ms_ops.mamba_scan = recorded(real[0]), recorded(real[1])
    try:
        return fn(), seen
    finally:
        wkv_ops.wkv6, ms_ops.mamba_scan = real


def sm_drift(recs, ref_seen, n_layers):
    """Each layer's relative drift of the members' recurrence input ``r``
    and output ``y`` from the one-member run's on the same heads (the
    largest difference over the steps and ranks, over the one-member
    run's largest value), as ``cells_long_fp32`` prints K3's against the
    plain path's: {"r": [a layer], "y": [...]}."""
    import numpy as np
    drift = {}
    for i, name in enumerate(("r", "y")):
        diff, scale = [0.0] * n_layers, [0.0] * n_layers
        for rec in recs:
            c = rec["c"]
            if len(c["seen"]) != len(ref_seen):
                raise AssertionError(f"[serve-mesh] (c): {len(c['seen'])} recurrence calls "
                                     f"recorded on a rank, {len(ref_seen)} on one member")
            for n, (got, want) in enumerate(zip(c["seen"], ref_seen)):
                mine = want[i][:, :, c["heads"]:c["heads"] + got[i].shape[2]]
                diff[n % n_layers] = max(diff[n % n_layers],
                                         float(np.abs(got[i] - mine).max()))
                scale[n % n_layers] = max(scale[n % n_layers], float(np.abs(want[i]).max()))
        drift[name] = [d / max(m, 1e-30) for d, m in zip(diff, scale)]
    return drift


def sm_combine(torch, arch, S):
    """The two-stage softmax over data against one ``attend_decode`` over
    the whole cache, on random bf16 k/v (B=1, S rows, this member's kv
    heads) and fp32 q (its query heads; the output in fp32) drawn alike on
    every member: at a
    ``pos`` inside member 0's rows (member 1 masked whole) and one inside
    member 1's.  Returns [(pos, max_abs_diff, max |o|)]."""
    from repro_torch.core import prims
    from repro_torch.models import layers as L
    n, r = prims.axis_size("data"), prims.axis_rank("data")
    KV = arch.n_kv_heads // prims.axis_size("model")
    H = arch.n_heads // prims.axis_size("model")
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    k = torch.randn((1, S, KV, arch.resolved_head_dim), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(k.shape, generator=g, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((1, 1, H, arch.resolved_head_dim), generator=g, device="cuda")
    blk = S // n
    out = []
    for pos in (S // 4 + 3, 3 * S // 4 + 5):
        lens = torch.full((1,), pos, device="cuda")
        split = L.attend_decode(q, k[:, r * blk:(r + 1) * blk],
                                v[:, r * blk:(r + 1) * blk], lens, "data")
        whole = L.attend_decode(q, k, v, lens)
        out.append((pos, (split.float() - whole.float()).abs().max().item(),
                    whole.float().abs().max().item()))
    del k, v
    torch.cuda.empty_cache()
    return out


def sm_jamba(torch, mesh, kernels, inputs):
    """(d) jamba long_500k, one DP member's share (B=1) of one Jamba block
    without experts at every width, on (data, model) = (2, 2) with FSDP
    over data as the cell: each rank's 8192 of 16384 channels through K4 (7
    a step), the attention cache's 524,288 rows split over data (262,144 a
    member, its kv heads over model), the softmax combined over data; then
    the combine beside the whole ``attend_decode`` on random caches; then
    fp32 on a Mamba layer and the attention layer."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import one_card_arch
    from repro_torch.core import prims
    from repro_torch.launch.cells import build_cell
    from repro_torch.utils.trees import tree_paths
    cell = build_cell("jamba-1.5-large-398b", "long_500k", CELL_MESH)
    arch = one_card_arch("jamba-1.5-large-398b")[0]
    S, rows = cell.shape.seq_len, member_rows(cell)
    st = dataclasses.replace(cell.model.settings, use_kernel_ssm=True)
    bf16_steps, fp32_steps = SERVE_MESH_JAMBA_STEPS
    toks = inputs["d"].cuda()
    rec = {}
    torch.cuda.reset_peak_memory_stats()
    model = sm_model(torch, mesh, arch, st, fsdp=True, turns=SERVE_MESH_RANKS)
    rec["params_gb"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    with prims.bind(mesh):
        cache = model.init_cache(rows, S)
        rec["cache"] = {k: tuple(v.shape) for k, v in tree_paths(cache).items()}
        rec["cache_gb"] = tree_bytes(cache) / 1e9
        times = []
        dist.barrier()
        lg, launches = drive_path(kernels, lambda: sm_steps(
            torch, model, cache, toks[:, :bf16_steps], S - bf16_steps, rows, S, times))
        rec.update(launches=launches, times=times, finite=bool(np.isfinite(lg).all()),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, cache, lg
        gc.collect()
        torch.cuda.empty_cache()
        rec["combine"] = sm_combine(torch, arch, S)
        model = sm_model(torch, mesh, arch.replace(**SERVE_MESH_JAMBA_FP32),
                         sm_fp32(st), fsdp=True, turns=SERVE_MESH_RANKS)
        rec["fp32"] = sm_steps(torch, model, model.init_cache(rows, S),
                               toks[:, :fp32_steps], S - fp32_steps, rows, S)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sm_server(torch, mesh, inputs):
    """(e) the DecodeServer over (2, 2), qwen3-1.7b: 16 requests, 8 slots (4
    a data member), greedy, bf16; then fp32 at SERVE_MESH_FP32_LAYERS
    layers, its tokens for the one-member server's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ModelSettings
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    arch = get_arch("qwen3-1.7b")
    cfg = SERVE_MESH_SERVER
    rec = {}
    for tag, depth, st in (("bf16", arch.n_layers, ModelSettings()),
                           ("fp32", SERVE_MESH_FP32_LAYERS, sm_fp32(ModelSettings()))):
        torch.cuda.reset_peak_memory_stats()
        model = sm_model(torch, mesh, arch.replace(n_layers=depth), st)
        server = DecodeServer(model, mesh, batch_slots=cfg["slots"], max_seq=cfg["max_seq"])
        for i, prompt in enumerate(inputs["e"]):
            server.submit(Request(uid=i, prompt=prompt, max_new=cfg["max_new"]))
        outs = server.run(max_steps=cfg["max_seq"] - 1)
        rec[tag] = dict(outs=outs, stats=dict(server.stats), rows=server.rows,
                        latency=server.latency_summary(), tok_s=server.throughput(),
                        done=all(r.done for r in server.all_requests),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, server
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def serve_mesh_runs(torch, kernels, inputs):
    """This rank's ``[serve-mesh]`` runs: (a)-(c) on SERVE_MESH_TP, (d) and
    (e) on SERVE_MESH_FSDP, each run's launches counted in this process."""
    from repro_torch.core import prims
    tp, fs = prims.Mesh(SERVE_MESH_TP), prims.Mesh(SERVE_MESH_FSDP)
    rec = {"s": {}}
    for name, fn, mesh in (("ab", sm_qwen3, tp), ("c", sm_rwkv, tp),
                           ("d", sm_jamba, fs), ("e", sm_server, fs)):
        t0 = time.perf_counter()
        out = (fn(torch, mesh, inputs) if name == "e"
               else fn(torch, mesh, kernels, inputs))
        rec.update(out if name == "ab" else {name: out})
        rec["s"][name] = time.perf_counter() - t0
    return rec


def sm_reference(torch, arch, st, fn):
    """``fn(model)`` on the one-member model of ``arch`` built from the seed
    on the card, freed after."""
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(arch, st, device="cuda", seed=SEED)
    try:
        return fn(model)
    finally:
        del model
        gc.collect()
        torch.cuda.empty_cache()


def sm_check(torch, tag, recs, ref, tol):
    """Every rank's fp32 logits of run ``tag`` within ``tol`` (atol =
    rtol) of the one-member run's; returns the largest difference."""
    import numpy as np
    err = max(float(np.abs(rec[tag]["fp32"] - ref).max()) for rec in recs)
    for rank, rec in enumerate(recs):
        torch.testing.assert_close(torch.from_numpy(rec[tag]["fp32"]),
                                   torch.from_numpy(ref), atol=tol, rtol=tol,
                                   msg=lambda m: f"[serve-mesh] ({tag}) rank {rank}: {m}")
    return err


def sm_check_qwen3(torch, recs, inputs, card):
    """(a) and (b) against the one-member runs."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import build_cell
    zero = {k: 0 for k in kernel_modules()}
    qwen3 = get_arch("qwen3-1.7b").replace(n_layers=SERVE_MESH_QWEN3_LAYERS)
    pre = build_cell("qwen3-1.7b", "prefill_32k", CELL_MESH, attn_impl="kernel")
    dec = build_cell("qwen3-1.7b", "decode_32k", CELL_MESH)
    r0 = recs[0]
    want = dict(zero, flash_attention_fwd=qwen3.n_layers)
    for rank, rec in enumerate(recs):
        a = rec["a"]
        if a["launches"] != want or a["shape"] != (1, qwen3.vocab) \
                or not bool(np.isfinite(a["logits"]).all()):
            raise AssertionError(f"[serve-mesh] (a) rank {rank}: launches {a['launches']} "
                                 f"(expected {want}), logits {a['shape']}")
    toks = inputs["a"].cuda()
    S = toks.shape[1]
    bf16_ref = sm_reference(torch, qwen3, pre.model.settings,
                            lambda m: m.prefill(toks)[0].float().cpu().numpy())
    gap = max(float(np.abs(rec["a"]["logits"] - bf16_ref).max()) for rec in recs)
    b0 = r0["b"]
    btoks, S_dec = inputs["b"].cuda(), dec.shape.seq_len

    def fp32_runs(m):  # (a)'s prefill, then (b)'s steps on the same model, as the ranks run
        a = m.prefill(toks)[0].cpu().numpy()
        m.settings = sm_fp32(dec.model.settings)
        return a, sm_steps(torch, m, m.init_cache(b0["rows"], S_dec), btoks, b0["start"],
                           b0["rows"], S_dec)

    fp32_ref, ref = sm_reference(torch, qwen3.replace(n_layers=SERVE_MESH_FP32_LAYERS),
                                 sm_fp32(pre.model.settings), fp32_runs)
    err = sm_check(torch, "a", recs, fp32_ref, 1e-4)
    ms = statistics.median(r0["a"]["runs"])
    log(f"[serve-mesh] (a) qwen3-1.7b prefill_32k, one DP member of {CELL_MESH}, model axis "
        f"cut to {SERVE_MESH_TP}: B=1 S={S} bf16 gqa_repeat="
        f"{r0['a']['settings']['gqa_repeat']}: K1 a rank a prefill "
        f"{r0['a']['launches']['flash_attention_fwd']} at q (1,{qwen3.n_heads // 4},{S},"
        f"{qwen3.resolved_head_dim}) and kv after the repeat; prefill_ms rank 0 runs="
        f"{[round(t, 2) for t in r0['a']['runs']]} tok/s={S / ms * 1e3:.0f} peak_gb a "
        f"rank={[round(r['a']['peak_gb'], 2) for r in recs]}; members' logits vs one-member: "
        f"fp32 at {SERVE_MESH_FP32_LAYERS} layers max_abs_diff={err:.3e} (atol=rtol=1e-4), "
        f"bf16 at {qwen3.n_layers} layers max_abs_diff={gap:.3e} | {card}")
    for rank, rec in enumerate(recs):
        if rec["b"]["launches"] != zero or not rec["b"]["finite"]:
            raise AssertionError(f"[serve-mesh] (b) rank {rank}: {rec['b']['launches']}, "
                                 f"finite {rec['b']['finite']}")
    err = sm_check(torch, "b", recs, ref, 1e-4)
    S = S_dec
    p50 = statistics.median(b0["times"])
    log(f"[serve-mesh] (b) qwen3-1.7b decode_32k, one DP member on {SERVE_MESH_TP}: "
        f"B={b0['rows']} over a {S}-long cache ({b0['cache_gb']:.2f} GB a rank), "
        f"{SERVE_MESH_STEPS} steps at pos {b0['start']}..{S - 1}: launches={b0['launches']} "
        f"tpot_p50_ms={p50:.2f} step_ms={[round(t, 2) for t in b0['times']]} "
        f"tok/s={b0['rows'] * SERVE_MESH_STEPS / sum(b0['times']) * 1e3:.1f} peak_gb a rank="
        f"{[round(r['b']['peak_gb'], 2) for r in recs]}; every step's logits vs one-member "
        f"fp32 at {SERVE_MESH_FP32_LAYERS} layers max_abs_diff={err:.3e} (atol=rtol=1e-4) "
        f"| {card}")


def sm_check_rwkv(torch, recs, inputs, card):
    """(c) against the one-member run, with the layers' drift printed
    before the hold."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import build_cell
    rwkv = get_arch("rwkv6-1.6b")
    long = build_cell("rwkv6-1.6b", "long_500k", CELL_MESH)
    c0 = recs[0]["c"]
    want = dict({k: 0 for k in kernel_modules()}, wkv6_fwd=rwkv.n_layers * SERVE_MESH_STEPS)
    for rank, rec in enumerate(recs):
        c = rec["c"]
        if c["launches"] != want or not c["finite"] or c["checked"] != want["wkv6_fwd"] \
                or c["k3_shapes"] != [(1, rwkv.n_heads // 4, 1, rwkv.rwkv.head_size)]:
            raise AssertionError(f"[serve-mesh] (c) rank {rank}: {c['launches']} (expected "
                                 f"{want}), {c['checked']} checked at {c['k3_shapes']}")
    S = long.shape.seq_len
    ctoks = inputs["c"].cuda()
    st = dataclasses.replace(long.model.settings, use_kernel_ssm=True)
    depth = SERVE_MESH_FP32_LAYERS
    ref, ref_seen = sm_reference(
        torch, rwkv.replace(n_layers=depth), sm_fp32(st),
        lambda m: sm_recorded(lambda: sm_steps(torch, m, m.init_cache(1, S), ctoks,
                                               S - SERVE_MESH_STEPS, 1, S)))
    drift = sm_drift(recs, ref_seen, depth)
    err = max(float(np.abs(rec["c"]["fp32"] - ref).max()) for rec in recs)
    log(f"[serve-mesh] (c) rwkv6-1.6b long_500k, one DP member on {SERVE_MESH_TP}: B=1, "
        f"{SERVE_MESH_STEPS} steps at pos {S - SERVE_MESH_STEPS}..{S - 1}, bf16: K3 a rank "
        f"{c0['launches']['wkv6_fwd']} ({rwkv.n_layers} a step) at {c0['k3_shapes'][0]}; "
        f"tpot_p50_ms={statistics.median(c0['times']):.2f} step_ms="
        f"{[round(t, 2) for t in c0['times']]} peak_gb a rank="
        f"{[round(r['c']['peak_gb'], 2) for r in recs]}; every K3 launch of a second run vs "
        f"plain on its inputs: max_err={max(r['c']['max_err'] for r in recs):.3e} "
        f"({sum(r['c']['checked'] for r in recs)} launches; rtol 1e-4, atol 2e-5 x "
        f"(max|y|+1)); fp32 at {depth} layers, members vs one-member: each layer's "
        f"relative drift, recurrence input r: {[float(f'{d:.2e}') for d in drift['r']]}; "
        f"output y: {[float(f'{d:.2e}') for d in drift['y']]}; logits max_abs_diff="
        f"{err:.3e} (max|logits| {float(np.abs(ref).max()):.3e}; atol=rtol=1e-3) | {card}")
    sm_check(torch, "c", recs, ref, 1e-3)


def sm_check_jamba(torch, recs, inputs, card):
    """(d) against the one-member run, and the combine's differences."""
    from repro_torch.configs import one_card_arch
    from repro_torch.launch.cells import build_cell
    jamba, cuts = one_card_arch("jamba-1.5-large-398b")
    cell = build_cell("jamba-1.5-large-398b", "long_500k", CELL_MESH)
    d0 = recs[0]["d"]
    bf16_steps, fp32_steps = SERVE_MESH_JAMBA_STEPS
    n_mamba = jamba.n_layers - len(jamba.attn_layer_ids())
    want = dict({k: 0 for k in kernel_modules()}, mamba_scan_fwd=n_mamba * bf16_steps)
    S = cell.shape.seq_len
    kv = jamba.n_kv_heads // SERVE_MESH_FSDP["model"]
    for rank, rec in enumerate(recs):
        d = rec["d"]
        k_shape = [v for p, v in d["cache"].items() if p.endswith("/k")][0]
        if d["launches"] != want or not d["finite"] \
                or k_shape != (1, 1, S // 2, kv, jamba.resolved_head_dim):
            raise AssertionError(f"[serve-mesh] (d) rank {rank}: {d['launches']} (expected "
                                 f"{want}), finite {d['finite']}, k block {k_shape}")
        for pos, diff, top in d["combine"]:
            if not diff <= 1e-5 * max(top, 1.0):
                raise AssertionError(f"[serve-mesh] (d) rank {rank}: the combine at pos "
                                     f"{pos} is {diff} off the whole attend_decode")
    dtoks = inputs["d"].cuda()
    st = dataclasses.replace(cell.model.settings, use_kernel_ssm=True)
    ref = sm_reference(
        torch, jamba.replace(**SERVE_MESH_JAMBA_FP32), sm_fp32(st),
        lambda m: sm_steps(torch, m, m.init_cache(1, S), dtoks[:, :fp32_steps],
                           S - fp32_steps, 1, S))
    err = sm_check(torch, "d", recs, ref, 1e-4)
    k_block = [v for p, v in d0["cache"].items() if p.endswith("/k")][0]
    log(f"[serve-mesh] (d) {jamba.name} long_500k, one DP member of one block "
        f"({'; '.join(cuts)}) on {SERVE_MESH_FSDP}, FSDP over data: B=1, {bf16_steps} steps "
        f"at pos {S - bf16_steps}..{S - 1}, bf16: parameters {d0['params_gb']:.2f} GB a rank, "
        f"cache {d0['cache_gb']:.2f} GB a rank (k block {k_block}); K4 a rank "
        f"{d0['launches']['mamba_scan_fwd']} ({n_mamba} a step) at (1,1,"
        f"{jamba.mamba.expand * jamba.d_model // SERVE_MESH_FSDP['model']}); tpot_p50_ms="
        f"{statistics.median(d0['times']):.2f} step_ms={[round(t, 2) for t in d0['times']]} "
        f"peak_gb a rank={[round(r['d']['peak_gb'], 2) for r in recs]}; the combine vs the "
        f"whole attend_decode, (pos, max_abs_diff, max|o|) rank 0: {d0['combine']}; logits "
        f"vs one-member fp32 ({SERVE_MESH_JAMBA_FP32}, {fp32_steps} steps) max_abs_diff="
        f"{err:.3e} (atol=rtol=1e-4) | {card}")


def sm_check_server(torch, recs, inputs, card):
    """(e): every member's outputs equal; fp32 tokens for the one-member
    server's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ModelSettings
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    qwen3 = get_arch("qwen3-1.7b")
    cfg = SERVE_MESH_SERVER
    e0 = recs[0]["e"]
    for rank, rec in enumerate(recs):
        for tag in ("bf16", "fp32"):
            e = rec["e"][tag]
            if not e["done"] or e["outs"] != e0[tag]["outs"] \
                    or e["stats"]["tokens"] != e0[tag]["stats"]["tokens"]:
                raise AssertionError(f"[serve-mesh] (e) {tag} rank {rank}: outputs differ "
                                     f"from rank 0's or a request did not finish")

    def one_member(model):
        server = DecodeServer(model, "cuda", batch_slots=cfg["slots"], max_seq=cfg["max_seq"])
        for i, prompt in enumerate(inputs["e"]):
            server.submit(Request(uid=i, prompt=prompt, max_new=cfg["max_new"]))
        return server.run(max_steps=cfg["max_seq"] - 1)

    ref = sm_reference(torch, qwen3.replace(n_layers=SERVE_MESH_FP32_LAYERS),
                       sm_fp32(ModelSettings()), one_member)
    same = sum(ref[u] == t for u, t in e0["fp32"]["outs"].items())
    lat, stats = e0["bf16"]["latency"], e0["bf16"]["stats"]
    log(f"[serve-mesh] (e) DecodeServer over {SERVE_MESH_FSDP}, qwen3-1.7b: "
        f"{cfg['requests']} requests, {cfg['slots']} slots ({cfg['slots'] // 2} a data "
        f"member: rank 0 slots {e0['bf16']['rows']}), max_seq {cfg['max_seq']}, max_new "
        f"{cfg['max_new']}, greedy, bf16: tokens={stats['tokens']} steps={stats['steps']} "
        f"wall_s={stats['wall']:.3f} tok/s={e0['bf16']['tok_s']:.1f} "
        f"ttft_p50_ms={lat['ttft_p50_s'] * 1e3:.2f} ttft_p99_ms={lat['ttft_p99_s'] * 1e3:.2f} "
        f"tpot_p50_ms={lat['tpot_p50_s'] * 1e3:.2f} tpot_p99_ms={lat['tpot_p99_s'] * 1e3:.2f} "
        f"peak_gb a rank={[round(r['e']['bf16']['peak_gb'], 2) for r in recs]}; every "
        f"member's outputs equal; fp32 at {SERVE_MESH_FP32_LAYERS} layers: {same} of "
        f"{len(ref)} requests' tokens equal to the one-member server's | {card}")
    if same != len(ref) or len(ref) != cfg["requests"]:
        raise AssertionError("[serve-mesh] (e) fp32 tokens differ from the one-member server's")


def serve_mesh_phase(torch, card, phase_done, recs, inputs):
    """``[serve-mesh]``: the four cells' shares and the DecodeServer over a
    mesh (``recs``: each rank's record, :func:`serve_mesh_runs`), each run
    held against the one-member run on the card; every run's check runs,
    and the phase fails after them if any failed."""
    log(f"[serve-mesh] rank 0's seconds by run: "
        f"{ {k: round(v, 1) for k, v in recs[0]['s'].items()} } | {card}")
    failed = []
    for fn, what in ((sm_check_qwen3, "(a) qwen3 prefill_32k, (b) decode_32k on (1, 4)"),
                     (sm_check_rwkv, "(c) rwkv6 long_500k on (1, 4)"),
                     (sm_check_jamba, "(d) jamba long_500k on (2, 2), FSDP"),
                     (sm_check_server, "(e) DecodeServer on (2, 2)")):
        try:
            fn(torch, recs, inputs, card)
        except AssertionError as e:
            log(f"[serve-mesh] {what} FAILED: {e}")
            failed.append(what)
        phase_done(f"serve-mesh: {what}")
    if failed:
        raise AssertionError(f"[serve-mesh] failed: {'; '.join(failed)}")


# ---------------------------------------------------------------------------
# [seq-par]: the sequence split, the context-parallel cell, MoE groups
# ---------------------------------------------------------------------------

#: the training runs' mesh, (pod, data, model) = (1, 2, 2): two DP members
#: of a model axis of 2, the 4 ranks sharing the card; B=1 S=4096 (the
#: train_4k cells' length) a DP member, 2 steps
SEQ_PAR_SIZES = {"pod": 1, "data": 2, "model": 2}
SEQ_PAR_STEPS, SEQ_PAR_SEQ = 2, 4096
#: (d) one DP member of CELL_MESH with its model axis cut to the 4 ranks,
#: at 4 of qwen3's 28 layers (at 28: 43.4 s of the phase); (e) 4 DP
#: members of one deepseek MoE layer in 2 dispatch groups
SEQ_PAR_PREFILL = {"data": 1, "model": 4}
SEQ_PAR_PREFILL_LAYERS = 2
SEQ_PAR_MOE, SEQ_PAR_MOE_GROUPS = {"data": 4}, 2
#: the fp32 holds' depth: with and without the sequence split, one step
#: (a)-(c) or one prefill (d) on the same inputs
SEQ_PAR_FP32_LAYERS = 2


class SpRun(NamedTuple):
    """A train_4k cell of ``[seq-par]`` bound by ``Cell.bind`` on
    SEQ_PAR_SIZES with its flag: its arch, flag, depth (None: every
    layer), sequence a DP member (B=1), steps, and its fp32 hold's depth
    and sequence."""
    arch: str
    flag: str
    depth: Optional[int]
    seq: int
    steps: int
    fp32_layers: int
    fp32_seq: int


#: (a), (b), (f) and (g).  (a) runs 1 step at 12 of qwen2's 24 layers;
#: (b) 2 of qwen3's 28 layers (at 28 its two steps and their checks took
#: 59-83 s of the phase: each step sums and gathers the whole replicated
#: blocks over gloo), 2 steps, so that its ZeRO moments cross a step; (f)
#: 2 of deepseek's 28 (a third adds about 9.4 GB a DP member at 16 bytes a
#: parameter, nothing sharded over data); (g) 2 of rwkv6's 24 at S=1024,
#: its fp32 hold at 2 layers and S=256 (the backward is the plain
#: recurrence, step by step); the fp32 holds of (a), (b) and (f) run
#: SEQ_PAR_FP32_SEQ tokens a DP member
SEQ_PAR_FP32_SEQ = 1024
SEQ_PAR_TRAIN = {
    "a": SpRun("qwen2-0.5b", "seq_shard", 12, SEQ_PAR_SEQ, 1,
               SEQ_PAR_FP32_LAYERS, SEQ_PAR_FP32_SEQ),
    "b": SpRun("qwen3-1.7b", "context_parallel", 2, SEQ_PAR_SEQ, SEQ_PAR_STEPS,
               SEQ_PAR_FP32_LAYERS, SEQ_PAR_FP32_SEQ),
    "f": SpRun("deepseek-moe-16b", "seq_shard", 2, SEQ_PAR_SEQ, 1, 2, SEQ_PAR_FP32_SEQ),
    "g": SpRun("rwkv6-1.6b", "seq_shard", 2, 1024, 1, 2, 256)}


def depth_cut(arch, layers):
    """``arch`` at ``layers`` layers (an encoder-decoder's encoder too)."""
    arch = arch.replace(n_layers=layers)
    if arch.is_encdec:
        arch = arch.replace(encoder=dataclasses.replace(arch.encoder, n_layers=layers))
    return arch


def sp_steps(torch, kernels, mesh, model, run, state, steps, agree=True,
             seq=SEQ_PAR_SEQ, rows=1):
    """``steps`` steps of ``run(params, state, batch, step)`` (a bound cell
    or a step factory's) on this DP member's ``rows`` x ``seq``, drawn from
    a seed a DP member (the same rows on its model members, and in every
    call): each step's loss, gradient norm, time, launches (every count
    set to 0 just before the step), the collectives of the model's
    TP/FSDP/sequence-split Functions (``prims.TP_CALLS``), the (token, k)
    slots each MoE layer's dispatch dropped (forward, then recompute),
    whether the blocks two members hold alike agree bit for bit (with
    ``agree``), and the peak memory."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.models import layers as L
    from repro_torch.runtime.train_loop import dp_rank
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1 + dp_rank(mesh))
    share = ShapeConfig("seq-par", seq, rows, "train")
    model.requires_grad_(True)
    params, out = model.params(), []
    torch.cuda.reset_peak_memory_stats()
    for step in range(steps):
        batch = model.synthetic_batch(gen, share)
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.LAUNCHES = 0  # just before the path
        calls = dict(prims.TP_CALLS)
        L.DROP_LOG = []
        try:
            t0 = time.perf_counter()
            params, state, metrics = run(params, state, batch, step)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            drops = [int(d.sum()) for d in L.DROP_LOG]
        finally:
            L.DROP_LOG = None
        launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
        calls = {k: v - calls[k] for k, v in prims.TP_CALLS.items()}
        agree, shared = (blocks_agree(params, model.layout, mesh) if agree
                         else (None, None))
        out.append(dict(step=step, loss=loss, grad_norm=float(metrics["grad_norm"]),
                        dt=dt, launches=launches, calls=calls, drops=drops, agree=agree,
                        shared=shared, peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        del batch
    return out, state


def sp_factory(model, mesh, kind):
    """(step, init) of the step factory ``kind`` uses for ``model`` on
    ``mesh``: the DFabric step (a, f, g), the context-parallel cell's GSPMD
    step (b), the GSPMD step with FSDP (c, i)."""
    from repro_torch.core.topology import topology_from_mesh_sizes
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.runtime.train_loop import (make_dfabric_train_step,
                                                make_gspmd_train_step,
                                                make_sync_plan, mesh_info)
    lr = cosine_schedule(3e-4, 100, 10000)
    if kind in ("a", "f", "g"):
        plan, ss = make_sync_plan(model, mesh.sizes, topology_from_mesh_sizes(mesh.sizes))
        return make_dfabric_train_step(model, mesh, plan, ss, AdamWConfig(), lr)
    mi = mesh_info(mesh.sizes, fsdp=kind in ("c", "i"))
    if kind == "b":
        mi.tp_scope = "embed_only"
    step, init, _ = make_gspmd_train_step(model, mesh, AdamWConfig(), lr,
                                          fsdp=kind in ("c", "i"), mi=mi,
                                          zero_opt=kind == "b")
    return step, init


def sp_fp32_hold(torch, kernels, mesh, arch, st, kind, layers=SEQ_PAR_FP32_LAYERS,
                 seq=SEQ_PAR_SEQ, rows=1, nosplit_kind=None):
    """One fp32 step at ``layers`` layers with the sequence split (the step
    factory of ``kind``) and one without (of ``nosplit_kind``, ``kind`` by
    default), on the same rows: (the split step's record, [(loss,
    grad_norm, collectives, dropped slots) of each])."""
    from repro_torch.models import build_model
    out, first = [], None
    for split in (True, False):
        fields = dict(param_dtype="float32", compute_dtype="float32")
        if not split:
            fields.update(seq_axis=None, batch_axes=None)
        model = build_model(depth_cut(arch, layers),
                            dataclasses.replace(st, **fields), device="cuda", seed=SEED)
        step, init = sp_factory(model, mesh, kind if split else nosplit_kind or kind)
        # the blocks are compared in the split step (c) records
        steps, _ = sp_steps(torch, kernels, mesh, model, step, init(), 1,
                            agree=split and kind == "c", seq=seq, rows=rows)
        if split:
            first = steps
        out.append((steps[0]["loss"], steps[0]["grad_norm"], steps[0]["calls"],
                    steps[0]["drops"]))
        del model, step, init
        gc.collect()
        torch.cuda.empty_cache()
    return first, out


def sp_train(torch, kernels, mesh, part):
    """(a), (b), (f) or (g): the train_4k cell of SEQ_PAR_TRAIN[part] with
    its flag, at its depth, bound to this rank's mesh (``Cell.bind``; a
    DFabric cell cut in depth through the step factory, with the cell's
    settings), its steps; the context-parallel cell's moments' blocks
    against its stand-ins' specs (``zero_moment_specs``); then the fp32
    hold."""
    from repro_torch.launch.cells import Bound, build_cell
    from repro_torch.models import build_model
    from repro_torch.models.sharding import local_shape
    from repro_torch.utils.trees import tree_paths
    run = SEQ_PAR_TRAIN[part]
    cell = build_cell(run.arch, "train_4k", SEQ_PAR_SIZES, attn_impl="kernel",
                      **{run.flag: True})
    if cell.arch.rwkv is not None:  # the cell's settings, K3 in the forward
        cell.model.settings = dataclasses.replace(cell.model.settings,
                                                  use_kernel_ssm=True)
    if run.depth:
        cell.arch = cell.arch.replace(n_layers=run.depth)
    st = cell.model.settings
    if run.depth and cell.step_kind == "dfabric":
        # the cell's sync plan is the whole model's: the cut model, with
        # the cell's settings, gets its own from the DFabric step factory
        model = build_model(cell.arch, st, device="cuda", seed=SEED)
        bound = Bound(model, *sp_factory(model, mesh, part))
    else:
        bound = cell.bind(mesh, device="cuda", seed=SEED)
    state = bound.init()
    rec = dict(step_kind=cell.step_kind, microbatches=cell.microbatches,
               settings=dataclasses.asdict(st), n_steps=run.steps, seq=run.seq,
               layers=cell.arch.n_layers, fp32_layers=run.fp32_layers,
               fp32_seq=run.fp32_seq,
               expected={k: n * cell.microbatches
                         for k, n in expected_launches(cell.arch, st).items()},
               mem_after_init_gb=torch.cuda.memory_allocated() / 1e9)
    if cell.step_kind == "gspmd_cp":
        shapes = {k: v.shape for k, v in tree_paths(bound.model.param_shapes()).items()}
        specs = bound.model.layout.specs
        want = {k: local_shape(shapes[k], leaf.spec, mesh.sizes)
                for k, leaf in tree_paths(cell.args[1]["m"]).items()}
        blocks = {k: local_shape(shapes[k], specs[k], mesh.sizes) for k in shapes}
        got = {k: tuple(t.shape) for k, t in tree_paths(state["m"]).items()}
        rec["moments"] = dict(equal=got == want, leaves=len(want), split=sum(
            math.prod(v) < math.prod(blocks[k]) for k, v in want.items()))
    rec["steps"], state = sp_steps(torch, kernels, mesh, bound.model, bound.run, state,
                                   run.steps, seq=run.seq)
    del bound, state
    gc.collect()
    torch.cuda.empty_cache()
    _, rec["fp32"] = sp_fp32_hold(torch, kernels, mesh, cell.arch, st, part,
                                  layers=run.fp32_layers, seq=run.fp32_seq)
    return rec


def sp_fsdp(torch, kernels, mesh):
    """(c) qwen3-1.7b at SEQ_PAR_FP32_LAYERS layers under FSDP over data x
    TP over model with the nemotron cell's settings (``seq_axis``,
    ``batch_axes``), the GSPMD step, in fp32: the fp32 hold, whose split
    step is the run recorded."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import build_cell
    nemotron = build_cell("nemotron-4-340b", "train_4k", SEQ_PAR_SIZES, seq_shard=True,
                          attn_impl="kernel").model.settings
    arch = get_arch("qwen3-1.7b")
    st = dataclasses.replace(nemotron, param_dtype="float32", compute_dtype="float32")
    rec = dict(settings=dataclasses.asdict(st), n_steps=1,
               expected=expected_launches(arch.replace(n_layers=SEQ_PAR_FP32_LAYERS), st))
    rec["steps"], rec["fp32"] = sp_fp32_hold(torch, kernels, mesh, arch, st, "c")
    return rec


def sp_prefill(torch, kernels, tokens, nosplit):
    """(d) qwen3-1.7b's prefill_32k cell with ``seq_shard``, one DP member
    (B=1) on SEQ_PAR_PREFILL: bf16 at SEQ_PAR_PREFILL_LAYERS layers, timed
    once; then fp32 at SERVE_MESH_FP32_LAYERS layers, beside ``nosplit``,
    the same prefill's fp32 logits without the split (``[serve-mesh]``
    (a)'s, at that depth)."""
    import torch.distributed as dist
    from repro_torch.core import prims
    from repro_torch.launch.cells import build_cell
    mesh = prims.Mesh(SEQ_PAR_PREFILL)
    cell = build_cell("qwen3-1.7b", "prefill_32k", CELL_MESH, seq_shard=True,
                      attn_impl="kernel")
    arch, st = cell.arch, cell.model.settings
    toks = tokens.cuda()
    torch.cuda.reset_peak_memory_stats()
    model = sm_model(torch, mesh, arch.replace(n_layers=SEQ_PAR_PREFILL_LAYERS), st)
    rec = dict(settings=dataclasses.asdict(st), layers=SEQ_PAR_PREFILL_LAYERS)
    with prims.bind(mesh):
        dist.barrier()
        t0 = time.perf_counter()
        (logits, cache), launches = drive_path(
            kernels, lambda: model.prefill(toks, batch=toks.shape[0]))
        rec.update(ms=(time.perf_counter() - t0) * 1e3, launches=launches,
                   shape=tuple(logits.shape), finite=bool(torch.isfinite(logits).all()),
                   cache_seq=cache["l0"]["k"].shape[2],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
        model = sm_model(torch, mesh, arch.replace(n_layers=SERVE_MESH_FP32_LAYERS),
                         sm_fp32(st))
        rec["fp32"] = [model.prefill(toks, batch=toks.shape[0])[0].cpu().numpy(), nosplit]
        del model
    return rec


def sp_moe(torch):
    """(e) one deepseek-moe-16b MoE layer in fp32 on SEQ_PAR_MOE_GROUPS
    dispatch groups of a 4-row global batch (S=2048), whole on this rank
    (output, aux loss, dropped slots), then this DP member's row routed
    with the batch's (``token_axes``: each group spans two members)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prims
    from repro_torch.models import layers as L
    mesh = prims.Mesh(SEQ_PAR_MOE)
    arch, dev = get_arch("deepseek-moe-16b"), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(MOE_CUT_SEED)
    p = L.init_moe(arch, gen, (), torch.float32, dev)
    # a direction shared by every token skews the routing past the capacity
    x = (torch.randn((4, S_MAIN, arch.d_model), generator=gen, device=dev)
         + 0.5 * torch.randn(arch.d_model, generator=gen, device=dev))
    row, g = mesh.coords["data"], SEQ_PAR_MOE_GROUPS
    L.DROP_LOG = []
    try:
        with torch.no_grad():
            whole, whole_aux = L.apply_moe(arch, p, x, groups=g)
            whole_drops = int(L.DROP_LOG.pop().sum())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with prims.bind(mesh):
                y, aux = L.apply_moe(arch, p, x[row:row + 1], groups=g,
                                     token_axes=("data",))
            torch.cuda.synchronize()
            drops = int(L.DROP_LOG.pop().sum())
    finally:
        L.DROP_LOG = None
    return dict(drops=drops, whole_drops=whole_drops, s=time.perf_counter() - t0,
                err=(y[0] - whole[row]).abs().max().item(),
                scale=whole.abs().max().item(), aux=aux.item(),
                whole_aux=whole_aux.item())


#: (h) the jamba smoke with its experts under the GSPMD step with the
#: sequence split (``HYBRID_FIELDS``, B=HYBRID_ROWS S=HYBRID_SEQ a DP
#: member), then one full-width Mamba layer of MAMBA_CUT over model = 2 with
#: the sequence split, B=1 S=2048
SEQ_PAR_JAMBA_STEPS = 1
#: (i) whisper-medium under the GSPMD step (FSDP x TP) with the sequence
#: split, bf16, ``remat="full"``, K1 in the decoder; its depth (2 of 24 +
#: 24, for the card's time), rows a DP member, steps, checkpoint step and
#: fp32 hold's depth
SEQ_PAR_WHISPER = dict(depth=2, rows=2, steps=2, ckpt=2, fp32_depth=2)
#: (j) prefill with the sequence split on SEQ_PAR_PREFILL, B=1: rwkv6-1.6b's
#: prefill_32k cell at SEQ_PAR_RWKV_PREFILL_LAYERS of its 24 layers (for
#: the card's time: each layer gathers and reduce-scatters 134 MB over
#: gloo), and the jamba block (one_card_arch) at
#: S=4096; the fp32 holds: rwkv6 at 4 layers over the first 8192 tokens (at
#: 32768 its two prefills took 10-20 s of the run's 31-53 s), jamba a Mamba
#: layer and the attention layer (attn_every 2: 11 GB in fp32, built by the
#: ranks at once; 4 layers, 20 GB, had to be built in turns)
SEQ_PAR_JAMBA_PREFILL_SEQ = 4096
SEQ_PAR_RWKV_FP32_SEQ = 8192
SEQ_PAR_RWKV_PREFILL_LAYERS = 8
#: the planned MoE dispatch: one deepseek-moe-16b MoE layer in fp32, its
#: experts over model, each DP member's row of a 2 x 2048 global batch
#: routed with the batch's; a 4-member all-to-all at chunks 2, lane offset 1
SEQ_PAR_SCHED = dict(chunks=2, lane_offset=1, members=4)


def sp_jamba(torch, mesh, out_dir):
    """(h) on this rank: the jamba smoke with its experts, the ``Trainer``
    in GSPMD mode with ``seq_axis``/``batch_axes`` on SEQ_PAR_SIZES
    (:func:`step_recorder`), then its block of the full-width Mamba layer
    of MAMBA_CUT (its DP member's dtype) with the sequence split
    (:func:`mamba_member_grads`)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    rec = {"steps": []}
    start, on_step = step_recorder(rec)
    st = ModelSettings(**HYBRID_FIELDS, seq_axis="model", batch_axes=("pod", "data"))
    trainer = Trainer(build_model(get_smoke_arch("jamba-1.5-large-398b"), st,
                                  device="cuda", seed=SEED),
                      mesh, ShapeConfig("custom", HYBRID_SEQ, HYBRID_ROWS * 2, "train"),
                      TrainerConfig(steps=SEQ_PAR_JAMBA_STEPS, lr=3e-4, warmup=1,
                                    mode="gspmd"))
    params, opt, step0 = trainer.init_state()
    start(trainer)
    trainer.train(params, opt, step0, on_step=on_step)
    rec["settings"] = dataclasses.asdict(st)
    del trainer, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    rec["mamba"] = mamba_member_grads(torch, mesh, out_dir, sp="model")
    rec["coords"] = mesh.coords
    return rec


def sp_whisper(torch, kernels, mesh, ckpt_dir):
    """(i) on this rank: whisper-medium at SEQ_PAR_WHISPER's depth, the
    ``Trainer`` in GSPMD mode (FSDP over data x TP over model) with
    ``seq_axis``/``batch_axes``, its frames from the data pipeline,
    recorded by :func:`step_recorder`, a checkpoint at its last step
    restored into a fresh model; then the fp32 hold at 2 + 2 layers, the
    GSPMD step with the split against the DFabric step without it."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    w, seq = SEQ_PAR_WHISPER, whisper_seq()
    arch = family_arch("whisper-medium", w["depth"])[0]
    st = ModelSettings(**BF16, remat="full", attn_impl="kernel", max_seq=seq,
                       seq_axis="model", batch_axes=("pod", "data"))
    rec = {"steps": [], "settings": dataclasses.asdict(st), "seq": seq}
    start, on_step = step_recorder(rec, ckpt_at=w["ckpt"])
    shape = ShapeConfig("custom", seq, w["rows"] * 2, "train")
    cfg = TrainerConfig(steps=w["steps"], lr=3e-4, warmup=1, mode="gspmd",
                        ckpt_dir=ckpt_dir, ckpt_every=w["ckpt"])
    trainer = Trainer(build_model(arch, st, device="cuda", seed=SEED), mesh, shape, cfg)
    params, opt, step0 = trainer.init_state()
    start(trainer)
    trainer.train(params, opt, step0, on_step=on_step)
    rec["specs"] = {k: v for k, v in trainer.model.layout.specs.items()
                    if k.startswith(("enc_blocks/", "blocks/l0/xattn/"))}
    del trainer, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    fresh = Trainer(build_model(arch, st, device="cuda", seed=SEED + 1), mesh, shape, cfg)
    params, opt, step = fresh.try_restore()
    got = state_digests(params, opt)
    rec["restore"] = dict(step=step, restore_s=fresh.restore_s, leaves=len(got),
                          equal=sum(got[k] == v for k, v in rec["ckpt_digests"].items()))
    del fresh, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    _, rec["fp32"] = sp_fp32_hold(torch, kernels, mesh, arch, st, "i",
                                  layers=w["fp32_depth"], seq=seq, rows=w["rows"],
                                  nosplit_kind="a")
    return rec


def sp_prefill_family(torch, kernels, part, toks):
    """(j) on this rank of SEQ_PAR_PREFILL: rwkv6-1.6b's prefill_32k cell
    with ``seq_shard`` at SEQ_PAR_RWKV_PREFILL_LAYERS layers (``part``
    "rwkv") or the jamba block at S=4096 ("jamba"), B=1, bf16, K3/K4 (and
    K1) in the forward,
    timed once; then in fp32 at the hold's depth with the split and
    without it on the same tokens: the logits, every cache leaf and each
    recurrence's output a layer."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import one_card_arch
    from repro_torch.core import prims
    from repro_torch.launch.cells import build_cell
    from repro_torch.utils.trees import tree_paths
    mesh = prims.Mesh(SEQ_PAR_PREFILL)
    name = "rwkv6-1.6b" if part == "rwkv" else "jamba-1.5-large-398b"
    cell = build_cell(name, "prefill_32k", CELL_MESH, seq_shard=True, attn_impl="kernel")
    st = dataclasses.replace(cell.model.settings, use_kernel_ssm=True)
    if part == "rwkv":
        arch = cell.arch.replace(n_layers=SEQ_PAR_RWKV_PREFILL_LAYERS)
        hold, turns = dict(n_layers=4), 1
        hold_toks = toks[:, :SEQ_PAR_RWKV_FP32_SEQ].cuda()
    else:
        # 18 GB uncut in bf16: two ranks' at a time
        arch, hold, turns = (one_card_arch(name)[0], SERVE_MESH_JAMBA_FP32, 2)
        toks = toks[:, :SEQ_PAR_JAMBA_PREFILL_SEQ]
        hold_toks = toks.cuda()
    toks = toks.cuda()
    torch.cuda.reset_peak_memory_stats()
    model = sm_model(torch, mesh, arch, st, turns=turns)
    rec = dict(settings=dataclasses.asdict(st), seq=toks.shape[1], layers=arch.n_layers,
               hold=dict(hold, seq=hold_toks.shape[1]))
    with prims.bind(mesh):
        dist.barrier()
        t0 = time.perf_counter()
        (logits, cache), launches = drive_path(
            kernels, lambda: model.prefill(toks, batch=toks.shape[0]))
        rec.update(ms=(time.perf_counter() - t0) * 1e3, launches=launches,
                   shape=tuple(logits.shape), finite=bool(torch.isfinite(logits).all()),
                   cache={k: tuple(v.shape) for k, v in tree_paths(cache).items()},
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
        runs = []
        for split in (True, False):
            fields = {} if split else dict(seq_axis=None, batch_axes=None)
            model = sm_model(torch, mesh, arch.replace(**hold),
                             dataclasses.replace(sm_fp32(st), **fields))
            (lg, cache), seen = sm_recorded(
                lambda: model.prefill(hold_toks, batch=hold_toks.shape[0]))
            runs.append(((lg.cpu(), tree_paths(cache)), [y for _, y in seen]))
            del model
            gc.collect()
            torch.cuda.empty_cache()
    ((lg, c), ys), ((lg0, c0), ys0) = runs
    rec["fp32"] = dict(
        logits=(lg - lg0).abs().max().item(), scale=lg0.abs().max().item(),
        cache={k: (c[k].float() - c0[k].float()).abs().max().item() for k in c0},
        shapes_equal=all(c[k].shape == c0[k].shape for k in c0),
        drift=[float(np.abs(y - y0).max() / max(np.abs(y0).max(), 1e-30))
               for y, y0 in zip(ys, ys0)],
        calls=(len(ys), len(ys0)))
    return rec


def sp_sched(torch, mesh):
    """The planned dispatch on this rank of SEQ_PAR_SIZES: one
    deepseek-moe-16b MoE layer in fp32 (MOE_CUT_SEED), its experts split
    over model (32 of 64 a member), this DP member's row of a 2 x 2048
    global batch routed with the batch's (``token_axes``), once without a
    schedule and once with SEQ_PAR_SCHED's, planned for the whole batch's
    dispatch buffer: whether the outputs and aux losses are bit-equal."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prims, schedule, topology
    from repro_torch.models import layers as L
    arch, dev = get_arch("deepseek-moe-16b"), torch.device("cuda")
    moe, d, sc = arch.moe, arch.d_model, SEQ_PAR_SCHED
    gen = torch.Generator(device=dev).manual_seed(MOE_CUT_SEED)
    p = L.init_moe(arch, gen, (), torch.float32, dev)
    n, r = mesh.sizes["model"], mesh.coords["model"]
    El = moe.num_experts // n
    for k in ("we_in", "we_gate", "we_out"):
        p[k] = p[k][r * El:(r + 1) * El].contiguous()
    x = (torch.randn((2, S_MAIN, d), generator=gen, device=dev)
         + 0.5 * torch.randn(d, generator=gen, device=dev))
    C = L.moe_capacity(2 * S_MAIN, moe.top_k, moe.num_experts, moe.capacity_factor)
    m = sc["members"]
    numel = m * (moe.num_experts // m) * C * d
    fab = topology.as_fabric(topology.TwoTierTopology(
        num_pods=m, pod_shape=(1,))).with_paths(topology.cxl_shortcut_path())
    plan = schedule.build_all_to_all(
        fab, schedule.SyncConfig(chunks=sc["chunks"], path_split=(("cxl", 0.5),)),
        (m, numel // m), "float32").with_lane_offset(sc["lane_offset"])
    row = mesh.coords["data"]
    kw = dict(dispatch_spec=(None, "model"), token_axes=("data",))
    with prims.bind(mesh), torch.no_grad():
        y0, a0 = L.apply_moe(arch, p, x[row:row + 1], **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y1, a1 = L.apply_moe(arch, p, x[row:row + 1], dispatch_schedule=plan, **kw)
        torch.cuda.synchronize()
    return dict(equal=bool(torch.equal(y0, y1)), aux_equal=bool(torch.equal(a0, a1)),
                s=time.perf_counter() - t0, experts=El, slow_legs=len(plan.slow_legs),
                issue=[leg.index for leg in plan.slow_legs], capacity=C)


#: where (h)'s gradient blocks and (i)'s checkpoint are written
SEQ_PAR_DIR = os.path.join(HERE, "build", "seq_par")


def seq_par_runs(torch, kernels, inputs, sm):
    """This rank's ``[seq-par]`` runs: (a)-(c), (f)-(i) and the planned dispatch on SEQ_PAR_SIZES,
    (d) and (j) on SEQ_PAR_PREFILL, (d) on ``[serve-mesh]`` (a)'s tokens
    (its fp32 logits, ``sm["a"]["fp32"]``, are the prefill without the
    split on the same mesh and settings), (e) on SEQ_PAR_MOE, each run's
    launches counted in this process."""
    from repro_torch.core import prims
    mesh = prims.Mesh(SEQ_PAR_SIZES)
    rec = {"s": {}}
    runs = (("a", lambda: sp_train(torch, kernels, mesh, "a")),
            ("b", lambda: sp_train(torch, kernels, mesh, "b")),
            ("c", lambda: sp_fsdp(torch, kernels, mesh)),
            ("d", lambda: sp_prefill(torch, kernels, inputs["a"], sm["a"]["fp32"])),
            ("e", lambda: sp_moe(torch)),
            ("f", lambda: sp_train(torch, kernels, mesh, "f")),
            ("g", lambda: sp_train(torch, kernels, mesh, "g")),
            ("h", lambda: sp_jamba(torch, mesh, SEQ_PAR_DIR)),
            ("i", lambda: sp_whisper(torch, kernels, mesh,
                                     os.path.join(SEQ_PAR_DIR, "ckpt_whisper"))),
            ("j-rwkv", lambda: sp_prefill_family(torch, kernels, "rwkv", inputs["j"])),
            ("j-jamba", lambda: sp_prefill_family(torch, kernels, "jamba", inputs["j"])),
            ("sched", lambda: sp_sched(torch, mesh)))
    for part, fn in runs:
        t0 = time.perf_counter()
        rec[part] = fn()
        rec["s"][part] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def sp_check_train(part, recs, card):
    """(a), (b), (c), (f) or (g): every rank's launches as the code counts
    them, finite losses the ranks agree on, the blocks two members hold
    alike bit-equal after every step; the fp32 hold: step 0's loss within
    1e-5 and its gradient norm within 1e-4 of the step without the split,
    and a MoE layer's dropped slots equal to those without it, layer by
    layer."""
    tag = f"[seq-par] ({part})"
    r0 = recs[0]
    want = dict(r0["expected"], quantize_ef_fwd=0)
    tokens = 2 * r0.get("seq", SEQ_PAR_SEQ)  # the global batch: B=1 a DP member
    for rank, rec in enumerate(recs):
        for st in rec["steps"]:
            log(f"{tag} rank {rank} step {st['step']}: loss={st['loss']:.6f} "
                f"grad_norm={st['grad_norm']:.4f} step_s={st['dt']:.3f} "
                f"tok/s={tokens / st['dt']:.0f} (global batch) launches={st['launches']} "
                f"(expected {want}) collectives {st['calls']} "
                f"{'dropped slots a MoE dispatch ' + str(st['drops']) + ' ' if st['drops'] else ''}"
                f"blocks_bit_equal={st['agree']} ({st['shared']} "
                f"blocks held by 2+ members) peak_gb={st['peak_gb']:.2f} | {card}")
            if st["launches"] != want:
                raise AssertionError(f"{tag} rank {rank} step {st['step']} launched "
                                     f"{st['launches']}, expected {want}")
            if not (math.isfinite(st["loss"]) and st["agree"] and st["shared"] > 0):
                raise AssertionError(f"{tag} rank {rank} step {st['step']}: {st}")
        if [a["loss"] for a in rec["steps"]] != [a["loss"] for a in r0["steps"]]:
            raise AssertionError(f"{tag} rank {rank} disagrees on the loss")
        if len(rec["steps"]) != rec["n_steps"]:
            raise AssertionError(f"{tag} rank {rank} ran {len(rec['steps'])} steps")
    if "moments" in r0:
        for rank, rec in enumerate(recs):
            m = rec["moments"]
            log(f"{tag} rank {rank}: the ZeRO moments' blocks as zero_moment_specs "
                f"cuts them: {m['equal']} ({m['split']} of {m['leaves']} leaves split "
                f"beyond the parameter's block)")
            if not (m["equal"] and m["split"] > 0):
                raise AssertionError(f"{tag} rank {rank}: moments {m}")
    (loss, gnorm, calls, drops), (loss0, gnorm0, calls0, drops0) = r0["fp32"]
    rel_l, rel_g = abs(loss - loss0) / abs(loss0), abs(gnorm - gnorm0) / abs(gnorm0)
    log(f"{tag} fp32 at {r0.get('fp32_layers', SEQ_PAR_FP32_LAYERS)} layers, S="
        f"{r0.get('fp32_seq', SEQ_PAR_SEQ)}, step 0 with the sequence split "
        f"against without it: loss {loss!r} vs {loss0!r} rel {rel_l:.2e} (tol 1e-5); "
        f"grad_norm {gnorm!r} vs {gnorm0!r} rel {rel_g:.2e} (tol 1e-4); the model's "
        f"collectives a rank {calls} vs {calls0}"
        f"{f'; dropped slots a MoE dispatch {drops} vs {drops0}' if drops0 else ''}")
    for rank, rec in enumerate(recs):  # each DP member routes its own rows
        (*_, d), (*_, d0) = rec["fp32"]
        if d != d0 or (part == "f" and not d0):
            raise AssertionError(f"{tag} rank {rank}: the split step's drops {d} "
                                 f"differ from {d0}")
    if not calls["reduce_scatter"] > calls0["reduce_scatter"]:
        raise AssertionError(f"{tag} the split step ran no more reduce-scatters than "
                             f"the step without it")
    if any([h[:3] for h in rec["fp32"]] != [h[:3] for h in r0["fp32"]] for rec in recs):
        raise AssertionError(f"{tag} the ranks' fp32 holds differ")
    if not (rel_l <= 1e-5 and rel_g <= 1e-4):
        raise AssertionError(f"{tag} the split step is off the step without it")


def sp_check_prefill(torch, recs, tokens, card):
    """(d): K1 in every layer on every rank, the logits (1, vocab) and
    finite, the cache the whole sequence; fp32 at SERVE_MESH_FP32_LAYERS
    layers with the split within atol = rtol = 1e-5 of without it."""
    import numpy as np
    from repro_torch.configs import get_arch
    qwen3 = get_arch("qwen3-1.7b")
    d = recs[0]["d"]
    want = {k: 0 for k in kernel_modules()}
    want["flash_attention_fwd"] = d["layers"]
    for rank, rec in enumerate(recs):
        if rec["d"]["launches"] != want or rec["d"]["shape"] != (1, qwen3.vocab) \
                or not rec["d"]["finite"] or rec["d"]["cache_seq"] != tokens.shape[1]:
            raise AssertionError(f"(d) rank {rank}: launches {rec['d']['launches']} "
                                 f"(expected {want}), logits {rec['d']['shape']}, "
                                 f"cache rows {rec['d']['cache_seq']}")
    err = max(float(np.abs(rec["d"]["fp32"][0] - rec["d"]["fp32"][1]).max())
              for rec in recs)
    S = tokens.shape[1]
    log(f"[seq-par] (d) qwen3-1.7b prefill_32k seq_shard at {d['layers']} of "
        f"{qwen3.n_layers} layers, one DP member of "
        f"{CELL_MESH} cut to {SEQ_PAR_PREFILL}: B=1 S={S} bf16, K1 a rank "
        f"{d['launches']['flash_attention_fwd']} on the gathered sequence; "
        f"prefill_ms={d['ms']:.2f} tok/s={S / d['ms'] * 1e3:.0f} peak_gb a rank="
        f"{[round(r['d']['peak_gb'], 2) for r in recs]}; fp32 logits at "
        f"{SERVE_MESH_FP32_LAYERS} layers with the split vs without max_abs_diff="
        f"{err:.3e} (atol=rtol=1e-5) | {card}")
    for rank, rec in enumerate(recs):
        torch.testing.assert_close(
            torch.from_numpy(rec["d"]["fp32"][0]), torch.from_numpy(rec["d"]["fp32"][1]),
            atol=1e-5, rtol=1e-5, msg=lambda m: f"(d) rank {rank}: {m}")


def sp_check_moe(recs, card):
    """(e): the members' dropped slots summed equal the whole grouped
    layer's, each member's output within 1e-5 of the whole layer's largest
    value, the aux loss within 1e-6."""
    drops = sum(rec["e"]["drops"] for rec in recs)
    e = recs[0]["e"]
    log(f"[seq-par] (e) one deepseek-moe-16b MoE layer in fp32, {SEQ_PAR_MOE_GROUPS} "
        f"dispatch groups of a 4-row global batch (S={S_MAIN}) over {SEQ_PAR_MOE}, "
        f"each member's row routed with the batch's: dropped slots summed over the "
        f"members {drops} vs the whole grouped layer's {e['whole_drops']}; output "
        f"max_abs_err {max(r['e']['err'] for r in recs):.3e} of max|y| "
        f"{e['scale']:.3f} (tol 1e-5 of it); aux {e['aux']!r} vs {e['whole_aux']!r}; "
        f"{e['s'] * 1e3:.1f} ms on rank 0 | {card}")
    if drops != e["whole_drops"] or any(
            r["e"]["err"] > 1e-5 * r["e"]["scale"] for r in recs):
        raise AssertionError("(e) the members' layer is off the whole layer's")
    if any(abs(r["e"]["aux"] - r["e"]["whole_aux"]) > 1e-6 for r in recs):
        raise AssertionError("(e) the aux loss is off the whole layer's")


def sp_check_jamba(torch, recs, card):
    """(h): the jamba smoke's steps by :func:`check_tp_steps`; the Mamba
    layer with the sequence split by :func:`check_mamba_cut` against the
    unsharded layer through the plain scan."""
    h = [r["h"] for r in recs]
    log(f"[seq-par] (h) jamba smoke with its experts, GSPMD on {SEQ_PAR_SIZES} with "
        f"the sequence split, {h[0]['settings']}, B={HYBRID_ROWS} S={HYBRID_SEQ} a DP "
        f"member, {SEQ_PAR_JAMBA_STEPS} steps | {card}")
    check_tp_steps("seq-par (h)", h, card, HYBRID_ROWS * 2 * HYBRID_SEQ)
    check_mamba_cut(torch, h, SEQ_PAR_DIR, card, sp=True)


def sp_check_whisper(recs, card):
    """(i): the steps by :func:`check_tp_steps` (K1 a rank a step as
    ``expected_launches`` counts it), the encoder's and the cross
    attention's blocks split over data (FSDP) and model, the checkpoint
    restored bit for bit on every rank; the fp32 hold at 2 + 2 layers:
    step 0's loss within 1e-5 of the DFabric step without the split."""
    w, r0 = SEQ_PAR_WHISPER, recs[0]["i"]
    log(f"[seq-par] (i) whisper-medium at {w['depth']} + {w['depth']} of its 24 + 24 "
        f"layers, GSPMD (FSDP over data x TP over model) on {SEQ_PAR_SIZES} with the "
        f"sequence split, {r0['settings']}, B={w['rows']} S={r0['seq']} a DP member "
        f"over its frames, {w['steps']} steps, a checkpoint at step {w['ckpt']} | {card}")
    check_tp_steps("seq-par (i)", [r["i"] for r in recs], card, w["rows"] * 2 * r0["seq"])
    split = {k: sp for k, sp in r0["specs"].items() if "data" in sp and "model" in sp}
    if not (any(k.startswith("enc_blocks/") for k in split)
            and any("/xattn/" in k for k in split)):
        raise AssertionError(f"(i) the encoder's or the cross attention's blocks are "
                             f"not split over data and model: {r0['specs']}")
    for rank, rec in enumerate(r["i"] for r in recs):
        r = rec["restore"]
        log(f"[seq-par] (i) rank {rank}: restored step {r['step']} into a fresh model in "
            f"{r['restore_s']:.2f} s; {r['equal']} of {r['leaves']} blocks (parameters, "
            f"m, v, step) bit-equal to this rank's at step {w['ckpt']}")
        if r["step"] != w["ckpt"] or r["equal"] != r["leaves"] \
                or r["leaves"] != len(rec["ckpt_digests"]):
            raise AssertionError(f"(i) rank {rank}'s restore differs: {r}")
    (loss, gnorm, calls, _), (loss0, gnorm0, calls0, _) = r0["fp32"]
    rel = abs(loss - loss0) / abs(loss0)
    log(f"[seq-par] (i) fp32 at {w['fp32_depth']} + {w['fp32_depth']} layers, step 0: "
        f"the GSPMD step with the split {loss!r} against the DFabric step without it "
        f"{loss0!r}, rel {rel:.2e} (tol 1e-5); grad_norm {gnorm!r} vs {gnorm0!r}; the "
        f"model's collectives a rank {calls} vs {calls0}")
    if any(rec["i"]["fp32"][0][0] != loss for rec in recs) or not rel <= 1e-5:
        raise AssertionError("(i) the split GSPMD step is off the DFabric step")


def sp_check_prefill_family(torch, part, recs, card):
    """(j): K3 (rwkv6: one a layer a rank) or K4 and K1 (the jamba block: 7 and 1)
    launched on every rank, the logits (1, vocab) and finite, the
    attention cache the whole sequence; fp32 at the hold's depth: each
    recurrence's drift between the split and the unsplit prefill, layer
    by layer, then the logits and every cache leaf (the recurrent states
    the whole sequence's) within 1e-5 (rwkv6: 1e-3) of the unsplit's."""
    from repro_torch.configs import get_arch, one_card_arch
    key = f"j-{part}"
    arch = (get_arch("rwkv6-1.6b").replace(n_layers=SEQ_PAR_RWKV_PREFILL_LAYERS)
            if part == "rwkv" else one_card_arch("jamba-1.5-large-398b")[0])
    n_attn = 0 if part == "rwkv" else len(arch.attn_layer_ids())
    want = {k: 0 for k in kernel_modules()}
    want.update({"wkv6_fwd": arch.n_layers} if part == "rwkv" else
                {"mamba_scan_fwd": arch.n_layers - n_attn, "flash_attention_fwd": n_attn})
    tol = 1e-3 if part == "rwkv" else 1e-5
    j = recs[0][key]
    S = j["seq"]
    log(f"[seq-par] (j) {arch.name} prefill with the sequence split on "
        f"{SEQ_PAR_PREFILL}, B=1 S={S}, {j['layers']} layers, bf16, {j['settings']}: "
        f"launches a rank {j['launches']} (expected {want}); prefill_ms={j['ms']:.2f} "
        f"tok/s={S / j['ms'] * 1e3:.0f} peak_gb a rank="
        f"{[round(r[key]['peak_gb'], 2) for r in recs]}; cache {j['cache']} | {card}")
    for rank, rec in enumerate(r[key] for r in recs):
        seqs = [shape[2] for k, shape in rec["cache"].items() if k.endswith("/k")]
        if rec["launches"] != want or rec["shape"] != (1, arch.vocab) \
                or not rec["finite"] or any(n != S for n in seqs):
            raise AssertionError(f"(j) {part} rank {rank}: launches {rec['launches']}, "
                                 f"logits {rec['shape']} finite {rec['finite']}, "
                                 f"attention cache rows {seqs}")
    for rank, rec in enumerate(r[key] for r in recs):
        f = rec["fp32"]
        log(f"[seq-par] (j) {part} rank {rank} fp32 at {rec['hold']}: each "
            f"recurrence's output, the "
            f"split prefill's relative drift from the unsplit's, first layer to last: "
            f"{' '.join(f'{x:.2e}' for x in f['drift'])} ({f['calls']} calls); logits "
            f"max_abs_diff {f['logits']:.3e} of max {f['scale']:.3e}; cache leaves' "
            f"max_abs_diff {{{', '.join(f'{k}: {v:.2e}' for k, v in f['cache'].items())}}} "
            f"(atol = rtol = {tol})")
        if f["calls"][0] != f["calls"][1] or not f["shapes_equal"] \
                or f["logits"] > tol * (1 + f["scale"]) \
                or any(v > tol * (1 + f["scale"]) for v in f["cache"].values()):
            raise AssertionError(f"(j) {part} rank {rank}: the split prefill is off "
                                 f"the unsplit one: {f}")


def sp_check_sched(recs, card):
    """The planned dispatch with split experts over the GSPMD step's rows:
    every rank's output and aux loss bit-equal to the unscheduled layer's."""
    r0 = recs[0]["sched"]
    log(f"[seq-par] planned dispatch: one deepseek-moe-16b MoE layer fp32, "
        f"{r0['experts']} of 64 experts a model member, each DP member's row of 2 x "
        f"{S_MAIN} routed with the batch's (capacity {r0['capacity']}), a "
        f"{SEQ_PAR_SCHED['members']}-member all-to-all at chunks "
        f"{SEQ_PAR_SCHED['chunks']}, lane offset {SEQ_PAR_SCHED['lane_offset']} "
        f"({r0['slow_legs']} slow legs issued in order {r0['issue']}): output bit-equal "
        f"to the unscheduled layer on the ranks "
        f"{[r['sched']['equal'] for r in recs]}, aux "
        f"{[r['sched']['aux_equal'] for r in recs]}; {r0['s'] * 1e3:.1f} ms on rank 0 "
        f"| {card}")
    if not all(r["sched"]["equal"] and r["sched"]["aux_equal"] for r in recs):
        raise AssertionError("the scheduled dispatch is not bit-equal to the unscheduled")


def seq_par_phase(torch, card, phase_done, recs, inputs):
    """``[seq-par]``: (a)-(e) (``recs``: each rank's record,
    :func:`seq_par_runs`); every run's check runs, and the phase fails
    after them if any failed."""
    log(f"[seq-par] rank 0's seconds by run: "
        f"{ {k: round(v, 1) for k, v in recs[0]['s'].items()} } | {card}")
    tokens = inputs["a"]
    r0 = recs[0]
    failed = []

    def held(what, fn):
        try:
            fn()
        except AssertionError as e:
            log(f"[seq-par] {what} FAILED: {e}")
            failed.append(what)

    for part, what in (("a", "qwen2-0.5b train_4k seq_shard, DFabric"),
                       ("b", "qwen3-1.7b train_4k context_parallel"),
                       ("c", "qwen3-1.7b (4 layers) FSDP x TP with seq_axis")):
        log(f"[seq-par] ({part}) {what} on {SEQ_PAR_SIZES}, B=1 S={SEQ_PAR_SEQ} a DP "
            f"member, {r0[part].get('layers', SEQ_PAR_FP32_LAYERS)} layers, "
            f"{r0[part]['n_steps']} step(s): step kind "
            f"{r0[part].get('step_kind', 'gspmd')}, settings {r0[part]['settings']}")
        held(f"({part}) {what}",
             lambda part=part: sp_check_train(part, [r[part] for r in recs], card))
    phase_done("seq-par: (a) qwen2 seq_shard, (b) qwen3 context_parallel, (c) FSDP x TP")

    held("(d) qwen3-1.7b prefill_32k seq_shard",
         lambda: sp_check_prefill(torch, recs, tokens, card))
    held("(e) deepseek MoE layer, moe_groups", lambda: sp_check_moe(recs, card))
    phase_done("seq-par: (d) prefill_32k seq_shard, (e) MoE groups")

    for part, what in (("f", "deepseek-moe-16b train_4k seq_shard, DFabric"),
                       ("g", "rwkv6-1.6b train_4k seq_shard, DFabric")):
        log(f"[seq-par] ({part}) {what} on {SEQ_PAR_SIZES}, B=1 S={r0[part]['seq']} a "
            f"DP member, {r0[part]['layers']} layers, {r0[part]['n_steps']} step(s): "
            f"step kind {r0[part]['step_kind']}, settings {r0[part]['settings']}")
        held(f"({part}) {what}",
             lambda part=part: sp_check_train(part, [r[part] for r in recs], card))
    held("(h) jamba smoke and a Mamba layer, GSPMD with the split",
         lambda: sp_check_jamba(torch, recs, card))
    held("(i) whisper-medium GSPMD with the split", lambda: sp_check_whisper(recs, card))
    phase_done("seq-par: (f) deepseek, (g) rwkv6, (h) jamba, (i) whisper with the split")
    for part in ("rwkv", "jamba"):
        held(f"(j) {part} prefill with the split",
             lambda part=part: sp_check_prefill_family(torch, part, recs, card))
    held("the planned dispatch over split experts", lambda: sp_check_sched(recs, card))
    shutil.rmtree(SEQ_PAR_DIR, ignore_errors=True)
    phase_done("seq-par: (j) rwkv6 and jamba prefill with the split, planned dispatch")
    if failed:
        raise AssertionError(f"[seq-par] failed: {'; '.join(failed)}")


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit("chip_smoke.py: src/repro_torch not found beside this script; "
                 "run it from a checkout of the repository")
    sys.path.insert(0, SRC)
    # the largest models here (deepseek-moe-16b's 33.8 GB, the nemotron
    # cut's 46.5 GB, its 51.6 GB fp32 layer) are built one after another in
    # one process: growable segments keep the freed ones reusable
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: CUDA is not available; it runs on an NVIDIA GPU")

    from repro_torch.configs import get_arch, one_card_arch
    from repro_torch.kernels._build import library_path
    from repro_torch.models import ModelSettings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t_start = time.perf_counter()
    counters = kernel_modules()
    phase_t = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        log(f"[phase] {name}: {now - phase_t[0]:.1f} s")
        phase_t[0] = now

    # ---- card and build: one nvcc per kernel, all started together ---------
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(counters)) as pool:
        for fut in [pool.submit(mod.build) for mod in counters.values()]:
            fut.result()
    log(f"[build] {', '.join(counters)} built/loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, mod in counters.items():
        ptxas = library_path(name, mod.SOURCES).with_suffix(".log")
        if ptxas.exists():
            summary = ptxas_summary(ptxas.read_text(), *PTXAS_ENTRY[name])
            log(f"[build]   {name} ptxas per instantiation: {summary}")
            if name == "wkv6_fwd":
                k3_spill_check(summary)
            if name == "mamba_scan_fwd":
                k4_spill_check(summary)
    fa_lib = library_path("flash_attention_fwd", counters["flash_attention_fwd"].SOURCES)
    log(f"[build]   flash_attention_fwd SASS: {k1_sass_check(fa_lib)}")
    phase_done("build")

    # ---- qwen2-0.5b: K1 vs plain, prefill, consistency, serve --------------
    qwen = get_arch("qwen2-0.5b")
    jamba, cuts = one_card_arch("jamba-1.5-large-398b")
    deepseek, qwen3, stablelm, whisper = (get_arch(n) for n in (
        "deepseek-moe-16b", "qwen3-1.7b", "stablelm-12b", "whisper-medium"))
    nemotron, nemotron_cuts = one_card_arch("nemotron-4-340b")
    fa_results = check_flash_attention(
        torch, gen, dev, qwen, jamba,
        mains=(("main-deepseek", deepseek), ("main-qwen3", qwen3),
               ("main-stablelm", stablelm), ("main-nemotron", nemotron)),
        # K1 at the shapes of the training phases of FAMILY_RUNS
        trains=(("main-train-bf16", 2, qwen, S_MAIN, "bfloat16"),
                ("main-train-moe", 1, deepseek, S_MAIN, "bfloat16"),
                ("main-train-jamba-smoke", 2,
                 family_arch("jamba-1.5-large-398b-smoke")[0], 512, "bfloat16"),
                # whisper's decoder: its prefill, and [train-whisper]'s rows
                ("main-whisper", B_MAIN, whisper, whisper_seq(), "bfloat16"),
                ("main-train-whisper", 2, whisper, whisper_seq(), "float32"),
                # [cells]: a DP member's rows of the prefill_32k cell and
                # a microbatch of its rows of the train_4k cell
                ("main-cells-prefill", 1, qwen, 32768, "bfloat16"),
                ("main-cells-train", 8 // CELL_TRAIN_MICROBATCHES, qwen,
                 4096, "bfloat16"),
                # [examples]: the training twins' batches, fp32
                *examples_k1_cases()),
        # a model member's local heads in [train-tp] and [train-gspmd]
        locals_=(("main-train-tp-fp32", 2, qwen.n_heads // 2, qwen.n_kv_heads // 2,
                  S_MAIN, qwen.resolved_head_dim, "float32"),
                 ("main-train-gspmd-bf16", 1, qwen3.n_heads // 2,
                  qwen3.n_kv_heads // 2, S_MAIN, qwen3.resolved_head_dim,
                  "bfloat16"),
                 # [serve-mesh] (a) and [seq-par] (d): a model member's 4
                 # query heads of qwen3's prefill_32k share, the kv
                 # repeated per head
                 ("main-serve-mesh-prefill", 1, qwen3.n_heads // 4,
                  qwen3.n_heads // 4, 32768, qwen3.resolved_head_dim, "bfloat16"),
                 # [seq-par] (a): a model member's 7 heads of qwen2 on the
                 # gathered 4096-long sequence, bf16, and the fp32 hold's
                 *((f"main-seq-par-a-{dt}", 1, qwen.n_heads // 2, qwen.n_kv_heads // 2,
                    S, qwen.resolved_head_dim, dt)
                   for dt, S in (("bfloat16", SEQ_PAR_SEQ), ("float32", SEQ_PAR_FP32_SEQ))),
                 # (b): every head of qwen3 on the whole gathered sequence
                 # (the context-parallel cell's blocks are whole)
                 *((f"main-seq-par-b-{dt}", 1, qwen3.n_heads, qwen3.n_kv_heads,
                    S, qwen3.resolved_head_dim, dt)
                   for dt, S in (("bfloat16", SEQ_PAR_SEQ), ("float32", SEQ_PAR_FP32_SEQ))),
                 # (c): a model member's 8 heads of qwen3, fp32
                 ("main-seq-par-c-float32", 1, qwen3.n_heads // 2,
                  qwen3.n_kv_heads // 2, SEQ_PAR_SEQ, qwen3.resolved_head_dim,
                  "float32"),
                 # (f): a model member's 8 heads of deepseek on the gathered
                 # 4096-long sequence (its fp32 hold's is (c)'s heads over
                 # SEQ_PAR_FP32_SEQ); (i):
                 # whisper's decoder, 8 heads, 2 rows of 448; (j): the jamba
                 # block's 16 query heads at model = 4, the kv repeated per
                 # head (the cell's gqa_repeat), S=4096; (h): the jamba
                 # smoke's 2 heads and its kv head, 2 rows of 512
                 ("main-seq-par-f", 1, deepseek.n_heads // 2, deepseek.n_kv_heads // 2,
                  SEQ_PAR_SEQ, deepseek.resolved_head_dim, "bfloat16"),
                 *((f"main-seq-par-{part}-{dt}", B, a.n_heads // n,
                    a.n_kv_heads // n if part != "j" else a.n_heads // n, S,
                    a.resolved_head_dim, dt)
                   for part, a, B, n, S in (
                       ("i", whisper, SEQ_PAR_WHISPER["rows"], 2, whisper_seq()),
                       ("j", jamba, 1, 4, SEQ_PAR_JAMBA_PREFILL_SEQ))
                   for dt in ("bfloat16", "float32")),
                 ("main-seq-par-h", HYBRID_ROWS, 2, 1, HYBRID_SEQ, 16, "bfloat16")))

    model, fa_launches = prefill_checks(torch, gen, dev, qwen, attention_settings,
                                        counters, {"flash_attention_fwd": qwen.n_layers}, 3)
    # the fp32 checks on 4 of its 24 layers, built at that depth
    fp32_checks(torch, gen, dev, qwen, attention_settings, fp32_layers=4,
                full_depth=False)
    server, launches = serve(model, qwen, counters)
    log(serve_line(qwen.name, server, launches)
        + " (decode attention is plain PyTorch)")
    del model, server
    torch.cuda.empty_cache()
    phase_done("qwen2-0.5b: K1, prefill, serve")

    # ---- rwkv6-1.6b: K3 vs plain, prefill, consistency, serve --------------
    rwkv = get_arch("rwkv6-1.6b")
    wkv_results = check_wkv6(torch, gen, dev, rwkv)

    def rwkv_settings(dtype, use_kernel):
        return ModelSettings(param_dtype=dtype, compute_dtype=dtype,
                             use_kernel_ssm=use_kernel)

    # the plain recurrence is a Python loop over 2048 steps in each of 24
    # layers: one run of it.  The fp32 checks run on 4 of the 24 layers,
    # built at that depth (through all 24 random layers fp32 rounding is
    # amplified past their tolerance; the full-depth comparison beside the
    # noise floor was dropped to make room for whisper's phases)
    model, wkv_launches = prefill_checks(torch, gen, dev, rwkv, rwkv_settings,
                                         counters, {"wkv6_fwd": rwkv.n_layers}, 1)
    fp32_checks(torch, gen, dev, rwkv, rwkv_settings, fp32_layers=4,
                full_depth=False)
    server, launches = serve(model, rwkv, counters)
    if launches["wkv6_fwd"] != rwkv.n_layers * server.stats["steps"]:
        raise AssertionError(f"rwkv6 serve launched {launches} in "
                             f"{server.stats['steps']} steps, expected "
                             f"{rwkv.n_layers} wkv6_fwd a step")
    log(serve_line(rwkv.name, server, launches))
    del model, server
    torch.cuda.empty_cache()
    phase_done("rwkv6-1.6b: K3, prefill, serve")

    # ---- jamba (one-card cut): K4 vs plain, prefill, consistency, serve ----
    log(f"[jamba] {jamba.name} cut to one card: {'; '.join(cuts)}")
    ms_results = check_mamba_scan(torch, gen, dev, jamba)

    def jamba_settings(dtype, use_kernel):
        return ModelSettings(param_dtype=dtype, compute_dtype=dtype,
                             attn_impl="kernel" if use_kernel else "masked",
                             use_kernel_ssm=use_kernel)

    n_mamba = jamba.n_layers - len(jamba.attn_layer_ids())
    # the plain path runs the sequential scan, a Python loop over 2048
    # steps in each of 7 layers: one run of it
    model, jamba_launches = prefill_checks(
        torch, gen, dev, jamba, jamba_settings, counters,
        {"mamba_scan_fwd": n_mamba, "flash_attention_fwd": len(jamba.attn_layer_ids())}, 1)
    # the fp32 checks on a Mamba layer and the attention layer at every
    # width (``[serve-mesh]``'s hold)
    fp32_checks(torch, gen, dev, jamba.replace(**SERVE_MESH_JAMBA_FP32), jamba_settings)
    server, launches = serve(model, jamba, counters)
    if launches != {"flash_attention_fwd": 0, "wkv6_fwd": 0, "quantize_ef_fwd": 0,
                    "mamba_scan_fwd": n_mamba * server.stats["steps"]}:
        raise AssertionError(f"jamba serve launched {launches} in "
                             f"{server.stats['steps']} steps, expected "
                             f"{n_mamba} mamba_scan_fwd a step and nothing else")
    log(serve_line(jamba.name, server, launches)
        + " (decode attention is plain PyTorch)")
    del model, server
    torch.cuda.empty_cache()
    phase_done("jamba cut: K4, prefill, serve")

    # ---- the decoders of the MoE slice: K1 in every prefill layer ----------
    for a in (deepseek, stablelm, nemotron):
        log(f"[{a.name}] served at {SERVE_LAYERS[a.name]} of its {a.n_layers} layers")
    # deepseek-moe-16b (33.8 GB in bf16 whole); its fp32 checks build 2 layers
    decoder_path(torch, gen, dev, deepseek.replace(n_layers=SERVE_LAYERS[deepseek.name]),
                 counters, fp32_layers=2, full_depth=False)
    phase_done("deepseek-moe-16b: experts, K1 prefill, serve")
    decoder_path(torch, gen, dev, qwen3, counters)
    phase_done("qwen3-1.7b: qk-norm, K1 prefill, serve")
    # stablelm-12b (24.3 GB in bf16 whole); its fp32 checks on a 4-layer model
    decoder_path(torch, gen, dev, stablelm.replace(n_layers=SERVE_LAYERS[stablelm.name]),
                 counters, fp32_layers=4, full_depth=False)
    phase_done("stablelm-12b: K1 at hd 160, prefill, serve")
    # nemotron-4-340b cut to one card; one fp32 layer is 51.6 GB with its
    # vocab, so its checks run after the bf16 model is freed
    log(f"[nemotron] {nemotron.name} cut to one card: {'; '.join(nemotron_cuts)}")
    decoder_path(torch, gen, dev, nemotron.replace(n_layers=SERVE_LAYERS[nemotron.name]),
                 counters, fp32_layers=1, full_depth=False, fp32_last=True)
    phase_done("nemotron-4-340b cut: K1 at hd 192, prefill, serve")
    # whisper-medium whole (24 encoder + 24 decoder layers, 1.6 GB in bf16)
    # at its text context, frames (B, 1500, 1024) drawn from the seed
    decoder_path(torch, gen, dev, whisper, counters, settings=whisper_settings,
                 seq=whisper_seq())
    phase_done("whisper-medium: encoder, cross attention, K1 prefill, serve")

    # ---- K2 vs plain, then the training path on two ranks ------------------
    q_results = check_quantize(torch, gen, dev)
    torch.cuda.empty_cache()
    phase_done("K2")
    log(f"[train] card memory in use by this process before the ranks start: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    # checkpoints go under build/ in the checkout, ≈ 7.9 GB a step: (a)'s
    # step 4 stays until (b)'s restart has written its own step 4 beside
    # its step 2, so three are on disk at most
    ckpt_root = os.path.join(HERE, "build", "ckpt_smoke")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    os.makedirs(ckpt_root)
    need = int(3.15 * 4 * 494_032_768 * 4)
    free = shutil.disk_usage(ckpt_root).free
    log(f"[ckpt] free disk under {ckpt_root}: {free / 1e9:.1f} GB (need {need / 1e9:.1f})")
    if free < need:
        raise RuntimeError(f"{free} bytes free under {ckpt_root}; the "
                           f"checkpoint phase needs {need}")
    recs = run_training(ckpt_root)
    phase_done(f"train: 2 ranks x {TRAIN_STEPS} steps, checkpoints at 2 and 4 (a)")
    run_checkpoint_phase(ckpt_root, recs, card)
    shutil.rmtree(ckpt_root)
    phase_done("ckpt: crash, elastic restart, restart")

    # ---- three tiers on 8 ranks: top-k, mid int8, all-to-all, ring --------
    log(f"[train3] card memory in use by this process before the ranks start: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    train3 = run_train3(card)
    phase_done("train3: 8 ranks (2,2,2,1), top-k, mid int8, all-to-all, ring, "
               "(e) the rwkv6 smoke on model = 8")
    log(f"[train3] (e) the 8 ranks' runs: {train3[0]['e_s']:.1f} s on rank 0")
    split_heads_check([r["e"] for r in train3], split_heads_reference(torch), card)
    phase_done("train3 (e): the one-member reference and the checks")

    # ---- the four examples' twins, in one spawned process ------------------
    run_examples(card)
    phase_done("examples: quickstart, elastic_restart, ddp_train, serve_decode")

    # ---- training beyond dense fp32: bf16, experts, RWKV6, Jamba ----------
    family = family_phases(torch, gen, dev, card, phase_done)

    # ---- the cells: the dry-run, one DP member's share of four cells ------
    cells_phase(torch, gen, dev, counters, card, phase_done, family["cells-train"])

    # ---- 4 ranks on the card: tensor parallelism, the GSPMD step, serving --
    # ---- over a mesh, the sequence split and the context-parallel cell ------
    four_rank_phases(torch, card, recs, phase_done)

    # ---- kernels line, result ----------------------------------------------
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
         "launches": fa_launches["flash_attention_fwd"], **fa_results["main-bf16"]},
        {"name": "wkv6_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/wkv6/csrc/wkv6_fwd.cu",
         "replaces": "src/repro/kernels/wkv6/kernel.py:104",
         "launches": wkv_launches["wkv6_fwd"], **wkv_results["main-bf16"]},
        {"name": "mamba_scan_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_fwd.cu",
         "replaces": "src/repro/kernels/mamba_scan/kernel.py:87",
         "launches": jamba_launches["mamba_scan_fwd"], **ms_results["main-bf16"]},
        {"name": "quantize_ef_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/quantize/csrc/quantize_ef_fwd.cu",
         "replaces": "src/repro/kernels/quantize/kernel.py:53",
         "launches": recs[0]["q_total"] + train3[0]["b_q_total"],
         **q_results["sec-embed"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
