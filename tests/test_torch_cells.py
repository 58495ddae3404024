"""The cells and the dry-run (``repro_torch.launch.cells``, ``.dryrun``,
``.mesh``), the caches' shapes and specs, and ``gqa_repeat``, held
against the JAX package.

One JAX subprocess on 512 fake devices (module-scoped) builds the
reference's cells with ``build_cell`` on both two-tier production meshes
and on (pod, data, model) = (2, 2, 2), and records every stand-in (leaf
path, global shape, dtype, spec, the bytes of one device's shard), the
cells' settings, the non-default flags' cells, the caches and four cells'
``model_cost``.  The port builds the same cells on the meta device."""
import dataclasses
import json
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (jax_loss_and_grads, jax_model, jax_params,  # noqa: E402
                           port_loss_and_grads, port_model, run_jax_devices,
                           smoke_weights, to_numpy, train_batch)

from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cells import (build_cell, cell_microbatches,  # noqa: E402
                                      input_specs)
from repro_torch.launch.mesh import (make_ntier_test_mesh,  # noqa: E402
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import ModelSettings, build_model  # noqa: E402
from repro_torch.models.sharding import MeshInfo  # noqa: E402
from repro_torch.runtime.train_loop import dp_axes_of, mesh_info  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

MESHES = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True),
          "test": make_test_mesh((2, 2, 2))}
CELLS = [(a, s) for a in list_archs() for s in SHAPES
         if shape_applicable(get_arch(a), SHAPES[s])[0]]
# (arch, shape, mesh, build_cell's keyword arguments): cells the JAX
# package builds with the sequence-parallel settings (every family), the
# context-parallel cell and MoE dispatch groups under its GSPMD step
# (ROADMAP item 8)
FLAGGED = [("qwen2-0.5b", "train_4k", "test", dict(seq_shard=True)),
           ("qwen3-1.7b", "prefill_32k", "multi", dict(seq_shard=True)),
           ("nemotron-4-340b", "train_4k", "test", dict(seq_shard=True)),
           ("qwen2-0.5b", "train_4k", "test", dict(context_parallel=True)),
           ("qwen3-1.7b", "train_4k", "multi", dict(context_parallel=True)),
           ("jamba-1.5-large-398b", "train_4k", "test", dict(moe_groups=2)),
           ("deepseek-moe-16b", "train_4k", "test", dict(seq_shard=True)),
           ("rwkv6-1.6b", "train_4k", "test", dict(seq_shard=True)),
           ("jamba-1.5-large-398b", "train_4k", "test", dict(seq_shard=True)),
           ("whisper-medium", "train_4k", "test", dict(seq_shard=True)),
           ("rwkv6-1.6b", "prefill_32k", "multi", dict(seq_shard=True)),
           ("deepseek-moe-16b", "prefill_32k", "multi", dict(seq_shard=True))]
COSTS = [("qwen2-0.5b", "train_4k"), ("deepseek-moe-16b", "prefill_32k"),
         ("rwkv6-1.6b", "long_500k"), ("whisper-medium", "decode_32k")]
CACHE_SEQ = 4096

JAX_SCRIPT = r'''
import json, math, os
import numpy as np
import jax
from repro.configs import get_arch
from repro.launch.cells import build_cell, cell_settings, cell_microbatches, FSDP_ARCHS
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.roofline.analytics import model_cost
from repro.runtime.train_loop import mesh_info
from repro.utils.jax_compat import make_mesh

inp = json.loads(str(np.load(os.environ["JAX_IN"])["spec"]))
meshes = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True),
          "test": make_mesh((2, 2, 2), ("pod", "data", "model"))}


def entry(e):
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else list(e)
    return e


def spec_of(leaf):
    sp = [entry(e) for e in leaf.sharding.spec]
    return sp + [None] * (len(leaf.shape) - len(sp))


def path_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


out = {"cells": {}, "flagged": {}, "caches": {}, "costs": {}}


def record(cell, arch, mesh):
    leaves = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(cell.args)[0]:
        shard = leaf.sharding.shard_shape(leaf.shape)
        leaves.append([path_of(path), list(leaf.shape), str(leaf.dtype),
                       spec_of(leaf),
                       math.prod(shard) * np.dtype(leaf.dtype).itemsize])
    st = cell.model.settings
    dp_total = mesh_info(mesh, fsdp=arch in FSDP_ARCHS).dp_total
    return {"mode": cell.mode, "step_kind": cell.step_kind,
            "donate": list(cell.donate), "leaves": leaves,
            "settings": {f: getattr(st, f) for f in inp["fields"] if hasattr(st, f)},
            "microbatches": cell_microbatches(get_arch(arch), cell.shape, dp_total)}


for mname, mesh in meshes.items():
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for arch, shape in inp["cells"]:
        cell = build_cell(arch, shape, mesh)
        out["cells"][f"{mname}|{arch}|{shape}"] = record(cell, arch, mesh)
        if mname == "multi" and [arch, shape] in inp["costs"]:
            mc = model_cost(cell.model, cell.shape, cell.mode,
                            n_chips=int(mesh.devices.size))
            out["costs"][f"{arch}|{shape}"] = {
                k: float(mc[k]) for k in ("flops", "bytes", "model_flops",
                                          "useful_ratio", "params",
                                          "active_params")}
for arch, shape, mname, kw in inp["flagged"]:
    cell = build_cell(arch, shape, meshes[mname], **kw)
    out["flagged"][f"{mname}|{arch}|{shape}|{json.dumps(kw)}"] = record(
        cell, arch, meshes[mname])
for mname in ("multi", "test"):
    mesh = meshes[mname]
    mi = mesh_info(mesh)
    for arch in inp["archs"]:
        a = get_arch(arch)
        model = build_model(a, cell_settings(a, type("S", (), {
            "seq_len": inp["seq"], "kind": "decode"})()))
        for batch in (mi.dp_total * 2, 1):
            shapes = model.cache_shapes(batch, inp["seq"])
            specs = model.cache_specs(mi, batch, inp["seq"])
            flat = {}
            for (path, leaf), (_, sp) in zip(
                    jax.tree_util.tree_flatten_with_path(shapes)[0],
                    jax.tree_util.tree_flatten_with_path(
                        specs, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))[0]):
                spec = [entry(e) for e in sp]
                flat[path_of(path)] = [list(leaf.shape), str(leaf.dtype),
                                       spec + [None] * (len(leaf.shape) - len(spec))]
            out["caches"][f"{mname}|{arch}|{batch}"] = flat
np.savez(os.environ["JAX_OUT"], out=json.dumps(out))
'''


def _entry(e):
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else list(e)
    return e


def _spec(spec, ndim):
    sp = [_entry(e) for e in spec]
    return sp + [None] * (ndim - len(sp))


def _port_leaves(cell):
    out = []
    for i, arg in enumerate(cell.args):
        flat = tree_paths(arg) if isinstance(arg, dict) else {"": arg}
        for path, leaf in sorted(flat.items()):
            out.append([f"{i}/{path}" if path else str(i), list(leaf.shape),
                        leaf.dtype, _spec(leaf.spec, len(leaf.shape)),
                        leaf.member_bytes(cell.sizes)])
    return sorted(out)


@pytest.fixture(scope="module")
def ref():
    fields = [f.name for f in dataclasses.fields(ModelSettings)]
    spec = dict(cells=CELLS, flagged=FLAGGED, costs=[list(c) for c in COSTS],
                archs=list(list_archs()), seq=CACHE_SEQ, fields=fields)
    out = run_jax_devices(JAX_SCRIPT, {"spec": np.array(json.dumps(spec))},
                          n_devices=512, timeout=600)
    return json.loads(str(out["out"]))


def _jax_cell(ref, mname, arch, shape):
    return ref["cells"][f"{mname}|{arch}|{shape}"]


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------


def test_meshes_are_the_references():
    """The production meshes (``src/repro/launch/mesh.py:18-51``) and the
    test meshes, as {axis: size}, slowest tier first."""
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(tiers=3) == {"host": 4, "data": 4, "model": 16}
    assert make_production_mesh(multi_pod=True, tiers=3) == {
        "pod": 2, "host": 4, "data": 4, "model": 16}
    assert make_test_mesh() == {"pod": 2, "data": 2, "model": 2}
    assert make_ntier_test_mesh() == {"pod": 2, "host": 2, "data": 2}
    for sizes in (make_production_mesh(multi_pod=True),
                  make_production_mesh(multi_pod=True, tiers=3)):
        assert np.prod(list(sizes.values())) == 512


# ---------------------------------------------------------------------------
# (i) the stand-ins, (ii) the bytes a member, (iii) the cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_stand_ins_equal_jax(ref, mname):
    """Every (arch x applicable shape) cell with the default flags: mode,
    step kind, donated arguments, every leaf's path, global shape, dtype
    and spec, the settings and the microbatches equal the reference's."""
    sizes = MESHES[mname]
    dp_total = mesh_info(sizes).dp_total
    for arch, shape in CELLS:
        want = _jax_cell(ref, mname, arch, shape)
        cell = build_cell(arch, shape, sizes)
        assert next(iter(cell.model.parameters())).device.type == "meta"
        what = f"{mname} {arch} {shape}"
        assert (cell.mode, cell.step_kind, list(cell.donate)) == (
            want["mode"], want["step_kind"], want["donate"]), what
        got = [leaf[:4] for leaf in _port_leaves(cell)]
        assert got == sorted(leaf[:4] for leaf in want["leaves"]), what
        st = cell.model.settings
        assert {f: getattr(st, f) for f in want["settings"]} == {
            f: tuple(v) if isinstance(v, list) else v
            for f, v in want["settings"].items()}, what
        assert cell.microbatches == want["microbatches"] == cell_microbatches(
            cell.arch, cell.shape, dp_total), what


@pytest.mark.parametrize("mname", ["single", "multi"])
def test_member_bytes_equal_jax_shards(ref, mname, tmp_path):
    """The dry-run's argument bytes a member (by kind and in all) sum to
    the bytes of JAX's shard of every stand-in; the CLI writes one record
    a cell, spec-free (no seconds), with the collective bytes' sources."""
    for arch, shape in CELLS:
        want = sum(leaf[4] for leaf in _jax_cell(ref, mname, arch, shape)["leaves"])
        rec = dryrun.run_cell(arch, shape, multi_pod=mname == "multi")
        assert rec["ok"], rec.get("traceback")
        mem = rec["memory"]
        assert mem["argument_bytes_per_member"]["total"] == want, (arch, shape)
        assert sum(v for k, v in mem["argument_bytes_per_member"].items()
                   if k != "total") == want
        assert mem["temp_bytes"] is None and mem["temp_note"]
        coll = rec["collectives"]
        assert set(coll["bytes_per_member"]) == set(coll["sources"])
        assert "not_counted" not in coll, (arch, shape)
        assert "roofline" not in rec
        if rec["step_kind"] == "dfabric":
            axes = set(dp_axes_of(MESHES[mname]))
            assert axes <= set(coll["bytes_per_member"]), (arch, shape)
    dryrun.main(["--arch", "rwkv6-1.6b", "--mesh", "multi", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"rwkv6-1.6b__{s}__multi.json" for s in sorted(SHAPES)]


@pytest.mark.parametrize("arch,shape", COSTS)
def test_model_cost_equals_jax(ref, arch, shape):
    """``model_cost`` of a dense, a MoE, an RWKV6 and an encoder-decoder
    cell on the multi-pod mesh, and the seconds only under a named spec."""
    rec = dryrun.run_cell(arch, shape, multi_pod=True)
    want = ref["costs"][f"{arch}|{shape}"]
    for k, v in want.items():
        np.testing.assert_allclose(rec["cost"][k], v, rtol=1e-12, err_msg=k)
    priced = dryrun.run_cell(arch, shape, multi_pod=True,
                             hw=dryrun.HARDWARE["tpu-v5e"], hw_name="tpu-v5e")
    assert priced["roofline"]["hardware"].startswith("HardwareSpec() defaults")
    with pytest.raises(ValueError, match="hw_name"):
        dryrun.run_cell(arch, shape, multi_pod=True,
                        hw=dryrun.HARDWARE["tpu-v5e"])


def _ring(nbytes, n, factor=1.0):
    return factor * (n - 1) / n * nbytes


def test_collective_bytes_of_a_dense_dfabric_cell_by_hand():
    """qwen2-0.5b train_4k on (pod, data, model) = (2, 16, 16), counted by
    hand from the config.  The model axis splits the MLP's columns (4864 /
    16) and the vocabulary (151,936 / 16); 14 query heads do not divide 16,
    so attention stays whole.  The gradient sync moves each member's fp32
    gradients X: a reduce-scatter and an all-gather over data, 2 (15 / 16)
    X, and the pod all-reduce of the 1/16 left, 2 (1 / 2) X / 16.  The TP
    sums: the MLP's output in the forward, its recompute (remat "full") and
    its input's gradient, 24 x 3, plus the embedding's lookup, each a ring
    all-reduce of the (8, 4096, 896) bf16 activations; the tied head
    reduces three (8, 4096) fp32 values."""
    a = get_arch("qwen2-0.5b")
    hd, d, f, L = a.resolved_head_dim, a.d_model, a.d_ff, a.n_layers
    attn = (d * a.n_heads * hd + a.n_heads * hd * d
            + 2 * d * a.n_kv_heads * hd + (a.n_heads + 2 * a.n_kv_heads) * hd)
    whole = L * (attn + 2 * d) + d            # attention, two norms, final norm
    split = (L * 3 * d * f + a.vocab * d) // 16  # MLP, embed: a member's 1/16
    X = 4 * (whole + split)
    rows = SHAPES["train_4k"].global_batch // 32
    act = rows * 4096 * d * 2
    want = {"data": _ring(X, 16, 2.0), "pod": _ring(X / 16, 2, 2.0),
            "model": (L * 3 + 1) * _ring(act, 16, 2.0)
            + _ring(3 * rows * 4096 * 4, 16, 2.0)}
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", multi_pod=True)
    assert rec["step_kind"] == "dfabric" and rec["collectives"]["rows_per_member"] == rows
    got = rec["collectives"]["bytes_per_member"]
    assert got.keys() == want.keys()
    for axis in want:
        assert got[axis] == pytest.approx(want[axis], rel=1e-12), axis


def test_collective_bytes_of_a_sequence_split_cell_by_hand():
    """qwen2-0.5b train_4k with ``seq_shard`` on (2, 16, 16), counted by
    hand: the sync's bytes are the plain cell's; over model, the split
    MLP's sums become a gather and a reduce-scatter a forward (and in the
    recompute) and a reduce-scatter and a gather in the backward, the
    bytes of the all-reduces they replace; the whole attention (14 heads)
    gathers its input in the forward and the recompute, and the backward
    gathers its output's gradient, (15 / 16) of the (8, 4096, 896) bf16
    activations each; the embedding's reduce-scatter and the backward's
    gather; the gather before the final norm; and ln1's and ln2's
    gradients summed over model, which a member computes on its rows."""
    a = get_arch("qwen2-0.5b")
    d, L = a.d_model, a.n_layers
    rows = SHAPES["train_4k"].global_batch // 32
    act = rows * 4096 * d * 2
    unit, half = _ring(act, 16, 2.0), _ring(act, 16)
    want_model = (L * 3 * unit + L * 3 * half + half + 2 * half
                  + _ring(2 * L * d * 2, 16, 2.0)
                  + _ring(3 * rows * 4096 * 4, 16, 2.0))
    plain = dryrun.run_cell("qwen2-0.5b", "train_4k", multi_pod=True)
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", multi_pod=True, seq_shard=True)
    got, base = (r["collectives"]["bytes_per_member"] for r in (rec, plain))
    assert rec["step_kind"] == "dfabric" and got.keys() == base.keys()
    for axis in ("data", "pod"):
        assert got[axis] == base[axis]
    assert got["model"] == pytest.approx(want_model, rel=1e-12)


def test_collective_bytes_of_an_rwkv6_sequence_split_cell_by_hand():
    """rwkv6-1.6b train_4k with ``seq_shard`` on (2, 16, 16), its model
    axis counted by hand from the config.  The model axis splits the time
    mix's heads (32 / 16) and the channel mix's d_ff, and the vocabulary.
    Each mix gathers its input with ``gather_replicated`` and sums its
    input's gradient inside: the forward, its recompute and the backward
    move a sum's bytes each, and the backward all-reduces the gathered
    gradient where a dense sublayer reduce-scatters it, half a sum more; the
    time mix sums four input gradients (xr, xk, xv, xg) and its decay
    LoRA's (b, S, 64), and once a microbatch the gradients of w0, td_w2
    and its groupnorm's affine, which a member uses on its channels; the
    channel mix's gate takes a member's rows of a gathered input whose
    gradient is summed (a sum a layer) and ``cmix/wr``'s gradient is
    summed with the norms'."""
    a = get_arch("rwkv6-1.6b")
    d, L = a.d_model, a.n_layers
    lora = a.rwkv.decay_lora
    rows, S = SHAPES["train_4k"].global_batch // 32, 4096
    act = rows * S * d * 2
    unit, half = _ring(act, 16, 2.0), _ring(act, 16)
    want_model = (2 * L * 3 * unit + 2 * L * half      # the two mixes
                  + L * _ring(rows * S * (3 * d + lora) * 2, 16, 2.0)
                  + L * unit                            # the gates' inputs
                  + half + 2 * half                     # final norm, embed
                  + _ring(L * (4 * d + d * d) * 2, 16, 2.0)    # norms, wr
                  + _ring(L * (3 * d + lora * d) * 2, 16, 2.0)  # w0, td_w2, ln
                  + _ring(3 * rows * S * 4, 16, 2.0))
    rec = dryrun.run_cell("rwkv6-1.6b", "train_4k", multi_pod=True, seq_shard=True)
    assert rec["ok"] and rec["step_kind"] == "dfabric"
    assert rec["collectives"]["rows_per_member"] == rows
    got = rec["collectives"]["bytes_per_member"]["model"]
    assert got == pytest.approx(want_model, rel=1e-12)


def test_collective_bytes_of_a_moe_sequence_split_cell_by_hand():
    """deepseek-moe-16b train_4k with ``seq_shard`` on (2, 16, 16), its
    model axis by hand: attention (16 heads), the 64 routed experts and
    the shared experts split over model in each of its 28 layers, three
    passes each (remat "full"); the MoE layer gathers with
    ``gather_replicated`` (the router is replicated) and sums the tokens'
    gradient inside, an all-reduce where attention and the shared experts
    reduce-scatter, and sums the gates' (b, S, 6) fp32 gradient; the
    embedding's reduce-scatter and gather, the final norm's gather, the
    norms' gradients, the vocab-split head."""
    a = get_arch("deepseek-moe-16b")
    d, L, k = a.d_model, a.n_layers, a.moe.top_k
    rows, S = SHAPES["train_4k"].global_batch // 32, 4096
    act = rows * S * d * 2
    unit, half = _ring(act, 16, 2.0), _ring(act, 16)
    want_model = (3 * L * 3 * unit + L * half
                  + _ring(rows * S * L * k * 4, 16, 2.0)
                  + half + 2 * half
                  + _ring(L * 2 * d * 2, 16, 2.0)
                  + _ring(3 * rows * S * 4, 16, 2.0))
    rec = dryrun.run_cell("deepseek-moe-16b", "train_4k", multi_pod=True,
                          seq_shard=True)
    assert rec["ok"] and rec["collectives"]["rows_per_member"] == rows
    got = rec["collectives"]["bytes_per_member"]["model"]
    assert got == pytest.approx(want_model, rel=1e-12)


def test_collective_bytes_of_an_encoder_decoder_sequence_split_cell_by_hand():
    """whisper-medium train_4k with ``seq_shard`` on (2, 16, 16), its
    model axis by hand: each of the 24 decoder layers' attention, cross
    attention and MLP split over model (three passes each), the 24
    encoder layers' attention and MLP summing (b, 1500, d) over the
    frames, which do not split, and in the backward each cross
    attention's sum of the encoder output's gradient (b, 1500, d); the
    whole embedding's gather, the final norm's gather, and the gradients
    of ln1, ln2 and lnx, used on a member's rows."""
    a = get_arch("whisper-medium")
    d, L, F = a.d_model, a.n_layers, a.encoder.n_frames
    rows, S = SHAPES["train_4k"].global_batch // 32, 4096
    unit, half = _ring(rows * S * d * 2, 16, 2.0), _ring(rows * S * d * 2, 16)
    frame_unit = _ring(rows * F * d * 2, 16, 2.0)
    want_model = (3 * L * 3 * unit + 2 * a.encoder.n_layers * 3 * frame_unit
                  + L * frame_unit + half + half
                  + _ring(L * 6 * d * 2, 16, 2.0))
    rec = dryrun.run_cell("whisper-medium", "train_4k", multi_pod=True,
                          seq_shard=True)
    assert rec["ok"] and rec["collectives"]["rows_per_member"] == rows
    got = rec["collectives"]["bytes_per_member"]["model"]
    assert got == pytest.approx(want_model, rel=1e-12)


def test_collective_bytes_of_the_context_parallel_cell_by_hand():
    """qwen2-0.5b train_4k's context-parallel cell on (2, 16, 16), its
    model axis counted by hand: the blocks whole on every model member, so
    each attention gathers its input in the forward and the recompute and
    the backward gathers its output's gradient; the embedding's
    reduce-scatter and gather, the gather before the final norm; the
    gradients of the leaves used on a member's rows (ln1, ln2 and the
    MLP) summed over model.  The pod tier sums every leaf's block (bf16)
    over the two pods."""
    a = get_arch("qwen2-0.5b")
    hd, d, f, L, V = a.resolved_head_dim, a.d_model, a.d_ff, a.n_layers, a.vocab
    rows = SHAPES["train_4k"].global_batch // 32
    half = _ring(rows * 4096 * d * 2, 16)
    want_model = (L * 3 * half + half + 2 * half
                  + _ring(2 * L * (2 * d + 3 * d * f), 16, 2.0)
                  + _ring(3 * rows * 4096 * 4, 16, 2.0))
    attn = (d * a.n_heads * hd + a.n_heads * hd * d
            + 2 * d * a.n_kv_heads * hd + (a.n_heads + 2 * a.n_kv_heads) * hd)
    X = 2 * (L * (attn + 2 * d + 3 * d * f) + d + V * d // 16)
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", multi_pod=True,
                          context_parallel=True)
    got = rec["collectives"]["bytes_per_member"]
    assert rec["step_kind"] == "gspmd_cp" and rec["microbatches_used"] == 1
    assert got["model"] == pytest.approx(want_model, rel=1e-12)
    assert got["pod"] == pytest.approx(_ring(X, 2, 2.0), rel=1e-12)
    assert got["data"] > _ring(X, 16, 2.0)  # and the moments' parts gathered


def test_collective_bytes_of_an_fsdp_cell_by_hand():
    """nemotron-4-340b train_4k on (data, model) = (16, 16), the GSPMD step
    in 8 microbatches, counted by hand from the config.  FSDP splits every
    matrix over data and leaves the norms whole; the model axis splits the
    96 query heads, the MLP's columns and the vocabulary of the embedding
    and the head, not the 8 KV heads.  Each matrix is gathered over data
    for each use (a microbatch's forward and its recompute) and its
    gradient reduce-scattered a microbatch: 24 (15 / 16) of its gathered
    bf16 bytes; each norm's gradient is summed over data once, 2 (15 / 16)
    of it.  The TP sums: attention and MLP in each of 96 layers, three
    times (forward, recompute, input gradient), and the embedding, over a
    member's 16 rows; the untied head reduces three fp32 values."""
    a = get_arch("nemotron-4-340b")
    hd, d, f, L, V = a.resolved_head_dim, a.d_model, a.d_ff, a.n_layers, a.vocab
    matrices = L * (2 * d * a.n_heads * hd // 16 + 2 * d * a.n_kv_heads * hd
                    + 2 * d * f // 16) + 2 * V * d // 16
    norms = L * 4 * d + 2 * d                 # ln1, ln2 (scale, bias), final
    mb = 8
    rows = SHAPES["train_4k"].global_batch // 16
    act = rows * 4096 * d * 2
    want = {"data": (3 * mb) * _ring(2 * matrices, 16) + _ring(2 * norms, 16, 2.0),
            "model": (L * 2 * 3 + 1) * _ring(act, 16, 2.0)
            + _ring(3 * rows * 4096 * 4, 16, 2.0)}
    rec = dryrun.run_cell("nemotron-4-340b", "train_4k", multi_pod=False)
    assert rec["step_kind"] == "gspmd" and rec["microbatches_used"] == mb
    assert rec["collectives"]["rows_per_member"] == rows
    got = rec["collectives"]["bytes_per_member"]
    assert got.keys() == want.keys()
    for axis in want:
        assert got[axis] == pytest.approx(want[axis], rel=1e-12), axis


def test_collective_bytes_of_a_sequence_split_decode_cell_by_hand():
    """jamba long_500k on (pod, data, model) = (2, 16, 16), counted by hand
    from the config.  B = 1 does not divide the 32 DP members, so every
    member holds the row and each attention layer's 524,288-long cache
    splits over data (32,768 rows a member).  Over data: the FSDP gathers,
    once a decode step, of every matrix's blocks after the model axis's cut
    (attention's query heads, the MLP's and the experts' columns, Mamba's
    channels and the vocabulary split over model; the 8 kv heads and the
    router's 16 experts whole), 15/16 of their bf16 bytes (the router's
    fp32); and in each of
    the 9 attention layers the two-stage softmax over the 16 members of
    data, one max and two sums of (1, 4) and (1, 4, 128) fp32 values (4
    query heads a model member), each a ring all-reduce."""
    a = get_arch("jamba-1.5-large-398b")
    d, hd, H, KV, V = a.d_model, a.resolved_head_dim, a.n_heads, a.n_kv_heads, a.vocab
    f, E, di = a.d_ff, a.moe.num_experts, a.mamba.expand * a.d_model
    n_attn, n_moe = len(a.attn_layer_ids()), len(a.moe_layer_ids())
    attn = 2 * d * H * hd // 16 + 2 * d * KV * hd
    mamba = 3 * d * di // 16
    moe, mlp = 3 * E * d * f // 16, 3 * d * f // 16
    router = n_moe * d * E  # fp32
    nbytes = 2 * (n_attn * attn + (a.n_layers - n_attn) * mamba + n_moe * moe
                  + (a.n_layers - n_moe) * mlp + 2 * V * d // 16) + 4 * router
    combine = n_attn * _ring((2 * 1 * (H // 16) + 1 * (H // 16) * hd) * 4, 16, 2.0)
    assert (n_attn, n_moe, combine) == (9, 36, 35100.0)
    rec = dryrun.run_cell("jamba-1.5-large-398b", "long_500k", multi_pod=True)
    coll = rec["collectives"]
    assert rec["mode"] == "decode" and coll["rows_per_member"] == 1
    assert "not_counted" not in coll and "two-stage softmax" in coll["sources"]["data"]
    assert coll["bytes_per_member"]["data"] == pytest.approx(
        _ring(nbytes, 16) + combine, rel=1e-12)
    cell = build_cell("jamba-1.5-large-398b", "long_500k", MESHES["multi"])
    assert dryrun.split_attention_bytes(cell) == {"data": combine}
    assert dryrun.fsdp_bytes(cell)["data"] == pytest.approx(_ring(nbytes, 16),
                                                            rel=1e-12)


# ---------------------------------------------------------------------------
# (iv) the flags that reach item 8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,mname,kw", FLAGGED,
                         ids=[f"{a}-{s}-{m}-{next(iter(k))}" for a, s, m, k in FLAGGED])
def test_flags_of_item_8_raise(ref, arch, shape, mname, kw):
    """(The name is the refusal's, which these cells were until the
    sequence split, the context-parallel cell and MoE dispatch groups under
    the GSPMD step were ported.)  The port builds each cell the JAX package
    builds with these flags (on its mesh): mode, step kind, every stand-in's path,
    global shape, dtype and spec (the context-parallel cell's fp32 moments
    under ``zero_moment_specs`` included), the bytes of one member's block
    of each, the settings (``seq_axis``, ``batch_axes``, ``moe_groups``)
    and the microbatches equal the reference's; the dry-run records the
    same flags' cell on the production mesh (the single-pod one for a test
    mesh's cell) ``ok``, with the model axis's traffic among its
    collectives."""
    want = ref["flagged"][f"{mname}|{arch}|{shape}|{json.dumps(kw)}"]
    cell = build_cell(arch, shape, MESHES[mname], **kw)
    assert (cell.mode, cell.step_kind, list(cell.donate)) == (
        want["mode"], want["step_kind"], want["donate"])
    assert _port_leaves(cell) == sorted(want["leaves"])
    st = cell.model.settings
    assert {f: getattr(st, f) for f in want["settings"]} == {
        f: tuple(v) if isinstance(v, list) else v
        for f, v in want["settings"].items()}
    assert cell.microbatches == want["microbatches"]
    if "context_parallel" in kw:
        assert cell.step_kind == "gspmd_cp"
        moments = tree_paths(cell.args[1]["m"])
        assert any(m.spec != tree_paths(cell.args[0])[k].spec
                   for k, m in moments.items())
    # on its production mesh, or the single-pod one for a test-mesh cell
    rec = dryrun.run_cell(arch, shape, multi_pod=mname == "multi", **kw)
    assert rec["ok"], rec.get("traceback")
    assert rec["step_kind"] == want["step_kind"]
    assert rec["collectives"]["bytes_per_member"]["model"] > 0


# ---------------------------------------------------------------------------
# (v) the caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", ["multi", "test"])
def test_cache_shapes_and_specs_equal_jax(ref, mname):
    """Every arch's decode cache at a batch that divides the DP members
    (batch over the DP axes) and at B=1 (an attention cache's sequence
    over ``data``): shapes, dtypes, specs; built on the meta device."""
    sizes = MESHES[mname]
    mi = mesh_info(sizes)
    for arch_name in list_archs():
        arch = get_arch(arch_name)
        model = build_model(arch, dataclasses.replace(ModelSettings(), max_seq=CACHE_SEQ),
                            device="meta")
        for batch in (mi.dp_total * 2, 1):
            want = ref["caches"][f"{mname}|{arch_name}|{batch}"]
            shapes = tree_paths(model.cache_shapes(batch, CACHE_SEQ))
            specs = tree_paths(model.cache_specs(mi, batch, CACHE_SEQ))
            got = {k: [list(v.shape), str(v.dtype), _spec(specs[k], len(v.shape))]
                   for k, v in shapes.items()}
            assert got == want, (arch_name, batch)
    whisper = build_model(get_arch("whisper-medium"), ModelSettings(), device="meta")
    short = tree_paths(whisper.cache_shapes(2, 64, n_frames=10))
    assert short["l0/xk"].shape == (24, 2, 10, 16, 64)
    assert short["l0/k"].shape == (24, 2, 64, 16, 64)


def test_batch_specs_and_synthetic_batch():
    """``batch_specs`` over the DP axes and ``synthetic_batch``'s shapes,
    dtypes and ranges (the reference's, other numbers)."""
    sizes = MESHES["multi"]
    mi = mesh_info(sizes)
    model = build_model(get_arch("whisper-medium"), ModelSettings(), device="meta")
    assert model.batch_specs(mi) == {"tokens": (("pod", "data"), None),
                                     "labels": (("pod", "data"), None),
                                     "frames": (("pod", "data"), None, None)}
    assert build_model(get_arch("qwen2-0.5b"), ModelSettings(), device="meta"
                       ).batch_specs(MeshInfo({"data": 4}, dp_axes=("data",))) == {
        "tokens": ("data", None), "labels": ("data", None)}
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    smoke = build_model(get_smoke_arch("whisper-medium"), ModelSettings(),
                        device="cpu")
    batch = smoke.synthetic_batch(torch.Generator().manual_seed(0),
                                  ShapeConfig("s", 16, 3, "train"))
    arch = smoke.arch
    assert batch["tokens"].shape == batch["labels"].shape == (3, 16)
    assert batch["tokens"].dtype == torch.int32
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < arch.vocab
    assert batch["frames"].shape == (3, arch.encoder.n_frames, arch.d_model)
    assert batch["frames"].dtype == torch.bfloat16


def test_bind_checks_the_mesh_and_runs_a_serving_cell():
    """A training cell binds only to a mesh of its sizes, and so does a
    serving cell given a mesh (over a model axis too; the mesh bound by
    its members is in ``test_torch_serve_mesh.py``); without a mesh a
    decode cell runs one step of the whole model on the CPU from its
    zeroed cache."""
    cell = build_cell("qwen2-0.5b", "train_4k", MESHES["test"])
    for mesh in (None, types.SimpleNamespace(sizes={"pod": 2, "data": 1, "model": 1})):
        with pytest.raises(ValueError, match="binds to a mesh"):
            cell.bind(mesh, device="cpu")
    dec = build_cell("qwen2-0.5b", "decode_32k", MESHES["test"])
    with pytest.raises(ValueError, match="binds to a mesh"):
        dec.bind(types.SimpleNamespace(sizes={"pod": 2, "data": 1, "model": 2}),
                 device="cpu")
    bound = dec.bind(device="cpu")
    assert bound.model.settings == dec.model.settings
    cache = bound.init(1, 8)
    logits, cache = bound.run(cache, torch.tensor([[3]]), 0)
    assert logits.shape == (1, dec.arch.vocab) and torch.isfinite(logits).all()
    assert len(input_specs("qwen2-0.5b", "decode_32k", MESHES["test"])) == 4


# ---------------------------------------------------------------------------
# (vi) gqa_repeat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-1.7b", "stablelm-12b"])
def test_gqa_repeat_matches_jax(name):
    """k/v repeated per query head: prefill logits and cache, loss and
    every gradient equal JAX's with ``gqa_repeat=True`` at fp32 tolerance
    (through K1's plain version too), and the port without it."""
    w = smoke_weights(seed=11, arch=name)
    toks = np.random.default_rng(12).integers(0, 512, (2, 16)).astype(np.int32)
    jm = jax_model(arch=name, gqa_repeat=True)
    jlogits, jcache = jm.prefill(jax_params(w), jnp.asarray(toks))
    batch = train_batch(port_model(w, arch=name).arch, 13)
    jloss, jgrads = jax_loss_and_grads(jm, w, batch)
    for impl in ("masked", "kernel"):
        for repeat in (True, False):
            model = port_model(w, arch=name, attn_impl=impl, gqa_repeat=repeat)
            logits, cache = model.prefill(torch.from_numpy(toks).long())
            np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                                       atol=1e-4, rtol=1e-4)
            jflat = tree_paths(jcache)
            for path, leaf in tree_paths(cache).items():
                np.testing.assert_allclose(to_numpy(leaf), np.asarray(jflat[path]),
                                           atol=1e-4, rtol=1e-4, err_msg=path)
            loss, grads = port_loss_and_grads(model, batch)
            np.testing.assert_allclose(loss, jloss, rtol=1e-5)
            for path, g in grads.items():
                np.testing.assert_allclose(to_numpy(g), jgrads[path], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{impl} {path}")
