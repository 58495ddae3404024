"""RWKV6's time mix with its projections split over the model axis and its
heads whole on every member, held against the JAX package on the CPU.

The reference's rules split ``wr``/``wk``/``wv``/``wg`` by columns (and
``wo`` by rows) wherever d divides the model axis, but ``u`` and the
``wkv`` cache only where the head count does.  rwkv6-1.6b's smoke (4 heads
of 16, d 64) on a model axis of 8 is that layout: each member holds 8
columns, half a head.  The port gathers r, k, v and w to whole heads, runs
the recurrence and the groupnorm on every head on every member, and keeps
its columns for the affine, the gate and ``wo``.

  * loss and every leaf's gradient at (data, model) = (1, 8), with and
    without the sequence split (``seq_axis``), put together from the
    members' blocks against JAX's single-device ``value_and_grad``; ``u``,
    ``ln_scale`` and ``ln_bias``, whose gradients a double count would
    show in, on their own on every member;
  * the DFabric and the GSPMD ``Trainer`` on (pod, data, model) = (1, 1,
    8), with and without the split, 2 steps, against the JAX ``Trainer``
    on the same mesh: losses at rtol 1e-5, parameters and moments as
    ``check_tp_run`` holds them;
  * prefill on (data, model) = (1, 8), with and without the split, and 4
    decode steps from its cache, against JAX's ``jit`` of ``prefill`` and
    ``decode_step`` on the same mesh: each member's logits and cache
    blocks (the ``wkv`` state whole on every member);
  * ``cache_specs`` equal to JAX's.

One 8-rank gloo spawn; the JAX side in one subprocess on 8 fake devices.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (MAX_SEQ, RECURRENT_FAR, RWKV, TRAIN,  # noqa: E402
                           TRAIN_LOSS_CHUNK, TRAIN_SHAPE, assemble_blocks, check_tp_run,
                           rank_split_heads, redraw, run_jax_devices, spawn_ranks,
                           train_batch)

from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.models import ModelSettings, build_model, sharding  # noqa: E402
from repro_torch.runtime.train_loop import mesh_info  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

TP8 = {"data": 1, "model": 8}
MESH = {"pod": 1, "data": 1, "model": 8}
SP = dict(seq_axis="model")
SP_GSPMD = dict(seq_axis="model", batch_axes=("pod", "data"))
STEPS = 2
GRADS = {"tp8": {}, "tp8-sp": SP}
RUNS = {"dfabric": (dict(mode="dfabric"), {}), "dfabric-sp": (dict(mode="dfabric"), SP),
        "gspmd": (dict(mode="gspmd"), {}), "gspmd-sp": (dict(mode="gspmd"), SP_GSPMD)}
B, S, DECODE, DECODE_SEQ = 4, 16, 4, 24
TOKENS = np.random.default_rng(31).integers(0, 512, (B, S)).astype(np.int32)
PREFILLS = {"prefill": dict(decode=np.random.default_rng(32).integers(
                0, 512, (B, DECODE)).astype(np.int32), max_seq=DECODE_SEQ),
            "prefill-sp": dict(settings=dict(seq_axis="model", batch_axes=("data",)))}
#: the leaves each member uses whole on its columns or every head, whose
#: gradients are its part summed over the axis
WHOLE = ("tmix/u", "tmix/ln_scale", "tmix/ln_bias")
TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_serve_mesh.py's


def _weights():
    """Every leaf of the smoke tree redrawn from seed 5."""
    meta = build_model(get_smoke_arch(RWKV), ModelSettings(param_dtype="float32",
                                                           compute_dtype="float32",
                                                           max_seq=MAX_SEQ),
                       device="meta")
    return redraw(tree_paths(meta.param_shapes()), 5)


def _batch():
    return train_batch(get_smoke_arch(RWKV), seed=9, B=2, S=16)


JAX_SCRIPT = r'''
import json, os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_smoke_arch
from repro.launch.cells import _dp_spec
from repro.models import ModelSettings, build_model
from repro.runtime.train_loop import Trainer, TrainerConfig, mesh_info
from repro.utils.jax_compat import make_mesh
from repro.utils.trees import tree_from_paths, tree_paths

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
weights, batch = z["weights"].item(), z["batch"].item()
train, shp = json.loads(str(z["train"])), json.loads(str(z["shape"]))
arch = get_smoke_arch(str(z["arch"]))


class Shape:
    global_batch, seq_len = shp["global_batch"], shp["seq_len"]
    name, kind = "t", "train"


def settings(extra, **kw):
    extra = {k: tuple(v) if isinstance(v, list) else v for k, v in extra.items()}
    return ModelSettings(param_dtype="float32", compute_dtype="float32",
                         max_seq=64, remat="none", **kw, **extra)


def tree():
    return tree_from_paths({k: jnp.asarray(v) for k, v in weights.items()})


def mesh_of(sizes):
    return make_mesh(tuple(sizes.values()), tuple(sizes))


res = {}
model = build_model(arch, settings({}, loss_chunk=8))
loss, grads = jax.value_and_grad(model.loss)(tree(), {k: jnp.asarray(v)
                                                      for k, v in batch.items()})
res["grads/loss"] = np.asarray(loss)
for k, v in tree_paths(grads).items():
    res[f"grads/g/{k}"] = np.asarray(v)

for run in json.loads(str(z["runs"])):
    name, sizes, cfg = run["name"], run["sizes"], run["cfg"]
    model = build_model(arch, settings(run["settings"],
                                       loss_chunk=int(z["loss_chunk"])))
    mesh = mesh_of(sizes)
    tr = Trainer(model, mesh, Shape(), TrainerConfig(**train, **cfg))
    if cfg["mode"] == "gspmd":
        params = jax.device_put(tree(), tr.pshard)
        opt = jax.device_put(
            {"m": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
             "v": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
             "step": jnp.zeros((), jnp.int32)}, tr.oshard)
    else:
        params = jax.device_put(tree(), jax.tree.map(
            lambda s: NamedSharding(mesh, s), model.param_specs(mesh_info(mesh))))
        opt = jax.device_put(tr._init_state(), tr.state_sharding)
    with mesh:  # the sequence split's constraints name its axes
        out = tr.train(params, opt, 0)
    res[f"{name}/loss"] = np.array([m["loss"] for m in out["metrics"]])
    for k, v in tree_paths(out["params"]).items():
        res[f"{name}/p/{k}"] = np.asarray(v)
    opt = out["opt"]
    if "sections" in opt:
        for sec, entry in opt["sections"].items():
            for k, v in entry.items():
                res[f"{name}/s/{sec}/{k}"] = np.asarray(v)
    else:
        for key in ("m", "v"):
            for k, v in tree_paths(opt[key]).items():
                res[f"{name}/s/{key}/{k}"] = np.asarray(v)

tokens = z["tokens"]
b = tokens.shape[0]
for pre in z["prefill"].item().values():
    model = build_model(arch, settings(pre.get("settings", {})))
    mesh = mesh_of(pre["sizes"])
    mi = mesh_info(mesh)
    params = jax.device_put(tree(), jax.tree.map(
        lambda s: NamedSharding(mesh, s), model.param_specs(mi)))

    def put(x):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, _dp_spec(mi, x.ndim, b)))

    with mesh:
        logits, cache = jax.jit(model.prefill)(params, put(tokens))
    key = pre["name"]
    res[f"{key}/logits"] = np.asarray(logits)
    for k, v in tree_paths(cache).items():
        res[f"{key}/cache/{k}"] = np.asarray(v)
    if "decode" in pre:
        specs = model.cache_specs(mi, b, pre["max_seq"])
        res[f"{key}/cache_specs"] = np.array(json.dumps(
            {k: list(s) for k, s in tree_paths(specs).items()}))
        cache = jax.device_put(cache, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                                   specs))
        dec = jax.jit(model.decode_step)
        steps = pre["decode"]
        for t in range(steps.shape[1]):
            logits, cache = dec(params, cache, put(steps[:, t:t + 1]),
                                jnp.int32(tokens.shape[1] + t))
            res[f"{key}/decode/{t}"] = np.asarray(logits)
        for k, v in tree_paths(cache).items():
            res[f"{key}/final/{k}"] = np.asarray(v)
np.savez(os.environ["JAX_OUT"], **res)
'''


@pytest.fixture(scope="module")
def runs():
    """(the port's records {case: every rank's}, JAX's) from one 8-rank
    spawn beside the JAX subprocess."""
    weights = _weights()
    grads = [dict(kind="grads", name=n, weights=weights, batch=_batch(), arch=RWKV,
                  loss_chunk=8, sizes=TP8, settings=st) for n, st in GRADS.items()]
    trainers = [dict(kind="trainer", name=n, arch=RWKV, sizes=MESH, cfg=cfg,
                     settings=st, train=dict(steps=STEPS))
                for n, (cfg, st) in RUNS.items()]
    serve = [dict(name=n, arch=RWKV, tokens=TOKENS, **c) for n, c in PREFILLS.items()]
    inputs = {
        "weights": np.array(weights, dtype=object),
        "batch": np.array(_batch(), dtype=object),
        "arch": np.array(RWKV),
        "runs": np.array(json.dumps([dict(name=n, sizes=MESH, cfg=cfg, settings=st)
                                     for n, (cfg, st) in RUNS.items()])),
        "train": np.array(json.dumps(dict(TRAIN, steps=STEPS))),
        "shape": np.array(json.dumps(TRAIN_SHAPE)),
        "loss_chunk": np.array(TRAIN_LOSS_CHUNK),
        "tokens": TOKENS,
        "prefill": np.array({n: dict(c, name=n, sizes=TP8) for n, c in PREFILLS.items()},
                            dtype=object)}
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_jax_devices, JAX_SCRIPT, inputs)
        out = spawn_ranks(8, rank_split_heads, dict(
            train=dict(cases=grads + trainers, weights={RWKV: weights}),
            serve=dict(sizes=TP8, cases=serve, weights={RWKV: weights})), timeout=900)
        jax = job.result()
    port = {case["name"]: [r[0][i] for r in out]
            for i, case in enumerate(grads + trainers)}
    port.update({n: [(r[1]["coords"], r[1]["cases"][n]) for r in out] for n in PREFILLS})
    return port, jax


def _jax_grads(jax):
    pre = "grads/g/"
    return float(jax["grads/loss"]), {k[len(pre):]: v for k, v in jax.items()
                                      if k.startswith(pre)}


#: a gradient's tolerance against JAX's single-device one (the smoke's
#: gradients reach 0.1-1; ``grad_tolerance`` holds RWKV6's at rtol 1e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def test_layout_splits_projections_not_heads(runs):
    """Each time mix's ``wr``/``wk``/``wv``/``wg`` columns and ``wo`` rows
    split over model, ``u`` whole on every member."""
    port, _ = runs
    specs = port["tp8"][0][3]
    tmix = {k: sp for k, sp in specs.items() if "/tmix/" in k}
    assert tmix
    for k, sp in tmix.items():
        name = k.rsplit("/", 1)[1]
        if name in ("wr", "wk", "wv", "wg"):
            assert sp[-1] == "model", k
        elif name == "wo":
            assert sp[-2] == "model", k
        else:
            assert "model" not in sp, k


@pytest.mark.parametrize("name", list(GRADS))
def test_loss_and_grads_match_jax(runs, name):
    """Each member's loss within rtol 1e-5 of JAX's single-device loss;
    every leaf's gradient, put together from the members' blocks (two
    members' blocks of a leaf held alike bit-equal), within ``GRAD_TOL``
    of JAX's."""
    port, jax = runs
    out = port[name]
    jloss, jgrads = _jax_grads(jax)
    for loss, *_ in out:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads = assemble_blocks([(g, c, s) for _, g, c, s, _ in out],
                            {k: v.shape for k, v in jgrads.items()}, TP8, name)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("name", list(GRADS))
def test_whole_leaves_counted_once(runs, name):
    """``u`` (every head, on every member), ``ln_scale`` and ``ln_bias``
    (the members' columns of the affine): each member's gradient is the
    whole of JAX's, once (a member's part, or the sum counted twice, would
    be off by a factor)."""
    port, jax = runs
    _, jgrads = _jax_grads(jax)
    keys = [k for k in jgrads if k.endswith(WHOLE)]
    assert len(keys) == len(WHOLE)  # each stacked over the layers
    for _, g, _, specs, _ in port[name]:
        for k in keys:
            assert "model" not in specs[k], k
            np.testing.assert_allclose(g[k], jgrads[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_jax(runs, name):
    """The port's ``Trainer`` on (1, 1, 8) against the JAX ``Trainer`` with
    the same mode and settings: the losses at rtol 1e-5, then
    ``check_tp_run`` (parameters, moments, blocks two members hold alike
    bit-equal)."""
    port, jax = runs
    cfg, _ = RUNS[name]
    recs = port[name]
    np.testing.assert_allclose(recs[0]["losses"], jax[f"{name}/loss"], rtol=1e-5)
    check_tp_run(name, recs, jax, MESH, cfg, steps=STEPS, far_share=RECURRENT_FAR,
                 arch=RWKV)
    specs = recs[0]["specs"]
    assert any(k.endswith("tmix/wr") and "model" in sp for k, sp in specs.items())
    assert all("model" not in sp for k, sp in specs.items() if k.endswith("tmix/u"))


def _cache_specs(max_seq):
    model = build_model(get_smoke_arch(RWKV), ModelSettings(), device="meta")
    shapes = {k: v.shape for k, v in tree_paths(model.cache_shapes(B, max_seq)).items()}
    return sharding.cache_specs(model.arch, shapes, mesh_info(TP8), B)


def test_cache_specs_match_jax(runs):
    """The cache's specs on (1, 8) equal JAX's ``cache_specs``: the
    ``wkv`` state (4 heads) whole over the 8 model members."""
    _, jax = runs
    want = json.loads(str(jax["prefill/cache_specs"]))
    got = _cache_specs(DECODE_SEQ)
    assert sorted(got) == sorted(want)
    for k, sp in got.items():
        assert tuple(sp) == tuple(want[k]) + (None,) * (len(sp) - len(want[k])), k
    assert all("model" not in sp for k, sp in got.items() if k.endswith("wkv"))


def _check_blocks(blocks, jax, key, coords, max_seq):
    specs = _cache_specs(max_seq)
    assert sorted(blocks) == sorted(specs)
    for path, blk in blocks.items():
        want = sharding.local_block(jax[f"{key}/{path}"], specs[path], coords, TP8)
        assert blk.shape == want.shape, path
        np.testing.assert_allclose(blk, want, err_msg=f"{key} {path}", **TOL)


@pytest.mark.parametrize("name", list(PREFILLS))
def test_prefill_and_decode_match_jax(runs, name):
    """Each member's prefill logits and cache blocks against JAX's ``jit``
    of ``prefill`` on (1, 8) (with the split: the states are the whole
    sequence's); without the split, 4 decode steps from that cache: every
    step's logits and the final cache; the ``wkv`` state alike on every
    member."""
    port, jax = runs
    recs = port[name]
    for coords, rec in recs:
        np.testing.assert_allclose(rec["logits"], jax[f"{name}/logits"], **TOL)
        _check_blocks(rec["cache"], jax, f"{name}/cache", coords, S)
        if "decode" in PREFILLS[name]:
            assert len(rec["decode"]) == DECODE
            for t, logits in enumerate(rec["decode"]):
                np.testing.assert_allclose(logits, jax[f"{name}/decode/{t}"],
                                           err_msg=f"step {t}", **TOL)
            _check_blocks(rec["final"], jax, f"{name}/final", coords, DECODE_SEQ)
    for key in ("cache", "final") if "decode" in PREFILLS[name] else ("cache",):
        states = [rec[key] for _, rec in recs]
        for path in states[0]:
            if path.endswith("wkv"):
                for other in states[1:]:
                    np.testing.assert_array_equal(other[path], states[0][path])
