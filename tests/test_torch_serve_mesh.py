"""Serving over a mesh: ``Model.prefill``, ``Model.decode_step``,
``init_cache`` and the ``DecodeServer`` with the model cut over a model
axis, an FSDP axis or both, held against the JAX package on the same
meshes.

The JAX side runs in one module-scoped subprocess on 8 fake devices: it
``jit``s ``prefill`` and ``decode_step`` with the parameters laid out by
``param_specs(mesh_info(mesh, fsdp=...))``, the tokens by ``_dp_spec`` and
the cache by ``cache_specs``, and serves with its ``DecodeServer`` on the
mesh.  The port runs one gloo rank a member (one spawn a mesh, every case
inside), each on its rows and blocks, fp32, the smoke widths, the weights
drawn with numpy and loaded through ``convert.load_jax_params``.

  * prefill of every family's smoke (qwen2, qwen3 with ``gqa_repeat``,
    deepseek with its experts over ``model``, rwkv6, jamba with its
    experts, whisper) on (data, model) = (2, 4), where the query heads
    split and the kv heads (2) stay whole, and (4, 2), where both split;
    jamba also on (pod, data, model) = (2, 2, 2) under FSDP, as its cells
    are laid out.  Each member's logits (its rows, the whole vocab) and
    its block of every cache leaf equal JAX's at fp32 tolerance;
  * 8 decode steps from that cache (qwen2, rwkv6, jamba, whisper), and
    from a zeroed cache at B = 1, which does not divide the DP members, so
    that ``cache_specs`` splits the attention cache's sequence over
    ``data`` (16 positions, 8 a member; rwkv6's states stay whole over
    it): from pos 0, where member 1's whole shard lies past ``pos``, and
    from pos 4, across the two shards.  whisper's cross cache, set to
    random values there, splits its 16 frames over ``data`` too; it also
    decodes where only one of the two splits: beside 15 positions, and
    with 15 frames beside 16 positions;
  * the ``DecodeServer`` on (2, 2) (the 4 slots split over ``data``) and
    (1, 4): 6 requests' greedy tokens equal to the JAX server's on the same
    mesh, and every member's outputs and stats equal;
  * ``Cell.bind`` of whisper-medium's decode_32k cell on the (2, 2, 2) test
    mesh by 8 ranks (the cell cut to one encoder and one decoder layer, so
    that 8 ranks' models stay near 2 GB), one decode step.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (DEEPSEEK, JAMBA, RWKV, WHISPER, port_model,  # noqa: E402
                           rank_serve_mesh, run_jax_devices, smoke_weights,
                           spawn_ranks)

from repro_torch.configs import get_arch, get_smoke_arch  # noqa: E402
from repro_torch.launch.cells import _dp_spec  # noqa: E402
from repro_torch.models import ModelSettings, build_model, sharding  # noqa: E402
from repro_torch.runtime.train_loop import mesh_info  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

QWEN2, QWEN3 = "qwen2-0.5b", "qwen3-1.7b"
TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = {"2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}
FAMILIES = [(QWEN2, {}), (QWEN3, {"gqa_repeat": True}), (DEEPSEEK, {}),
            (RWKV, {}), (JAMBA, {}), (WHISPER, {})]
B, S, MAX_SEQ, STEPS = 4, 8, 16, 8
DECODERS = (QWEN2, RWKV, JAMBA, WHISPER)
ZERO_STARTS = (0, 4)  # pos 0: member 1's shard (rows 8-15) masked throughout
N_FRAMES = get_smoke_arch(WHISPER).encoder.n_frames
SERVERS = {"2x2": (QWEN2, DEEPSEEK), "1x4": (QWEN2, JAMBA)}
CELL = {"arch": WHISPER, "shape": "decode_32k", "layers": 1, "max_seq": 8}


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _cases(mname):
    """The cases of one mesh (see the module docstring)."""
    cases = []
    if mname in ("2x4", "4x2"):
        for i, (arch, settings) in enumerate(FAMILIES):
            case = {"name": f"prefill/{arch}", "arch": arch, "settings": settings,
                    "tokens": _tokens(10 + i, (B, S))}
            if arch == WHISPER:
                case["frames"] = np.random.default_rng(30).standard_normal(
                    (B, get_smoke_arch(WHISPER).encoder.n_frames, 64)).astype(np.float32)
            if arch in DECODERS:
                case.update(decode=_tokens(20 + i, (B, STEPS)), max_seq=MAX_SEQ)
            cases.append(case)
    if mname == "2x2x2":
        cases.append({"name": f"prefill/{JAMBA}", "arch": JAMBA, "fsdp": True,
                      "tokens": _tokens(14, (B, S)), "decode": _tokens(24, (B, STEPS)),
                      "max_seq": MAX_SEQ})
    for arch, start, max_seq, nf in _zero(mname):
        case = {"name": _zero_name(arch, start, max_seq, nf), "arch": arch,
                "fsdp": mname == "2x2x2", "start": start,
                "zero": _tokens(40 + start, (1, STEPS)), "max_seq": max_seq}
        if arch == WHISPER:
            meta = build_model(get_smoke_arch(arch), ModelSettings(), device="meta")
            rng = np.random.default_rng(60 + max_seq + (nf or 0))
            case.update(n_frames=nf, xcache={
                k: rng.standard_normal(v.shape).astype(np.float32)
                for k, v in tree_paths(meta.cache_shapes(1, max_seq, nf)).items()
                if k.split("/")[-1] in ("xk", "xv")})
        cases.append(case)
    return cases


def _zero(mname):
    """The B = 1 decodes from a zeroed cache on one mesh: (arch, start,
    max_seq, n_frames or None for the config's)."""
    if mname == "2x4":
        return ([(arch, start, MAX_SEQ, None) for arch in DECODERS
                 for start in ZERO_STARTS]
                + [(WHISPER, 4, MAX_SEQ - 1, None), (WHISPER, 4, MAX_SEQ, N_FRAMES - 1)])
    if mname == "2x2x2":
        return [(JAMBA, start, MAX_SEQ, None) for start in ZERO_STARTS]
    return []


def _zero_name(arch, start, max_seq, nf):
    name = f"zero{start}/{arch}"
    return name if (max_seq, nf) == (MAX_SEQ, None) else f"{name}/seq{max_seq}-frames{nf}"


def _servers(mname):
    return [{"name": arch, "arch": arch, "slots": 4, "max_seq": 32, "max_new": 4,
             "max_steps": 40,
             "prompts": [np.array([1, 2, 3 + i], np.int32) for i in range(6)]}
            for arch in SERVERS.get(mname, ())]


JAX_SCRIPT = r'''
import json, math, os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_smoke_arch
from repro.launch.cells import _dp_spec
from repro.models import ModelSettings, build_model
from repro.runtime.serve_loop import DecodeServer, Request
from repro.runtime.train_loop import mesh_info
from repro.utils.jax_compat import make_mesh
from repro.utils.trees import tree_from_paths, tree_paths

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
spec, weights = z["spec"].item(), z["weights"].item()
res = {}


def settings(extra):
    return ModelSettings(param_dtype="float32", compute_dtype="float32",
                         max_seq=64, remat="none", **extra)


def pad(flat, max_seq):
    out = {}
    for k, v in flat.items():
        if k.split("/")[-1] in ("k", "v"):
            v = np.concatenate([v, np.zeros(v.shape[:2] + (max_seq - v.shape[2],)
                                            + v.shape[3:], v.dtype)], axis=2)
        out[k] = jnp.asarray(v)
    return tree_from_paths(out)


for mname, m in spec.items():
    sizes = m["sizes"]
    mesh = make_mesh(tuple(sizes.values()), tuple(sizes),
                     devices=jax.devices()[:math.prod(sizes.values())])

    def named(specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs)

    for case in m["cases"]:
        arch = get_smoke_arch(case["arch"])
        model = build_model(arch, settings(case.get("settings", {})))
        mi = mesh_info(mesh, fsdp=case.get("fsdp", False))
        params = jax.device_put(
            tree_from_paths({k: jnp.asarray(v) for k, v in weights[case["arch"]].items()}),
            named(model.param_specs(mi)))
        nf = case.get("n_frames") or (arch.encoder.n_frames if arch.is_encdec else None)

        def put(x, b):
            return jax.device_put(jnp.asarray(x), NamedSharding(mesh, _dp_spec(mi, x.ndim, b)))

        key = f"{mname}/{case['name']}"
        if "tokens" in case:
            toks = case["tokens"]
            b, s = toks.shape
            if "frames" in case:
                logits, cache = jax.jit(lambda p, t, f: model.prefill(p, t, frames=f))(
                    params, put(toks, b), put(case["frames"], b))
            else:
                logits, cache = jax.jit(model.prefill)(params, put(toks, b))
            res[f"{key}/logits"] = np.asarray(logits)
            flat = {k: np.asarray(v) for k, v in tree_paths(cache).items()}
            for k, v in flat.items():
                res[f"{key}/cache/{k}"] = v
            steps, start = case.get("decode"), s
            if steps is not None:
                cache = jax.device_put(pad(flat, case["max_seq"]), named(
                    model.cache_specs(mi, b, case["max_seq"], n_frames=nf)))
        else:
            steps, start = case["zero"], case["start"]
            b = steps.shape[0]
            flat = tree_paths(model.init_cache(b, case["max_seq"], n_frames=nf))
            flat.update({k: jnp.asarray(v) for k, v in case.get("xcache", {}).items()})
            cache = jax.device_put(tree_from_paths(flat),
                                   named(model.cache_specs(mi, b, case["max_seq"],
                                                           n_frames=nf)))
        if steps is not None:
            dec = jax.jit(model.decode_step)
            for t in range(steps.shape[1]):
                logits, cache = dec(params, cache, put(steps[:, t:t + 1], b),
                                    jnp.int32(start + t))
                res[f"{key}/decode/{t}"] = np.asarray(logits)
            for k, v in tree_paths(cache).items():
                res[f"{key}/final/{k}"] = np.asarray(v)
    for srv in m["servers"]:
        model = build_model(get_smoke_arch(srv["arch"]), settings({}))
        server = DecodeServer(model, mesh, batch_slots=srv["slots"],
                              max_seq=srv["max_seq"])
        for i, prompt in enumerate(srv["prompts"]):
            server.submit(Request(uid=i, prompt=prompt, max_new=srv["max_new"]))
        params = tree_from_paths({k: jnp.asarray(v)
                                  for k, v in weights[srv["arch"]].items()})
        outs = server.run(params, max_steps=srv["max_steps"])
        stats = {k: v for k, v in server.stats.items() if k != "wall"}
        res[f"{mname}/server/{srv['name']}"] = np.array(json.dumps(
            [{str(k): v for k, v in outs.items()}, stats]))
np.savez(os.environ["JAX_OUT"], **res)
'''


@pytest.fixture(scope="module")
def weights():
    return {arch: smoke_weights(seed=3, arch=arch, experts=True)
            for arch, _ in FAMILIES}


@pytest.fixture(scope="module")
def ref(weights):
    spec = {m: {"sizes": MESHES[m], "cases": _cases(m), "servers": _servers(m)}
            for m in MESHES}
    return run_jax_devices(JAX_SCRIPT, {"spec": np.array(spec, dtype=object),
                                        "weights": np.array(weights, dtype=object)})


@pytest.fixture(scope="module")
def port(weights):
    """{mesh: every rank's ``rank_serve_mesh`` record}, one spawn a mesh,
    run when a test first asks for that mesh."""
    runs = {}

    def get(mname):
        if mname not in runs:
            sizes = MESHES[mname]
            payload = {"sizes": sizes, "cases": _cases(mname),
                       "servers": _servers(mname), "weights": weights,
                       "cell": CELL if mname == "2x2x2" else None}
            runs[mname] = spawn_ranks(int(np.prod(list(sizes.values()))),
                                      rank_serve_mesh, payload, timeout=600)
        return runs[mname]
    return get


def _rows(x, mname, coords, b):
    """This member's rows of a global (b, ...) array (``_dp_spec``)."""
    sizes = MESHES[mname]
    return sharding.local_block(x, _dp_spec(mesh_info(sizes), x.ndim, b), coords, sizes)


def _check_cache(blocks, ref, key, mname, coords, arch, b, seq, fsdp=False, nf=None):
    """Every leaf of a member's cache is its block of JAX's global leaf
    under ``cache_specs`` (shape and values); ``nf``: the cross cache's
    frames, the config's when None."""
    sizes = MESHES[mname]
    model = build_model(get_smoke_arch(arch), ModelSettings(param_dtype="float32",
                                                            compute_dtype="float32"),
                        device="meta")
    nf = nf or (model.arch.encoder.n_frames if model.arch.is_encdec else None)
    specs = tree_paths(model.cache_specs(mesh_info(sizes, fsdp=fsdp), b, seq, n_frames=nf))
    assert sorted(blocks) == sorted(specs)
    for path, blk in blocks.items():
        want = ref[f"{key}/{path}"]
        assert blk.shape == sharding.local_shape(want.shape, specs[path], sizes), path
        np.testing.assert_allclose(
            blk, sharding.local_block(want, specs[path], coords, sizes), **TOL,
            err_msg=f"{key} {path} at {coords}")


PREFILL = ([(m, arch) for m in ("2x4", "4x2") for arch, _ in FAMILIES]
           + [("2x2x2", JAMBA)])


@pytest.mark.parametrize("mname,arch", PREFILL, ids=[f"{m}-{a}" for m, a in PREFILL])
def test_prefill_matches_jax(ref, port, mname, arch):
    """Each member's logits (its rows over the whole vocab, gathered over
    the model axis) and its block of every cache leaf (the heads or
    channels it holds; whole kv heads where they do not split) equal
    JAX's."""
    name = f"prefill/{arch}"
    key = f"{mname}/{name}"
    for rec in port(mname):
        got = rec["cases"][name]
        coords = rec["coords"]
        np.testing.assert_allclose(got["logits"], _rows(ref[f"{key}/logits"], mname,
                                                        coords, B), **TOL)
        _check_cache(got["cache"], ref, f"{key}/cache", mname, coords, arch, B, S,
                     fsdp=mname == "2x2x2")


DECODE = ([(m, arch) for m in ("2x4", "4x2") for arch in DECODERS]
          + [("2x2x2", JAMBA)])


@pytest.mark.parametrize("mname,arch", DECODE, ids=[f"{m}-{a}" for m, a in DECODE])
def test_decode_from_prefill_cache_matches_jax(ref, port, mname, arch):
    """8 steps from the prefill cache padded to 16 positions: every step's
    logits and the cache after them."""
    name = f"prefill/{arch}"
    key = f"{mname}/{name}"
    for rec in port(mname):
        got, coords = rec["cases"][name], rec["coords"]
        for t, logits in enumerate(got["decode"]):
            np.testing.assert_allclose(logits, _rows(ref[f"{key}/decode/{t}"], mname,
                                                     coords, B), **TOL, err_msg=f"step {t}")
        _check_cache(got["final"], ref, f"{key}/final", mname, coords, arch, B,
                     MAX_SEQ, fsdp=mname == "2x2x2")


ZERO = [(m, *z) for m in ("2x4", "2x2x2") for z in _zero(m)]


@pytest.mark.parametrize(
    "mname,arch,start,max_seq,nf", ZERO,
    ids=[f"{m}-{a}-pos{s}" + ("" if (q, f) == (MAX_SEQ, None) else f"-seq{q}-frames{f}")
         for m, a, s, q, f in ZERO])
def test_decode_on_a_sequence_split_cache_matches_jax(ref, port, mname, arch, start,
                                                      max_seq, nf):
    """B = 1 does not divide the DP members: every member holds the row,
    the attention cache's positions split over ``data`` where 2 divides
    them (8 a member of 16, the state caches whole over it: rwkv6's are
    all whole there), and so do whisper's cross-attention frames, each
    leaf by its own spec; decode attention's softmax over a split leaf is
    taken in two stages over the members, and only the member that holds
    row ``pos`` writes it.  Every step's logits equal JAX's on every
    member, and so does each member's block of the final cache (from pos 0
    member 1's block of the keys stays zero, its rows masked at every
    step)."""
    name = f"{_zero_name(arch, start, max_seq, nf)}"
    key = f"{mname}/{name}"
    recs = port(mname)
    frames = nf or N_FRAMES

    def local(n):  # the length a member holds of n positions split over data
        return n // 2 if n % 2 == 0 else n
    for rec in recs:
        got, coords = rec["cases"][name], rec["coords"]
        for t, logits in enumerate(got["decode"]):
            np.testing.assert_allclose(logits, ref[f"{key}/decode/{t}"], **TOL,
                                       err_msg=f"step {t} at {coords}")
        _check_cache(got["final"], ref, f"{key}/final", mname, coords, arch, 1,
                     max_seq, fsdp=mname == "2x2x2", nf=nf)
        for path, k in got["final"].items():  # the attention layers' keys
            if path.endswith("/k"):
                assert k.shape[2] == local(max_seq)
                if start == 0 and coords["data"] == 1:
                    assert not k.any()
            if path.endswith("/xk"):
                assert k.shape[2] == local(frames)


SERVE = [(m, arch) for m, archs in SERVERS.items() for arch in archs]


@pytest.mark.parametrize("mname,arch", SERVE, ids=[f"{m}-{a}" for m, a in SERVE])
def test_decode_server_over_a_mesh_matches_jax(ref, port, mname, arch):
    """6 requests on 4 slots: each request's greedy tokens equal the JAX
    server's on the same mesh, and every member's outputs, stats and count
    of latency records are equal."""
    jouts, jstats = json.loads(str(ref[f"{mname}/server/{arch}"]))
    recs = port(mname)
    outs, stats, records = recs[0]["servers"][arch]
    assert {str(k): v for k, v in outs.items()} == jouts
    assert stats == jstats
    assert len(set(map(tuple, outs.values()))) > 1
    for rec in recs[1:]:
        assert rec["servers"][arch] == (outs, stats, records)


def test_cell_bind_serves_on_a_mesh_of_its_sizes(port):
    """whisper-medium's decode_32k cell bound on the (2, 2, 2) test mesh by
    its 8 members: each holds its 32 of the 128 rows and its blocks of the
    cache under ``cache_specs``; one decode step gives finite logits over
    the whole vocab, equal on the two model members of each DP member."""
    import dataclasses
    recs = port("2x2x2")
    arch = get_arch(WHISPER)
    cut = arch.replace(n_layers=1, encoder=dataclasses.replace(arch.encoder, n_layers=1))
    sizes = MESHES["2x2x2"]
    model = build_model(cut, ModelSettings(), device="meta")
    shapes = tree_paths(model.cache_shapes(128, CELL["max_seq"]))
    specs = tree_paths(model.cache_specs(mesh_info(sizes), 128, CELL["max_seq"]))
    by_dp = {}
    for rec in recs:
        logits, rows, cache = rec["cell"]
        assert rows == 32 and logits.shape == (32, arch.vocab)
        assert np.isfinite(logits).all()
        assert cache == {k: sharding.local_shape(v.shape, specs[k], sizes)
                         for k, v in shapes.items()}
        c = rec["coords"]
        by_dp.setdefault((c["pod"], c["data"]), []).append(logits)
    assert len(by_dp) == 4
    for pair in by_dp.values():
        np.testing.assert_allclose(pair[0], pair[1], atol=1e-2, rtol=1e-2)


def test_a_model_cut_for_dp_only_serves_its_rows(weights):
    """A model whose layout splits no leaf (as a DP-only training step cuts
    it) serves its member's rows of the batch, as any cut model does: its
    prefill, its cache of the global batch and its decode steps are the
    uncut model's on those rows.  (A dense model needs no collective there,
    so no mesh is bound.)"""
    sizes = {"pod": 2, "data": 1, "model": 1}
    uncut, cut = port_model(weights[QWEN2]), port_model(weights[QWEN2])
    cut.shard(mesh_info(sizes), sizes, {"pod": 1, "data": 0, "model": 0})
    toks = torch.from_numpy(_tokens(50, (B, S))).long()
    mine = slice(B // 2, B)
    logits, cache = uncut.prefill(toks)
    got, got_cache = cut.prefill(toks[mine], batch=B)
    torch.testing.assert_close(got, logits[mine], **TOL)
    for path, leaf in tree_paths(got_cache).items():
        torch.testing.assert_close(leaf, tree_paths(cache)[path][:, mine], **TOL)
    whole, rows = uncut.init_cache(B, MAX_SEQ), cut.init_cache(B, MAX_SEQ)
    for path, leaf in tree_paths(rows).items():
        assert leaf.shape[1] == B // 2 and tree_paths(whole)[path].shape[1] == B
    for t in range(2):
        want, whole = uncut.decode_step(whole, toks[:, t:t + 1], t)
        got, rows = cut.decode_step(rows, toks[mine, t:t + 1], t, batch=B)
        torch.testing.assert_close(got, want[mine], **TOL)
