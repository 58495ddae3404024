"""The port's collectives with the codecs beyond the slow int8 leg, on 8
gloo ranks, held against the JAX package's on 8 fake devices: the grid of
``test_torch_collectives.py`` extended by

  * the top-k slow codec (``codec="topk"``, ``codec_k_frac`` 1/16 and 1.0)
    on the 2-tier (2, 4), 3-tier (2, 2, 2) and (4, 2) meshes, through
    ``lower_all_reduce``, ``lower_reduce_scatter`` + ``dfabric_all_gather``
    and ``pod_psum`` (top-k never chunks: ``chunks=4`` is clamped to one
    sub-flow by the schedule, in both packages);
  * the mid-tier int8 codec (``mid_codec="int8"``) on the 3-tier mesh at
    ``scatter_depth`` 1 (the host tier summed in place by a coded psum)
    and at full depth (the host tier's reduce-scatter coded), with and
    without the slow int8 codec, sequential and pipelined: the
    configurations of ``tests/batteries/schedule_battery.py`` and
    ``tests/test_ntier.py``;

and every leg log equal to the schedule's legs.

Top-k: inputs and EF states are integer-valued fp32, so every sum is exact
in any order and the outputs, EF states and gathers are held bit for bit,
the (4, 2) mesh's four-member combine included.  The indices kept are the
reference's exactly (ties to the lowest index; ``test_torch_compression``).

Mid int8: inside ``jax.jit`` XLA divides by 127 as a multiply by the
reciprocal and contracts the residual into an FMA (see
``test_torch_collectives.py``), so the sum is held to 1e-6 of the output's
range.  A quantized value that differed by one would move the sum by a
whole block scale, about 1/127 of the range, so that bound also holds the
int8 payloads equal; the slow leg's EF, where there is one, is held to
1e-4 absolute, as there.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (CODEC_MESHES, rank_codec_collectives,  # noqa: E402
                           run_jax_devices, spawn_ranks)

EF_ATOL = 1e-4
SHAPES = {(1024,): 0, (16, 64): 1}


def _topk(frac, chunks=1):
    return dict(strategy="hier_striped", chunks=chunks, codec="topk",
                codec_k_frac=frac)


def _mid(depth, codec, chunks, pipeline):
    return dict(strategy="hier_striped", chunks=chunks, codec=codec,
                codec_block=128, scatter_depth=depth, mid_codec="int8",
                pipeline=pipeline)


CASES = []  # (mesh, SyncConfig fields, op, shape, scatter dim)
for mesh in ("2tier", "3tier", "4x2"):
    for frac in (1 / 16, 1.0):
        CASES += [(mesh, _topk(frac, chunks), "all_reduce", (1024,), 0)
                  for chunks in (1, 4)]
        CASES += [(mesh, _topk(frac), op, (16, 64), 1)
                  for op in ("all_reduce", "reduce_scatter")]
        CASES.append((mesh, _topk(frac), "reduce_scatter", (1024,), 0))
    CASES.append((mesh, _topk(1 / 16), "pod_psum", (1024,), 0))
for codec in (None, "int8"):
    for chunks in (1, 2):
        CASES += [("3tier", _mid(depth, codec, chunks, pipeline), "all_reduce",
                   (1024,), 0) for depth in (1, -1) for pipeline in (False, True)]
        CASES.append(("3tier", _mid(-1, codec, chunks, False), "reduce_scatter",
                      (1024,), 0))
    CASES.append(("3tier", _mid(-1, codec, 2, True), "all_reduce", (16, 64), 1))

JAX_SCRIPT = r'''
import json, os, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import schedule
from repro.core.collectives import (dfabric_all_gather, lower_all_reduce,
                                    lower_reduce_scatter, pod_psum)
from repro.utils import jax_compat
sys.path.insert(0, os.environ["TESTS_DIR"])
from torch_harness import CODEC_MESHES, codec_schedule

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
cases = json.loads(str(z["cases"]))
xs, efs = list(z["x"]), list(z["ef"])
meshes = {n: (jax_compat.make_mesh(shape, axes), dict(zip(axes, shape)), axes, fast, slow)
          for n, (shape, axes, fast, slow) in CODEC_MESHES.items()}
res = {}
for i, case in enumerate(cases):
    mesh_name, fields, op, shape, dim = case
    mesh, sizes, axes, fast, slow = meshes[mesh_name]
    cfg, sched = codec_schedule(schedule, case, sizes)
    dp = P(axes if len(axes) > 1 else axes[0])
    has_ef = efs[i] is not None
    ef = efs[i] if has_ef else np.zeros((8, 1), np.float32)

    def f(xb, eb):
        e = eb[0] if has_ef else None
        g = None
        if op == "pod_psum":
            y, ne = pod_psum(xb[0], slow, cfg, ef=e)
        elif op == "all_reduce":
            y, ne = lower_all_reduce(sched, xb[0], ef=e)
        else:
            y, ne = lower_reduce_scatter(sched, xb[0], ef=e)
        g = y if op != "reduce_scatter" else dfabric_all_gather(y, fast, gather_dim=dim)
        ne = ne if ne is not None else eb[0]
        return y[None], ne[None], g[None]

    fn = jax.jit(jax_compat.shard_map(f, mesh=mesh, in_specs=(dp, dp),
                                      out_specs=(dp, dp, dp), check_vma=False))
    put = lambda a: jax.device_put(a, NamedSharding(mesh, dp))
    y, ne, g = (np.asarray(a) for a in fn(put(xs[i]), put(ef)))
    res[f"y{i}"], res[f"ef{i}"], res[f"g{i}"] = y, ne, g
np.savez(os.environ["JAX_OUT"], **res)
'''


def _ints(seed, shape, lo=-64, hi=64):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.float32)


def _ef(i, case):
    """The case's EF rows: integer-valued for top-k, normals for int8, the
    size of the slow leg's input; None where the slow leg has no codec."""
    mesh, fields, op, shape, dim = case
    if fields["codec"] is None:
        return None
    if op == "pod_psum":
        n = int(np.prod(shape))
    else:
        sizes = dict(zip(CODEC_MESHES[mesh][1], CODEC_MESHES[mesh][0]))
        from repro_torch.core import schedule
        from torch_harness import codec_schedule
        _, sched = codec_schedule(schedule, case, sizes)
        n = sched.numel // sched.scattered_prod
    if fields["codec"] == "topk":
        return _ints(500 + i, (8, n), -4, 5)
    return (np.random.default_rng(500 + i).standard_normal((8, n)) * 0.3
            ).astype(np.float32)


@pytest.fixture(scope="module")
def results():
    xs = [_ints(i, (8,) + shape) for i, (_, _, _, shape, _) in enumerate(CASES)]
    efs = [_ef(i, case) for i, case in enumerate(CASES)]
    os.environ["TESTS_DIR"] = os.path.dirname(os.path.abspath(__file__))
    jax_out = run_jax_devices(JAX_SCRIPT, {
        "cases": np.array(json.dumps(CASES)),
        "x": np.array(xs + [None], dtype=object)[:-1],
        "ef": np.array(efs + [None], dtype=object)[:-1]})
    port = spawn_ranks(8, rank_codec_collectives,
                       {"cases": CASES, "x": xs, "ef": efs})
    return xs, efs, jax_out, port


def _id(case):
    mesh, f, op, shape, dim = case
    codec = (f"topk{f['codec_k_frac']:g}" if f["codec"] == "topk" else
             f"mid-d{f['scatter_depth']}-{f['codec']}")
    return f"{mesh}-{codec}-c{f['chunks']}-{'pipe' if f.get('pipeline', True) else 'seq'}" \
           f"-{op}-{len(shape)}d"


@pytest.mark.parametrize("i", range(len(CASES)), ids=[_id(c) for c in CASES])
def test_codec_lowering_matches_jax(results, i):
    xs, efs, jax_out, port = results
    mesh, fields, op, shape, dim = CASES[i]
    assert all(port[r][i][3] for r in range(8)), "leg log != schedule legs"
    y = np.stack([port[r][i][0] for r in range(8)])
    g = y if op != "reduce_scatter" else np.stack([port[r][i][2] for r in range(8)])
    total = xs[i].sum(0)
    if fields["codec"] == "topk":
        np.testing.assert_array_equal(y, jax_out[f"y{i}"])
        np.testing.assert_array_equal(g, jax_out[f"g{i}"])
        ef = np.stack([port[r][i][1] for r in range(8)])
        np.testing.assert_array_equal(ef, jax_out[f"ef{i}"])
        if fields["codec_k_frac"] == 1.0:  # everything sent, nothing left
            assert not ef.any()
        else:
            assert all(np.abs(e).max() > 0 for e in ef)
        return
    rng = np.abs(total).max()
    np.testing.assert_allclose(y, jax_out[f"y{i}"], rtol=0, atol=1e-6 * rng)
    np.testing.assert_allclose(g, jax_out[f"g{i}"], rtol=0, atol=1e-6 * rng)
    # the int8 legs are lossy: off the exact sum by about a block scale
    err = np.abs(g - np.broadcast_to(total, g.shape)).max()
    assert 0 < err < 0.05 * rng, err
    if fields["codec"] == "int8":
        ef = np.stack([port[r][i][1] for r in range(8)])
        np.testing.assert_allclose(ef, jax_out[f"ef{i}"], rtol=0, atol=EF_ATOL)
        assert np.abs(ef).max() > 0.1


def test_mid_codec_reaches_the_legs():
    """Each mid case's schedule carries the codec on the leg the JAX
    package puts it on: the host psum at depth 1, the host reduce-scatter
    at full depth, never on the fastest tier."""
    from repro_torch.core import schedule
    from torch_harness import codec_schedule
    sizes = {"pod": 2, "host": 2, "data": 2}
    for case in CASES:
        if case[1].get("mid_codec") is None:
            continue
        _, sched = codec_schedule(schedule, case, sizes)
        coded = [(type(l).__name__, l.axis) for l in sched.down_legs if l.codec]
        want = "Psum" if case[1]["scatter_depth"] == 1 else "ReduceScatter"
        assert coded == [(want, "host")], (case, coded)
