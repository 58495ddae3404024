"""The port's collectives (``repro_torch.core.{prims,collectives}``) on 8
gloo ranks, held against the JAX package's on 8 fake devices: the grid of
``tests/batteries/schedule_battery.py`` — 1, 2 and 3 tiers x chunks
1/2/4 x codec none/int8 x sequential/pipelined — through
``lower_all_reduce``, and ``lower_reduce_scatter`` followed by
``dfabric_all_gather``, on a flat input (scatter dim 0) and a 2-D one
(scatter dim 1); and ``pod_psum``, the bare slow leg.

Inputs are integer-valued fp32, so every exact leg sums exactly in any
order and the outputs are compared bit for bit.  An int8 leg quantizes the
same fast-tier-reduced shard on both sides, but inside ``jax.jit`` XLA on
the CPU contracts the residual ``x - q*scale`` into an FMA (and may divide
by 127 as a multiply by the reciprocal), which the port, like the JAX
codec run op by op, does not: ``test_torch_quantize.py`` holds the codec
bit for bit to the eager JAX codec.  Here the EF residual is held per rank
to 1e-4 absolute: those roundings move it by at most ~2.5e-5 of the block
scale, and the scale is at most ~4.1 with these inputs, while a q that
differed by one would move it by a whole scale, so q is held equal too.
The int8 sum is held to 1e-6 of the output's range.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (COLLECTIVE_MESHES, rank_collectives,  # noqa: E402
                           run_jax_devices, spawn_ranks)

SHAPES = {(1024,): 0, (16, 64): 1}
EF_ATOL = 1e-4
CASES = [(mesh, chunks, codec, pipeline, "all_reduce", shape, dim)
         for mesh in COLLECTIVE_MESHES for chunks in (1, 2, 4)
         for codec in (None, "int8") for pipeline in (False, True)
         for shape, dim in SHAPES.items()
         if dim == 0 or (chunks == 2 and pipeline)]
CASES += [(mesh, chunks, codec, False, "reduce_scatter", shape, dim)
          for mesh in COLLECTIVE_MESHES for chunks in (1, 2, 4)
          for codec in (None, "int8") for shape, dim in SHAPES.items()
          if dim == 0 or chunks == 2]
CASES += [(mesh, chunks, codec, False, "pod_psum", (1024,), 0)
          for mesh in ("2tier", "3tier") for chunks in (1, 4)
          for codec in (None, "int8")]

JAX_SCRIPT = r'''
import json, os
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import schedule
from repro.core.collectives import (dfabric_all_gather, lower_all_reduce,
                                    lower_reduce_scatter, pod_psum)
from repro.utils import jax_compat
import sys
sys.path.insert(0, os.environ["TESTS_DIR"])
from torch_harness import COLLECTIVE_MESHES, collective_cfg, collective_schedule

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
cases = json.loads(str(z["cases"]))
xs, efs = z["x"].item(), z["ef"].item()
meshes = {n: (jax_compat.make_mesh(shape, axes), dict(zip(axes, shape)), axes, fast)
          for n, (shape, axes, fast, _) in COLLECTIVE_MESHES.items()}
res = {}
for i, case in enumerate(cases):
    mesh_name, chunks, codec, pipeline, op, shape, dim = case
    shape = tuple(shape)
    case = (mesh_name, chunks, codec, pipeline, op, shape, dim)
    mesh, sizes, axes, fast = meshes[mesh_name]
    sched = collective_schedule(schedule, case, sizes)
    dp = P(axes if len(axes) > 1 else axes[0])
    x = xs[str(shape)]
    ef_key = mesh_name + ("/full" if op == "pod_psum" else "")
    ef = efs[str(shape)][ef_key] if codec else np.zeros((8, 1), np.float32)

    def f(xb, eb):
        e = eb[0] if codec else None
        if op == "pod_psum":
            y, ne = pod_psum(xb[0], COLLECTIVE_MESHES[mesh_name][3],
                             collective_cfg(schedule, case), ef=e)
            g = y
        elif op == "all_reduce":
            y, ne = lower_all_reduce(sched, xb[0], ef=e)
            g = y
        else:
            y, ne = lower_reduce_scatter(sched, xb[0], ef=e)
            g = dfabric_all_gather(y, fast, gather_dim=dim)
        ne = ne if ne is not None else eb[0]
        return y[None], ne[None], g[None]

    fn = jax.jit(jax_compat.shard_map(f, mesh=mesh, in_specs=(dp, dp),
                                      out_specs=(dp, dp, dp), check_vma=False))
    put = lambda a: jax.device_put(a, NamedSharding(mesh, dp))
    y, ne, g = (np.asarray(a) for a in fn(put(x), put(ef)))
    res[f"y{i}"], res[f"ef{i}"], res[f"g{i}"] = y, ne, g
np.savez(os.environ["JAX_OUT"], **res)
'''


def _ints(seed, shape):
    return np.random.default_rng(seed).integers(-64, 64, size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import os
    xs = {str(s): _ints(i, (8,) + s) for i, s in enumerate(SHAPES)}
    efs = {}
    for i, shape in enumerate(SHAPES):
        efs[str(shape)] = {}
        for name, (_, _, fast, _) in COLLECTIVE_MESHES.items():
            n_fast = int(np.prod([dict(zip(COLLECTIVE_MESHES[name][1],
                                           COLLECTIVE_MESHES[name][0]))[a]
                                  for a in fast]))
            n = int(np.prod(shape)) // n_fast
            efs[str(shape)][name] = (np.random.default_rng(100 + i).standard_normal(
                (8, n)) * 0.3).astype(np.float32)
            efs[str(shape)][name + "/full"] = (np.random.default_rng(200 + i).standard_normal(
                (8,) + shape) * 0.3).astype(np.float32)
    inputs = {"cases": np.array(json.dumps(CASES)),
              "x": np.array(xs, dtype=object), "ef": np.array(efs, dtype=object)}
    os.environ["TESTS_DIR"] = os.path.dirname(os.path.abspath(__file__))
    jax_out = run_jax_devices(JAX_SCRIPT, inputs)
    port = spawn_ranks(8, rank_collectives, {"cases": CASES, "x": xs, "ef": efs})
    return xs, jax_out, port


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c[:5])) + f"-{len(c[5])}d"
                              for c in CASES])
def test_lowering_matches_jax(results, i):
    xs, jax_out, port = results
    mesh, chunks, codec, pipeline, op, shape, dim = CASES[i]
    y = np.stack([port[r][i][0] for r in range(8)])
    jy = jax_out[f"y{i}"]
    assert all(port[r][i][3] for r in range(8)), "leg log != schedule legs"
    total = xs[str(shape)].sum(0)
    if op == "reduce_scatter":
        g = np.stack([port[r][i][2] for r in range(8)])
        if codec is None:
            np.testing.assert_array_equal(g, jax_out[f"g{i}"])
            np.testing.assert_array_equal(g, np.broadcast_to(total, g.shape))
        else:
            np.testing.assert_allclose(g, jax_out[f"g{i}"], rtol=0,
                                       atol=1e-6 * np.abs(total).max())
    if codec is None or COLLECTIVE_MESHES[mesh][3] is None:
        np.testing.assert_array_equal(y, jy)
        if op == "pod_psum":  # the sum over the slow axis only
            n_slow = COLLECTIVE_MESHES[mesh][0][0]
            rows = xs[str(shape)].reshape(n_slow, -1, *shape)
            np.testing.assert_array_equal(
                y, np.broadcast_to(rows.sum(0)[None], rows.shape).reshape(y.shape))
        elif op == "all_reduce":
            np.testing.assert_array_equal(y, np.broadcast_to(total, y.shape))
    else:
        np.testing.assert_allclose(y, jy, rtol=0, atol=1e-6 * np.abs(total).max())
        ef = np.stack([port[r][i][1] for r in range(8)])
        np.testing.assert_allclose(ef, jax_out[f"ef{i}"], rtol=0, atol=EF_ATOL)
        assert np.abs(ef).max() > 0.1
