"""The port's hierarchical all-to-all (``lower_all_to_all``,
``dfabric_all_to_all``) and ring all-reduce (``ring_all_reduce`` on
``prims.ppermute``) on 8 gloo ranks, held against the JAX package's on 8
fake devices.

All-to-all: ``tests/batteries/alltoall_battery.py``'s four meshes ((8,),
(2, 4), (4, 2), (2, 2, 2)) x slow-leg chunks 1/2/4 x every lane offset,
the skewed (``dest_sizes``) schedules and the schedule built in place.  An
all-to-all is a permutation of the payload, so each output is held bit for
bit to the JAX lowering of the same schedule and to one flat all-to-all
over the world (``dist.all_to_all_single`` here, ``lax.all_to_all`` over
every axis there).  The legs each lowering logs equal the schedule's legs
and the legs ``CostModel.from_schedule`` prices, and the port's schedules
equal the JAX package's (``to_json``).

Ring: the ``collectives_battery.py`` case (ring over "data" inside each
pod of a (2, 2, 2) mesh) and an 8-member ring.  On integer-valued fp32 it
is held bit for bit to the JAX ring and to ``prims.psum``; on normals to
the JAX ring bit for bit (the same adds in the same order: each step adds
the received chunk to the held one) and to the exact sum at the battery's
``rtol=1e-5, atol=1e-4``.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (ALLTOALL_MESHES, RING_CASES,  # noqa: E402
                           alltoall_schedules, rank_alltoall, rank_ring,
                           run_jax_devices, spawn_ranks)

from repro_torch.core import schedule as port_schedule  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.core.topology import (TwoTierTopology, as_fabric,  # noqa: E402
                                       fabric_from_mesh_sizes, three_tier_fabric)

SHAPE = (8, 8, 3)  # 8 ranks x 8 destination rows of 3
SKEW = [24.0] + [float(w) for w in np.random.default_rng(11).uniform(0, 8, 7)]
N_RING = 4096

A2A_JAX_SCRIPT = r'''
import json, os, sys
import jax, numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import schedule
from repro.core.collectives import dfabric_all_to_all, lower_all_to_all
from repro.utils import jax_compat
sys.path.insert(0, os.environ["TESTS_DIR"])
from torch_harness import ALLTOALL_MESHES, alltoall_schedules

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
x, skew = z["x"], [float(w) for w in z["skew"]]
res = {}
for name, (dims, axes, fast, slow) in ALLTOALL_MESHES.items():
    mesh = jax_compat.make_mesh(dims, axes)
    spec = P(axes, None, None)
    xx = jax.device_put(x, NamedSharding(mesh, spec))

    def run(f):
        g = jax.jit(jax_compat.shard_map(lambda xl: f(xl[0])[None], mesh=mesh,
                                         in_specs=spec, out_specs=spec,
                                         check_vma=False))
        return np.asarray(g(xx))

    res[f"{name}/flat"] = run(lambda v: lax.all_to_all(v, axes, 0, 0, tiled=True))
    for (c, off), s in alltoall_schedules(schedule, name, x.shape[1:]).items():
        res[f"{name}/{c}/{off}"] = run(lambda v: lower_all_to_all(s, v))
        res[f"{name}/{c}/{off}/json"] = np.array(s.to_json())
    for (c, off), s in alltoall_schedules(schedule, name, x.shape[1:], skew).items():
        res[f"{name}/skew/{c}/{off}"] = run(lambda v: lower_all_to_all(s, v))
    for c in (1, 2, 4):
        res[f"{name}/in_place/{c}"] = run(
            lambda v: dfabric_all_to_all(v, fast, slow, schedule.SyncConfig(chunks=c)))
np.savez(os.environ["JAX_OUT"], **res)
'''

RING_JAX_SCRIPT = r'''
import os, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.collectives import ring_all_reduce
from repro.utils import jax_compat
sys.path.insert(0, os.environ["TESTS_DIR"])
from torch_harness import RING_CASES

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
res = {}
for case, (sizes, axis) in RING_CASES.items():
    axes = tuple(sizes)
    mesh = jax_compat.make_mesh(tuple(sizes.values()), axes)
    spec = P(axes, None)
    g = jax.jit(jax_compat.shard_map(
        lambda xl: ring_all_reduce(xl[0], axis, sizes[axis])[None], mesh=mesh,
        in_specs=spec, out_specs=spec, check_vma=False))
    for kind in ("ints", "normal"):
        x = z[f"{case}/{kind}"]
        res[f"{case}/{kind}"] = np.asarray(g(jax.device_put(x, NamedSharding(mesh, spec))))
np.savez(os.environ["JAX_OUT"], **res)
'''


@pytest.fixture(scope="module")
def a2a():
    # rank r's payload: 8 destination rows of 3 (the battery's xa)
    x = np.random.default_rng(11).standard_normal(SHAPE).astype(np.float32)
    os.environ["TESTS_DIR"] = os.path.dirname(os.path.abspath(__file__))
    jax_out = run_jax_devices(A2A_JAX_SCRIPT, {"x": x, "skew": np.array(SKEW)})
    port = spawn_ranks(8, rank_alltoall, {"x": x, "skew": SKEW})
    return x, jax_out, port


def _stack(port, mesh, key, part=None):
    rows = [port[r][mesh][key] for r in range(8)]
    return np.stack([row if part is None else row[part] for row in rows])


@pytest.mark.parametrize("mesh", list(ALLTOALL_MESHES))
def test_flat_all_to_all_matches_jax(a2a, mesh):
    x, jax_out, port = a2a
    flat = _stack(port, mesh, "flat")
    np.testing.assert_array_equal(flat, jax_out[f"{mesh}/flat"])
    # row d of rank s lands as row s of rank d
    np.testing.assert_array_equal(flat, x.transpose(1, 0, 2))


A2A_CASES = [(mesh, c, off) for mesh in ALLTOALL_MESHES
             for (c, off) in alltoall_schedules(port_schedule, mesh, SHAPE[1:])]


@pytest.mark.parametrize("mesh,chunks,off", A2A_CASES,
                         ids=[f"{m}-c{c}-off{o}" for m, c, o in A2A_CASES])
def test_lower_all_to_all_matches_jax(a2a, mesh, chunks, off):
    x, jax_out, port = a2a
    out = _stack(port, mesh, (chunks, off), 0)
    np.testing.assert_array_equal(out, jax_out[f"{mesh}/{chunks}/{off}"])
    np.testing.assert_array_equal(out, jax_out[f"{mesh}/flat"])
    s = alltoall_schedules(port_schedule, mesh, SHAPE[1:])[(chunks, off)]
    assert s.to_json() == str(jax_out[f"{mesh}/{chunks}/{off}/json"])
    fab = {"8": fabric_from_mesh_sizes({"data": 8}),
           "2x4": as_fabric(TwoTierTopology(num_pods=2, pod_shape=(4,))),
           "4x2": as_fabric(TwoTierTopology(num_pods=4, pod_shape=(2,))),
           "2x2x2": three_tier_fabric(num_pods=2, hosts_per_pod=2,
                                      chips_per_host=2)}[mesh]
    priced = [lc.leg for lc in CostModel(fab).from_schedule(s).leg_charges]
    for r in range(8):
        assert port[r][mesh][(chunks, off)][1] == list(s.legs) == priced


@pytest.mark.parametrize("mesh", list(ALLTOALL_MESHES))
def test_skewed_and_in_place_all_to_all(a2a, mesh):
    """The skewed schedules (a wire annotation only) and the schedule built
    in place lower bit for bit as the flat all-to-all, in both packages."""
    x, jax_out, port = a2a
    flat = jax_out[f"{mesh}/flat"]
    for (c, off) in alltoall_schedules(port_schedule, mesh, SHAPE[1:], SKEW):
        out = _stack(port, mesh, ("skew", c, off))
        np.testing.assert_array_equal(out, jax_out[f"{mesh}/skew/{c}/{off}"])
        np.testing.assert_array_equal(out, flat)
    for c in (1, 2, 4):
        out = _stack(port, mesh, ("in_place", c))
        np.testing.assert_array_equal(out, jax_out[f"{mesh}/in_place/{c}"])
        np.testing.assert_array_equal(out, flat)


def _ring_rows(case, base):
    """Each rank's row: the battery feeds pod x data members 4 rows,
    replicated over the model axis; the 8-member ring one row a rank."""
    if case == "battery":
        return np.stack([base[(r // 4) * 2 + (r // 2) % 2] for r in range(8)])
    return base


@pytest.fixture(scope="module")
def ring():
    rng = np.random.default_rng(0)
    payload = {}
    for case in RING_CASES:
        n_rows = 4 if case == "battery" else 8
        payload[case] = {
            "ints": _ring_rows(case, rng.integers(-512, 512, (n_rows, N_RING)
                                                  ).astype(np.float32)),
            "normal": _ring_rows(case, rng.standard_normal((n_rows, N_RING)
                                                           ).astype(np.float32))}
    os.environ["TESTS_DIR"] = os.path.dirname(os.path.abspath(__file__))
    jax_out = run_jax_devices(RING_JAX_SCRIPT, {
        f"{case}/{kind}": v for case, d in payload.items() for kind, v in d.items()})
    port = spawn_ranks(8, rank_ring, payload)
    return payload, jax_out, port


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("kind", ["ints", "normal"])
def test_ring_all_reduce_matches_jax(ring, case, kind):
    payload, jax_out, port = ring
    got = np.stack([port[r][(case, kind)][0] for r in range(8)])
    psum = np.stack([port[r][(case, kind)][1] for r in range(8)])
    np.testing.assert_array_equal(got, jax_out[f"{case}/{kind}"])
    x = payload[case][kind]
    if case == "battery":  # the sum over data inside each pod
        want = np.stack([x[(r // 4) * 4 + (r % 2)] + x[(r // 4) * 4 + 2 + (r % 2)]
                         for r in range(8)])
    else:
        want = np.broadcast_to(x.sum(0, dtype=np.float64).astype(np.float32), x.shape)
    if kind == "ints":
        np.testing.assert_array_equal(got, psum)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(psum, want, rtol=1e-5, atol=1e-4)
