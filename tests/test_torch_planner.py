"""The port's copies of the framework-free planner stack
(``repro_torch.core.{mempool,topology,nicpool,schedule,cost_model,planner}``),
of ``data/pipeline.py`` and of the simulators and their audit stack
(``obs/{plan_report,trace,audit,capture}``, ``sim``, ``serve_sim``), held
against the JAX package's originals: the same sync plan, JSON for JSON, for
qwen2-0.5b on every mesh the training tests run, and the same source where
the copy is verbatim."""
import ast
import os
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import get_smoke_arch as jax_smoke_arch  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import ModelSettings as JaxSettings  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.core.topology import topology_from_mesh_sizes as jax_topology  # noqa: E402
from repro.runtime.train_loop import make_sync_plan as jax_make_sync_plan  # noqa: E402
from repro_torch.configs import get_arch, get_smoke_arch  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.cost_model import dtype_itemsize  # noqa: E402
from repro_torch.core.topology import topology_from_mesh_sizes  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import ModelSettings, build_model  # noqa: E402
from repro_torch.models.registry import numpy_dtype_name  # noqa: E402
from repro_torch.runtime.train_loop import make_sync_plan  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESHES = {"2,1,1": ((2, 1, 1), ("pod", "data", "model")),
          "2,4,1": ((2, 4, 1), ("pod", "data", "model")),
          "1,8,1": ((1, 8, 1), ("pod", "data", "model")),
          "2,2,2,1": ((2, 2, 2, 1), ("pod", "host", "data", "model"))}


def _fake_mesh(shape, axes):
    """What the JAX ``make_sync_plan`` reads of a mesh: its axis names and
    the shape of its device array (no devices needed)."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("smoke", [False, True])
def test_sync_plan_json_matches_jax(smoke, mesh, codec):
    shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    jarch = jax_smoke_arch("qwen2-0.5b") if smoke else jax_get_arch("qwen2-0.5b")
    arch = get_smoke_arch("qwen2-0.5b") if smoke else get_arch("qwen2-0.5b")
    jmodel = jax_build_model(jarch, JaxSettings(param_dtype="float32",
                                                compute_dtype="float32"))
    # the meta device: shapes only, no memory
    model = build_model(arch, ModelSettings(param_dtype="float32",
                                            compute_dtype="float32"),
                        device="meta")
    jplan, jss = jax_make_sync_plan(jmodel, _fake_mesh(shape, axes),
                                    jax_topology(sizes), codec=codec)
    plan, ss = make_sync_plan(model, sizes, topology_from_mesh_sizes(sizes),
                              codec=codec)
    assert plan.to_json() == jplan.to_json()
    assert plan.describe() == jplan.describe()
    assert plan.est_total_s == jplan.est_total_s
    assert ss == type(ss)(**vars(jss))
    if not smoke and mesh == "2,1,1" and codec == "int8":
        # the training path on the card: 9 sections, one int8 slow chunk
        # each, 494,032,768 elements
        assert len(plan.sections) == 9
        assert sum(s.numel for s in plan.sections) == 494_032_768
        assert all(s.sync.strategy == "hier_striped" and s.sync.codec == "int8"
                   and s.schedule.chunks == 1 for s in plan.sections)


def test_dtype_names_price_as_numpy():
    """The planner copy is handed numpy dtype names, never torch dtypes
    (``str(torch.bfloat16)`` would price at 4 bytes)."""
    assert numpy_dtype_name(torch.bfloat16) == "bfloat16"
    assert numpy_dtype_name(torch.float32) == "float32"
    assert dtype_itemsize(str(torch.bfloat16)) == 4  # the hazard itself
    sd = planner.ShapeDtype((3, 4), numpy_dtype_name(torch.bfloat16))
    assert sd.dtype.itemsize == 2 and str(sd.dtype) == "bfloat16"
    sec = planner.Section("w", ("w",), 12, "bfloat16", 0)
    assert sec.nbytes == 24
    # the candidate report (obs/plan_report, now copied) prices the leaf
    # as the JAX planner does a bf16 jax.ShapeDtypeStruct
    import jax
    from repro.core.planner import Planner as JaxPlanner
    topo = topology_from_mesh_sizes({"pod": 2, "data": 1})
    mine = planner.Planner(topo, keep_report=True)
    mine.plan({"w": sd})
    theirs = JaxPlanner(jax_topology({"pod": 2, "data": 1}), keep_report=True)
    theirs.plan({"w": jax.ShapeDtypeStruct((3, 4), jax.numpy.bfloat16)})
    assert mine.report.to_json() == theirs.report.to_json()


def _code(path: str) -> str:
    """The module's AST without docstrings, with ``repro_torch`` imports
    read as ``repro``."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("repro_torch"):
            node.module = "repro" + node.module[len("repro_torch"):]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["core/mempool.py", "core/topology.py",
                                    "core/nicpool.py", "core/schedule.py",
                                    "core/cost_model.py", "data/pipeline.py",
                                    "obs/plan_report.py", "obs/trace.py",
                                    "obs/audit.py", "obs/capture.py",
                                    "sim/__init__.py", "sim/fabric_sim.py",
                                    "serve_sim/__init__.py",
                                    "serve_sim/workload.py",
                                    "serve_sim/fleet.py",
                                    "roofline/analytics.py"])
def test_copy_is_verbatim(module):
    """Docstrings and comments aside (the topology copy says its hardware
    defaults are the reference's, not this card's), the copy is the
    original."""
    assert _code(os.path.join(SRC, "repro_torch", module)) == \
        _code(os.path.join(SRC, "repro", module))


def test_pipeline_batches_match_jax():
    arch, jarch = get_smoke_arch("qwen2-0.5b"), jax_smoke_arch("qwen2-0.5b")
    from repro.configs.base import ShapeConfig as JaxShape
    from repro_torch.configs.base import ShapeConfig
    p = pipeline.TokenPipeline(arch, ShapeConfig("t", 32, 8, "train"),
                               pipeline.DataConfig(seed=3))
    jp = jax_pipeline.TokenPipeline(jarch, JaxShape("t", 32, 8, "train"),
                                    jax_pipeline.DataConfig(seed=3))
    for step in (0, 5):
        a, b = p.batch_at(step), jp.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
