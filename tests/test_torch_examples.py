"""The four examples' PyTorch twins (``examples/*_torch.py``) held to their
originals (``examples/*.py``) on the CPU.

  * by source (``ast``): the literal arguments of ``ModelSettings``,
    ``TrainerConfig``, ``DecodeServer`` and ``make_mesh`` (the twins'
    ``one_process_mesh``), ``Shape``'s attributes, ``ARCH_100M``, the
    flags and the printed lines; the twins add only the kernels to their
    settings (``PORT_ONLY``) and ``--device``, and import nothing of the
    JAX package;
  * quickstart: its first ``QUICKSTART_STEPS`` steps from JAX's
    ``Model.init`` weights against the JAX ``Trainer`` at the example's
    settings (losses rtol 1e-4, the trainer tests' tolerance), and its
    ``main`` for 60 steps: the loss falls;
  * elastic_restart: its ``main``; the restarted trajectory equals the
    uninterrupted one from the restored step on, the restore gives step 16;
  * ddp_train: ``count_params`` equal to the JAX package's count, the
    step-0 loss from JAX's weights within rtol 1e-4 of JAX's on the same
    pipeline batch, and ``--steps 2`` prints its summary line;
  * serve_decode: at temperature 0 from JAX's weights, the greedy tokens
    equal to the JAX ``DecodeServer``'s on the example's prompts and slots
    for the qwen2, rwkv6, jamba and whisper smokes; at 0.8 ``main``
    completes 12/12 and repeats its tokens.

Every ``main`` starts a world of its own, so the port's side runs in one
spawned child that joins no group, beside the JAX side in this process.
Without a card each twin raises unless given ``--device cpu``.
"""
import ast
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (EXAMPLES, QUICKSTART_STEPS, SERVE_ARCHS,  # noqa: E402
                           rank_examples, spawn_ranks)

NAMES = ("quickstart", "ddp_train", "elastic_restart", "serve_decode")
#: what a twin adds to a call of its original: the kernels
KERNEL = {"attn_impl": "kernel"}
PORT_ONLY = {"quickstart": {"ModelSettings": KERNEL},
             "ddp_train": {"ModelSettings": KERNEL},
             "elastic_restart": {"ModelSettings": KERNEL},
             "serve_decode": {"ModelSettings": dict(KERNEL, use_kernel_ssm=True)}}
#: the twin's name for the reference's ``make_mesh``
MESH_CALL = "one_process_mesh"
#: flags whose default differs on purpose: the checkpoints go under the
#: temporary directory (``TMPDIR``), not under a fixed /tmp path
OWN_DEFAULTS = {("ddp_train", "--ckpt-dir")}


def _source(name, twin):
    path = os.path.join(EXAMPLES, f"{name}{'_torch' if twin else ''}.py")
    with open(path) as f:
        return ast.parse(f.read())


class _Expr(str):
    """The ``ast.dump`` of an argument that is not a literal."""


class _Calls(ast.NodeVisitor):
    """Every call in a module by the called name: (its keyword arguments,
    its positional ones), each a value (``ast.literal_eval``'s) or, where
    not a literal, its ``ast.dump`` (an :class:`_Expr`).  A name is first
    resolved to the default of the enclosing function's parameter, or the
    module constant, that it names."""

    def __init__(self, tree):
        self.consts = {t.id: n.value for n in tree.body if isinstance(n, ast.Assign)
                       for t in n.targets if isinstance(t, ast.Name)}
        self.scopes, self.calls = [], {}
        self.visit(tree)

    def visit_FunctionDef(self, node):
        a = node.args
        pos = a.posonlyargs + a.args
        scope = {p.arg: None for p in pos + a.kwonlyargs}
        scope.update(zip((p.arg for p in pos[len(pos) - len(a.defaults):]), a.defaults))
        scope.update((p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d)
        self.scopes.append(scope)
        self.generic_visit(node)
        self.scopes.pop()

    def value(self, node):
        if isinstance(node, ast.Name):
            for scope in reversed(self.scopes):
                if node.id in scope:
                    return (self.value(scope[node.id]) if scope[node.id]
                            else _Expr(ast.dump(node)))
            if node.id in self.consts:
                return self.value(self.consts[node.id])
        try:
            return ast.literal_eval(node)
        except ValueError:
            return _Expr(ast.dump(node))

    def visit_Call(self, node):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", None)
        self.calls.setdefault(name, []).append(
            ({k.arg: self.value(k.value) for k in node.keywords},
             [self.value(a) for a in node.args]))
        self.generic_visit(node)


def _calls(name, twin):
    return _Calls(_source(name, twin)).calls


@pytest.mark.parametrize("name", NAMES)
def test_twin_settings_match_original(name):
    """The keyword arguments of ``ModelSettings``, ``TrainerConfig`` and
    ``DecodeServer`` equal the original's, call by call, but for
    ``PORT_ONLY``; each ``make_mesh`` is a ``one_process_mesh`` of the same
    shape and axes; ``Shape``'s attributes and ``ARCH_100M`` are the
    original's."""
    orig, twin = _calls(name, False), _calls(name, True)
    for callee in ("ModelSettings", "TrainerConfig", "DecodeServer"):
        assert len(orig.get(callee, ())) == len(twin.get(callee, ())), callee
        extra = PORT_ONLY[name].get(callee, {})
        for (okw, oargs), (tkw, targs) in zip(orig.get(callee, ()), twin.get(callee, ())):
            assert {k: v for k, v in tkw.items() if k not in extra} == okw, callee
            assert {k: tkw[k] for k in extra} == extra, callee
            assert targs == oargs, callee
    meshes = [args[:2] for _, args in orig["make_mesh"]]
    assert meshes and [args[:2] for _, args in twin[MESH_CALL]] == meshes
    trees = [_source(name, t) for t in (False, True)]
    for node_of in (lambda t: [n for n in t.body if isinstance(n, ast.ClassDef)
                               and n.name == "Shape"],
                    lambda t: [n.value for n in t.body if isinstance(n, ast.Assign)
                               and any(getattr(x, "id", "") == "ARCH_100M"
                                       for x in n.targets)]):
        want, got = (node_of(t) for t in trees)
        assert [ast.dump(n) for n in got] == [ast.dump(n) for n in want]


def _flags(name, twin):
    return {args[0]: kw for kw, args in _calls(name, twin).get("add_argument", ())}


@pytest.mark.parametrize("name", NAMES)
def test_twin_flags_and_printed_lines(name):
    """The original's flags with their types, defaults and choices, plus
    ``--device`` (cuda by default); every ``print`` of the original
    appears in the twin."""
    orig, twin = _flags(name, False), _flags(name, True)
    assert set(twin) == set(orig) | {"--device"}
    assert twin["--device"] == dict(default="cuda", choices=["cuda", "cpu"])
    for flag, kw in orig.items():
        for key in ("type", "default", "choices"):
            if key == "default" and (name, flag) in OWN_DEFAULTS:
                continue
            assert twin[flag].get(key) == kw.get(key), (flag, key)
    prints = [(name, twin) for twin in (False, True)]
    want, got = ([ast.dump(n) for n in ast.walk(_source(*p)) if isinstance(n, ast.Call)
                  and getattr(n.func, "id", "") == "print"] for p in prints)
    assert want and set(want) <= set(got)


@pytest.mark.parametrize("name", NAMES)
def test_twin_imports_no_jax(name):
    """A twin imports the port and nothing of ``repro``, ``jax`` or
    ``ml_dtypes``."""
    roots = set()
    for node in ast.walk(_source(name, True)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots and not roots & {"repro", "jax", "ml_dtypes"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is there to run on")
@pytest.mark.parametrize("name", NAMES)
def test_twin_raises_without_a_card(name):
    """Asked for the card (the default) where there is none, a twin raises
    before it builds anything else; it does not fall back to the CPU."""
    import importlib
    import sys
    sys.path.insert(0, EXAMPLES)
    try:
        mod = importlib.import_module(f"{name}_torch")
    finally:
        sys.path.remove(EXAMPLES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


# ---------------------------------------------------------------------------
# the runs: the port in a spawned child, the JAX package here
# ---------------------------------------------------------------------------


def _literals(name, callee, i=0):
    """The literal keyword arguments of the ``i``-th ``callee`` call of the
    original ``name``."""
    kw = _calls(name, False)[callee][i][0]
    return {k: v for k, v in kw.items() if not isinstance(v, _Expr)}


def _original(name):
    """The original example as a module (its ``Shape``, ``ARCH_100M``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"original_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(params):
    from repro.utils.trees import tree_paths
    return {k: np.asarray(v) for k, v in tree_paths(params).items()}


def _jax_weights():
    """JAX's ``Model.init`` weights of each run, from the seed its original
    uses: {"quickstart", "ddp", "serve": {arch: ...}} of flat trees, and
    the JAX models."""
    import jax
    from repro.configs import get_smoke_arch
    from repro.models import ModelSettings, build_model
    from repro.runtime.train_loop import TrainerConfig
    qs = build_model(get_smoke_arch("qwen2-0.5b"),
                     ModelSettings(**_literals("quickstart", "ModelSettings")))
    qs_cfg = TrainerConfig(**_literals("quickstart", "TrainerConfig"))
    ddp = build_model(_original("ddp_train").ARCH_100M,
                      ModelSettings(**_literals("ddp_train", "ModelSettings")))
    st = ModelSettings(**_literals("serve_decode", "ModelSettings"))
    serve = {a: build_model(get_smoke_arch(a), st) for a in SERVE_ARCHS}
    models = dict(quickstart=(qs, qs_cfg), ddp=ddp, serve=serve)
    weights = dict(quickstart=_flat(qs.init(jax.random.key(qs_cfg.seed))),
                   ddp=_flat(ddp.init(jax.random.key(TrainerConfig().seed))),
                   serve={a: _flat(m.init(jax.random.key(0))) for a, m in serve.items()})
    return models, weights


def _jax_runs(models, weights):
    """The JAX side: quickstart's ``Trainer`` for its first steps, ddp's
    count and step-0 loss on the pipeline's batch, each server's greedy
    tokens."""
    import jax
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.models import count_params
    from repro.runtime.serve_loop import DecodeServer, Request
    from repro.runtime.train_loop import Trainer
    from repro.utils.jax_compat import make_mesh
    from repro.utils.trees import tree_from_paths
    out = {}
    model, cfg = models["quickstart"]
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = dataclasses.replace(cfg, steps=QUICKSTART_STEPS, log_every=0)
    res = Trainer(model, mesh, _original("quickstart").Shape(), cfg).train()
    out["quickstart_losses"] = [m["loss"] for m in res["metrics"]]
    ddp = models["ddp"]
    params = tree_from_paths({k: jax.numpy.asarray(v) for k, v in weights["ddp"].items()})
    batch = TokenPipeline(ddp.arch, _original("ddp_train").Shape(),
                          DataConfig(seed=0)).batch_at(0)
    out["ddp"] = dict(count=count_params(ddp), batch=batch,
                      loss0=float(jax.jit(ddp.loss)(params, batch)))
    kw = dict(_literals("serve_decode", "DecodeServer"), temperature=0.0)
    out["greedy"] = {}
    for name, model in models["serve"].items():
        server = DecodeServer(model, make_mesh((1, 1), ("data", "model")), **kw)
        rng = np.random.default_rng(0)
        for i in range(12):
            server.submit(Request(uid=i, max_new=24, prompt=rng.integers(
                0, model.arch.vocab, 4).astype(np.int32)))
        params = tree_from_paths({k: jax.numpy.asarray(v)
                                  for k, v in weights["serve"][name].items()})
        out["greedy"][name] = server.run(params, max_steps=120)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port child's records, the JAX side's)."""
    models, weights = _jax_weights()
    payload = dict(weights, tmp=str(tmp_path_factory.mktemp("examples")))
    with ThreadPoolExecutor(1) as pool:
        child = pool.submit(spawn_ranks, 1, rank_examples, payload, 900, False)
        jax_out = _jax_runs(models, weights)
        port = child.result()[0]
    return port, jax_out


def test_quickstart_matches_jax_trainer(runs):
    """From JAX's ``Model.init`` weights, quickstart's first steps through
    the twin's model and settings follow the JAX ``Trainer``'s losses at
    rtol 1e-4."""
    port, jax_out = runs
    assert len(port["quickstart_losses"]) == QUICKSTART_STEPS
    np.testing.assert_allclose(port["quickstart_losses"], jax_out["quickstart_losses"],
                               rtol=1e-4)


def test_quickstart_main_loss_falls(runs):
    """``main(["--device", "cpu"])`` trains its 60 steps and the loss
    falls (its own assertion), printed as the original prints it."""
    port, _ = runs
    losses = port["quickstart_main"]
    assert len(losses) == 60 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert "over 60 steps" in port["quickstart_text"]


def test_elastic_restart_main(runs):
    """The run crashed at step 10 and restarted from its step-8 checkpoint
    ends on the uninterrupted run's losses, step by step from the restored
    step, and the restore onto a new mesh gives step 16."""
    port, _ = runs
    rec = port["elastic"]
    assert len(rec["ref"]) == 16 and rec["restored_step"] == 16
    steps = [s for s, _ in rec["restarted"]]
    assert steps == list(range(8, 16))
    assert [loss for _, loss in rec["restarted"]] == rec["ref"][8:]
    assert "restored step 16 OK" in port["elastic_text"]


def test_ddp_param_count_matches_jax(runs):
    """``count_params`` of the twin's model equals the JAX package's (67.1M,
    as the twin's docstring says), printed as ``params: 67.1M``."""
    port, jax_out = runs
    assert port["ddp"]["count"] == jax_out["ddp"]["count"]
    assert f"params: {jax_out['ddp']['count'] / 1e6:.1f}M" == "params: 67.1M"
    assert "params: 67.1M" in port["ddp_text"]


def test_ddp_step0_loss_matches_jax(runs):
    """From JAX's weights the twin's model's loss on the data pipeline's
    step-0 batch (the port's pipeline, equal to JAX's) is within rtol 1e-4
    of JAX's."""
    port, jax_out = runs
    for k, v in jax_out["ddp"]["batch"].items():
        np.testing.assert_array_equal(port["ddp"]["batch"][k], v)
    np.testing.assert_allclose(port["ddp"]["loss0"], jax_out["ddp"]["loss0"], rtol=1e-4)


def test_ddp_cli_two_steps(runs):
    """``--steps 2`` trains two steps and prints the summary line, with no
    checkpoint yet (the first is at step 50)."""
    port, _ = runs
    rec = port["ddp_main"]
    assert rec["step"] == 2 and len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert ("done at step 2: loss " in port["ddp_text"]
            and "ckpt latest = step None; straggler events = " in port["ddp_text"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_greedy_tokens_match_jax(runs, arch):
    """At temperature 0 from JAX's weights, the twin's server (its slots
    and prompts) decodes each of the 12 requests' 24 tokens as the JAX
    ``DecodeServer`` does."""
    port, jax_out = runs
    got, want = port["greedy"][arch], jax_out["greedy"][arch]
    assert sorted(got) == sorted(want) == list(range(12))
    for uid in want:
        assert len(want[uid]) == 24
        assert [int(t) for t in got[uid]] == [int(t) for t in want[uid]], uid


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_main_samples_from_its_seed(runs, arch):
    """``main`` at temperature 0.8 completes 12/12 requests and draws the
    same tokens when run again (the generator seeded 0)."""
    port, _ = runs
    (outs, text), (again, _) = port["serve_main"][arch]
    assert "12/12 requests completed" in text
    assert outs == again and all(len(t) == 24 for t in outs.values())
