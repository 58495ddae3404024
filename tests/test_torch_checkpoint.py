"""The port's ``CheckpointManager`` (``repro_torch.checkpoint.manager``):
every manager case of ``tests/test_fault_tolerance.py`` run on the port,
the on-disk format held to the JAX manager's in both directions, the
reference's sweep race made deterministic, and bf16 leaves in the
reference's format."""
import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.checkpoint.manager as M  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.utils.trees import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402


def test_checkpoint_roundtrip_and_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"a": {"b": torch.arange(6.0).reshape(2, 3)}, "c": torch.ones(4)}
    for step in (2, 4, 6, 8):
        mgr.save(step, {"params": tree, "data_state": {"step": step}},
                 blocking=True)
    # keep-K garbage collection
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000006", "step_00000008"]
    out = mgr.restore()
    assert out["__step__"] == 8
    np.testing.assert_array_equal(out["params"]["a"]["b"],
                                  np.arange(6.0).reshape(2, 3))
    assert out["data_state"]["step"] == 8
    # no tmp dirs left behind (atomicity)
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_snapshot_is_taken_before_save_returns(tmp_path, monkeypatch):
    """The host copy is made in ``save``: an in-place update of the
    (CPU) tensor after ``save`` returns, while the write is still pending,
    does not reach the checkpoint."""
    gate = threading.Event()
    real_save = M.np.save

    def gated(*a, **k):
        gate.wait(10)
        return real_save(*a, **k)

    monkeypatch.setattr(M.np, "save", gated)
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(8)
    mgr.save(1, {"params": {"w": w}})
    w.add_(1.0)  # the trainer's in-place update of the next step
    gate.set()
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore()["params"]["w"], np.zeros(8))
    assert mgr.stats[0]["bytes"] == 32 and mgr.stats[0]["write_s"] >= 0
    mgr.close()


def test_failed_async_save_is_not_sticky(tmp_path, monkeypatch):
    """A failed async write surfaces ONCE at wait() and is then cleared;
    checkpointing continues."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    real_save = M.np.save

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(M.np, "save", boom)
    mgr.save(1, {"params": {"a": torch.ones(2)}})
    with pytest.raises(OSError):
        mgr.wait()
    monkeypatch.setattr(M.np, "save", real_save)
    # second wait() must NOT re-raise the drained failure
    mgr.wait()
    mgr.save(2, {"params": {"a": torch.ones(2)}}, blocking=True)
    assert mgr.latest_step() == 2
    assert not M._LIVE_WRITES  # the failed write released its tmp dir
    mgr.close()


def test_init_sweeps_orphaned_tmp_dirs(tmp_path):
    """``.tmp-step_*`` trees and a stale ``.LATEST.tmp`` left by a crash
    mid-save are reclaimed when a manager restarts on the directory."""
    orphan = tmp_path / ".tmp-step_00000007" / "arrays"
    orphan.mkdir(parents=True)
    (orphan / "junk.npy").write_bytes(b"x")
    (tmp_path / ".LATEST.tmp").write_text("step_00000007")
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    left = os.listdir(tmp_path)
    assert not [d for d in left if d.startswith(".tmp")]
    assert ".LATEST.tmp" not in left
    mgr.save(1, {"params": {"a": torch.ones(2)}}, blocking=True)
    assert mgr.restore()["__step__"] == 1


def test_gc_preserves_latest_target_on_out_of_order_saves(tmp_path):
    """keep=1 with an out-of-order save (elastic rollback): LATEST points
    at step 5 while step 10's dir sorts newer — GC must not delete the
    step the pointer names."""
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    tree = {"a": torch.ones(2)}
    mgr.save(10, {"params": tree}, blocking=True)
    mgr.save(5, {"params": tree}, blocking=True)
    assert mgr.latest_step() == 5
    out = mgr.restore()
    assert out is not None and out["__step__"] == 5


def test_restore_missing_explicit_step_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(2, {"params": {"a": torch.ones(2)}}, blocking=True)
    assert mgr.restore(step=99) is None
    assert mgr.restore(step=2)["__step__"] == 2


def test_close_and_context_manager(tmp_path, monkeypatch):
    """close()/with drain the pending write and shut the worker down;
    a failed pending write re-raises from close() but the executor still
    shuts down."""
    with CheckpointManager(str(tmp_path / "a"), keep=2) as mgr:
        mgr.save(3, {"params": {"a": torch.arange(4.0)}})
    assert mgr._pool._shutdown
    assert mgr.latest_step() == 3

    mgr2 = CheckpointManager(str(tmp_path / "b"), keep=2)

    def boom(*a, **k):
        raise OSError("boom")

    monkeypatch.setattr(M.np, "save", boom)
    mgr2.save(1, {"params": {"a": torch.ones(2)}})
    with pytest.raises(OSError):
        mgr2.close()
    assert mgr2._pool._shutdown


def test_read_only_manager_restores_and_never_writes(tmp_path):
    """The non-writing members' manager: no directory made, no sweep, no
    worker; it restores what member 0 wrote and refuses to save."""
    root = tmp_path / "ckpt"
    ro = CheckpointManager(str(root), read_only=True)
    assert not root.exists() and ro.latest_step() is None and ro.restore() is None
    CheckpointManager(str(root), async_save=False).save(
        4, {"params": {"a": torch.ones(2)}}, blocking=True)
    (root / ".tmp-step_00000006").mkdir()
    ro = CheckpointManager(str(root), read_only=True)
    assert (root / ".tmp-step_00000006").exists()
    assert ro.restore()["__step__"] == 4
    with pytest.raises(RuntimeError, match="read-only"):
        ro.save(5, {"params": {"a": torch.ones(2)}})
    ro.wait()
    ro.close()


# ---------------------------------------------------------------------------
# the on-disk format: JAX -> port and port -> JAX, leaf for leaf
# ---------------------------------------------------------------------------


def _trees(rng):
    """A checkpoint's three trees as the JAX trainer saves them: fp32
    parameters (a stacked layer group), the sync state (int32 step, fp32
    m, v, ef) and the data pipeline's Python ints."""
    params = {"blocks": {"l0": {"attn": {"wq": rng.standard_normal((2, 8, 4, 2))}}},
              "embed": rng.standard_normal((16, 8))}
    opt = {"step": np.int32(3), "sections": {
        "embed": {"m": rng.standard_normal((16, 8)), "v": rng.random((16, 8)),
                  "ef": rng.standard_normal((16, 8)) * 1e-3},
        "bucket[blocks.l0.attn.wq...x1]": {"m": rng.standard_normal(128),
                                           "v": rng.random(128)}}}
    f32 = lambda t: {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
                         and v.dtype == np.float64 else v)
                     for k, v in tree_paths(t).items()}
    return f32(params), f32(opt), {"seed": 7, "step": 3, "host_index": 0,
                                   "host_count": 1}


def _check_equal(got_flat, want_flat):
    assert set(got_flat) == set(want_flat)
    for k, want in want_flat.items():
        got = np.asarray(got_flat[k])
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_format_crosses_between_packages(tmp_path, direction):
    """A checkpoint written by one package's manager restores in the
    other's bit for bit: every leaf's values, dtype (0-d int32 ``opt/step``,
    0-d int64 ``data_state``) and shape, and the same files and index."""
    from repro.utils.trees import tree_from_paths as jax_from_paths
    from repro_torch.utils.trees import tree_from_paths
    params, opt, data = _trees(np.random.default_rng(0))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    JaxManager(str(jdir), async_save=False).save(3, {
        "params": jax_from_paths({k: jnp.asarray(v) for k, v in params.items()}),
        "opt": jax_from_paths({k: jnp.asarray(v) for k, v in opt.items()}),
        "data_state": data}, metadata={"arch": "t"}, blocking=True)
    with CheckpointManager(str(pdir)) as mgr:
        mgr.save(3, {
            "params": tree_from_paths({k: torch.from_numpy(v) for k, v in params.items()}),
            "opt": tree_from_paths({k: (v if k == "step" else torch.from_numpy(v))
                                    for k, v in opt.items()}),
            "data_state": data}, metadata={"arch": "t"})
    # the same files, and the same index
    step_dir = "step_00000003"
    assert sorted(os.listdir(jdir / step_dir / "arrays")) == \
        sorted(os.listdir(pdir / step_dir / "arrays"))
    assert json.loads((jdir / step_dir / "index.json").read_text()) == \
        json.loads((pdir / step_dir / "index.json").read_text())
    assert (jdir / "LATEST").read_text() == (pdir / "LATEST").read_text()
    if direction == "jax_to_port":
        out = CheckpointManager(str(jdir), read_only=True).restore()
        flat = lambda t: tree_paths(t)
    else:
        out = JaxManager(str(pdir), async_save=False).restore()
        flat = lambda t: jax_tree_paths(t)
    assert out["__step__"] == 3 and out["__metadata__"] == {"arch": "t"}
    _check_equal(flat(out["params"]), params)
    _check_equal(flat(out["opt"]), {**opt, "step": np.asarray(3, np.int32)})
    _check_equal(flat(out["data_state"]),
                 {k: np.asarray(v) for k, v in data.items()})
    assert np.asarray(flat(out["opt"])["step"]).dtype == np.int32
    assert np.asarray(flat(out["data_state"])["step"]).dtype == np.int64


# ---------------------------------------------------------------------------
# the reference's sweep race, made to show every time
# ---------------------------------------------------------------------------


def test_restart_does_not_sweep_a_pending_write(tmp_path, monkeypatch):
    """A manager constructed while another one in this process still
    writes a step (a trainer restarted after a failure injected right
    after the save was submitted) leaves that write's ``.tmp`` dir alone:
    the step lands complete.  The writer is held inside its first
    ``np.save`` until the restarted manager has swept, so the reference's
    sweep removes the dir here every time."""
    started, release = threading.Event(), threading.Event()
    real_save = M.np.save

    def held(*a, **k):
        started.set()
        assert release.wait(10)
        return real_save(*a, **k)

    monkeypatch.setattr(M.np, "save", held)
    tree = {f"w{i}": torch.full((64,), float(i)) for i in range(8)}
    dead = CheckpointManager(str(tmp_path))
    dead.save(2, {"params": tree, "data_state": {"step": 2}})
    assert started.wait(10)  # the writer is inside .tmp-step_00000002
    restarted = CheckpointManager(str(tmp_path))
    assert (tmp_path / ".tmp-step_00000002").exists()
    release.set()
    dead.wait()
    out = restarted.restore()
    assert out["__step__"] == 2 and restarted.latest_step() == 2
    _check_equal(out["params"], {k: v.numpy() for k, v in tree.items()})
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    dead.close()
    restarted.close()


# ---------------------------------------------------------------------------
# bf16 leaves: the reference's format, bit for bit in both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leaf", ["torch", "numpy", "jax"])
def test_bf16_leaf_raises(tmp_path, leaf):
    """A bf16 leaf no longer raises: saved by one package's manager (the
    port's, from a torch or an ``ml_dtypes`` leaf; or the JAX one's) it
    restores in the other's bit for bit (every high byte of a 16-bit
    word, NaN and inf among them), with the same file name and
    ``index.json`` entry (``"dtype": "bfloat16"``).  The port writes a
    bf16 leaf as its 16-bit payload; the JAX manager ``np.save``s the
    ``ml_dtypes`` array itself.  Both read back the 2-byte void array
    ``np.load`` gives, which ``numpy_to_torch`` reads as bf16."""
    import ml_dtypes
    from repro_torch.convert import numpy_to_torch
    bits = np.arange(0, 1 << 16, 257, dtype=np.uint16).reshape(32, 8)
    ref = bits.view(ml_dtypes.bfloat16)
    fp32 = np.arange(6, dtype=np.float32)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    JaxManager(str(jdir), async_save=False).save(
        1, {"params": {"w": jnp.asarray(ref), "b": jnp.asarray(fp32)}},
        blocking=True)
    w = (torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
         if leaf == "torch" else ref)
    with CheckpointManager(str(pdir)) as mgr:
        mgr.save(1, {"params": {"w": w, "b": torch.from_numpy(fp32)}})
    step = "step_00000001"
    assert json.loads((jdir / step / "index.json").read_text()) == \
        json.loads((pdir / step / "index.json").read_text())
    assert json.loads((pdir / step / "index.json").read_text())[
        "trees"]["params"]["w"]["dtype"] == "bfloat16"
    if leaf == "jax":  # saved by the JAX manager, restored by the port's
        out = CheckpointManager(str(jdir), read_only=True).restore()["params"]
    else:
        out = JaxManager(str(pdir), async_save=False).restore()["params"]
    got = np.asarray(out["w"])
    assert got.dtype.itemsize == 2 and got.shape == bits.shape
    np.testing.assert_array_equal(got.view(np.uint16), bits)
    np.testing.assert_array_equal(
        numpy_to_torch(got).view(torch.int16).numpy().view(np.uint16), bits)
    np.testing.assert_array_equal(np.asarray(out["b"]), fp32)


def test_assemble_takes_the_first_member_in_mesh_order():
    """A state replicated over an axis its spec does not name (the int8 EF
    over the pods) but different on each member: the global array is
    built from the first member in mesh order, pod 0 — the copy JAX's
    ``device_get`` returns — whatever order the blocks come in."""
    from repro_torch.optim import grad_sync
    sizes = {"pod": 2, "data": 2}
    spec = ("data", None)
    blocks = {(("data", d), ("pod", p)): np.full((1, 3), 10 * p + d)
              for p in (1, 0) for d in (1, 0)}  # pod 1 first
    got = grad_sync.assemble(blocks, spec, (2, 3), sizes,
                             lambda ps, d: np.concatenate(ps, d))
    np.testing.assert_array_equal(got, [[0, 0, 0], [1, 1, 1]])
