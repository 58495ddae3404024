"""The memory-pool analogues (``repro_torch.core.staging_utils``), held to
``tests/test_memory_pool_utils.py``'s checks of the reference: staging
slots that round-robin, an offload placement that falls back on the CPU,
and the steps' in-place carries that stand for ``donated_jit``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_harness import (rank_in_place_steps, smoke_weights,  # noqa: E402
                           spawn_ranks)

from repro_torch.core.staging_utils import (Placement,  # noqa: E402
                                            StagingBuffers,
                                            host_memory_kind_available,
                                            offload_placement)


def test_staging_buffers_round_robin():
    """Batch i lands in slot i % 2, each put returns the batch on the
    device, and a slot holds the last batch written to it."""
    staging = StagingBuffers("cpu", n_slots=2)
    batches = [np.full((8,), float(i), np.float32) for i in range(4)]
    outs = [staging.put(b) for b in batches]
    for i, out in enumerate(outs):
        assert out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), batches[i])
    assert staging._slots[0] is outs[2]
    assert staging._slots[1] is outs[3]
    assert staging._next == 0  # wrapped around
    # a put copies: the host batch may be rewritten once it returns
    host = np.zeros(3, np.float32)
    out = staging.put(host)
    host[:] = 7
    assert float(out.sum()) == 0.0


def test_staging_buffers_take_a_batch_tree():
    """A dict of arrays (the pipeline's batch) goes through leaf by leaf,
    its keys and dtypes kept."""
    staging = StagingBuffers("cpu", n_slots=3)
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "labels": torch.ones(2, 3, dtype=torch.int64)}
    out = staging.put(batch)
    assert set(out) == {"tokens", "labels"}
    assert out["tokens"].dtype == torch.int32 and out["labels"].dtype == torch.int64
    np.testing.assert_array_equal(out["tokens"].numpy(), batch["tokens"])
    assert staging._slots[0] is out and staging._next == 1


def test_offload_placement_falls_back_without_pinned_memory():
    """No CUDA here, so no pinned memory: an offload request degrades to
    the device itself, as the reference's does without ``pinned_host``."""
    assert host_memory_kind_available() is torch.cuda.is_available()
    plain = offload_placement("cpu", offload=False)
    assert plain == Placement(torch.device("cpu"))
    offloaded = offload_placement("cpu", offload=True)
    if not host_memory_kind_available():
        assert offloaded == plain
        assert not offloaded.zeros((2, 3)).is_pinned()
    assert offloaded.zeros((2, 3)).shape == (2, 3)


@pytest.fixture(scope="module")
def in_place():
    return spawn_ranks(2, rank_in_place_steps, {"weights": smoke_weights(seed=5)})


@pytest.mark.parametrize("mode", ["dfabric", "gspmd"])
def test_steps_update_their_carries_in_place(in_place, mode):
    """``donated_jit``'s property: after two steps every parameter and
    every moment of the carried state (the sync state's; the GSPMD
    step's) lies where it lay, the returned trees hold the given tensors,
    and every parameter moved.  The int8 step carries error feedback too,
    replaced each step by the codec's residual."""
    for rank, out in enumerate(in_place):
        rec = out[mode]
        assert rec["keys"], rank
        assert all(rec["same_storage"].values()), [
            k for k, v in rec["same_storage"].items() if not v]
        assert rec["same_tensors"] and rec["updated"], rank
        if mode == "dfabric":
            assert rec["has_ef"], rank
