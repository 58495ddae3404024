"""The port's ``Trainer`` with the int8 slow tier on the two-tier (2,4,1)
mesh, in ``zero1`` and ``paper`` modes, held against the JAX ``Trainer`` on
the same weights and data, to the tolerances set out in
``test_torch_trainer.py`` (a file of its own so that the two run on
different test workers)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (TRAIN, check_trainer_run, jax_trainer_runs,  # noqa: E402
                           rank_trainer, smoke_weights, spawn_ranks)

RUNS = {  # name: (mesh sizes, TrainerConfig fields)
    "2x4x1-int8-zero1": ({"pod": 2, "data": 4, "model": 1},
                         dict(zero1=True, codec="int8")),
    "2x4x1-int8-paper": ({"pod": 2, "data": 4, "model": 1},
                         dict(zero1=False, codec="int8")),
}


@pytest.fixture(scope="module")
def results():
    weights = smoke_weights(seed=8)
    jax_out = jax_trainer_runs(RUNS, weights)
    port = {name: spawn_ranks(8, rank_trainer,
                              {"weights": weights, "sizes": sizes, "cfg": cfg})
            for name, (sizes, cfg) in RUNS.items()}
    return jax_out, port


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_jax(results, name):
    jax_out, port = results
    sizes, cfg = RUNS[name]
    check_trainer_run(name, sizes, cfg, jax_out, port[name])
    efs = {n: e["ef"] for n, e in port[name][0][2].items() if "ef" in e}  # the EF state was written
    assert efs and all(np.abs(e).max() > 0 for e in efs.values())


def test_microbatches_match_one_batch():
    """Gradient accumulation over 2 microbatches takes the same steps as
    one batch (the JAX battery's check), on the port alone; the key biases,
    whose gradient is rounding noise, to 2 x lr x steps as in
    ``check_trainer_run``."""
    weights = smoke_weights(seed=8)
    sizes = {"pod": 2, "data": 1, "model": 1}
    runs = [spawn_ranks(2, rank_trainer, {"weights": weights, "sizes": sizes,
                                          "cfg": dict(microbatches=mb)})
            for mb in (1, 2)]
    np.testing.assert_allclose(runs[0][0][0], runs[1][0][0], rtol=1e-5)
    for k, v in runs[0][0][1].items():
        tol = 2 * TRAIN["lr"] * TRAIN["steps"] if k.endswith("attn/bk") else 1e-5
        np.testing.assert_allclose(runs[1][0][1][k], v, atol=tol, err_msg=k)
