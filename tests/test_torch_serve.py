"""The port's serving runtime (``repro_torch.runtime.serve_loop``), CLI,
configs and copied helpers, held against the JAX package."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (ARCH, ARCHS, FP32, JAMBA, NEW_ARCHS,  # noqa: E402
                           RWKV, WHISPER, jax_model, jax_params, port_model,
                           smoke_weights)

from repro import configs as jax_configs  # noqa: E402
from repro.runtime.serve_loop import DecodeServer as JaxDecodeServer  # noqa: E402
from repro.runtime.serve_loop import Request as JaxRequest  # noqa: E402
from repro.utils.jax_compat import make_mesh  # noqa: E402
from repro.utils.stats import percentile as jax_percentile  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import ModelSettings, build_model  # noqa: E402
from repro_torch.runtime.serve_loop import (DecodeServer, Request,  # noqa: E402
                                            priority_admission)
from repro_torch.utils.stats import percentile  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    return smoke_weights(seed=0)


@pytest.fixture(scope="module")
def model(weights):
    return port_model(weights)


def _server(model, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 32)
    return DecodeServer(model, "cpu", **kw)


def test_greedy_tokens_match_jax_server(weights, model):
    """The five requests of tests/test_system.py's continuous-batching
    test, on the same weights: the same token ids, request for request."""
    jserver = JaxDecodeServer(jax_model(max_seq=64), make_mesh((1, 1), ("data", "model")),
                              batch_slots=2, max_seq=64)
    server = _server(model, max_seq=64)
    for s, req in ((jserver, JaxRequest), (server, Request)):
        for i in range(5):  # more requests than slots -> queueing + swap
            s.submit(req(uid=i, prompt=np.array([1, 2, 3], np.int32), max_new=4))
    jouts = jserver.run(jax_params(weights), max_steps=40)
    outs = server.run(max_steps=40)
    assert outs == jouts
    assert len(set(map(tuple, outs.values()))) > 1  # not one constant stream
    assert server.stats == {**jserver.stats, "wall": server.stats["wall"]}


@pytest.mark.parametrize("use_kernel_ssm", [False, True])
def test_rwkv_greedy_tokens_match_jax_server(use_kernel_ssm):
    """The same five requests on the rwkv6 smoke model.  Neither server
    resets a slot's recurrent state when a new request takes the slot (the
    reference's behaviour), so the queued requests' tokens depend on it."""
    weights = smoke_weights(seed=0, arch=RWKV)
    jserver = JaxDecodeServer(jax_model(max_seq=64, arch=RWKV),
                              make_mesh((1, 1), ("data", "model")),
                              batch_slots=2, max_seq=64)
    server = _server(port_model(weights, arch=RWKV,
                                use_kernel_ssm=use_kernel_ssm), max_seq=64)
    for s, req in ((jserver, JaxRequest), (server, Request)):
        for i in range(5):
            s.submit(req(uid=i, prompt=np.array([1, 2, 3], np.int32), max_new=4))
    jouts = jserver.run(jax_params(weights), max_steps=40)
    outs = server.run(max_steps=40)
    assert outs == jouts
    assert len(set(map(tuple, outs.values()))) > 1
    assert server.stats == {**jserver.stats, "wall": server.stats["wall"]}


@pytest.mark.parametrize("use_kernel_ssm", [False, True])
def test_jamba_greedy_tokens_match_jax_server(use_kernel_ssm):
    """The same five requests on the jamba smoke model without experts:
    seven Mamba layers and one attention layer.  As for RWKV6, a slot's
    conv and ssm states carry over to the next request it takes."""
    weights = smoke_weights(seed=0, arch=JAMBA)
    jserver = JaxDecodeServer(jax_model(max_seq=64, arch=JAMBA),
                              make_mesh((1, 1), ("data", "model")),
                              batch_slots=2, max_seq=64)
    server = _server(port_model(weights, arch=JAMBA,
                                use_kernel_ssm=use_kernel_ssm), max_seq=64)
    for s, req in ((jserver, JaxRequest), (server, Request)):
        for i in range(5):
            s.submit(req(uid=i, prompt=np.array([1, 2, 3], np.int32), max_new=4))
    jouts = jserver.run(jax_params(weights), max_steps=40)
    outs = server.run(max_steps=40)
    assert outs == jouts
    assert len(set(map(tuple, outs.values()))) > 1
    assert server.stats == {**jserver.stats, "wall": server.stats["wall"]}


def test_whisper_greedy_tokens_match_jax_server():
    """The same five requests on the whisper smoke model.  Neither server
    runs the encoder: each decodes against its zeroed cross-attention
    cache of the config's 16 frames (the reference's behaviour, ROADMAP.md
    queue 3, item 5), and the learned positions are read at each step."""
    weights = smoke_weights(seed=0, arch=WHISPER)
    jserver = JaxDecodeServer(jax_model(max_seq=64, arch=WHISPER),
                              make_mesh((1, 1), ("data", "model")),
                              batch_slots=2, max_seq=64)
    server = _server(port_model(weights, arch=WHISPER, attn_impl="kernel"),
                     max_seq=64)
    for s, req in ((jserver, JaxRequest), (server, Request)):
        for i in range(5):
            s.submit(req(uid=i, prompt=np.array([1, 2, 3], np.int32), max_new=4))
    jouts = jserver.run(jax_params(weights), max_steps=40)
    outs = server.run(max_steps=40)
    assert outs == jouts
    assert len(set(map(tuple, outs.values()))) > 1
    assert server.stats == {**jserver.stats, "wall": server.stats["wall"]}


def test_admission_fifo_and_accounting(model):
    server = _server(model)
    for i in range(4):
        server.submit(Request(uid=i, prompt=np.array([1 + i], np.int32),
                              max_new=3))
    outs = server.run(max_steps=30)
    assert sorted(outs) == [0, 1, 2, 3]
    assert all(len(v) == 3 for v in outs.values())
    assert server.stats["tokens"] == 12 and server.stats["steps"] == 6
    assert server.throughput() > 0
    assert server.metrics.counters == {"decode_steps": 6.0, "tokens": 12.0}


def test_priority_admission_reorders_queue(model):
    server = _server(model, batch_slots=1, admission=priority_admission)
    for uid, prio in ((0, 1.0), (1, 1.0), (2, 5.0)):
        server.submit(Request(uid=uid, prompt=np.array([uid + 1], np.int32),
                              max_new=2, priority=prio))
    server.run(max_steps=31)
    by_uid = {r.uid: r.ttft_s for r in server.all_requests}
    assert by_uid[2] < by_uid[0] < by_uid[1]


def test_bad_admission_index_raises(model):
    server = _server(model, batch_slots=1, admission=lambda q: len(q))
    server.submit(Request(uid=0, prompt=np.array([1], np.int32), max_new=1))
    with pytest.raises(ValueError, match="admission policy"):
        server.run(max_steps=4)


def test_temperature_sampling_is_seeded(model):
    def sample(seed):
        server = _server(model, temperature=1.0, seed=seed)
        server.submit(Request(uid=7, prompt=np.array([3], np.int32), max_new=5))
        return server.run(max_steps=16)[7]

    toks = sample(3)
    assert len(toks) == 5 and all(0 <= t < model.arch.vocab for t in toks)
    assert sample(3) == toks


def test_ttft_and_token_latency_accounting(model):
    server = _server(model)
    for i in range(3):
        server.submit(Request(uid=i, prompt=np.array([1 + i], np.int32),
                              max_new=4))
    server.run(max_steps=30)
    for r in server.all_requests:
        assert r.ttft_s == pytest.approx(r.token_s[0])
        assert len(r.token_s) == len(r.generated) == 4
    lat = server.latency_summary()
    assert set(lat) == {"ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s"}
    # the queued request's TTFT includes its wait for a free slot
    assert max(r.ttft_s for r in server.all_requests) == server.all_requests[2].ttft_s


def test_max_seq_truncates_long_request(model):
    server = _server(model, batch_slots=1, max_seq=8)
    server.submit(Request(uid=0, prompt=np.array([5], np.int32), max_new=100))
    assert len(server.run(max_steps=50)[0]) == 7  # max_seq - 1
    assert not server.all_requests[0].done


@pytest.mark.parametrize("entry", ["build_model", "DecodeServer", "cli"])
def test_cuda_entry_points_raise_without_card(monkeypatch, model, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "build_model":
            build_model(configs.get_smoke_arch(ARCH), ModelSettings(**FP32))
        elif entry == "DecodeServer":
            DecodeServer(model)
        else:
            serve_cli.main(["--arch", ARCH, "--smoke"])


def test_cli_smoke_on_cpu(capsys):
    server = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "2",
                             "--batch-slots", "2", "--max-seq", "16"])
    assert server.stats["tokens"] == 6
    assert "throughput:" in capsys.readouterr().out


def test_cli_smoke_rwkv_on_cpu(capsys):
    server = serve_cli.main(["--arch", RWKV, "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "2",
                             "--batch-slots", "2", "--max-seq", "16"])
    assert server.stats["tokens"] == 6
    assert server.model.settings.use_kernel_ssm
    assert server.model.settings.attn_impl == "kernel"
    assert "throughput:" in capsys.readouterr().out


def test_cli_smoke_jamba_on_cpu(capsys):
    """The CLI serves the one-card cut: no experts."""
    server = serve_cli.main(["--arch", JAMBA, "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "2",
                             "--batch-slots", "2", "--max-seq", "16"])
    assert server.stats["tokens"] == 6
    assert server.model.arch.moe is None and server.model.arch.is_hybrid
    assert server.model.settings.use_kernel_ssm
    out = capsys.readouterr().out
    assert "cut to one card: moe" in out and "throughput:" in out


def test_cli_smoke_whisper_on_cpu(capsys):
    """The encoder-decoder through the CLI: ``pos_embed`` sized by
    --max-seq (as the JAX CLI sizes it), the cross cache of 16 frames."""
    server = serve_cli.main(["--arch", WHISPER, "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "2",
                             "--batch-slots", "2", "--max-seq", "16"])
    assert server.stats["tokens"] == 6
    assert server.model.arch == configs.get_smoke_arch(WHISPER)
    assert tuple(server.model.pos_embed.shape) == (16, server.model.arch.d_model)
    out = capsys.readouterr().out
    assert "throughput:" in out and "cut to one card" not in out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_smoke_decoder_archs_on_cpu(capsys, arch):
    """The MoE slice's six configs through the CLI; nemotron's smoke config
    is within its one-card depth, so nothing is cut."""
    server = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--requests", "3", "--max-new", "2",
                             "--batch-slots", "2", "--max-seq", "16"])
    assert server.stats["tokens"] == 6
    assert server.model.arch == configs.get_smoke_arch(arch)
    assert server.model.settings.attn_impl == "kernel"
    out = capsys.readouterr().out
    assert "throughput:" in out and "cut to one card" not in out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["get_arch", "get_smoke_arch"])
def test_configs_match_jax(getter, arch):
    """The port's copy of the configs is field-for-field the reference, for
    every arch the port registers."""
    assert configs.list_archs() == ARCHS
    ours = dataclasses.asdict(getattr(configs, getter)(arch))
    assert ours == dataclasses.asdict(getattr(jax_configs, getter)(arch))
    assert configs.SHAPES.keys() == jax_configs.SHAPES.keys()


def test_percentile_matches_jax_and_numpy():
    xs = np.random.default_rng(0).standard_normal(37)
    for q in (0, 13.5, 50, 99, 100):
        assert percentile(xs, q) == jax_percentile(xs, q)
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))
