"""Helpers for the PyTorch port's tests (``tests/test_torch_*.py``).

The same seeded numpy arrays go through the JAX package (the reference)
and its port.  Import this after ``pytest.importorskip("torch")``.
"""
import ml_dtypes
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_arch as jax_smoke_arch
from repro.models import ModelSettings as JaxSettings
from repro.models import build_model as jax_build_model
from repro.utils.trees import tree_from_paths, tree_paths
from repro_torch.configs import one_card_arch
from repro_torch.convert import load_jax_params
from repro_torch.models import ModelSettings, build_model

# six xdist workers share the machine: one intra-op thread each
torch.set_num_threads(1)

ARCH = "qwen2-0.5b"  # the dense arch, and the default below
RWKV = "rwkv6-1.6b"
JAMBA = "jamba-1.5-large-398b"  # runs without experts (one_card_arch)
ARCHS = (JAMBA, ARCH, RWKV)  # every arch the port registers, sorted
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def redraw(flat, seed: int):
    """Every leaf of a flat JAX tree redrawn with numpy, in its dtype.
    ``init_attention`` zeroes the QKV biases and ``init_norm`` sets scales
    to one; redrawn, both are exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in sorted(flat.items()):
        x = rng.standard_normal(leaf.shape) * 0.1
        if path.endswith("scale"):
            x = x + 1.0
        out[path] = np.asarray(x, dtype=leaf.dtype)
    return out


def smoke_archs(arch: str = ARCH, n_layers=None):
    """(the JAX smoke config, the port's) with the port's one-card cut
    (no experts for jamba) and, if given, ``n_layers``."""
    port, _ = one_card_arch(arch, smoke=True)
    jarch = jax_smoke_arch(arch)
    if port.moe is None:
        jarch = jarch.replace(moe=None)
    if n_layers is not None:
        port, jarch = port.replace(n_layers=n_layers), jarch.replace(n_layers=n_layers)
    return jarch, port


def jax_model(attn_impl: str = "masked", max_seq: int = 64, dtype="float32",
              arch: str = ARCH, use_pallas_ssm: bool = False, n_layers=None):
    st = JaxSettings(param_dtype=dtype, compute_dtype=dtype, remat="none",
                     attn_impl=attn_impl, max_seq=max_seq,
                     use_pallas_ssm=use_pallas_ssm)
    return jax_build_model(smoke_archs(arch, n_layers)[0], st)


def smoke_weights(seed: int = 0, dtype="float32", arch: str = ARCH,
                  n_layers=None):
    """The smoke model's flat JAX tree, every leaf redrawn from ``seed``."""
    params = jax_model(dtype=dtype, arch=arch,
                       n_layers=n_layers).init(jax.random.key(0))
    return redraw({k: np.asarray(v) for k, v in tree_paths(params).items()},
                  seed)


def jax_params(flat):
    return tree_from_paths({k: jnp.asarray(v) for k, v in flat.items()})


def port_model(flat, attn_impl: str = "masked", dtype="float32",
               arch: str = ARCH, use_kernel_ssm: bool = False, n_layers=None):
    st = ModelSettings(param_dtype=dtype, compute_dtype=dtype,
                       attn_impl=attn_impl, use_kernel_ssm=use_kernel_ssm)
    model = build_model(smoke_archs(arch, n_layers)[1], st, device="cpu")
    load_jax_params(model, flat)
    return model


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
