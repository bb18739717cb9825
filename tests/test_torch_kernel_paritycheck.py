"""The port's `tools/tpu_kernel_paritycheck.py` on the CPU, on the flash
kernels' plain versions.

Its `dense_chunked` equals the JAX tool's (tools/tpu_kernel_paritycheck.py,
imported by path) on the same weights, and `check` passes at small shapes,
the compacted `use_valid=False` path of `check_16k` included (engaged
here at 512 tokens by lowering `COMPACT_MIN_TOKENS`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maskunet_tpu.ops import attention as ja
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.tools import tpu_kernel_paritycheck as pc

from test_torch_attention import F32, _port_params
from test_torch_softmax_tools import _load_tool


def test_dense_chunked_equals_jax():
    jax_tool = _load_tool("tpu_kernel_paritycheck")
    b, l, c = 2, 256, 64
    rng = np.random.default_rng(0)
    jp = ja.attention_init(jax.random.key(0), c)
    tokens = rng.standard_normal((b, l, c)).astype(np.float32)
    mask = rng.random((b, l)) < 0.5
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax_tool.dense_chunked(
            jp, jnp.asarray(tokens), jnp.asarray(mask), chunk=64))
    got = pc.dense_chunked(_port_params(jp), torch.from_numpy(tokens),
                           torch.from_numpy(mask), chunk=64)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_check_passes_on_the_plain_versions():
    row = pc.check(256, 64, 2, device="cpu")
    assert row["ok"] and row["fwd_err"] < pc.TOL
    assert row["launches"] == {"K1": 0, "K2": 0, "K4": 0}


def test_check_16k_takes_the_compacted_path(monkeypatch):
    compacted = []
    compact = tfa.compact_keys

    def spy(*args, **kw):
        compacted.append(args[0].shape)
        return compact(*args, **kw)

    monkeypatch.setattr(tfa, "COMPACT_MIN_TOKENS", 256)
    monkeypatch.setattr(tfa, "compact_keys", spy)
    row = pc.check_16k(device="cpu", l=512, chunk=128)
    assert row["ok"] and row["b"] == 1
    assert compacted == [(1, 512, 64)] * 2     # the forward, the gradient
