"""The 256 px configuration of the port against the JAX package, and the
port's `tools/res256_bench.py` on the CPU.

At 256 px the attention layers see 16,384 (attn1, attn5), 4,096 (attn2,
attn4), 1,024 (attn3) and 65,536 (attn6) tokens: attn2 (C 256) and attn4
(C 128) compact for the first time (2,560 slots), attn6 to 34,304. The
mask sizes, which layers compact and each plan's slot count must equal
JAX's (batch 2, no forward); the compacted flash layer at attn2's shape
(batch 1, L 4,096, C 256) must match JAX's (its Pallas kernel in
interpret mode, ~3 s) in f32 to 2e-5 (summation order only, as
tests/test_torch_attention.py). The tool's `run` returns the JAX tool's
row keys (tools/res256_bench.py:291-298) plus its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.ops import attention as ja
from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.tools import res256_bench

from test_torch_attention import F32, _port_params

IMG, BATCH = 256, 2
# tools/res256_bench.py:291-298 (hbm_* only where XLA's memory analysis
# answers, which has no counterpart in the port)
JAX_ROW_KEYS = {"phase", "img_size", "batch", "images_per_sec",
                "ms_per_image", "peak_hbm_gib"}
PORT_ROW_KEYS = {"wall_ms", "device_ms", "card", "calls", "launches"}
TRAIN_ROW_KEYS = {"loss_first", "loss_last", "losses"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the model runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mask_sizes_and_plans_equal_jax():
    assert tmu.attention_mask_sizes(IMG) == jmu.attention_mask_sizes(IMG) \
        == (16384, 4096, 1024, 4096, 16384, 65536)
    jmasks = jmu.make_attention_masks(jax.random.key(1), BATCH, IMG)
    tmasks = tmu.make_attention_masks(torch.Generator().manual_seed(1),
                                      BATCH, IMG)
    assert [tuple(m.shape) for m in tmasks] == [m.shape for m in jmasks]
    jplans = jmu.precompute_mask_plans(jmasks)
    tplans = tmu.precompute_mask_plans(tmasks)
    compacts = [p is not None for p in tplans]
    assert compacts == [p is not None for p in jplans] \
        == [True, True, False, True, True, True]
    for tp, jp in zip(tplans, jplans):
        if tp is None:
            continue
        assert tuple(tp.idx.shape) == jp.idx.shape
        assert tuple(tp.valid.shape) == jp.valid.shape
        assert tuple(tp.bad.shape) == jp.bad.shape
        # a Bernoulli(0.5) mask fits its capacity: no row is poisoned
        assert not bool(tp.bad.any()) and not bool(np.asarray(jp.bad).any())
    assert [p.idx.shape[1] for p in tplans if p is not None] == \
        [9216, 2560, 2560, 9216, 34304]


def test_plans_identical_to_jax_on_the_same_masks():
    """The plans of one set of 256 px masks (JAX's, as numpy) are equal,
    slot for slot, in both packages."""
    jmasks = jmu.make_attention_masks(jax.random.key(3), BATCH, IMG)
    jplans = jmu.precompute_mask_plans(jmasks)
    tplans = tmu.precompute_mask_plans(
        tuple(torch.from_numpy(np.array(m)) for m in jmasks))
    for tp, jp in zip(tplans, jplans):
        if tp is None:
            assert jp is None
            continue
        np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
        np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
        np.testing.assert_array_equal(tp.bad.numpy(), np.asarray(jp.bad))


def test_flash_layer_compacted_c256_equals_jax():
    """attn2's 256 px shape at batch 1: 4,096 tokens of C 256, compacted to
    2,560 key slots, K1 without use_valid (its plain version here)."""
    rng = np.random.default_rng(0)
    jp = ja.attention_init(jax.random.key(0), 256)
    tokens = rng.standard_normal((1, 4096, 256)).astype(np.float32)
    mask = rng.integers(0, 2, (1, 4096)).astype(bool)
    want = jfa.masked_attention_flash(jp, jnp.asarray(tokens),
                                      jnp.asarray(mask))
    got = tfa.masked_attention_flash(_port_params(jp),
                                     torch.from_numpy(tokens),
                                     torch.from_numpy(mask))
    k_c, _, valid = tfa.compact_keys(torch.zeros(1, 4096, 256),
                                     torch.zeros(1, 4096, 256),
                                     torch.from_numpy(mask))
    assert tuple(k_c.shape) == (1, 2560, 256)
    assert int(valid.sum()) == int(mask.sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("train", [False, True])
def test_run_returns_jax_keys(train):
    """`run` at 32 px on the CPU, one timed call: the JAX tool's keys, the
    port's, finite numbers; no launch on the CPU."""
    row = res256_bench.run(32, 1, 1, train, device="cpu")
    keys = JAX_ROW_KEYS | PORT_ROW_KEYS | (TRAIN_ROW_KEYS if train else set())
    assert set(row) == keys
    assert row["phase"] == ("train" if train else "inference")
    assert (row["img_size"], row["batch"], row["calls"]) == (32, 1, 2)
    assert row["images_per_sec"] > 0 and row["ms_per_image"] > 0
    assert row["peak_hbm_gib"] is None and row["device_ms"] is None
    assert row["card"] is None
    assert row["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    if train:
        assert np.isfinite(row["loss_first"]) and np.isfinite(row["loss_last"])
