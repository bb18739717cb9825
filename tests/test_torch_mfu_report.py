"""The port's FLOPs account (`maskunet_tpu_torch.tools.mfu_report`) against
the JAX tool's (tools/mfu_report.py, imported by path).

`model_flops` must return the same integers as JAX's at every size, with
compaction and without, for both class counts the recipes use; it reads
the port's own `_key_capacity` and `COMPACT_MIN_TOKENS`, which must equal
JAX's at the sizes the 128 and 256 px models compact. Exact: both are
integer arithmetic.
"""

import functools
import json

import pytest
import torch

from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.tools import mfu_report

from test_torch_softmax_tools import _load_tool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the model runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tool():
    return _load_tool("mfu_report")


@pytest.mark.parametrize("c_out", [150, 19])
@pytest.mark.parametrize("compacted", [True, False])
@pytest.mark.parametrize("img", [32, 128, 256])
def test_model_flops_equal_jax(jax_tool, img, compacted, c_out):
    got = mfu_report.model_flops(img, c_out, compacted)
    want = jax_tool.model_flops(img, c_out, compacted)
    assert got == want
    assert all(type(v) is int for v in got.values())


@pytest.mark.parametrize("l", [4096, 16384, 65536])
def test_key_capacity_equal_jax(l):
    assert tfa._key_capacity(l) == jfa._key_capacity(l)
    assert tfa.COMPACT_MIN_TOKENS == jfa.COMPACT_MIN_TOKENS


def test_flops_at_256_px():
    """The 256 px forward: attn2 and attn4 (4,096 tokens) compact to 2,560
    slots and attn6 (65,536) to 34,304, so the dense attention count is
    larger; the train step is more than twice the forward."""
    fl = mfu_report.model_flops(256)
    dense = mfu_report.model_flops(256, compacted=False)
    assert fl["conv_fwd"] == dense["conv_fwd"]
    assert fl["attn_fwd"] < dense["attn_fwd"]
    assert 2 * fl["fwd"] < fl["train"] < 4 * fl["fwd"]
    assert mfu_report.mfu(fl["fwd"], 8, 1000.0) == pytest.approx(
        8 * fl["fwd"] / mfu_report.H100_PEAK_BF16)
    assert mfu_report.mfu(fl["fwd"], 8, None) is None


def test_main_on_cpu(capsys, monkeypatch):
    """`main` at 16 px on the CPU (one call a timing window): the FLOPs
    lines, then one JSON line with wall times, no device times, and the
    JAX tool's FLOPs."""
    monkeypatch.setattr(mfu_report, "measure", functools.partial(
        mfu_report.measure, fwd_iters=1, train_iters=1))
    out = mfu_report.main(["1", "--img", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("per-image tensor-core FLOPs @16^2")
    assert json.loads(lines[-1]) == out
    assert out["gflop_fwd_per_image"] == mfu_report.model_flops(16)["fwd"] / 1e9
    assert out["fwd_ms"] > 0 and out["train_ms"] > 0
    assert 0 < out["fwd_mfu_wall"] < 1 and 0 < out["train_mfu_wall"] < 1
    assert out["fwd_device_ms"] is None and out["fwd_mfu_device"] is None
    assert out["card"] is None
