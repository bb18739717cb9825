"""The frozen FLOP count and roofline bounds against the program's own
arithmetic, which they were copied from."""

import sys

import pytest
import torch

from perfbench.harness import flops, spec
from perfbench.reference.model import attention_lengths

ADE = spec.load_cell("ade_semantic.train_256")["config"]


def _all_visible(img, rows=1):
    return tuple(torch.ones(rows, n, dtype=torch.bool)
                 for n in attention_lengths(img))


@pytest.mark.parametrize("img", [128, 256])
def test_model_flops_equal_mfu_report_all_visible(img):
    from maskunet_tpu_torch.tools.mfu_report import model_flops
    ours = flops.model_flops(img, ADE, _all_visible(img))
    theirs = model_flops(img, ADE["c_out"], compacted=False)
    assert ours["fwd"] == theirs["fwd"]
    assert ours["train"] == theirs["train"]


def test_masks_count_visible_pairs():
    img = 32
    masks = tuple(torch.zeros(2, m.shape[1], dtype=torch.bool)
                  for m in _all_visible(img, 2))
    none = flops.model_flops(img, ADE, masks)
    full = flops.model_flops(img, ADE, _all_visible(img, 2))
    assert none["fwd"] < full["fwd"]
    assert none["fwd"] == 2 * flops.conv_flops(img, ADE) + sum(
        2 * 2 * lq * c * 3 * c for lq, c in zip(
            (256, 64, 16, 64, 256, 1024), (128, 256, 256, 128, 64, 64)))


@pytest.fixture
def chip_smoke(monkeypatch):
    sys.path.insert(0, str(spec.HERE.parent))
    import chip_smoke as cs
    # the yardstick's bf16 peak is the spec's 989.4e12 (mfu_report's)
    monkeypatch.setitem(cs.PEAK, torch.bfloat16, flops.PEAK_BF16)
    return cs


@pytest.mark.parametrize("lq,vis,c", [(16384, 4608, 64), (4096, 2000, 128),
                                      (1024, 1024, 256), (256, 3, 256)])
def test_bounds_equal_chip_smoke(chip_smoke, lq, vis, c):
    from maskunet_tpu_torch.ops import flash_attention as fa
    rows = 2
    q = torch.zeros(rows, lq, c, dtype=torch.bfloat16)
    k = torch.zeros(rows, vis, c, dtype=torch.bfloat16)
    bias = fa.mask_to_bias(torch.ones(rows, vis, dtype=torch.bool), rows,
                           vis)
    want = max(chip_smoke.bound_ms(q, k, bias)) / 1e3
    assert flops.attn_fwd_bound_s(rows, lq, rows * vis, c) == \
        pytest.approx(want, rel=1e-12)
    want = max(chip_smoke.bwd_bound_ms(q, k, bias)) / 1e3
    assert flops.attn_bwd_bound_s(rows, lq, rows * vis, c) == \
        pytest.approx(want, rel=1e-12)


def test_kernel_kind_equals_chip_smoke(chip_smoke):
    from perfbench.harness.trace import kernel_kind
    names = ["void (anonymous namespace)::fwd_nomax_wgmma<64>",
             "void (anonymous namespace)::bwd_wgmma<64>",
             "sm90_xmma_gemm_bf16", "nvjet_tst", "reduce_kernel<512, 1>",
             "Memcpy HtoD (Pageable -> Device)", "Memset (Device)",
             "void at::native::elementwise_kernel<128, 4>",
             "direct_copy_kernel_cuda", "cudnn::detail::conv", "other_op"]
    for n in names:
        assert kernel_kind(n) == chip_smoke.kernel_kind(n)
