"""The serving extras on the card: the flash operators that exported
artifacts call, and the int8 conv.

This file imports neither jax nor the JAX package, so it runs on a machine
with the card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_export_card.py

On the CPU every test skips (the kernels have no CPU mode, and `_int_mm`
on the card is what is tested).
"""

import pytest
import torch

from maskunet_tpu_torch.core import layers
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.ops import flash_attention as fa
from maskunet_tpu_torch.ops import flash_kernels as fk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(c, dtype, device, b=3, lq=200, lk=150, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(b, lq, c, generator=g, device=device)
         * c ** -0.5).to(dtype)
    k = torch.randn(b, lk, c, generator=g, device=device).to(dtype)
    v = torch.randn(b, lk, c, generator=g, device=device).to(dtype)
    mask = torch.rand(b, lk, generator=g, device=device) < 0.5
    return q, k, v, fa.mask_to_bias(mask, b, lk)


@pytest.mark.cuda
@pytest.mark.parametrize("c", fk.KERNEL_CHANNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operators_on_card_equal_the_direct_launches(cuda, c, dtype):
    """`maskunet::flash_fwd_nomax` (K1) and `maskunet::flash_fwd_online`
    (K3), the calls an exported artifact makes, launch the same kernels
    as the eager wrappers: equal outputs, one launch counted each."""
    q, k, v, bias = _inputs(c, dtype, cuda, seed=c)
    for use_valid in (True, False):
        before = fk.flash_fwd_nomax.launches
        got = torch.ops.maskunet.flash_fwd_nomax(q, k, v, bias, 1.0,
                                                 use_valid)
        want = fk.flash_fwd_nomax(q, k, v, bias, 1.0, use_valid)
        torch.cuda.synchronize()
        assert fk.flash_fwd_nomax.launches == before + 2
        assert torch.equal(got, want)
        before = fk.flash_fwd_online.launches
        got = torch.ops.maskunet.flash_fwd_online(q, k, v, bias, 1.0,
                                                  use_valid)
        want = fk.flash_fwd_online(q, k, v, bias, 1.0, use_valid)
        torch.cuda.synchronize()
        assert fk.flash_fwd_online.launches == before + 2
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _model_conv_shapes(device) -> list:
    """(input shape at batch 1, kernel shape) of every conv of the ADE
    model at 128 px (c_out 150), recorded from one float forward."""
    cfg = mu.MaskAttnUNetConfig(c_out=150, img_size=128)
    params, state = mu.init(torch.Generator(device=device).manual_seed(0),
                            cfg)
    with torch.no_grad():
        folded = mu.fold_bn_for_inference(params, state, cfg)
    shapes = []
    with torch.no_grad(), layers.recording_conv_inputs(
            lambda w, x: shapes.append((tuple(x.shape), tuple(w.shape)))):
        mu.apply(folded, None, torch.rand(1, 128, 128, 3, device=device),
                 cfg=cfg, folded=True)
    return shapes


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_int8_conv_on_card_equals_cpu_at_every_model_shape(cuda, batch):
    """At each of the model's 33 conv shapes (batch 1, 2 and 8: the rows
    of cuBLASLt's int8 product), the int8 conv on the card
    (`torch._int_mm`) gives the CPU's int32 sums exactly and, from the
    same float input, the same dequantized output."""
    shapes = _model_conv_shapes(cuda)
    assert len(shapes) == 33
    g = torch.Generator().manual_seed(batch)
    for (_, h, w, c), (o, _, kh, kw) in sorted(set(shapes)):
        kq = torch.randint(-127, 128, (o, c, kh, kw), generator=g,
                           dtype=torch.int8)
        xq = torch.randint(-127, 128, (batch, h, w, c), generator=g,
                           dtype=torch.int8)
        want = layers.conv2d_int8_accumulate(xq, kq)
        got = layers.conv2d_int8_accumulate(xq.to(cuda), kq.to(cuda))
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want), (batch, h, w, c, o, kh)
        if batch != 2:
            continue
        x = torch.randn(batch, h, w, c, generator=g) * 3.0
        w_scale = torch.rand(o, generator=g) * 1e-2
        bias = torch.randn(o, generator=g)
        want = layers.conv2d_int8(kq, w_scale, bias, x)
        got = layers.conv2d_int8(kq.to(cuda), w_scale.to(cuda),
                                 bias.to(cuda), x.to(cuda))
        assert torch.equal(got.cpu(), want), (h, w, c, o, kh)


@pytest.mark.cuda
def test_quantized_weights_on_card_equal_cpu(cuda):
    """`quantize_params_for_inference` on the card gives the CPU's int8
    kernels and scales bit for bit (its divisions are true divisions on
    both)."""
    cfg = mu.MaskAttnUNetConfig(c_out=150, img_size=128)
    params, state = mu.init(torch.Generator().manual_seed(2), cfg)
    with torch.no_grad():
        folded = mu.fold_bn_for_inference(params, state, cfg)
    want = mu.quantize_params_for_inference(folded)
    got = mu.quantize_params_for_inference(
        {k: v.to(cuda) for k, v in folded.items()})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
