"""The port's MaskAttn-UNet against the JAX model, on the JAX weights.

The JAX package makes the weights, inputs and masks (the golden config of
tests/test_golden.py: c_out 11, img 32, embedding and boundary heads);
`utils.jax_weights.from_jax` hands them to the port. Tolerances:

- f32: 1e-4 absolute and relative, the golden test's own bound (f32 noise
  grown through ~25 convs);
- bf16: logits within 4% of their largest magnitude and class maps equal
  on at least 98% of pixels. XLA and torch round bf16 intermediates at
  different places (fused vs unfused epilogues, erf/tanh GELU internals),
  so bf16 runs drift by a few bf16 steps (2^-8 relative each) per layer.

pyproject's `error::DeprecationWarning:maskunet_tpu` filter also matches
`maskunet_tpu_torch` (unanchored regex): the port avoids deprecated torch
calls instead of editing the filter.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.ops import flash_attention as jfa
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.utils import jax_weights

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_forward.npz")
F32 = dict(atol=1e-4, rtol=1e-4)
KW = dict(c_out=11, img_size=32, embed_dim=8, with_boundary_head=True)


@pytest.fixture(scope="module")
def golden_setup():
    """JAX params/state/input/masks of tests/test_golden.py, as numpy."""
    jcfg = jmu.MaskAttnUNetConfig(**KW, attn_impl="dense")
    init = jax.jit(jmu.init, static_argnums=1)
    params, state = jax.tree.map(np.asarray,
                                 init(jax.random.key(1234), jcfg))
    x = np.asarray(jax.random.normal(jax.random.key(5678), (2, 32, 32, 3)))
    masks = tuple(np.asarray(m) for m in jmu.make_attention_masks(
        jax.random.key(91011), 2, 32))
    return params, state, x, masks


def _jax_forward(params, state, x, masks, cfg, folded=False, plans=None):
    fn = jax.jit(lambda p, s, x_: jmu.apply(
        p, s, x_, cfg=cfg, masks=tuple(jnp.asarray(m) for m in masks),
        train=False, folded=folded, mask_plans=plans)[0])
    return jax.tree.map(np.asarray, fn(params, state, x))


def _port_inputs(x, masks):
    return (torch.from_numpy(np.array(x)),
            tuple(torch.from_numpy(np.array(m)) for m in masks))


def test_from_jax_round_trip_and_param_count(golden_setup):
    params, state, _, _ = golden_setup
    cfg = tmu.MaskAttnUNetConfig(**KW)
    tp, ts = jax_weights.from_jax(params, state, cfg)
    # the handed-over dicts have exactly the port's own keys and shapes
    fp, fs = tmu.init(torch.Generator().manual_seed(0), cfg)
    assert {k: v.shape for k, v in tp.items()} == \
        {k: v.shape for k, v in fp.items()}
    assert {k: v.shape for k, v in ts.items()} == \
        {k: v.shape for k, v in fs.items()}
    assert tmu.param_count(tp) == jmu.param_count(params) == \
        tmu.param_count(fp)
    back_p, back_s = jax_weights.to_jax(tp, ts, cfg)
    jax.tree.map(np.testing.assert_array_equal, back_p, params)
    jax.tree.map(np.testing.assert_array_equal, back_s, state)


def test_param_count_flagship():
    """The ADE model: 24,690,690 parameters, as the JAX package counts."""
    cfg = tmu.MaskAttnUNetConfig(c_out=150)
    params, _ = tmu.init(torch.Generator().manual_seed(0), cfg)
    assert tmu.param_count(params) == 24_690_690


def test_eval_apply_matches_jax_and_golden(golden_setup):
    params, state, x, masks = golden_setup
    want = _jax_forward(params, state, x, masks,
                        jmu.MaskAttnUNetConfig(**KW, attn_impl="dense"))
    cfg = tmu.MaskAttnUNetConfig(**KW)          # 'auto' -> flash
    tp, ts = jax_weights.from_jax(params, state, cfg)
    tx, tm = _port_inputs(x, masks)
    with torch.no_grad():
        got, _ = tmu.apply(tp, ts, tx, cfg=cfg, masks=tm)
    golden = np.load(GOLDEN)
    for key in ("semantic", "boundary", "embeddings"):
        g = getattr(got, key).numpy()
        np.testing.assert_allclose(g, getattr(want, key), **F32,
                                   err_msg=key)
        np.testing.assert_allclose(g, golden[key], **F32, err_msg=key)


def _perturb_bn(params, state, seed=0):
    """Random BN affines and running stats, so folding has work to do."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k in p:
            if isinstance(p[k], dict) and "scale" in p[k] and k in s:
                c = p[k]["scale"].shape
                p[k] = {"scale": rng.uniform(0.5, 1.5, c).astype("f4"),
                        "offset": rng.normal(0, 0.1, c).astype("f4")}
                s[k] = {"mean": rng.normal(0, 0.1, c).astype("f4"),
                        "var": rng.uniform(0.5, 1.5, c).astype("f4")}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    params = jax.tree.map(lambda a: a, params)
    state = jax.tree.map(lambda a: a, state)
    walk(params, state)
    return params, state


def test_folded_flash_matches_jax(golden_setup, monkeypatch):
    """Folded BN + the flash path, with compaction on (COMPACT_MIN_TOKENS
    lowered in both packages so the 256- and 1024-token layers compact at
    img 32), against JAX folded + Pallas (interpret)."""
    monkeypatch.setattr(jfa, "COMPACT_MIN_TOKENS", 256)
    monkeypatch.setattr(tfa, "COMPACT_MIN_TOKENS", 256)
    params, state = _perturb_bn(*golden_setup[:2])
    _, _, x, masks = golden_setup
    jcfg = jmu.MaskAttnUNetConfig(**KW, attn_impl="flash")
    jfold = jmu.fold_bn_for_inference(params, state, jcfg)
    jplans = jmu.precompute_mask_plans(tuple(jnp.asarray(m) for m in masks))
    assert sum(p is not None for p in jplans) == 3
    want = _jax_forward(jfold, None, x, masks, jcfg, folded=True,
                        plans=jplans)
    cfg = tmu.MaskAttnUNetConfig(**KW)
    tp, ts = jax_weights.from_jax(params, state, cfg)
    tfold = tmu.fold_bn_for_inference(tp, ts, cfg)
    assert not any(".conv_block.1." in k or ".conv_block.4." in k
                   for k in tfold)
    tx, tm = _port_inputs(x, masks)
    tplans = tmu.precompute_mask_plans(tm)
    with torch.no_grad():
        got, _ = tmu.apply(tfold, None, tx, cfg=cfg, masks=tm, folded=True,
                           mask_plans=tplans)
        unfolded, _ = tmu.apply(tp, ts, tx, cfg=cfg, masks=tm)
    for key in ("semantic", "boundary", "embeddings"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   getattr(want, key), **F32, err_msg=key)
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   getattr(unfolded, key).numpy(), **F32,
                                   err_msg=key)


def test_bf16_folded_cast_matches_jax(golden_setup):
    params, state, x, masks = golden_setup
    jcfg = jmu.MaskAttnUNetConfig(**KW, attn_impl="flash",
                                  compute_dtype="bfloat16")
    jinfer = jmu.cast_params_for_inference(
        jmu.fold_bn_for_inference(params, state, jcfg))
    want = _jax_forward(jinfer, None, x, masks, jcfg, folded=True)
    cfg = tmu.MaskAttnUNetConfig(**KW, compute_dtype="bfloat16")
    tp, ts = jax_weights.from_jax(params, state, cfg)
    tinfer = tmu.cast_params_for_inference(
        tmu.fold_bn_for_inference(tp, ts, cfg))
    assert tinfer["downsample1.maxpool_conv.1.conv_block.0.weight"].dtype \
        == torch.bfloat16
    assert tinfer["self_attention1.query.weight"].dtype == torch.bfloat16
    assert tinfer["norm.weight"].dtype == torch.float32
    assert tinfer["self_attention1.norm.weight"].dtype == torch.float32
    tx, tm = _port_inputs(x, masks)
    with torch.no_grad():
        got, _ = tmu.apply(tinfer, None, tx, cfg=cfg, masks=tm, folded=True)
    assert got.semantic.dtype == torch.bfloat16
    g = got.semantic.float().numpy()
    w = np.asarray(jnp.asarray(want.semantic).astype(jnp.float32))
    assert np.abs(g - w).max() <= 0.04 * np.abs(w).max()
    assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.98


def test_later_slices_raise():
    """Meshes still raise (the parallel slice); train mode (with or without
    remat) now runs and returns the new running stats of every BN, and
    int8 serving (the serving-extras slice) quantizes every conv, its
    calibration refusing a run that recorded nothing."""
    cfg = tmu.MaskAttnUNetConfig(c_out=4, img_size=16)
    params, state = tmu.init(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="dropout_generator"):
        tmu.apply(params, state, x, cfg=cfg, train=True)
    for remat in (False, True):
        _, new_state = tmu.apply(
            params, state, x, train=True,
            cfg=tmu.MaskAttnUNetConfig(c_out=4, img_size=16,
                                       remat_attention=remat),
            dropout_generator=torch.Generator().manual_seed(0))
        assert set(new_state) == set(state)
    with pytest.raises(NotImplementedError, match="parallel slice"):
        tmu.apply(params, state, x, cfg=cfg, mesh=object())
    quantized = tmu.quantize_params_for_inference(params)
    assert quantized["final_layer.0.kernel_q"].dtype == torch.int8
    assert "final_layer.0.weight" not in quantized
    with pytest.raises(RuntimeError, match="recorded no conv activations"):
        tmu.calibrate_activation_scales(params, None, [])


def test_masks_and_plans_layout():
    masks = tmu.make_attention_masks(torch.Generator().manual_seed(0), 2, 128)
    assert [m.shape[1] for m in masks] == list(tmu.attention_mask_sizes(128))
    plans = tmu.precompute_mask_plans(masks)
    assert [p is not None for p in plans] == [True, False, False, False,
                                              True, True]
    assert plans[5].idx.shape == (2, 9216)
    assert tmu.precompute_mask_plans(None) is None
