"""The port's breakdown tools (`maskunet_tpu_torch.tools.fwd_breakdown`,
`.train_breakdown`, `.trunk_breakdown`) on the CPU.

They time the eager model with module attributes patched, so what is
checked is the patching:

- each mode's attention dispatch reaches exactly the layers its token
  count names (the 128 px layers: attn6 has 16,384 tokens, attn1 and
  attn5 4,096), with the attention itself stubbed to record its calls;
- every patch is the original again after each mode, also after an
  exception, in the tools' own code paths;
- a patch is in place through every timed call (a patch restored too
  early would time the full model under every label);
- the `noattn` forward equals JAX's `mu.apply` with its
  `spatial_attention` patched to the identity (32 px, f32, one JAX
  compile, on weights from `from_jax`), within the model tests' f32
  bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.ops import attention as jattention
from maskunet_tpu_torch.core import layers
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.ops import attention, metrics_ops
from maskunet_tpu_torch.tools import fwd_breakdown, train_breakdown
from maskunet_tpu_torch.tools import trunk_breakdown
from maskunet_tpu_torch.train import step as step_lib
from maskunet_tpu_torch.utils import jax_weights

F32 = dict(atol=1e-4, rtol=1e-4)
# the six attention layers at 128 px: attn1..attn6's token counts
LAYERS_128 = dict(zip(range(1, 7), tmu.attention_mask_sizes(128)))
PATCHED = ((attention, "spatial_attention"), (layers, "gelu"),
           (layers, "layernorm"), (layers, "upsample_2x_bilinear"),
           (layers, "batchnorm_train"), (metrics_ops, "mean_iou"),
           (step_lib, "cross_entropy"))
# attention layers each mode lets through (dense: through the dense path)
FWD_REACHES = {
    "full": {1, 2, 3, 4, 5, 6}, "noattn": set(), "no16k": {1, 2, 3, 4, 5},
    "no4k": {2, 3, 4, 6}, "nosmall": {1, 5, 6}, "dense_small": {1, 2, 3,
                                                                 4, 5, 6}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the model runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _originals():
    return [getattr(mod, name) for mod, name in PATCHED]


def _recorder(reached):
    def stub(p, xx, km, *, impl, plan, **kw):
        layer = int(xx[0, 0, 0, 0])
        reached[layer] = impl
        assert plan is (None if impl == "dense" else "plan")
        return xx * 0
    return stub


def test_attention_modes_reach_the_layers_their_token_counts_name(
        monkeypatch):
    for mode, want in FWD_REACHES.items():
        reached = {}
        dispatch = fwd_breakdown.attention_for(mode, _recorder(reached))
        for i, l in LAYERS_128.items():
            side = int(l ** 0.5)
            x = torch.full((1, side, side, 1), float(i))
            out = dispatch({}, x, None, impl="flash", plan="plan")
            assert (out is x) == (i not in want), (mode, i)
        assert set(reached) == want, mode
        small = {i for i, l in LAYERS_128.items() if l < 4096}
        assert {i for i, impl in reached.items() if impl == "dense"} == (
            small if mode == "dense_small" else set()), mode
    # the step's modes: its attention modes, and 'full' for the others
    train_reaches = {"noattn": set(), "no16k": {1, 2, 3, 4, 5},
                     "no4k": {2, 3, 4, 6}}
    for mode in train_breakdown.MODES:
        reached = {}
        monkeypatch.setattr(attention, "spatial_attention",
                            _recorder(reached))
        (mod, name, dispatch), *_ = train_breakdown.mode_patches(mode)
        assert (mod, name) == (attention, "spatial_attention")
        for i, l in LAYERS_128.items():
            side = int(l ** 0.5)
            dispatch({}, torch.full((1, side, side, 1), float(i)), None,
                     impl="flash", plan="plan")
        assert set(reached) == train_reaches.get(mode, set(LAYERS_128))


@pytest.mark.parametrize("patches", [
    *(lambda m=m: train_breakdown.mode_patches(m)
      for m in train_breakdown.MODES),
    *(lambda v=v: trunk_breakdown.variant_patches(v)
      for v in trunk_breakdown.VARIANTS)],
    ids=[*train_breakdown.MODES, *trunk_breakdown.VARIANTS])
def test_each_patch_is_restored_after_an_exception(patches):
    before = _originals()
    listed = patches()
    with pytest.raises(RuntimeError, match="inside"):
        with fwd_breakdown.patched(*listed):
            now = _originals()
            for mod, name, value in listed:
                assert getattr(mod, name) is value
            assert now != before or not listed
            raise RuntimeError("inside")
    assert _originals() == before


def _counting(monkeypatch, mod, name):
    """Wraps mod.name to count its calls."""
    calls = []
    real = getattr(mod, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


def _timed_counts(monkeypatch, tool, calls):
    """Wraps tool.timeit to record the counted calls inside each timing."""
    seen = []
    real = tool.timeit

    def timeit(fn, fence, **kw):
        n = len(calls)
        out = real(fn, fence, **kw)
        seen.append(len(calls) - n)
        return out

    monkeypatch.setattr(tool, "timeit", timeit)
    return seen


def test_forward_patches_hold_through_the_timed_calls(monkeypatch):
    """At 16 px, batch 1, one window of 2 calls (and the warm-up): the
    real attention runs 6 times a call under 'full' and never under
    'noattn'; the real GELU never under the trunk's 'no_gelu'; both are
    the originals afterwards."""
    attn_calls = _counting(monkeypatch, attention, "spatial_attention")
    seen = _timed_counts(monkeypatch, fwd_breakdown, attn_calls)
    before = _originals()
    res = fwd_breakdown.run(1, ("full", "noattn"), steps=2, repeats=1,
                            img_size=16, device="cpu")
    assert seen == [6 * 3, 0]
    assert res["noattn"]["device_ms"] is None
    assert _originals() == before
    gelu_calls = _counting(monkeypatch, layers, "gelu")
    seen = _timed_counts(monkeypatch, fwd_breakdown, gelu_calls)
    monkeypatch.setattr(trunk_breakdown, "timeit", fwd_breakdown.timeit)
    before = _originals()
    res = trunk_breakdown.run(1, ("trunk", "no_gelu"), steps=2, repeats=1,
                              img_size=16, device="cpu")
    assert seen[0] > 0 and seen[1] == 0
    assert res["no_gelu"]["mean"] != res["trunk"]["mean"]
    assert _originals() == before


def test_step_patches_hold_and_are_restored_after_a_failure(monkeypatch):
    """The step's 'nobnstat' mode at 16 px: the real train BatchNorm never
    runs inside the timed calls, and a failure inside the timing leaves
    every original in place."""
    bn_calls = _counting(monkeypatch, layers, "batchnorm_train")
    seen = _timed_counts(monkeypatch, fwd_breakdown, bn_calls)
    monkeypatch.setattr(train_breakdown, "timeit", fwd_breakdown.timeit)
    before = _originals()
    row = train_breakdown.timed_step("nobnstat", 1, steps=1, repeats=1,
                                     img_size=16, device="cpu")
    assert seen == [0] and np.isfinite(row["loss"])
    assert _originals() == before

    def fails(*a, **kw):
        raise RuntimeError("timing failed")

    monkeypatch.setattr(train_breakdown, "timeit", fails)
    with pytest.raises(RuntimeError, match="timing failed"):
        train_breakdown.timed_step("nogelu", 1, img_size=16, device="cpu")
    assert _originals() == before


def test_noattn_forward_equals_jax(monkeypatch):
    """The weights are the port's init carried to JAX's layout by
    `to_jax`, and back by `from_jax`."""
    img, batch = 32, 2
    cfg = tmu.MaskAttnUNetConfig(c_out=150, img_size=img)
    jcfg = jmu.MaskAttnUNetConfig(c_out=150, img_size=img)
    params, state = jax_weights.to_jax(
        *tmu.init(torch.Generator().manual_seed(0), cfg), cfg)
    x = np.random.default_rng(0).standard_normal(
        (batch, img, img, 3)).astype(np.float32)
    monkeypatch.setattr(jattention, "spatial_attention",
                        lambda p, xx, km, **kw: xx)
    want = np.asarray(jax.jit(lambda p, s, x_: jmu.apply(
        jmu.fold_bn_for_inference(p, s, jcfg), None, x_, cfg=jcfg,
        train=False, folded=True)[0].semantic)(params, state,
                                               jnp.asarray(x)))

    tp, ts = jax_weights.from_jax(params, state, cfg)
    with torch.no_grad():
        tfold = tmu.fold_bn_for_inference(tp, ts, cfg)
    fwd = fwd_breakdown.make_forward(cfg, tfold, torch.from_numpy(x), None,
                                     None)
    before = _originals()
    with fwd_breakdown.patched((attention, "spatial_attention",
                                fwd_breakdown.attention_for(
                                    "noattn", attention.spatial_attention))):
        got = fwd().numpy()
    assert _originals() == before
    np.testing.assert_allclose(got, want, **F32)
