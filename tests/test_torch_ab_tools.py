"""The port's same-process A/B tools on the CPU: `conv_ab`, `conv_model_ab`,
`infer_ab`, `quant_ab`, `plan_ab` and `opt_ab`'s bf16-moment AdamW
(`maskunet_tpu_torch.tools`).

- `conv_ab.SHAPES` equals the JAX tool's table (tools/conv_ab.py, loaded
  by path with JAX's compilation cache pointed at the test's directory).
- The port's im2col conv equals the port's `conv2d` and JAX's
  `conv_im2col` on the same numpy input, f32, within 1e-5 of max|y|
  (summation order only).
- `AdamWBf16Mu` equals `optax.adamw(5e-5, weight_decay=0.1,
  mu_dtype=jnp.bfloat16)` over three updates of the same gradients: the
  parameters within two f32 ulps (2.4e-7 relative: the same arithmetic,
  rounded in another order; one ulp measured), the bf16 first moment and
  the f32 second moment exactly.
- The tools run at 16 px on the CPU with one window a call, one torch
  thread: finite times, their keys, the im2col patch in place through
  every call of its arm and restored after, int8 agreement a share.
"""

import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskunet_tpu_torch.core import layers
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.tools import (conv_ab, conv_model_ab, infer_ab,
                                      opt_ab, plan_ab, quant_ab)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_conv_ab(tmp_path, monkeypatch):
    """tools/conv_ab.py imported by path (tools/ is not a package); its
    import enables JAX's compilation cache, here under tmp_path."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    path = os.path.join(_ROOT, "tools", "conv_ab.py")
    spec = importlib.util.spec_from_file_location("_jax_tool_conv_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_conv_ab_shapes_are_jax_s(jax_conv_ab):
    assert conv_ab.SHAPES == jax_conv_ab.SHAPES
    # one entry for each 3x3 conv of the port's model
    params, _ = mu.init(torch.Generator().manual_seed(0),
                        mu.MaskAttnUNetConfig())
    assert sum(s[-1] for s in conv_ab.SHAPES) == sum(
        v.shape[-2:] == (3, 3) for v in params.values()) == 32


@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 16), (1, 5, 7, 16, 8)])
def test_im2col_equals_the_direct_conv_and_jax(jax_conv_ab, shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k_hwio = (rng.standard_normal((3, 3, cin, cout)) / 10).astype(np.float32)
    k_oihw = torch.from_numpy(k_hwio.transpose(3, 2, 0, 1).copy())
    tx = torch.from_numpy(x)
    got = conv_ab.conv_im2col(tx, k_oihw).numpy()
    direct = conv_ab.conv_direct(tx, k_oihw).numpy()
    jax_y = np.asarray(jax_conv_ab.conv_im2col(jnp.asarray(x),
                                               jnp.asarray(k_hwio)))
    scale = np.abs(direct).max()
    np.testing.assert_allclose(got, direct, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got, jax_y, atol=1e-5 * scale, rtol=0)
    # with a bias, as the in-model patch calls it
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    patched = conv_model_ab.im2col_conv2d(layers.conv2d)(k_oihw, bias, tx)
    np.testing.assert_allclose(
        patched.numpy(), layers.conv2d(k_oihw, bias, tx).numpy(),
        atol=1e-5 * scale, rtol=0)


def test_adamw_bf16_moment_equals_optax():
    rng = np.random.default_rng(1)
    shapes = [(4, 3), (7,), (2, 3, 3, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 0.1).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = optax.adamw(5e-5, weight_decay=0.1, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = opt_ab.AdamWBf16(5e-5, 0.1)(tp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        opt.zero_grad()
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=0,
                                   rtol=2.4e-7)
    mu = np.concatenate([np.asarray(m.astype(jnp.float32)).ravel()
                         for m in state[0].mu])
    nu = np.concatenate([np.asarray(m).ravel() for m in state[0].nu])
    assert state[0].mu[0].dtype == jnp.bfloat16
    assert opt.mu.dtype == torch.bfloat16
    np.testing.assert_array_equal(opt.mu.float().numpy(), mu)
    np.testing.assert_array_equal(opt.nu.numpy(), nu)
    assert all(p.grad is None for p in tp)


def test_conv_ab_runs_on_the_cpu():
    rows = conv_ab.run(1, [(6, 6, 3, 8, 1), (4, 4, 16, 8, 2)],
                       device="cpu", dtype="float32", steps=1, repeats=1)
    assert [r["count"] for r in rows] == [1, 2]
    assert all(r["rel_err"] < 1e-5 and r["direct_us"] > 0
               and r["direct_device_us"] is None for r in rows)


def test_conv_model_ab_keeps_the_patch_through_its_calls(monkeypatch):
    calls = []

    def counted(x, w, bias=None):
        calls.append(tuple(w.shape))
        return conv_ab.conv_im2col(x, w, bias)

    monkeypatch.setattr(conv_model_ab, "conv_im2col", counted)
    before = layers.conv2d
    res = conv_model_ab.run(1, img_size=16, device="cpu", steps=1,
                            rounds=1)
    assert layers.conv2d is before
    # the im2col arm's every call in place: the rel-err forward and a
    # round's warm-up and timed call, 32 3x3 convs a forward, none in the
    # direct arm (the step's arm, `--train`, runs in chip_smoke.py)
    assert len(calls) == 32 * 3
    assert all(c[-2:] == (3, 3) for c in calls)
    # bf16 through the whole model: the formulations may part by rounding
    assert 0 <= res["rel_err"] < 0.5
    assert "train" not in res
    assert set(res["forward"]) == {"direct", "im2col"}
    assert all(math.isfinite(r["best_ms"]) and r["device_ms"] is None
               for r in res["forward"].values())


def test_infer_ab_and_quant_ab_run_on_the_cpu():
    inf = infer_ab.run(1, img_size=16, device="cpu", steps=1, repeats=1)
    assert inf["plain"]["ms"] > 0 and inf["folded"]["ms"] > 0
    assert inf["speedup"] > 0
    q = quant_ab.run(1, img_size=16, device="cpu", steps=1, repeats=1)
    assert set(q) == {"bf16", "int8-dyn", "int8-static", "agree",
                      "agree_static"}
    assert 0.5 < q["agree"] <= 1 and 0.5 < q["agree_static"] <= 1


def test_plan_ab_runs_on_the_cpu():
    res = plan_ab.run(1, 1, img_size=16, device="cpu", rounds=1)
    for part in ("forward", "train"):
        assert set(res[part]) == {"inline", "plan"}
        assert all(math.isfinite(r["ms"]) and len(r["rounds"]) == 1
                   for r in res[part].values())
