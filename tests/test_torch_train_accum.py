"""Gradient accumulation and the eval step of the port against JAX.

`grad_accum=2` (a batch of 4 as two microbatches of 2, gradients averaged
into one AdamW update, BN running stats threaded through) against JAX's
`make_train_step(grad_accum=2)`, with the checks and tolerances of
tests/test_torch_train.py (whose set-up this file shares; microbatches of
one image would leave the bottleneck BatchNorm 4 pixels, whose f32 noise
flips gradient signs well above that file's bounds in either package);
and
`make_eval_step` (running stats, no dropout, K1's plain version) against
JAX's: metrics within 1e-5 relative (mIoU 1e-3), `pred` equal, `prob`
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskunet_tpu.core import state as jstate
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.train import step as jstep
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.train import step as tstep

from test_torch_train import IMG, NC, Setup, compare_step, port_step


def test_grad_accum_2_matches_jax(monkeypatch):
    setup = Setup(batch=4)
    # each microbatch draws its dropout masks at the microbatch's shape
    setup.keep = {(2,) + s[1:]: m[:2] for s, m in setup.keep.items()}
    setup.patch(monkeypatch)
    compare_step(setup, setup.jax_step(grad_accum=2),
                 port_step(setup, grad_accum=2))


@pytest.mark.parametrize("valid_rows", [None, (True, False)])
def test_eval_step_matches_jax(monkeypatch, valid_rows):
    setup = Setup()
    setup.patch(monkeypatch)
    masks = tuple(map(jnp.asarray, setup.masks(setup.batch)))
    ts = jstate.create(jax.random.key(2),
                       jax.tree.map(jnp.asarray, setup.params),
                       jax.tree.map(jnp.asarray, setup.mstate),
                       optax.identity(),
                       masks=masks)
    batch = {"image": setup.x, "label": setup.y}
    if valid_rows is not None:
        batch["valid"] = np.asarray(valid_rows)
    want = jax.jit(jstep.make_eval_step(setup.cfg, jstep.TaskConfig()))(
        ts, jax.tree.map(jnp.asarray, batch),
        jmu.precompute_mask_plans(masks))
    cfg = tmu.MaskAttnUNetConfig(c_out=NC, img_size=IMG)
    tts = setup.port_state(cfg, setup.batch)
    step = tstep.make_eval_step(cfg, tstep.TaskConfig(), device="cpu")
    got = step(tts, {k: torch.from_numpy(np.asarray(v)) for k, v in
                     batch.items()}, tmu.precompute_mask_plans(tts.masks))
    for key in ("loss", "ce_loss"):
        np.testing.assert_allclose(float(got["metrics"][key]),
                                   float(want["metrics"][key]), rtol=1e-5)
    assert abs(float(got["metrics"]["miou"])
               - float(want["metrics"]["miou"])) <= 1e-3
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    np.testing.assert_allclose(got["prob"].numpy(), np.asarray(want["prob"]),
                               atol=1e-5, rtol=1e-5)
