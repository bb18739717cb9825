"""The port's loss, metrics and optimizer against the JAX package's.

Cross-entropy (maskunet_tpu_torch.losses), the segmentation metrics
(maskunet_tpu_torch.ops.metrics_ops) and `torch.optim.AdamW` as
`train.loop.make_optimizer` builds it, against `losses.cross_entropy`,
`ops.metrics_ops` and `optax.adamw`, on the same numpy inputs. Counts are
equal exactly; f32 values within 1e-6 (AdamW over 3 steps: the same
update in another order of f32 operations) or 1e-5 (the loss, a mean over
512 pixels).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskunet_tpu.losses import cross_entropy as jce
from maskunet_tpu.ops import metrics_ops as jmo
from maskunet_tpu_torch.losses import cross_entropy as tce
from maskunet_tpu_torch.ops import metrics_ops as tmo
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop


def _logits_labels(rng, n=5):
    logits = rng.standard_normal((2, 16, 16, n)).astype(np.float32) * 2
    labels = rng.integers(0, n, (2, 16, 16))
    labels[0, :2] = 255            # ignore pixels
    labels[1, :3] = -1             # padded rows
    return logits, labels


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_cross_entropy_matches_jax(rng, ignore_index):
    logits, labels = _logits_labels(rng)
    want = jce.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             ignore_index)
    got = tce.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), ignore_index)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert got.dtype == torch.float32


def test_cross_entropy_all_ignored_and_gradient(rng):
    logits = torch.from_numpy(_logits_labels(rng)[0]).requires_grad_()
    labels = torch.full((2, 16, 16), -1)
    loss = tce.cross_entropy(logits, labels)
    assert float(loss.detach()) == 0.0   # denominator floored at 1
    loss.backward()
    assert torch.equal(logits.grad, torch.zeros_like(logits))


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_iou_and_mean_iou_match_jax(rng, ignore_index):
    logits, labels = _logits_labels(rng)
    jl_, jlab = jnp.asarray(logits), jnp.asarray(labels)
    tl_, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    pred = tmo.predictions(tl_)
    np.testing.assert_array_equal(pred.numpy(),
                                  np.asarray(jmo.predictions(jl_)))
    ji, ju = jmo.iou_counts(jmo.predictions(jl_), jlab, 5, ignore_index)
    ti, tu = tmo.iou_counts(pred, tlab, 5, ignore_index)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(
        float(tmo.mean_iou(tl_, tlab, 5, ignore_index=ignore_index)),
        float(jmo.mean_iou(jl_, jlab, 5, ignore_index=ignore_index)),
        rtol=1e-6)


def test_predictions_ties_and_probabilities(rng):
    """ReLU'd logits tie at 0 often: both packages take the first class."""
    logits = np.maximum(rng.standard_normal((2, 8, 8, 6)), 0).astype(
        np.float32)
    logits[0, 0] = 0.0
    np.testing.assert_array_equal(
        tmo.predictions(torch.from_numpy(logits)).numpy(),
        np.asarray(jmo.predictions(jnp.asarray(logits))))
    np.testing.assert_allclose(
        tmo.probabilities(torch.from_numpy(logits)).numpy(),
        np.asarray(jmo.probabilities(jnp.asarray(logits))), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_confusion_matrix_matches_jax(rng, ignore_index):
    pred = rng.integers(0, 5, (2, 16, 16))
    labels = rng.integers(0, 5, (2, 16, 16))
    labels[0, 0] = 255
    want = jmo.confusion_matrix(jnp.asarray(pred), jnp.asarray(labels), 5,
                                ignore_index)
    got = tmo.confusion_matrix(torch.from_numpy(pred),
                               torch.from_numpy(labels), 5, ignore_index)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("recipe", ["ade_semantic", "city_semantic"])
def test_adamw_matches_optax(rng, recipe):
    """Three steps on the same gradients: torch AdamW as make_optimizer
    builds it against optax.adamw(lr, weight_decay) from the same recipe
    (torch's default decay 0.01 would differ from optax's 1e-4)."""
    r = dataclasses.replace(trecipes.get(recipe), lr=1e-2)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = optax.adamw(r.lr, weight_decay=r.weight_decay)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in
          p0.items()}
    opt = tloop.make_optimizer(r)(list(tp.values()))
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    # the schedules are accepted: each builds AdamW with a LambdaLR
    # (tests/test_torch_loop.py holds their lr to optax's at every index)
    for schedule in ("cosine", "warmup_cosine", "step"):
        opt = tloop.make_optimizer(r, lr_schedule=schedule, total_steps=9)
        built = opt(list(tp.values()))
        assert isinstance(opt.scheduler(built),
                          torch.optim.lr_scheduler.LambdaLR)
    with pytest.raises(ValueError, match="requires total_steps"):
        tloop.make_optimizer(r, lr_schedule="cosine")
