"""The training loop's device-side pieces on the card: the prefetcher's
pinned, non-blocking copies and the async checkpoint snapshot.

This file imports neither jax nor the JAX package, so it runs on a machine
with the card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_loop_card.py

On the CPU both tests skip (they are about CUDA streams and in-place
updates queued on the card).
"""

import dataclasses
import os

import pytest
import torch

from maskunet_tpu_torch.core import checkpoint as ckpt_lib
from maskunet_tpu_torch.data import pipeline, synthetic
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.tasks import recipes
from maskunet_tpu_torch.train import loop
from maskunet_tpu_torch.train import step as step_lib


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (streams and pinned copies)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_prefetched_batches_equal_blocking_copies_on_card(cuda):
    """20 prefetched batches at 128 px equal blocking copies of the same
    batches. Each comparison is queued behind a long matmul on the
    consumer's stream and the batch is dropped at once, while the
    prefetch stream keeps copying the next ones: memory handed back too
    early would be overwritten before the comparison reads it."""
    ds = synthetic.SyntheticSegmentationDataset(
        num_examples=160, img_size=128, num_classes=150)
    it = pipeline.BatchIterator(ds, 8, shuffle=True, seed=3)
    want = []
    for b in it.epoch(0):
        want.append({k: torch.from_numpy(v).to(cuda) for k, v in b.items()})
        want[-1]["image"] = want[-1]["image"].float() / 255.0
    a = torch.randn(4096, 4096, device=cuda)
    same = []
    with pipeline.Prefetcher(it.epoch(0), device=cuda) as pf:
        for i, got in enumerate(pf):
            assert got["image"].dtype == torch.float32
            assert got["label"].dtype == torch.int32
            slow = a @ a @ a
            same.append(torch.stack(
                [(got[k] == want[i][k]).all() for k in want[i]]).all()
                & torch.isfinite(slow).all())
            del got
    assert len(same) == 20
    assert all(bool(s) for s in same)


@pytest.mark.cuda
def test_async_save_between_cuda_steps_restores_pre_step_values(
        cuda, tmp_path):
    """A save between two train steps on the card writes the state after
    the first: the second step's in-place update of the parameters and
    moments, queued right after the snapshot, does not reach the file."""
    recipe = dataclasses.replace(recipes.get("synthetic_semantic"),
                                 img_size=32)
    cfg = loop.model_config(recipe, 8)
    ts = loop.setup_state(recipe, cfg, loop.make_optimizer(recipe),
                          device=cuda)
    step = step_lib.make_train_step(
        cfg, recipe.task_config,
        mask_plans=mu.precompute_mask_plans(ts.masks), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"image": torch.rand(8, 32, 32, 3, generator=gen, device=cuda),
             "label": torch.randint(0, 8, (8, 32, 32), generator=gen,
                                    device=cuda)}
    ts, _ = step(ts, batch)
    manager = ckpt_lib.CheckpointManager(str(tmp_path), "c")
    manager.save_latest(ts)
    want = {k: p.detach().clone() for k, p in ts.params.items()}
    want_m = {k: ts.optimizer.state[p]["exp_avg_sq"].clone()
              for k, p in ts.params.items()}
    ts, _ = step(ts, batch)
    path = os.path.join(str(tmp_path), "c_latest.msgpack")
    try:
        manager.wait()
        back = ckpt_lib.restore(path, loop.setup_state(
            recipe, cfg, loop.make_optimizer(recipe), device=cuda))
    finally:
        if os.path.exists(path):
            os.remove(path)
    assert back.step == 1 and ts.step == 2
    moved = 0
    for k, p in back.params.items():
        assert torch.equal(p.detach(), want[k]), k
        assert torch.equal(back.optimizer.state[p]["exp_avg_sq"],
                           want_m[k]), k
        moved += not torch.equal(want[k], ts.params[k].detach())
    assert moved > len(want) // 2
