"""Data parallelism and the pipeline on the card.

This file imports neither jax nor the JAX package, so it runs on a machine
with the card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_card.py

- two gloo ranks sharing `cuda:0` (NCCL refuses two ranks on one card)
  take the data-parallel step of tests/test_torch_parallel.py's 'cached'
  and 'fresh_triplet' scenarios through the kernels (K2, K4) and equal
  the one-process step on the global batch on the card, at
  tests/test_sharding.py's tolerances;
- a one-rank NCCL group runs the same step through NCCL's collectives;
- the two-stream pipeline, both stages on `cuda:0`, equals the
  sequential per-microbatch loop (forward, running stats, gradients), at
  tests/test_pipeline.py's tolerances.

On the CPU every test skips.
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.parallel import pipeline as pp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels, streams and NCCL)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _check(r0, r1=None):
    for k, want in r0["want_metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], want, rtol=1e-5,
                                   err_msg=k)
    assert r0["params_diff"] <= 1e-5 and r0["state_diff"] <= 1e-6
    np.testing.assert_array_equal(r0["generator"], r0["want_generator"])
    if r1 is not None:
        np.testing.assert_array_equal(r0["sums"], r1["sums"])
        np.testing.assert_array_equal(r1["generator"], r0["want_generator"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cached", "fresh_triplet"])
def test_two_gloo_ranks_on_one_card_equal_one_process(cuda, name):
    _check(*ranks.spawn(ranks.dp_step, 2, name, "cuda:0"))


@pytest.mark.cuda
def test_one_rank_nccl_group(cuda):
    _check(*ranks.spawn(ranks.dp_step, 1, "cached", "cuda:0",
                        backend="nccl"))


@pytest.mark.cuda
def test_two_stream_pipeline_equals_sequential(cuda):
    cfg = mu.MaskAttnUNetConfig(c_out=5, img_size=32, embed_dim=4)
    g = torch.Generator().manual_seed(0)
    params, state = mu.init(g, cfg)
    params = {k: v.to(cuda).requires_grad_(True) for k, v in params.items()}
    state = {k: v.to(cuda) for k, v in state.items()}
    x = torch.randn(8, 32, 32, 3, generator=g).to(cuda)
    masks = tuple(m.to(cuda) for m in mu.make_attention_masks(g, 4, 32))
    mesh = pp.make_pipe_mesh(devices=[cuda, cuda])
    outs = []
    for pipelined in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(7)
        if pipelined:
            out, new = pp.pipeline_apply(
                params, state, pp.split_microbatches(x, 2), cfg=cfg,
                mesh=mesh, masks=masks, train=True, dropout_generator=gen)
            sem = out.semantic
        else:
            sems, new = [], state
            for m in x.reshape(2, 4, 32, 32, 3):
                o, s = mu.apply(params, new, m, cfg=cfg, masks=masks,
                                train=True, dropout_generator=gen)
                new = {**new, **s}
                sems.append(o.semantic)
            sem = torch.stack(sems)
        loss = sem.float().square().mean()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        outs.append((sem.detach(), new, grads))
    (o1, s1, g1), (o2, s2, g2) = outs
    assert float((o1 - o2).abs().max()) < 1e-4
    for k in s1:
        assert float((s1[k] - s2[k]).abs().max()) < 1e-4, k
    for a, b in zip(g1, g2):
        if b is not None:
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-4 * max(scale, 1.0)
