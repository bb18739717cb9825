"""The plain reference against the port's plain path, at 16 px in f32 on
the CPU (the port's attention there is its kernels' plain versions). The
test may import both; the reference imports nothing of the port."""

import pytest
import torch

from perfbench.harness import spec, weights
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

IMG, B = 16, 2
CONFIGS = ["ade_semantic", "city_instance"]


def _cfg(name):
    cell = {"ade_semantic": "ade_semantic.train_256",
            "city_instance": "city_instance.train_128"}[name]
    return spec.load_cell(cell)["config"]


def _port_cfg(c):
    from maskunet_tpu_torch.models import maskattn_unet as mu
    return mu.MaskAttnUNetConfig(
        c_out=c["c_out"], img_size=IMG, embed_dim=c["embed_dim"],
        with_boundary_head=c["with_boundary_head"],
        dropout_rate=c["dropout_rate"], attn_impl="flash",
        compute_dtype="float32")


def _ref(c, p, s):
    return ref_model.Reference(p, s, c_out=c["c_out"],
                               embed_dim=c["embed_dim"],
                               with_boundary_head=c["with_boundary_head"],
                               dropout_rate=c["dropout_rate"])


@pytest.mark.parametrize("name", CONFIGS)
def test_names_and_shapes_are_the_ports(name):
    from maskunet_tpu_torch.models import maskattn_unet as mu
    c = _cfg(name)
    p, s = mu.init(torch.Generator().manual_seed(0), _port_cfg(c))
    ours, state = weights.make_weights(c, IMG, 7, "cpu")
    assert {k: v.shape for k, v in p.items()} == \
        {k: v.shape for k, v in ours.items()}
    assert {k: v.shape for k, v in s.items()} == \
        {k: v.shape for k, v in state.items()}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mode", ["eval", "folded", "train"])
def test_forward_agrees(name, mode):
    from maskunet_tpu_torch.models import maskattn_unet as mu
    c = _cfg(name)
    cfg = _port_cfg(c)
    p, s = weights.make_weights(c, IMG, 11, "cpu")
    masks = weights.make_masks(IMG, B, 11, "cpu", c["attention_key_density"])
    x = torch.rand(B, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
    keep = mu.draw_dropout_masks(torch.Generator().manual_seed(2), cfg, B)
    if mode == "folded":
        out, _ = mu.apply(mu.fold_bn_for_inference(p, s, cfg), None, x,
                          cfg=cfg, masks=masks, folded=True)
    else:
        out, _ = mu.apply(p, s, x, cfg=cfg, masks=masks,
                          train=mode == "train", dropout_masks=keep)
    ref = _ref(c, p, s)(x, masks, train=mode == "train", keep_masks=keep)
    scale = ref["semantic"].abs().max()
    # f32 sums in another order (batch statistics over 512 pixels)
    assert (out.semantic - ref["semantic"]).abs().max() <= 1e-4 * scale
    if c["embed_dim"]:
        for key in ("embeddings", "boundary"):
            got, want = getattr(out, key), ref[key]
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_three_steps_agree_with_the_ports_step(name):
    from maskunet_tpu_torch.core import state as state_lib
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.train import loop as loop_lib
    from maskunet_tpu_torch.train import step as step_lib
    from perfbench.harness import data
    c = _cfg(name)
    cfg = _port_cfg(c)
    loss = c["loss"]
    task = step_lib.TaskConfig(
        ce_weight=loss["ce_weight"], triplet_weight=loss["triplet_weight"],
        triplet_features="embeddings", ignore_index=loss["ignore_index"],
        triplet_ignore_label=loss["triplet_ignore_label"])
    p0, s0 = weights.make_weights(c, IMG, 5, "cpu")
    masks = weights.make_masks(IMG, B, 5, "cpu", c["attention_key_density"])
    ts = state_lib.create(torch.Generator().manual_seed(9), p0, s0,
                          loop_lib.AdamW(c["optimizer"]["lr"],
                                         c["optimizer"]["weight_decay"]),
                          masks=masks)
    step = step_lib.make_train_step(cfg, task, device="cpu")
    pool = data.pool(5, 3 * B, img_size=IMG, num_classes=c["c_out"],
                     num_objects=4, ignore_border=loss["ignore_index"] == 255)
    batches = [{k: torch.as_tensor(v[i * B:(i + 1) * B])
                for k, v in pool.items()} for i in range(3)]
    for b in batches:
        b["image"] = b["image"].float() / 255.0
    losses, first = [], None
    for b in batches:
        ts, m = step(ts, dict(b))
        losses.append(float(m["loss"]))
        if first is None:
            first = {k: float(ts.optimizer.state[v]["exp_avg"].norm()) / 0.1
                     for k, v in ts.params.items()}
    r_losses, r_first, r_params = ref_train.train_steps(
        p0, batches, masks, torch.Generator().manual_seed(9), c)
    # step 1 in f32 agrees to rounding; AdamW then turns the round-off
    # gradients of the leaves no loss reaches (a key's bias under softmax,
    # a BatchNorm before another) into whole steps of the learning rate,
    # and steps 2 and 3 drift apart by a little more
    assert losses[0] == pytest.approx(r_losses[0], rel=1e-5)
    assert losses == pytest.approx(r_losses, rel=1e-3)
    norms = {k: float(g.norm()) for k, g in r_first.items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k in p0:
        if norms[k] < 1e-3 * median:
            continue
        assert first[k] == pytest.approx(norms[k], rel=1e-3), k
        moved = (ts.params[k].detach() - p0[k]).norm()
        want = (r_params[k] - p0[k]).norm()
        assert abs(moved - want) <= 5e-2 * want, k


def test_cross_entropy_and_triplet_equal_the_ports():
    from maskunet_tpu_torch.losses import cross_entropy, triplet
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 8, 8, 19, generator=g)
    labels = torch.randint(0, 19, (2, 8, 8), generator=g)
    labels[:, :2] = 255
    assert torch.allclose(
        ref_train.cross_entropy(logits, labels, 255),
        cross_entropy.cross_entropy(logits, labels, 255), rtol=1e-6)
    inst = torch.randint(0, 4, (2, 8, 8), generator=g)
    ours = ref_train.sample_triplets(torch.Generator().manual_seed(3), inst,
                                     5, 255)
    theirs = triplet.sample_triplets(torch.Generator().manual_seed(3), inst,
                                     num_samples=5, ignore_label=255)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    feats = torch.randn(2, 8, 8, 16, generator=g)
    assert torch.allclose(ref_train.triplet_loss(feats, *ours),
                          triplet.triplet_from_indices(feats, *theirs),
                          rtol=1e-6)
