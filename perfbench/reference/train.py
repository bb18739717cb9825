"""The reference's training step: the losses, the triplet sampler, AdamW.

- Cross-entropy: `nn.CrossEntropyLoss` (mean over the pixels whose label
  is not `ignore_index`) on the ReLU'd logits.
- Triplet term (city_instance): `TripletMarginLoss(margin=1, p=2)` over
  pixel embeddings, 32 anchors an image among the pixels of an instance
  (not background 0, not the ignore label), a positive from the anchor's
  instance and a negative outside it. The draws follow the rules of the
  repository's vectorised sampler: uniform scores plus 2 on the eligible
  pixels, top-k for the anchors, argmax for the positive and the
  negative, in that order from one generator.
- AdamW as `torch.optim.AdamW` computes it (betas 0.9, 0.999, eps 1e-8
  outside the square root, decoupled decay), written out.

A step draws from its generator in this order: the two decoder dropout
keep masks (NHWC, keep where uniform >= rate), then the triplets.
"""

from __future__ import annotations

import torch

from perfbench.reference.model import Reference

_BIG = 2.0


def cross_entropy(logits, labels, ignore_index=None):
    """logits [B, H, W, C]; labels [B, H, W]."""
    keep = torch.ones_like(labels, dtype=torch.bool)
    if ignore_index is not None:
        keep = labels != ignore_index
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.where(keep, labels, 0).long()[..., None])[..., 0]
    return (nll * keep).sum() / keep.sum().clamp(min=1)


def sample_triplets(generator, instance, num_samples, ignore_label):
    """(anchor, positive, negative, usable) flat pixel indices [B, K]."""
    b = instance.shape[0]
    ids = instance.reshape(b, -1)
    hw = ids.shape[1]
    dev = ids.device
    valid = ids != 0
    if ignore_label is not None:
        valid &= ids != ignore_label

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    a_idx = torch.topk(uniform(b, hw) + valid * _BIG, num_samples,
                       dim=1).indices
    a_ids = torch.gather(ids, 1, a_idx)
    same = ids[:, None, :] == a_ids[:, :, None]
    is_self = torch.arange(hw, device=dev)[None, None, :] == a_idx[:, :, None]
    pos = same & ~is_self
    p_idx = (uniform(b, num_samples, hw) + pos * _BIG).argmax(-1)
    neg = ~same
    if ignore_label is not None:
        neg &= ids[:, None, :] != ignore_label
    n_idx = (uniform(b, num_samples, hw) + neg * _BIG).argmax(-1)
    usable = (torch.gather(valid, 1, a_idx)
              & torch.gather(pos, 2, p_idx[..., None])[..., 0]
              & torch.gather(neg, 2, n_idx[..., None])[..., 0])
    return a_idx, p_idx, n_idx, usable.float()


def triplet_loss(features, a_idx, p_idx, n_idx, weight, margin=1.0):
    b, h, w, c = features.shape
    f = features.reshape(b, h * w, c)

    def pick(idx):
        return torch.gather(f, 1, idx[..., None].expand(-1, -1, c))

    a, p, n = pick(a_idx), pick(p_idx), pick(n_idx)
    d_ap = torch.sqrt(((a - p + 1e-6) ** 2).sum(-1))
    d_an = torch.sqrt(((a - n + 1e-6) ** 2).sum(-1))
    per = torch.relu(d_ap - d_an + margin)
    return (per * weight).sum() / weight.sum().clamp(min=1)


class AdamW:
    def __init__(self, params: dict, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2 = betas
        self.eps, self.t = eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(params0: dict, batches, masks, generator, cfg: dict,
                quant: str | None = None, half_batch: bool = False):
    """Three (or len(batches)) reference steps from `params0` (not
    changed). `batches`: dicts of device tensors (image f32 [B,H,W,3] in
    [0, 1], label, and instance for the triplet term); `masks`: the six
    [B, L] key masks; `cfg`: the configuration file's dict.
    `half_batch`: the loss over the first half of the rows only (a fault
    the comparison has to catch). Returns (losses, first gradients, the
    parameters after the last step)."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in params0.items()}
    loss_cfg = cfg["loss"]
    model = Reference(params, None, c_out=cfg["c_out"],
                      embed_dim=cfg["embed_dim"],
                      with_boundary_head=cfg["with_boundary_head"],
                      dropout_rate=cfg["dropout_rate"], quant=quant)
    opt = AdamW(params, cfg["optimizer"]["lr"],
                cfg["optimizer"]["weight_decay"])
    losses, first = [], None
    for batch in batches:
        n = batch["image"].shape[0]
        rate = cfg["dropout_rate"]
        s = batch["image"].shape[1]
        keep = tuple(torch.rand(shape, generator=generator,
                                device=generator.device) >= rate
                     for shape in ((n, s // 4, s // 4, 128),
                                   (n, s // 2, s // 2, 64)))
        out = model(batch["image"], masks, train=True, keep_masks=keep)
        rows = slice(0, n // 2) if half_batch else slice(0, n)
        loss = loss_cfg["ce_weight"] * cross_entropy(
            out["semantic"][rows], batch["label"][rows],
            loss_cfg["ignore_index"])
        if loss_cfg["triplet_weight"] > 0:
            tri = sample_triplets(generator, batch["instance"],
                                  loss_cfg["triplet_samples"],
                                  loss_cfg["triplet_ignore_label"])
            feats = out[loss_cfg["triplet_features"]]
            loss = loss + loss_cfg["triplet_weight"] * triplet_loss(
                feats[rows], *(t[rows] for t in tri))
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(keys, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        del out, loss, grads
    return losses, first, {k: v.detach() for k, v in params.items()}
