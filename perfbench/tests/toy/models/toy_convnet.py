"""A toy second model for the benchmark's own tests: three plain convs
(3x3, ReLU, 3x3, ReLU, 1x1 to the classes) under pixel cross-entropy and
torch's AdamW, in f32. The program under test is the few lines of
`_forward` and `training`'s step below; its plain reference is
`reference/toy_convnet.py`."""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from perfbench.harness import weights
from perfbench.harness.training import Built
from perfbench.reference import toy_convnet as ref

FIXED = {"model": "Toy-ConvNet", "c_in": 3, "widths": [8, 16]}


def _forward(params, image):
    x = image.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, params["conv1.weight"], params["conv1.bias"],
                        padding=1))
    x = F.relu(F.conv2d(x, params["conv2.weight"], params["conv2.bias"],
                        padding=1))
    return F.conv2d(x, params["head.weight"], params["head.bias"])


def training(cell: dict, seed: int, device) -> Built:
    cfg, p = cell["config"], cell["params"]
    img, batch = p["img_size"], p["batch"]
    params0 = ref.init(cfg, weights.derived_seed(seed, 0), device)
    params = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
    opt = torch.optim.AdamW(list(params.values()),
                            lr=cfg["optimizer"]["lr"],
                            weight_decay=cfg["optimizer"]["weight_decay"])
    state = types.SimpleNamespace(params=params, optimizer=opt)

    def step(ts, b):
        ts.optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(_forward(ts.params, b["image"]), b["label"])
        loss.backward()
        ts.optimizer.step()
        return ts, {"loss": loss.detach()}

    def reference(batches, *, quant=None, half_batch=False):
        return ref.train_steps(params0, batches, cfg, quant=quant,
                               half_batch=half_batch)

    w = [cfg["c_in"], *cfg["widths"]]
    fwd = 2 * img * img * (9 * w[0] * w[1] + 9 * w[1] * w[2]
                           + w[2] * cfg["c_out"])
    return Built(state=state, step=step, params0=params0,
                 classes=cfg["c_out"], pool_keys=("image", "label"),
                 flops_per_call=3 * fwd * batch, bounds={}, counters={},
                 reference=reference)
