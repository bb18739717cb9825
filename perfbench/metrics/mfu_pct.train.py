"""The whole training step's share of the bf16 tensor-core peak: the
model's FLOPs (`harness/flops.py`, attention over the cell's masks) of the
window's images over the window's seconds."""

from perfbench.harness import flops


def read(ctx):
    r = ctx.result
    if r["kind"] != "training" or not r["images"]:
        return None
    per_image = r["flops_per_call"] / ctx.cell["params"]["batch"]
    return 100.0 * r["images"] * per_image / r["seconds"] / flops.PEAK_BF16
