"""Same-process A/B of two formulations of the model's 3x3 convs, op by
op, on the card.

Counterpart of tools/conv_ab.py. Every 3x3 SAME stride-1 conv of the
UNet trunk at 128 px (`SHAPES`, the JAX tool's table with each shape's
count in a forward) in two formulations:

  direct   the port's conv, `core.layers.conv2d` (cuDNN on the card)
  im2col   the nine taps concatenated into [B*H*W, 9*Cin] patches and
           one matmul with the [9*Cin, Cout] kernel (`conv_im2col`:
           cuBLAS on the card)

On Hopper both run on the tensor cores; im2col writes and reads the 9x
wider patch tensor through memory and buys one long contraction (9*Cin)
in place of cuDNN's implicit GEMM. This A/B compares two library
formulations; no kernel of the port is involved.

    python -m maskunet_tpu_torch.tools.conv_ab [batch] [--device cuda|cpu]

For each shape: the relative error of im2col against direct
(max|Δ| / max|direct|), and wall and device µs a call of each
(`fwd_breakdown.timeit`'s best of 3 windows of 30 calls;
`utils/profiling.device_ms_per_call`), TF/s of the direct conv on both.
A host without CUDA is refused unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.fwd_breakdown import fence_tensor, timeit

# (H, W, Cin, Cout, count) for every 3x3 conv in the UNet trunk at 128px
# (models/maskattn_unet.py; counts = occurrences per forward)
SHAPES = [
    # 128x128: initial ConvBlock(3->64); up3 block1(128,128,res) +
    # block2(128->64, mid 64)
    (128, 128, 3, 64, 1),
    (128, 128, 64, 64, 2),
    (128, 128, 128, 128, 2),
    (128, 128, 128, 64, 1),
    # 64x64: down1 block1(64,64,res) + block2(64->128); up2
    # block1(256,256,res) + block2(256->64, mid 128)
    (64, 64, 64, 64, 2),
    (64, 64, 64, 128, 1),
    (64, 64, 128, 128, 1),
    (64, 64, 256, 256, 2),
    (64, 64, 256, 128, 1),
    (64, 64, 128, 64, 1),
    # 32x32: down2 block1(128,128,res) + block2(128->256); up1
    # block1(512,512,res) + block2(512->128, mid 256)
    (32, 32, 128, 128, 2),
    (32, 32, 128, 256, 1),
    (32, 32, 256, 256, 1),
    (32, 32, 512, 512, 2),
    (32, 32, 512, 256, 1),
    (32, 32, 256, 128, 1),
    # 16x16: down3 (256,256)x4; bottom1 256->512,512->512;
    # bottom2 512->512 x2; bottom3 512->256,256->256
    (16, 16, 256, 256, 5),
    (16, 16, 256, 512, 1),
    (16, 16, 512, 512, 3),
    (16, 16, 512, 256, 1),
]


def conv_direct(x, w):
    """The port's conv: NHWC `x`, OIHW `w`."""
    from maskunet_tpu_torch.core import layers
    return layers.conv2d(w, None, x)


def conv_im2col(x, w, bias=None):
    """3x3 SAME conv of NHWC `x` with OIHW `w` as one matmul over the
    9-tap patch axis (taps in (row, column) order, channels innermost, as
    JAX's tool), in x's dtype with f32 accumulation."""
    import torch
    import torch.nn.functional as F

    b, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, i:i + h, j:j + wd, :] for i in range(3) for j in range(3)]
    patches = torch.cat(taps, dim=-1)                       # [B,H,W,9C]
    wm = w.to(x.dtype).permute(2, 3, 1, 0).reshape(9 * c, -1)   # [9C,Cout]
    y = torch.matmul(patches, wm)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def run(batch: int = 8, shapes=SHAPES, *, device: str = "cuda",
        dtype: str = "bfloat16", steps: int = 30, repeats: int = 3,
        device_calls: int = 3) -> list[dict]:
    """Each shape's error and times; prints the JAX tool's table with
    device µs beside and the per-forward totals. Returns one row a
    shape."""
    import numpy as np
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    tdtype = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    tot_direct = tot_best = 0.0
    rows = []
    name = {"bfloat16": "bf16", "float32": "f32"}.get(dtype, dtype)
    print(f"batch={batch} dtype={name}   direct(us)  im2col(us)  ratio"
          f"   device direct(us)  im2col(us)")
    for h, w, cin, cout, count in shapes:
        x = torch.from_numpy(rng.normal(size=(batch, h, w, cin))).to(
            dev, tdtype)
        k = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3)) / 30).to(
            dev, tdtype)
        with torch.no_grad():
            yd = conv_direct(x, k).float()
            yi = conv_im2col(x, k).float()
        err = float((yd - yi).abs().max() / max(float(yd.abs().max()), 1e-6))
        fd = lambda: conv_direct(x, k)                      # noqa: E731
        fi = lambda: conv_im2col(x, k)                      # noqa: E731
        td = timeit(fd, fence_tensor, steps=steps, repeats=repeats)
        ti = timeit(fi, fence_tensor, steps=steps, repeats=repeats)
        dd = device_ms_per_call(fd, calls=device_calls)
        di = device_ms_per_call(fi, calls=device_calls)
        tot_direct += count * td
        tot_best += count * min(td, ti)
        flops = 2 * batch * h * w * 9 * cin * cout
        rows.append({"shape": (h, w, cin, cout), "count": count,
                     "direct_us": td * 1e6, "im2col_us": ti * 1e6,
                     "direct_device_us": None if dd is None else dd * 1e3,
                     "im2col_device_us": None if di is None else di * 1e3,
                     "rel_err": err, "tflops": flops / td / 1e12})
        dev_cols = ("  not measured" if dd is None or di is None else
                    f"  {dd * 1e3:9.1f}  {di * 1e3:9.1f}  "
                    f"(device {flops / dd / 1e9:5.1f} TF/s)")
        print(f"{h:4d}x{w:<4d} {cin:4d}->{cout:<4d} x{count}  "
              f"{td * 1e6:9.1f}  {ti * 1e6:9.1f}  {td / ti:5.2f}  "
              f"(direct {flops / td / 1e12:5.1f} TF/s, rel-err {err:.1e})"
              f"{dev_cols}", flush=True)
    print(f"\nper-forward conv total: direct {tot_direct * 1e3:.2f} ms, "
          f"best-of {tot_best * 1e3:.2f} ms "
          f"({tot_direct / tot_best:.2f}x if switched per-shape)")
    print("CAVEAT: one conv alone is a launch or two: its wall time holds "
          "the host's dispatch and the fence, and the device columns are "
          "the card's. Use maskunet_tpu_torch.tools.conv_model_ab, which "
          "swaps the formulation inside the whole forward, before "
          "changing the model's conv path.")
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="conv_ab")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("conv_ab", args.device)
    return run(args.batch, device=args.device)


if __name__ == "__main__":
    main()
