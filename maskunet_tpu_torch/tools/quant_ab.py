"""Same-process A/B of the serving forward: bf16 against int8 convs, on
the card.

Counterpart of tools/quant_ab.py: the ADE model (c_out 150, 128 px,
batch 8, weights from seed 0, cached masks from seed 1 with their plans),
BN folded, in three arms:

  bf16         `cast_params_for_inference` of the folded params
  int8-dyn     `quantize_params_for_inference`: int8 weights, each
               sample's activations scaled as it runs (`conv2d_int8`)
  int8-static  the same with activation scales calibrated on the input
               itself (`calibrate_activation_scales`, an eager pass)

and the share of pixels whose class (argmax of the logits) each int8
arm gives as bf16 does. The int8 conv is an int8 x int8 -> int32 product
(`torch._int_mm`) on im2col patches, dequantized in f32.

    python -m maskunet_tpu_torch.tools.quant_ab [batch] [--device cuda|cpu]

Wall times are `fwd_breakdown.timeit`'s (best of 3 windows of 30 calls)
with the card's kernel time a call (`utils/profiling.
device_ms_per_call`) beside. A host without CUDA is refused unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse

from maskunet_tpu_torch.tools.fwd_breakdown import (device_suffix,
                                                    fence_tensor,
                                                    inference_setup,
                                                    make_forward, timeit)


def run(batch: int = 8, *, img_size: int = 128, device: str = "cuda",
        steps: int = 30, repeats: int = 3, device_calls: int = 3) -> dict:
    """Times the three arms and their agreement with bf16; prints the JAX
    tool's line and the device ms. Returns {arm: {"ms", "device_ms"},
    "agree", "agree_static"}."""
    import torch

    from maskunet_tpu_torch.core.device import resolve_device
    from maskunet_tpu_torch.models import maskattn_unet as mu
    from maskunet_tpu_torch.utils.profiling import device_ms_per_call

    dev = resolve_device(device)
    cfg, folded, x, masks, plans = inference_setup(batch, img_size, dev,
                                                   cast=False)
    with torch.no_grad():
        p_bf16 = mu.cast_params_for_inference(folded)
        p_int8 = mu.cast_params_for_inference(
            mu.quantize_params_for_inference(folded))

        def fwd_eager(p, t):
            out, _ = mu.apply(p, None, t, cfg=cfg, masks=masks, train=False,
                              folded=True, mask_plans=plans)
            return out.semantic

        # static arm: calibrate on the bench input itself (eager pass)
        scales = mu.calibrate_activation_scales(folded, fwd_eager, [x])
        p_stat = mu.cast_params_for_inference(
            mu.quantize_params_for_inference(folded, act_scales=scales))
    fwds = {name: make_forward(cfg, p, x, masks, plans)
            for name, p in (("bf16", p_bf16), ("int8-dyn", p_int8),
                            ("int8-static", p_stat))}
    res = {}
    for name, fwd in fwds.items():
        sec = timeit(fwd, fence_tensor, steps=steps, repeats=repeats)
        res[name] = {"ms": sec * 1e3,
                     "device_ms": device_ms_per_call(fwd, calls=device_calls)}
    a, b, c = (fwds[n]().argmax(dim=-1) for n in fwds)
    agree = float((a == b).float().mean())
    agree_s = float((a == c).float().mean())
    res.update(agree=agree, agree_static=agree_s)
    t_bf16, t_int8, t_stat = (res[n]["ms"] / 1e3 for n in fwds)
    print(f"batch={batch} bf16={t_bf16 * 1e3:.2f} ms "
          f"({batch / t_bf16:.1f} img/s)  "
          f"int8-dyn={t_int8 * 1e3:.2f} ms ({batch / t_int8:.1f} img/s, "
          f"{t_bf16 / t_int8:.3f}x, agree={agree:.4f})  "
          f"int8-static={t_stat * 1e3:.2f} ms ({batch / t_stat:.1f} img/s, "
          f"{t_bf16 / t_stat:.3f}x, agree={agree_s:.4f})")
    print("  " + "  ".join(f"{n}{device_suffix(res[n]['device_ms'])}"
                           for n in fwds))
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="quant_ab")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from maskunet_tpu_torch.core.device import tool_device

    tool_device("quant_ab", args.device)
    return run(args.batch, device=args.device)


if __name__ == "__main__":
    main()
