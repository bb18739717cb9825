"""bf16 against f32 argmax agreement of the serving forward, batch 1, on a
standard-normal input: JAX's own `mu.apply` and the port's plain path on
the same weights (a script, not a test: pytest collects `test_*.py` only).

    JAX_PLATFORMS=cpu python tests/bf16_agreement.py [img] [impl] [seeds]
    JAX_PLATFORMS=cpu python tests/bf16_agreement.py 128 dense 0,1,2,3

For each seed: JAX's init (c_out 150) and key masks from the seed, BN
folded (and the weights cast for bf16, as serving casts them), one
standard-normal image; JAX's forward in f32 and in bf16, then the port's
(on the CPU: the flash kernels' plain versions, the plans precomputed) on
the same weights through `utils/jax_weights.from_jax`. Prints one JSON
line a seed: each pair's share of pixels with the same argmax class, and
the f32 logits' max|Δ| between the packages. The serving bound that the
card's check holds is 0.98 (`chip_smoke.py` SERVE_ARGMAX_AGREE).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskunet_tpu.models import maskattn_unet as jmu  # noqa: E402
from maskunet_tpu_torch.models import maskattn_unet as tmu  # noqa: E402
from maskunet_tpu_torch.utils import jax_weights  # noqa: E402


def main() -> None:
    img = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    impl = sys.argv[2] if len(sys.argv) > 2 else "dense"
    seeds = ([int(s) for s in sys.argv[3].split(",")]
             if len(sys.argv) > 3 else [0])
    torch.set_num_threads(4)
    for seed in seeds:
        t0 = time.time()
        jf32 = jmu.MaskAttnUNetConfig(c_out=150, img_size=img,
                                      attn_impl=impl)
        params, state = jax.tree.map(np.asarray, jax.jit(
            jmu.init, static_argnums=1)(jax.random.key(seed), jf32))
        masks = jmu.make_attention_masks(jax.random.key(seed + 100), 1, img)
        x = np.random.default_rng(seed).standard_normal(
            (1, img, img, 3)).astype(np.float32)
        out = {}
        for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = jmu.MaskAttnUNetConfig(c_out=150, img_size=img,
                                         attn_impl=impl, compute_dtype=dtype)
            fold = jmu.fold_bn_for_inference(params, state, cfg)
            if dtype == "bfloat16":
                fold = jmu.cast_params_for_inference(fold)
            fn = jax.jit(lambda p, x_, cfg=cfg: jmu.apply(
                p, None, x_, cfg=cfg, masks=masks, train=False,
                folded=True)[0].semantic)
            out[f"jax_{name}"] = np.asarray(
                fn(fold, jnp.asarray(x)).astype(jnp.float32))

            tcfg = tmu.MaskAttnUNetConfig(c_out=150, img_size=img,
                                          compute_dtype=dtype)
            tp, ts = jax_weights.from_jax(params, state, tcfg)
            tm = tuple(torch.from_numpy(np.asarray(m)) for m in masks)
            with torch.no_grad():
                tfold = tmu.fold_bn_for_inference(tp, ts, tcfg)
                if dtype == "bfloat16":
                    tfold = tmu.cast_params_for_inference(tfold)
                o, _ = tmu.apply(tfold, None, torch.from_numpy(x), cfg=tcfg,
                                 masks=tm, folded=True,
                                 mask_plans=tmu.precompute_mask_plans(tm))
            out[f"port_{name}"] = o.semantic.float().numpy()
        am = {k: v.argmax(-1) for k, v in out.items()}

        def agree(a, b):
            return float((am[a] == am[b]).mean())

        print(json.dumps({
            "img": img, "impl": impl, "seed": seed,
            "jax_bf16_vs_jax_f32": agree("jax_bf16", "jax_f32"),
            "port_bf16_vs_port_f32": agree("port_bf16", "port_f32"),
            "port_bf16_vs_jax_bf16": agree("port_bf16", "jax_bf16"),
            "port_f32_vs_jax_f32": agree("port_f32", "jax_f32"),
            "f32_max_abs_diff": float(np.abs(out["port_f32"]
                                             - out["jax_f32"]).max()),
            "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
