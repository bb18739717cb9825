"""Decompose the serving req/s ceiling on the card's host.

Counterpart of tools/serve_breakdown.py. It measures each stage of a
request's host-side life separately, then the in-process ceilings with the
HTTP layer removed:

  A. model-only ceiling: the serving runner's batches back to back, each
     fenced by one copy of the previous batch's class maps to the host
     (pipelined dispatch, as the micro-batcher runs it).
  B. batcher ceiling: `_Batcher.predict` from N in-process threads — adds
     the queue, the Event wakeups and the worker loop, still no HTTP or
     decode.
  C. per-request host CPU: JPEG decode, cvtColor + resize, PNG encode, raw
     tobytes — timed standalone.

If B is far above the HTTP req/s of `serve_bench` and C's sum times that
req/s approaches the host's cores, the bound is the host's CPU and not the
serving design.

    python -m maskunet_tpu_torch.tools.serve_breakdown [batch] [threads]
        [--device cuda|cpu] [--img N]

The model is the ADE serving model (c_out 150, bf16, BN folded, the
recipe's seeded init) at the recipe's 128 px unless `--img` says
otherwise. Prints the JAX tool's lines and its last JSON line, plus the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time

import numpy as np

# the JAX tool's counts: batches a stage A window (3 windows), stage B's
# requests, calls of each stage C timing
A_ITERS = 60
B_REQUESTS = 600
C_ITERS = 300


def main(argv: list[str] | None = None) -> dict:
    """Runs stages A, B and C; returns the JSON line's fields."""
    ap = argparse.ArgumentParser(prog="serve_breakdown")
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("threads", type=int, nargs="?", default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--img", type=int, default=None)
    args = ap.parse_args(argv)

    from maskunet_tpu_torch.core.device import card_name, tool_device

    dev = tool_device("serve_breakdown", args.device)
    import cv2

    from maskunet_tpu_torch import serve
    from maskunet_tpu_torch.tasks import recipes as recipes_lib

    batch, threads = args.batch, args.threads
    rec = recipes_lib.get("ade_semantic")
    if args.img is not None:
        rec = dataclasses.replace(rec, img_size=args.img)
    runner, img_size = serve.build_model_runner(
        rec, 150, None, "best", compute_dtype="bfloat16", batch_size=batch,
        device=dev)
    x = np.zeros((batch, img_size, img_size, 3), np.uint8)
    serve._to_numpy(runner(x))   # warm-up: cuDNN plans, the kernels' build

    # --- A: model-only ceiling (pipelined dispatch like the batcher) ---
    iters = A_ITERS
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        pending = None
        for _ in range(iters):
            out = runner(x)
            if pending is not None:
                serve._to_numpy(pending)
            pending = out
        serve._to_numpy(pending)
        best = min(best, (time.perf_counter() - t0) / iters)
    model_img_s = batch / best
    print(f"A. model-only ceiling : {model_img_s:7.1f} img/s "
          f"({best * 1e3:.2f} ms / batch-{batch})")

    # --- B: batcher ceiling, in-process threads, no HTTP ---
    batcher = serve._Batcher(runner, batch, max_wait_ms=5.0)
    img = np.zeros((img_size, img_size, 3), np.uint8)
    n_req = B_REQUESTS
    done = [0]
    lock = threading.Lock()

    def worker(n):
        for _ in range(n):
            batcher.predict(img)
            with lock:
                done[0] += 1

    per = n_req // threads
    ts = [threading.Thread(target=worker, args=(per,)) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    m = batcher.metrics()
    batcher_req_s = done[0] / wall
    print(f"B. batcher ceiling    : {batcher_req_s:7.1f} req/s "
          f"({threads} threads, batch fill {m['avg_batch_fill']:.2f})")

    # --- C: per-request host CPU stages ---
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, (160, 160, 3)).astype(np.uint8)
    ok, jpg = cv2.imencode(".jpg", src)
    jpg = np.frombuffer(jpg.tobytes(), np.uint8)
    mask = rng.integers(0, 150, (img_size, img_size)).astype(np.uint8)

    def timeit(fn, iters=C_ITERS):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    stages = {
        "jpeg_decode": timeit(lambda: cv2.imdecode(jpg, cv2.IMREAD_COLOR)),
        "cvt_resize": timeit(lambda: cv2.resize(
            cv2.cvtColor(src, cv2.COLOR_BGR2RGB), (img_size, img_size),
            interpolation=cv2.INTER_LINEAR)),
        "png_encode": timeit(lambda: cv2.imencode(".png", mask)),
        "raw_tobytes": timeit(lambda: mask.tobytes()),
    }
    print("C. per-request host CPU stages:")
    for k, v in stages.items():
        print(f"     {k:12s}: {v * 1e6:7.0f} us")
    png_path = (stages["jpeg_decode"] + stages["cvt_resize"]
                + stages["png_encode"])
    raw_path = (stages["jpeg_decode"] + stages["cvt_resize"]
                + stages["raw_tobytes"])
    ncpu = os.cpu_count() or 1
    print(f"\n   cv2-work budget on {ncpu} core(s): "
          f"{ncpu / png_path:6.0f} req/s (png) / "
          f"{ncpu / raw_path:6.0f} req/s (raw) — excludes HTTP parse, "
          f"threading, and the load generator sharing the core(s)")
    out = {"model_img_s": round(model_img_s, 1),
           "batcher_req_s": round(batcher_req_s, 1),
           "stage_us": {k: round(v * 1e6) for k, v in stages.items()},
           "cores": ncpu, "card": card_name(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
