"""End-to-end HTTP serving throughput on the card.

Counterpart of tools/serve_bench.py. Starts the port's serving stack
in-process (`serve.build_model_runner`, the micro-batcher and
`serve.make_handler` behind a ThreadingHTTPServer on an ephemeral port),
fires concurrent JPEG POSTs from SEPARATE client processes (an in-process
load generator shares the server's GIL and caps the measurement), and
reports req/s, latency percentiles and the batcher's fill ratio.

    python -m maskunet_tpu_torch.tools.serve_bench [n_requests]
        [concurrency] [client_procs] [--raw] [--device cuda|cpu] [--img N]

The clients import neither torch nor the port: this file's top level is
the standard library and numpy, every torch import sits in the server's
`main()`, the clients run this file by its path, and they start with
`CUDA_VISIBLE_DEVICES=""`, so that no client pays for a CUDA context or
shares the card. Each client reports whether torch reached its modules
(`client_imports_torch`).

The model is the ADE serving model (c_out 150, batch 8, bf16, BN folded,
the recipe's seeded init) at the recipe's 128 px unless `--img` says
otherwise. Prints the JAX tool's JSON line with its keys, plus the card's
name and power limit (`card`), the server's forward-kernel launches
(`kernel_launches`, K1 and, under MASKUNET_SAFE_SOFTMAX=1, K3) and the
batcher's batches (`batches`), from the HTTP server's start on, and the
seconds from `main` to a listening server (`setup_s`: the model's build
and its first forward).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np


def client(url: str, n_requests: int, concurrency: int,
           raw: bool = False) -> None:
    """Load-generator subprocess: POST loop, latencies JSON to stdout.

    Uses one persistent HTTP/1.1 connection per worker thread — the
    realistic production pattern (and what the server's keep-alive
    support is for); a fresh TCP connection per request re-measures
    kernel connection setup, not the serving stack."""
    import concurrent.futures
    import http.client
    import urllib.parse

    import cv2

    rng = np.random.default_rng(os.getpid())
    payloads = []
    for _ in range(8):
        img = rng.integers(0, 255, (160, 160, 3)).astype(np.uint8)
        ok, jpg = cv2.imencode(".jpg", img)
        payloads.append(jpg.tobytes())

    netloc = urllib.parse.urlparse(url).netloc
    path = "/predict" + ("?format=raw" if raw else "")
    local = threading.local()
    latencies = []
    failures = [0]
    lock = threading.Lock()

    def post(i):
        t0 = time.perf_counter()
        for attempt in range(3):   # the OS may refuse past the backlog
            conn = getattr(local, "conn", None)
            try:
                if conn is None:
                    conn = local.conn = http.client.HTTPConnection(
                        netloc, timeout=120)
                conn.request("POST", path, body=payloads[i % len(payloads)])
                r = conn.getresponse()
                r.read()
                if r.status >= 500:
                    # a 5xx (shed/timeout) is a RESULT, not a harness
                    # error: count it and keep the run alive. send_error
                    # responses carry Connection: close — drop the dead
                    # connection NOW or the thread's next request burns a
                    # failed attempt + retry sleep on it (latency skew)
                    local.conn = None
                    conn.close()
                    with lock:
                        failures[0] += 1
                    return
                break
            except (ConnectionError, OSError, http.client.HTTPException):
                local.conn = None
                if conn is not None:
                    conn.close()
                if attempt == 2:
                    with lock:
                        failures[0] += 1
                    return
                time.sleep(0.05 * (attempt + 1))
        with lock:
            latencies.append(time.perf_counter() - t0)

    post(0)   # per-process warmup (excluded from the timed window)
    latencies.clear()
    failures[0] = 0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        list(pool.map(post, range(n_requests)))
    wall = time.perf_counter() - t0
    print(json.dumps({"wall": wall, "latencies": latencies,
                      "failures": failures[0],
                      "torch_imported": "torch" in sys.modules}))


def main(argv: list[str] | None = None) -> dict | None:
    """The server and its clients; returns the JSON line's fields (None in
    a client)."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--client"]:
        client(argv[1], int(argv[2]), int(argv[3]), raw="--raw" in argv)
        return None

    ap = argparse.ArgumentParser(prog="serve_bench")
    ap.add_argument("n_requests", type=int, nargs="?", default=400)
    ap.add_argument("concurrency", type=int, nargs="?", default=16)
    ap.add_argument("client_procs", type=int, nargs="?", default=4)
    ap.add_argument("--raw", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--img", type=int, default=None)
    args = ap.parse_args(argv)

    from maskunet_tpu_torch.core.device import card_name, tool_device

    t_setup = time.perf_counter()
    dev = tool_device("serve_bench", args.device)
    from maskunet_tpu_torch import serve
    from maskunet_tpu_torch.ops import flash_kernels as fk
    from maskunet_tpu_torch.tasks import recipes as recipes_lib

    raw = args.raw
    n_requests, concurrency = args.n_requests, args.concurrency
    n_procs = args.client_procs

    rec = recipes_lib.get("ade_semantic")
    if args.img is not None:
        rec = dataclasses.replace(rec, img_size=args.img)
    runner, img_size = serve.build_model_runner(
        rec, 150, None, "best", compute_dtype="bfloat16", batch_size=8,
        device=dev)
    # warm-up: cuDNN plans, the kernels' build
    serve._to_numpy(runner(np.zeros((8, img_size, img_size, 3), np.uint8)))
    fk.flash_fwd_nomax.launches = fk.flash_fwd_online.launches = 0
    batcher = serve._Batcher(runner, 8, max_wait_ms=5.0)
    ThreadingHTTPServer.request_queue_size = 128   # hold bursts > backlog
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), serve.make_handler(batcher, img_size, 150))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    setup_s = time.perf_counter() - t_setup

    per = max(n_requests // n_procs, 1)
    conc = max(concurrency // n_procs, 1)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--client", url,
         str(per), str(conc)] + (["--raw"] if raw else []),
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        for _ in range(n_procs)]
    outs = [p.communicate()[0] for p in procs]
    httpd.shutdown()
    httpd.server_close()

    latencies: list[float] = []
    walls = []
    failed = 0
    client_torch = False
    for out in outs:
        rec_out = json.loads(out.splitlines()[-1])
        latencies.extend(rec_out["latencies"])
        walls.append(rec_out["wall"])
        failed += rec_out.get("failures", 0)
        client_torch |= rec_out["torch_imported"]
    # clients overlap (subprocess startup is outside their timed window);
    # the slowest client's window spans the whole loaded period
    wall = max(walls)
    lat = np.sort(np.array(latencies))
    # the batcher counts a batch just after it wakes the batch's callers:
    # wait for the counts of every answered request (the clients' warm-up
    # posts included)
    answered = len(latencies) + failed + n_procs
    deadline = time.monotonic() + 5.0
    m = batcher.metrics()
    while (m["requests"] + m["errors"] + m["shed"] < answered
           and time.monotonic() < deadline):
        time.sleep(0.01)
        m = batcher.metrics()
    # all-failure runs must still report the diagnostics that explain
    # the outage (failed_requests, batch fill) instead of dying on an
    # empty-percentile IndexError
    result = {
        "requests": per * n_procs,
        "concurrency": conc * n_procs,
        "client_procs": n_procs,
        "response_format": "raw" if raw else "png",
        "req_per_sec": round(len(latencies) / wall, 1),
        "failed_requests": failed,
        "p50_ms": round(float(lat[len(lat) // 2]) * 1e3, 1) if len(lat)
        else None,
        "p99_ms": round(float(lat[int(len(lat) * 0.99)]) * 1e3, 1)
        if len(lat) else None,
        "avg_batch_fill": round(m["avg_batch_fill"], 3),
        "model_ms_ema": m["run_ms_ema"],
        "card": card_name(dev),
        "kernel_launches": {"K1": fk.flash_fwd_nomax.launches,
                            "K3": fk.flash_fwd_online.launches},
        "batches": m["batches"],
        "client_imports_torch": client_torch,
        "setup_s": setup_s,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
