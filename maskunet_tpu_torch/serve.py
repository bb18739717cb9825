"""HTTP inference server on the port: batched mask prediction on the card.

Counterpart of maskunet_tpu/serve.py. A stdlib ThreadingHTTPServer accepts
image uploads and returns class-id mask PNGs; requests are micro-batched
(up to `batch_size` requests or `max_wait_ms`), run through one forward of
the folded bf16 model, and fanned back out.

    python -m maskunet_tpu_torch.serve --recipe ade_semantic \\
        --data-root <ADEChallengeData2016> --port 8799 [--device cuda]

    curl -s -X POST --data-binary @image.jpg \\
        http://localhost:8799/predict > mask.png
    curl -s http://localhost:8799/healthz

The model is `{workdir}/{checkpoint_name}_{tag}.msgpack` where there is
one, written by the JAX package or by the port (the same format), and a
fresh init seeded with the recipe's seed otherwise, as the JAX server does.
The class count is `--num-classes`, or the recipe's dataset's (read under
`--data-root`, as the JAX server does). `--quantize int8` serves int8 convs
(`--calibrate-images <dir>`: static activation scales from those images);
`--artifact <dir>` serves an exported artifact (`maskunet_tpu_torch.export`)
in place of the checkpoint. Multi-card serving (`--n-data`) belongs to the
parallel slice and is refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from maskunet_tpu_torch.core import checkpoint as ckpt_lib
from maskunet_tpu_torch.core.device import exact_f32, resolve_device
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.tasks import recipes as recipes_lib
from maskunet_tpu_torch.train import loop as loop_lib


class _Batcher:
    """Micro-batching executor: blocks callers until their result is ready."""

    def __init__(self, run_batch, batch_size: int, max_wait_ms: float = 10.0,
                 predict_timeout_s: float = 300.0, pipeline_depth: int = 3):
        self._run = run_batch
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.predict_timeout_s = predict_timeout_s
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        # handler-tracked in-flight count: covers accept -> model run ->
        # response written, which the queue alone cannot see
        self._inflight = 0
        self.stats = {"requests": 0, "errors": 0, "batches": 0,
                      "batched_images": 0, "shed": 0, "run_ms_ema": 0.0}
        # dispatched-but-unfetched batches ride this bounded queue to the
        # resolver thread, so the worker keeps assembling and launching
        # while up to `pipeline_depth` batches are still on the card;
        # put() blocking when full bounds the result buffers
        self._resolve_q: queue.Queue = queue.Queue(max(1, pipeline_depth))
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True)
        self._resolver.start()

    @contextlib.contextmanager
    def track(self):
        """Context manager marking one request in flight (handler-scoped)."""
        with self._lock:
            self._inflight += 1
        try:
            yield
        finally:
            with self._lock:
                self._inflight -= 1

    def pending(self) -> int:
        """Requests accepted but not yet fully responded to."""
        with self._lock:
            return self._inflight

    def metrics(self) -> dict:
        with self._lock:
            s = dict(self.stats)
        s["avg_batch_fill"] = (s["batched_images"] / s["batches"]
                               / self.batch_size if s["batches"] else 0.0)
        s["queue_depth"] = self._q.qsize()
        return s

    def predict(self, image: np.ndarray) -> np.ndarray:
        done = threading.Event()
        slot: dict = {}
        self._q.put((image, slot, done))
        if not done.wait(self.predict_timeout_s):
            # mark abandoned so the worker sheds it instead of spending
            # model time on a request whose client already got a 503
            slot["abandoned"] = True
            raise TimeoutError("prediction timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def _worker(self) -> None:
        # Dispatch loop: assembles batches and hands the (asynchronous)
        # device results to the resolver thread; it never waits on the
        # card, so one batch's result copy overlaps the next batches.
        while True:
            first = self._q.get()
            items = [first]
            deadline = time.monotonic() + self.max_wait
            while len(items) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            live = [it for it in items if not it[1].get("abandoned")]
            if len(live) != len(items):
                with self._lock:
                    self.stats["shed"] += len(items) - len(live)
            items = live
            if not items:
                continue
            # batch assembly inside the try: a malformed request must fail
            # its batch, not kill this singleton worker thread
            t0 = time.monotonic()
            try:
                images = np.stack([im for im, _, _ in items])
                pad = self.batch_size - len(items)
                if pad:
                    images = np.concatenate(
                        [images, np.repeat(images[-1:], pad, axis=0)])
                preds = self._run(images)   # asynchronous launch, no fetch
            except Exception as e:  # noqa: BLE001
                for _, slot, done in items:
                    slot["error"] = repr(e)
                    done.set()
                with self._lock:
                    self.stats["errors"] += len(items)
                    self.stats["batches"] += 1
                    self.stats["batched_images"] += len(items)
                continue
            self._resolve_q.put((preds, items, t0))   # blocks when full

    def _resolve_loop(self) -> None:
        while True:
            self._resolve(self._resolve_q.get())

    def _resolve(self, entry) -> None:
        """Fetch a dispatched batch's results and wake its callers."""
        preds, items, t0 = entry
        try:
            # ONE whole-batch copy to the host; it waits for the card, and
            # a fault of the batch's kernels surfaces here
            preds = _to_numpy(preds)
            for i, (_, slot, done) in enumerate(items):
                slot["result"] = preds[i]
                done.set()
            with self._lock:
                self.stats["requests"] += len(items)
        except Exception as e:  # noqa: BLE001
            for _, slot, done in items:
                if not done.is_set():
                    slot["error"] = repr(e)
                    done.set()
            with self._lock:
                self.stats["errors"] += len(items)
        with self._lock:
            self.stats["batches"] += 1
            self.stats["batched_images"] += len(items)
            ms = (time.monotonic() - t0) * 1e3
            ema = self.stats["run_ms_ema"]
            self.stats["run_ms_ema"] = round(
                ms if ema == 0.0 else 0.9 * ema + 0.1 * ms, 2)


def _to_numpy(preds) -> np.ndarray:
    if isinstance(preds, torch.Tensor):
        return preds.cpu().numpy()
    return np.asarray(preds)


def model_config(recipe: recipes_lib.Recipe, num_classes: int, *,
                 attn_impl: str = "auto",
                 compute_dtype: str = "float32") -> mu.MaskAttnUNetConfig:
    return mu.MaskAttnUNetConfig(
        c_out=num_classes, img_size=recipe.img_size,
        embed_dim=recipe.embed_dim,
        with_boundary_head=recipe.with_boundary_head,
        attn_impl=attn_impl, compute_dtype=compute_dtype,
        attn_output_layout=recipe.attn_output_layout)


def classify(infer_params: dict, masks: tuple | None, plans: tuple | None,
             cfg: mu.MaskAttnUNetConfig,
             images: torch.Tensor) -> torch.Tensor:
    """Class maps uint8 [B,H,W] of uint8 images [B,H,W,3] already on the
    device: the folded forward on `infer_params` with the serving masks
    and their plans, its argmax. The live forward and the exported
    artifact both run it."""
    out, _ = mu.apply(infer_params, None, images.float() / 255.0, cfg=cfg,
                      masks=masks, folded=True, mask_plans=plans)
    return out.semantic.argmax(dim=-1).to(torch.uint8)


def make_forward(infer_params: dict, masks: tuple | None, plans: tuple | None,
                 cfg: mu.MaskAttnUNetConfig, device: str | torch.device):
    """forward(images uint8 [B,H,W,3]) -> class maps uint8 [B,H,W] on
    `device` (not synchronised). `infer_params` are folded (and cast) and,
    with `masks` and `plans`, already on `device`."""
    device = torch.device(device)

    @torch.no_grad()
    def forward(images) -> torch.Tensor:
        return classify(infer_params, masks, plans, cfg,
                        torch.as_tensor(images).to(device))

    return forward


def build_inference_fn(recipe, num_classes: int, workdir: str | None = None,
                       tag: str = "best", *, attn_impl: str = "auto",
                       compute_dtype: str = "bfloat16",
                       batch_size: int | None = None,
                       quantize: str | None = None,
                       calibrate_images: str | None = None,
                       device: str | torch.device = "cuda"):
    """The folded serving forward and its operands: returns
    ``(forward, infer_params, masks, cfg)`` with ``forward(x_uint8)`` the
    class-map prediction. The weights and masks are the checkpoint's
    `{checkpoint_name}_{tag}.msgpack` in `workdir` where there is one (the
    JAX package's or the port's), else the recipe's seeded init. Masks (row
    0 broadcast over the batch, so an image scores the same in every slot)
    and their compaction plans are baked in as one pair. Shared with the
    exporter (`maskunet_tpu_torch.export`), so both serve the same
    computation.

    `quantize="int8"`: int8 convs (`mu.quantize_params_for_inference`);
    `calibrate_images`, with it: a directory of sample images whose
    per-conv activation maxima become static scales (every image counts;
    the ragged tail batch is padded by repetition, which adds no maximum)."""
    if isinstance(recipe, str):
        recipe = recipes_lib.get(recipe)
    if quantize is not None and quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if calibrate_images and quantize is None:
        raise ValueError("--calibrate-images requires --quantize int8")
    dev = resolve_device(device)
    exact_f32()
    cfg = model_config(recipe, num_classes, attn_impl=attn_impl,
                       compute_dtype=compute_dtype)
    ts = loop_lib.setup_state(recipe, cfg, loop_lib.make_optimizer(recipe),
                              device=dev)
    if workdir is not None:
        ckpt = os.path.join(workdir, f"{recipe.checkpoint_name}_{tag}.msgpack")
        if os.path.exists(ckpt):
            ts = ckpt_lib.restore_inference(ckpt, ts)
    # serving masks: row 0 of the state's masks broadcast over the batch,
    # so an image scores the same in every slot and at any batch size
    batch = batch_size or recipe.batch_size
    masks = tuple(m[:1].expand(batch, -1).contiguous() for m in ts.masks)
    plans = mu.precompute_mask_plans(masks)
    with torch.no_grad():
        infer_params = mu.fold_bn_for_inference(ts.params, ts.model_state,
                                                cfg)
    infer_params = {k: v.detach().to(dev) for k, v in infer_params.items()}
    if quantize == "int8":
        act_scales = None
        if calibrate_images:
            from maskunet_tpu_torch.tasks.predict import _DirectoryDataset
            cal_ds = _DirectoryDataset(calibrate_images, cfg.img_size)
            imgs = np.stack([cal_ds[i]["image"] for i in range(len(cal_ds))])
            chunks = []
            for i in range(0, len(imgs), batch):
                c = imgs[i:i + batch]
                if len(c) < batch:
                    c = np.concatenate(
                        [c, np.repeat(c[-1:], batch - len(c), axis=0)])
                chunks.append(torch.from_numpy(c).to(dev))
            print(json.dumps({"calibration_images": len(imgs),
                              "calibration_batches": len(chunks)}),
                  flush=True)

            def forward_float(p, chunk):
                mu.apply(p, None, chunk.float() / 255.0, cfg=cfg,
                         masks=masks, folded=True, mask_plans=plans)

            act_scales = mu.calibrate_activation_scales(
                infer_params, forward_float, chunks)
        infer_params = mu.quantize_params_for_inference(
            infer_params, act_scales=act_scales)
    if compute_dtype == "bfloat16":
        infer_params = mu.cast_params_for_inference(infer_params)
    forward = make_forward(infer_params, masks, plans, cfg, dev)
    return forward, infer_params, masks, cfg


def build_model_runner(recipe, num_classes: int, workdir: str | None = None,
                       tag: str = "best", *, attn_impl: str = "auto",
                       compute_dtype: str = "bfloat16",
                       batch_size: int | None = None,
                       quantize: str | None = None,
                       calibrate_images: str | None = None,
                       device: str | torch.device = "cuda"):
    """Returns (runner(images_uint8 [B,H,W,3]) -> class maps, img_size).
    The runner returns the device tensor without waiting for it."""
    forward, _, _, cfg = build_inference_fn(
        recipe, num_classes, workdir, tag, attn_impl=attn_impl,
        compute_dtype=compute_dtype, batch_size=batch_size,
        quantize=quantize, calibrate_images=calibrate_images, device=device)
    return forward, cfg.img_size


def make_handler(batcher: _Batcher, img_size: int, num_classes: int,
                 draining: threading.Event | None = None):
    import cv2

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive; every response path sends Content-Length
        protocol_version = "HTTP/1.1"
        # idle kept-alive connections close after this many seconds
        timeout = 30

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                if draining is not None and draining.is_set():
                    body = json.dumps({"status": "draining"}).encode()
                    self.send_response(503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                body = json.dumps({"status": "ok",
                                   "img_size": img_size,
                                   "num_classes": num_classes}).encode()
            elif self.path == "/metrics":
                body = json.dumps(batcher.metrics()).encode()
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path.split("?", 1)[0] != "/predict":
                self.send_error(404)
                return
            with batcher.track():
                self._predict()

        def _predict(self):
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            buf = np.frombuffer(data, np.uint8)
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            if img is None:
                self.send_error(400, "could not decode image")
                return
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (img_size, img_size),
                             interpolation=cv2.INTER_LINEAR)
            try:
                mask = batcher.predict(img)
            except TimeoutError as e:
                self.send_error(503, str(e))
                return
            except RuntimeError as e:
                self.send_error(500, str(e))
                return
            if "format=raw" in self.path:
                # raw row-major uint8 class ids, [img_size, img_size]
                body = mask.tobytes()
                ctype = "application/octet-stream"
            else:
                ok, png = cv2.imencode(".png", mask)
                body = png.tobytes()
                ctype = "image/png"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def main(argv=None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe")
    ap.add_argument("--artifact", default=None,
                    help="serve an exported artifact directory "
                         "(maskunet_tpu_torch.export) instead of building "
                         "the model from a checkpoint")
    ap.add_argument("--workdir", default="runs")
    ap.add_argument("--tag", default="best")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--num-classes", type=int, default=None,
                    help="class count (default: the recipe's dataset's, "
                         "read under --data-root)")
    ap.add_argument("--port", type=int, default=8799)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--pipeline-depth", type=int, default=3,
                    help="dispatched-but-unfetched batches kept in flight")
    ap.add_argument("--predict-timeout-s", type=float, default=300.0,
                    help="per-request wall clock before a 503")
    ap.add_argument("--drain-timeout-s", type=float, default=10.0,
                    help="max seconds to drain in-flight batches on "
                         "SIGTERM/SIGINT before exiting")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="int8-quantize the conv weights (the class maps "
                         "are not bit-equal to the float model's)")
    ap.add_argument("--calibrate-images", default=None,
                    help="with --quantize int8: directory of sample "
                         "images for static activation scales instead of "
                         "per-sample dynamic ones")
    ap.add_argument("--n-data", type=int, default=None,
                    help="data-parallel serving over N cards: belongs to "
                         "the parallel slice, refused here")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (an artifact runs where it was "
                         "exported)")
    args = ap.parse_args(argv)

    if args.n_data is not None:
        ap.error("--n-data (data-parallel serving) belongs to the parallel "
                 "slice of the port, which is not ported yet")
    if args.artifact:
        # an artifact is a frozen computation: its batch, classes and
        # quantization were fixed at export time
        for value, name in ((args.quantize, "--quantize"),
                            (args.calibrate_images, "--calibrate-images"),
                            (args.batch_size, "--batch-size"),
                            (args.num_classes, "--num-classes")):
            if value is not None:
                ap.error(f"{name} cannot be combined with --artifact "
                         "(it was fixed at export time)")
        from maskunet_tpu_torch import export as export_lib
        runner, meta = export_lib.load_serving_artifact(args.artifact)
        num_classes = meta["num_classes"]
        img_size = meta["img_size"]
        batch = meta["batch_size"]
        served = meta.get("recipe", args.artifact)
        device = meta["platforms"][0]
    else:
        if not args.recipe:
            ap.error("--recipe is required unless --artifact is given")
        recipe = recipes_lib.get(args.recipe)
        # reference-imported checkpoints must serve with the attention
        # layout their weights encode (the import records it)
        meta = ckpt_lib.read_import_meta(args.workdir,
                                         recipe.checkpoint_name)
        layout = (meta or {}).get("attn_output_layout", "transpose")
        if layout != recipe.attn_output_layout:
            recipe = dataclasses.replace(recipe, attn_output_layout=layout)
            print(f"attention-output layout: {layout} (from import "
                  "sidecar)", flush=True)
        if args.num_classes is not None:
            num_classes = args.num_classes
        else:
            from maskunet_tpu_torch.tasks.datasets import make_datasets
            _, _, num_classes = make_datasets(recipe, args.data_root)
        batch = args.batch_size or recipe.batch_size
        runner, img_size = build_model_runner(
            recipe, num_classes, args.workdir, args.tag,
            compute_dtype=args.compute_dtype, batch_size=batch,
            quantize=args.quantize, calibrate_images=args.calibrate_images,
            device=args.device)
        served = args.recipe
        device = args.device
    # warm up (kernel build, cuDNN plans) before accepting traffic
    _to_numpy(runner(np.zeros((batch, img_size, img_size, 3), np.uint8)))
    batcher = _Batcher(runner, batch, args.max_wait_ms,
                       predict_timeout_s=args.predict_timeout_s,
                       pipeline_depth=args.pipeline_depth)

    # default listen backlog (5) refuses connections under bursty load
    ThreadingHTTPServer.request_queue_size = 128
    draining = threading.Event()
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port),
        make_handler(batcher, img_size, num_classes, draining=draining))

    # graceful shutdown: SIGTERM/SIGINT flip /healthz to 503 but keep
    # accepting while in-flight requests drain; the accept loop stops
    # after 0.5 s of sustained quiet or the drain deadline
    def _drain_then_stop(signame: str) -> None:
        print(json.dumps({"shutdown": signame}), flush=True)
        deadline = time.monotonic() + args.drain_timeout_s
        quiet = 0
        while time.monotonic() < deadline:
            if batcher.pending() == 0:
                quiet += 1
                if quiet >= 10:
                    break
            else:
                quiet = 0
            time.sleep(0.05)
        server.shutdown()

    def _term(signum, frame):
        if draining.is_set():
            return   # second signal: drain already in progress
        draining.set()
        threading.Thread(target=_drain_then_stop,
                         args=(signal.Signals(signum).name,),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    print(json.dumps({"serving": served, "port": args.port,
                      "batch_size": batch, "img_size": img_size,
                      "device": device}),
          flush=True)
    server.serve_forever()
    server.server_close()
    print(json.dumps({"stopped": served,
                      "drained": batcher.pending() == 0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
