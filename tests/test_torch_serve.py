"""The port's serving path (maskunet_tpu_torch.serve) on the CPU.

The JAX server and the port's runner get the same folded weights and
serving masks (the JAX server's own, handed over through the port's
`make_forward` seam) and must give the same class maps: synthetic_semantic
at img 32, batch 2, f32. Class maps are compared exactly except on pixels
where JAX's two best logits are within 1e-4 of each other (f32 noise can
order a near-tie either way; ReLU'd logits of a random init tie at 0 on
most pixels), and the logits behind them to 1e-4 (f32 noise).

pyproject's `error::DeprecationWarning:maskunet_tpu` filter also matches
`maskunet_tpu_torch` (unanchored regex): the port avoids deprecated torch
calls instead of editing the filter.
"""

import concurrent.futures
import dataclasses
import inspect
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu import serve as jserve
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu_torch import serve as tserve
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.tasks import recipes as trecipes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_recipes_equal_field_for_field():
    assert list(trecipes.RECIPES) == list(jrecipes.RECIPES)
    for name, jr in jrecipes.RECIPES.items():
        assert dataclasses.asdict(trecipes.get(name)) == \
            dataclasses.asdict(jr), name
    assert [f.name for f in dataclasses.fields(trecipes.TaskConfig)] == \
        [f.name for f in dataclasses.fields(jrecipes.TaskConfig)]
    with pytest.raises(KeyError):
        trecipes.get("nope")


def _folded_from_jax(tree: dict, prefix_map: dict) -> dict:
    """JAX folded serving params -> the port's folded dict."""
    out = {}
    for jpath, tkey in prefix_map.items():
        node = tree
        for p in jpath:
            node = node[p]
        w = np.asarray(node["kernel"])
        out[f"{tkey}.weight"] = torch.from_numpy(np.ascontiguousarray(
            w.T if w.ndim == 2 else w.transpose(3, 2, 0, 1)))
        out[f"{tkey}.bias"] = torch.from_numpy(np.array(node["bias"]))
    for i in range(1, 7):
        norm = tree[f"attn{i}"]["norm"]
        out[f"self_attention{i}.norm.weight"] = torch.from_numpy(
            np.array(norm["scale"]))
        out[f"self_attention{i}.norm.bias"] = torch.from_numpy(
            np.array(norm["offset"]))
    fn = tree["final_norm"]
    out["norm.weight"] = torch.from_numpy(
        np.asarray(fn["scale"]).transpose(2, 0, 1).copy())
    out["norm.bias"] = torch.from_numpy(
        np.asarray(fn["offset"]).transpose(2, 0, 1).copy())
    return out


def _folded_map() -> dict:
    m = {}

    def block(jpath, tprefix):
        m[jpath + ("conv1",)] = f"{tprefix}.0"
        m[jpath + ("conv2",)] = f"{tprefix}.3"

    block(("initial",), "initial_conv.conv_block")
    for i in (1, 2, 3):
        block((f"down{i}", "block1"),
              f"downsample{i}.maxpool_conv.1.conv_block")
        block((f"down{i}", "block2"),
              f"downsample{i}.maxpool_conv.2.conv_block")
        block((f"up{i}", "block1"), f"upsample{i}.conv.0.conv_block")
        block((f"up{i}", "block2"), f"upsample{i}.conv.1.conv_block")
        block((f"bottom{i}",), f"bottom{i}.conv_block")
    for i in range(1, 7):
        for n in ("query", "key", "value"):
            m[(f"attn{i}", n)] = f"self_attention{i}.{n}"
    m[("final_conv",)] = "final_layer.0"
    return m


@pytest.fixture(scope="module")
def shared():
    """The JAX server's folded weights and masks, and a port runner on
    them (synthetic_semantic, img 32, batch 2, f32, CPU)."""
    rec = dataclasses.replace(jrecipes.get("synthetic_semantic"),
                              img_size=32, batch_size=2)
    jfwd, jinfer, jmasks, jcfg = jserve.build_inference_fn(
        rec, 8, "/nonexistent_workdir", "best", compute_dtype="float32",
        batch_size=2)
    tcfg = tmu.MaskAttnUNetConfig(c_out=8, img_size=32)
    tinfer = _folded_from_jax(jinfer, _folded_map())
    tmasks = tuple(torch.from_numpy(np.array(m)) for m in jmasks)
    forward = tserve.make_forward(tinfer, tmasks,
                                  tmu.precompute_mask_plans(tmasks), tcfg,
                                  "cpu")
    return dict(jfwd=jfwd, jinfer=jinfer, jmasks=jmasks, jcfg=jcfg,
                forward=forward, tinfer=tinfer, tmasks=tmasks, tcfg=tcfg)


def test_runner_class_maps_match_jax_server(shared):
    images = np.random.default_rng(0).integers(
        0, 256, (2, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(shared["jfwd"](shared["jinfer"], images))
    got = shared["forward"](images)
    assert got.dtype == torch.uint8 and got.shape == (2, 32, 32)
    # JAX's logits, to find the near-ties an f32 difference may flip
    logits = np.asarray(jax.jit(lambda p, x: jmu.apply(
        p, None, x, cfg=shared["jcfg"], masks=shared["jmasks"], train=False,
        folded=True)[0].semantic)(shared["jinfer"],
                                  jnp.asarray(images, jnp.float32) / 255.0))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert decided.mean() > 0.2
    np.testing.assert_array_equal(got.numpy()[decided], want[decided])
    # and the logits behind the maps agree to f32 noise
    x = torch.from_numpy(images).float() / 255.0
    with torch.no_grad():
        out, _ = tmu.apply(shared["tinfer"], None, x, cfg=shared["tcfg"],
                           masks=shared["tmasks"], folded=True)
    np.testing.assert_allclose(out.semantic.numpy(), logits, atol=1e-4,
                               rtol=1e-4)


def test_batcher_concurrent_requests(shared):
    forward = shared["forward"]
    batcher = tserve._Batcher(forward, 2, max_wait_ms=20.0)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
              for _ in range(6)]
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        results = list(ex.map(batcher.predict, images))
    for img, res in zip(images, results):
        direct = forward(np.stack([img, img]))[0].numpy()
        np.testing.assert_array_equal(res, direct)
    m = batcher.metrics()
    assert m["requests"] == 6 and m["errors"] == 0 and m["batches"] >= 3


def test_http_round_trip(shared):
    batcher = tserve._Batcher(shared["forward"], 2, max_wait_ms=5.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tserve.make_handler(batcher, 32, 8))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert b'"status": "ok"' in r.read()
        img = np.random.default_rng(2).integers(
            0, 255, (48, 40, 3)).astype(np.uint8)
        ok, jpg = cv2.imencode(".jpg", img)
        req = urllib.request.Request(url + "/predict", data=jpg.tobytes(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            mask = cv2.imdecode(np.frombuffer(r.read(), np.uint8),
                                cv2.IMREAD_GRAYSCALE)
        assert mask.shape == (32, 32) and mask.max() < 8
        req = urllib.request.Request(url + "/predict?format=raw",
                                     data=jpg.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = np.frombuffer(r.read(), np.uint8).reshape(32, 32)
        np.testing.assert_array_equal(raw, mask)
    finally:
        httpd.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_device_defaults_to_cuda_and_raises_without():
    for fn in (tserve.build_model_runner, tserve.build_inference_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.build_model_runner("synthetic_semantic", 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--recipe", "synthetic_semantic", "--num-classes", "8"])


def test_fresh_runner_on_cpu_and_jax_checkpoint_refused(tmp_path):
    runner, img = tserve.build_model_runner(
        dataclasses.replace(trecipes.get("synthetic_semantic"), img_size=16),
        5, str(tmp_path), batch_size=2, compute_dtype="float32",
        device="cpu")
    out = runner(np.zeros((2, img, img, 3), np.uint8))
    assert out.shape == (2, 16, 16) and out.dtype == torch.uint8
    (tmp_path / "checkpoint_synth_best.msgpack").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="checkpoint slice"):
        tserve.build_model_runner("synthetic_semantic", 8, str(tmp_path),
                                  device="cpu")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without jax or
    any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import maskunet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'maskunet_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('maskunet_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 27
