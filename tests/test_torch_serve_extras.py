"""The server's extras on the CPU: `serve --artifact` and `serve
--quantize int8 --calibrate-images` over HTTP in a subprocess, each
answering with its runner's class maps; the flags an artifact fixed, and
`--n-data`, refused with exit code 2.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from maskunet_tpu_torch import export as texport
from maskunet_tpu_torch import serve as tserve
from maskunet_tpu_torch.tasks import recipes as trecipes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, BATCH, C_OUT = 16, 2, 8


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    recipe = dataclasses.replace(trecipes.get("synthetic_semantic"),
                                 img_size=IMG, batch_size=BATCH)
    out = str(tmp_path_factory.mktemp("f32"))
    texport.export_serving_artifact(recipe, C_OUT, None, "best", out,
                                    compute_dtype="float32", device="cpu")
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_thread():
    """One torch thread here and in the server: on the CPU a class map
    can depend on the thread count (sums split otherwise, near ties)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {"OMP_NUM_THREADS": "1"}
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ["artifact", "int8"])
def test_server_over_http(mode, artifact, one_thread, tmp_path):
    """`python -m maskunet_tpu_torch.serve --artifact <dir>`, and `--recipe
    ... --quantize int8 --calibrate-images <dir>`, answer requests with
    their runner's class maps, then drain on SIGTERM."""
    if mode == "artifact":
        runner, _ = texport.load_serving_artifact(artifact)
        img_size, argv = IMG, ["--artifact", artifact]
    else:
        rng = np.random.default_rng(1)
        for i in range(3):
            cv2.imwrite(str(tmp_path / f"{i}.png"),
                        rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
        runner, img_size = tserve.build_model_runner(
            "synthetic_semantic", C_OUT, None, compute_dtype="float32",
            batch_size=BATCH, quantize="int8",
            calibrate_images=str(tmp_path), device="cpu")
        argv = ["--recipe", "synthetic_semantic", "--num-classes",
                str(C_OUT), "--batch-size", str(BATCH), "--compute-dtype",
                "float32", "--quantize", "int8", "--calibrate-images",
                str(tmp_path), "--workdir", str(tmp_path / "none"),
                "--device", "cpu"]
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "maskunet_tpu_torch.serve", *argv, "--port",
         str(port), "--max-wait-ms", "1"], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, **one_thread},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.2)
        assert health == {"status": "ok", "img_size": img_size,
                          "num_classes": C_OUT}
        images = np.random.default_rng(0).integers(
            0, 256, (BATCH, img_size, img_size, 3)).astype(np.uint8)
        for img in images:
            ok, png = cv2.imencode(".png", img[..., ::-1])  # RGB as BGR
            req = urllib.request.Request(url + "/predict?format=raw",
                                         data=png.tobytes(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got = np.frombuffer(r.read(), np.uint8).reshape(img_size,
                                                                img_size)
            want = runner(np.stack([img] * BATCH))[0].numpy()
            np.testing.assert_array_equal(got, want)
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    assert [l for l in lines if "serving" in l] == [{
        "serving": "synthetic_semantic", "port": port, "batch_size": BATCH,
        "img_size": img_size, "device": "cpu"}]
    assert lines[-1] == {"stopped": "synthetic_semantic", "drained": True}
    if mode == "int8":
        assert lines[0] == {"calibration_images": 3,
                            "calibration_batches": 2}


@pytest.mark.parametrize("flags", [
    ["--quantize", "int8"], ["--calibrate-images", "x"],
    ["--batch-size", "4"], ["--num-classes", "8"]])
def test_artifact_refuses_what_it_fixed(flags, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--artifact", "nowhere", *flags])
    assert e.value.code == 2
    assert (f"{flags[0]} cannot be combined with --artifact"
            in capsys.readouterr().err)


@pytest.mark.parametrize("argv, message", [
    # more replicas than the host has cards (the card default)
    (["--recipe", "ade_semantic", "--n-data", "2"],
     "--n-data 2: mesh needs 2 devices"),
    (["--artifact", "nowhere", "--n-data", "2"],
     "--n-data cannot be combined with --artifact"),
    ([], "--recipe is required unless --artifact is given")])
def test_serve_refusals(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(argv)
    assert e.value.code == 2 and message in capsys.readouterr().err


