"""Serving artifacts of the port (`maskunet_tpu_torch.export`) on the CPU.

- The artifact's `meta.json` has the keys of the JAX package's (JAX's
  exporter run on a stub forward: no model is compiled).
- An exported artifact, loaded back, gives the live runner's class maps
  exactly (f32, bf16, int8 and the safe softmax), and its program calls
  the flash operator 6 times a forward (`maskunet::flash_fwd_nomax`, or
  `maskunet::flash_fwd_online` when exported safe); int8 shrinks it as
  JAX's test requires (< 0.45 of the float artifact, both f32).
- A list of `--platforms` is refused (the server's flags:
  tests/test_torch_serve_extras.py).
- The operators' CPU implementation is the plain version, bit for bit,
  and passes `torch.library.opcheck`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from maskunet_tpu import export as jexport
from maskunet_tpu import serve as jserve
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu_torch import export as texport
from maskunet_tpu_torch import serve as tserve
from maskunet_tpu_torch.ops import flash_attention as tfa
from maskunet_tpu_torch.ops import flash_kernels as tk
from maskunet_tpu_torch.tasks import recipes as trecipes

IMG, BATCH, C_OUT = 16, 2, 8


@pytest.fixture(scope="module")
def recipe():
    return dataclasses.replace(trecipes.get("synthetic_semantic"),
                               img_size=IMG, batch_size=BATCH)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(
        0, 256, (BATCH, IMG, IMG, 3)).astype(np.uint8)


def _export(recipe, out, **kw):
    kw.setdefault("compute_dtype", "float32")
    texport.export_serving_artifact(recipe, C_OUT, None, "best", str(out),
                                    device="cpu", **kw)
    return str(out)


@pytest.fixture(scope="module")
def artifact(recipe, tmp_path_factory):
    return _export(recipe, tmp_path_factory.mktemp("f32"))


@pytest.fixture(scope="module")
def int8_artifact(recipe, tmp_path_factory):
    return _export(recipe, tmp_path_factory.mktemp("int8"), quantize="int8")


def _op_calls(path: str) -> dict:
    program = torch.export.load(os.path.join(path, texport.MODULE_NAME))
    names = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    return {op: names.count(f"maskunet.{op}.default")
            for op in ("flash_fwd_nomax", "flash_fwd_online")}


def test_meta_keys_equal_jax(monkeypatch, recipe, artifact, tmp_path):
    """JAX's exporter on a stub forward (its meta does not depend on the
    model): the port's meta.json has the same keys and, where the two
    packages agree by design, the same values."""
    jcfg = jmu.MaskAttnUNetConfig(c_out=C_OUT, img_size=IMG)

    def stub(*args, **kw):
        return (lambda p, x: x[..., 0], {}, None, jcfg)

    monkeypatch.setattr(jserve, "build_inference_fn", stub)
    jrec = dataclasses.replace(jrecipes.get("synthetic_semantic"),
                               img_size=IMG, batch_size=BATCH)
    jexport.export_serving_artifact(jrec, C_OUT, None, "best",
                                    str(tmp_path), compute_dtype="float32",
                                    batch_size=BATCH)
    with open(tmp_path / jexport.META_NAME) as f:
        want = json.load(f)
    with open(os.path.join(artifact, texport.META_NAME)) as f:
        got = json.load(f)
    assert list(got) == list(want)
    for key in ("recipe", "img_size", "num_classes", "batch_size",
                "compute_dtype", "quantize", "calibrated", "input_shape",
                "output", "platforms"):
        assert got[key] == want[key], key
    assert got["attn_impl"] == "flash"


@pytest.mark.parametrize("variant", ["f32", "bf16", "int8", "safe"])
def test_artifact_equals_live_runner(variant, monkeypatch, recipe, artifact,
                                     int8_artifact, images, tmp_path):
    kw = {"bf16": dict(compute_dtype="bfloat16"),
          "int8": dict(quantize="int8")}.get(variant, {})
    if variant == "safe":
        monkeypatch.setattr(tfa, "_SAFE_SOFTMAX", True)
    path = {"f32": artifact, "int8": int8_artifact}.get(variant)
    if path is None:
        path = _export(recipe, tmp_path, **kw)
    runner, meta = texport.load_serving_artifact(path)
    kw.setdefault("compute_dtype", "float32")
    live, img_size = tserve.build_model_runner(recipe, C_OUT, None,
                                               device="cpu", **kw)
    got = runner(images)
    assert got.dtype == torch.uint8 and got.shape == (BATCH, IMG, IMG)
    assert torch.equal(got, live(images))
    assert meta["img_size"] == img_size and meta["platforms"] == ["cpu"]
    assert meta["quantize"] == kw.get("quantize")
    assert _op_calls(path) == {
        "flash_fwd_nomax": 0 if variant == "safe" else 6,
        "flash_fwd_online": 6 if variant == "safe" else 0}


def test_int8_artifact_is_smaller(artifact, int8_artifact):
    """JAX's bound (tests/test_quantize.py:108): the int8 artifact under
    0.45 of the float one, both exported in f32."""
    qb = os.path.getsize(os.path.join(int8_artifact, texport.MODULE_NAME))
    fb = os.path.getsize(os.path.join(artifact, texport.MODULE_NAME))
    assert qb < 0.45 * fb, (qb, fb)


def test_platforms_name_one_device(recipe, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        texport.main(["--recipe", "synthetic_semantic", "--out",
                      str(tmp_path), "--num-classes", "8", "--platform",
                      "cpu", "--platforms", "cuda,cpu"])
    assert e.value.code == 2
    assert "runs only on the device it was traced on" in \
        capsys.readouterr().err
    for platforms, match in ((["cuda", "cpu"], "runs only on the device"),
                             (["tpu"], "one of 'cuda' or 'cpu'"),
                             (["cuda"], "the export runs on cpu")):
        with pytest.raises(ValueError, match=match):
            _export(recipe, tmp_path, platforms=platforms)
    assert not os.listdir(tmp_path)


def _op_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 64, generator=g) * 0.125
    k = torch.randn(2, 24, 64, generator=g)
    v = torch.randn(2, 24, 64, generator=g)
    bias = torch.zeros(2, 1, 24)
    bias[1, 0, 5:] = tk.NEG_INF
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_valid", [True, False])
def test_operators_on_the_cpu_are_the_plain_versions(dtype, use_valid):
    q, k, v, bias = (t.to(dtype) if t.dim() == 3 and i < 3 else t
                     for i, t in enumerate(_op_inputs()))
    before = (tk.flash_fwd_nomax.launches, tk.flash_fwd_online.launches)
    o = torch.ops.maskunet.flash_fwd_nomax(q, k, v, bias, 0.5, use_valid)
    assert torch.equal(o, tk.flash_fwd_nomax_reference(q, k, v, bias, 0.5,
                                                       use_valid))
    o, lse = torch.ops.maskunet.flash_fwd_online(q, k, v, bias, 0.5,
                                                 use_valid)
    want_o, want_lse = tk.flash_fwd_online_reference(q, k, v, bias, 0.5,
                                                     use_valid)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert (tk.flash_fwd_nomax.launches,
            tk.flash_fwd_online.launches) == before


def test_operators_pass_opcheck():
    """Schema, fake (shape-only) implementation, autograd registration
    and tracing of both operators, by `torch.library.opcheck`."""
    q, k, v, bias = _op_inputs()
    for op in (torch.ops.maskunet.flash_fwd_nomax.default,
               torch.ops.maskunet.flash_fwd_online.default):
        result = torch.library.opcheck(op, (q, k, v, bias, 0.5, True))
        assert set(result.values()) == {"SUCCESS"}, result
