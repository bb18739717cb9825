"""int8 serving of the port against the JAX package's.

The same JAX-initialised model (c_out 8, 16 px, f32), BN-folded by JAX and
handed to the port, is quantized by both packages:

- `quantize_params_for_inference`: `kernel_q` equal exactly (HWIO ->
  OIHW), `w_scale` within 1 ulp;
- one int8 conv on the same quantized params and input: the quantized
  activations and the int32 accumulators equal, the output within 1 ulp;
- `calibrate_activation_scales`, keys related by `jax_weights.mapping`:
  on the same input to each conv, every conv's maximum within 1e-6
  relative (measured: equal); over the whole model on the same batches
  (both on their dense attention) within 1e-5, the f32 noise of the two
  packages' float forwards after up to 33 convs (measured: 2.7e-6 at
  worst, bottom2's second conv);
- every conv of JAX's (jitted) quantized forward, fed JAX's input to it:
  the same quantized activations and int32 sums, the output within 2 ulp
  of its largest entry;
- the whole quantized folded forward at 16 px, batch 2 (JAX's dense
  attention, the port's flash path on the kernel's plain version): logits
  within 2e-2 rms relative, argmax agreement >= 0.99 (measured 9.1e-3
  and 0.998: see `test_quantized_forward_matches_jax` for why int8 does
  not keep the float models' 1e-6 agreement);
- batch-composition invariance of the int8 runner, bf16 composition, and
  the error messages.

JAX's quantized forwards run once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskunet_tpu.core import layers as jlayers
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu_torch import serve as tserve
from maskunet_tpu_torch.core import layers as tlayers
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.utils import jax_weights

IMG, BATCH, C_OUT = 16, 2, 8


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def folded_from_jax(tree: dict) -> dict:
    """JAX's folded (or quantized) serving tree -> the port's flat dict:
    each conv and linear of `jax_weights.mapping` with its bias (folding
    gave every conv one), the attention and final norms; int8 leaves
    (`kernel_q`, `w_scale`, `a_scale`) keep their names."""
    out = {}
    for tkey, _, path, to_torch, _ in jax_weights.mapping():
        prefix, leaf = tkey.rsplit(".", 1)
        try:
            node = _node(tree, path[:-1])
        except KeyError:          # a BatchNorm, folded away
            continue
        if path[-1] == "kernel":
            if "kernel_q" in node:
                out[f"{prefix}.kernel_q"] = torch.from_numpy(
                    np.array(to_torch(np.asarray(node["kernel_q"]))))
                out[f"{prefix}.w_scale"] = torch.from_numpy(
                    np.array(node["w_scale"]))
                if "a_scale" in node:
                    out[f"{prefix}.a_scale"] = torch.from_numpy(
                        np.array(node["a_scale"]))
            else:
                out[tkey] = torch.from_numpy(
                    np.array(to_torch(np.asarray(node["kernel"]))))
            out[f"{prefix}.bias"] = torch.from_numpy(np.array(node["bias"]))
        elif path[-1] in node:
            out[tkey] = torch.from_numpy(
                np.array(to_torch(np.asarray(node[path[-1]]))))
    return out


def jax_conv_names() -> dict:
    """The port's conv name ('initial_conv.conv_block.0') -> JAX's
    ('initial/conv1'), from `jax_weights.mapping`."""
    return {tkey[:-len(".weight")]: "/".join(path[:-1])
            for tkey, _, path, _, _ in jax_weights.mapping()
            if path[-1] == "kernel" and tkey.rsplit(".", 2)[-2].isdigit()}


@pytest.fixture(scope="module")
def model():
    jcfg = jmu.MaskAttnUNetConfig(c_out=C_OUT, img_size=IMG,
                                  compute_dtype="float32")
    params, state = jmu.init(jax.random.key(0), jcfg)
    # running statistics away from (0, 1), so that folding moves weights
    rng = np.random.default_rng(1)
    state = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
             else rng.normal(0.0, 0.1, a.shape)).astype(np.float32)),
        state)
    folded = jmu.fold_bn_for_inference(params, state, jcfg)
    masks = jmu.make_attention_masks(jax.random.key(2), BATCH, IMG)
    images = [rng.uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
              for _ in range(3)]
    tcfg = tmu.MaskAttnUNetConfig(c_out=C_OUT, img_size=IMG)
    return dict(jcfg=jcfg, folded=folded, masks=masks, images=images,
                tcfg=tcfg, tfolded=folded_from_jax(folded),
                tmasks=tuple(torch.from_numpy(np.array(m)) for m in masks))


def _jax_forward(cfg, masks):
    def fwd(p, x):
        out, _ = jmu.apply(p, None, x, cfg=cfg, masks=masks, train=False,
                           folded=True)
        return out.semantic
    return fwd


@pytest.fixture(scope="module")
def jax_scales(model):
    dense = dataclasses.replace(model["jcfg"], attn_impl="dense")
    return jmu.calibrate_activation_scales(
        model["folded"], _jax_forward(dense, model["masks"]),
        [jnp.asarray(x) for x in model["images"]])


@pytest.fixture(scope="module")
def jax_int8(model, jax_scales):
    """JAX's quantized forward, dynamic and calibrated, jitted with every
    conv's input and output as extra outputs (the conv is wrapped while it
    traces, as JAX's calibration does): {mode: (logits, [(JAX conv path,
    conv input, conv output) in call order])}."""
    out = {}
    for mode, scales in (("dynamic", None), ("calibrated", jax_scales)):
        q = jmu.quantize_params_for_inference(model["folded"],
                                              act_scales=scales)
        paths = {}

        def index(node, path):
            if isinstance(node, dict) and "kernel_q" in node:
                paths[id(node)] = "/".join(path)
            elif isinstance(node, dict):
                for k, v in node.items():
                    index(v, path + (k,))

        index(q, ())
        order = []

        def run(x):
            calls = []
            orig = jlayers.conv2d

            def recording(p, x, **kw):
                y = orig(p, x, **kw)
                order.append(paths[id(p)])
                calls.append((x, y))
                return y

            jlayers.conv2d = recording
            try:
                logits = _jax_forward(model["jcfg"], model["masks"])(q, x)
            finally:
                jlayers.conv2d = orig
            return logits, calls

        logits, calls = jax.jit(run)(jnp.asarray(model["images"][0]))
        out[mode] = (np.asarray(logits),
                     [(path, np.asarray(x), np.asarray(y))
                      for path, (x, y) in zip(order, calls)])
    return out


def _port_quantized(model, jax_scales, mode):
    scales = None
    if mode == "calibrated":
        names = jax_conv_names()
        scales = {n: jax_scales[names[n]] for n in names}
    return tmu.quantize_params_for_inference(model["tfolded"],
                                             act_scales=scales)


def test_quantized_weights_equal_jax(model):
    jq = jmu.quantize_params_for_inference(model["folded"])
    tq = tmu.quantize_params_for_inference(model["tfolded"])
    want = folded_from_jax(jq)
    assert set(tq) == set(want)
    convs = [k for k in tq if k.endswith(".kernel_q")]
    assert len(convs) == 33 and not any(k.endswith(".weight") and
                                        tq[k].dim() == 4 for k in tq)
    for k in convs:
        assert tq[k].dtype == torch.int8
        assert torch.equal(tq[k], want[k]), k
        s = k[:-len("kernel_q")] + "w_scale"
        # f32 within 1 ulp
        np.testing.assert_array_max_ulp(tq[s].numpy(), want[s].numpy(), 1)
    # the attention linears stay float (they feed the flash kernel)
    assert tq["self_attention1.query.weight"].dtype == torch.float32


def test_one_int8_conv_equals_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 3, 64, 24)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    scale = np.maximum(np.abs(k).max(axis=(0, 1, 2)), 1e-12) / 127.0
    kq = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    jp = {"kernel_q": jnp.asarray(kq), "w_scale": jnp.asarray(scale),
          "bias": jnp.asarray(bias)}
    want = np.asarray(jlayers.conv2d(jp, jnp.asarray(x)))
    # JAX's quantized activations and int32 sums, step by step
    a = np.asarray(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)),
                                       axis=(1, 2, 3), keepdims=True)
                               / 127.0, 1e-12))
    xq = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / a), -127,
                             127).astype(jnp.int8))
    acc = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    tk = torch.from_numpy(kq.transpose(3, 2, 0, 1).copy())
    tx = torch.from_numpy(x)
    ta = torch.clamp(tx.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0,
                     min=1e-12)
    txq = torch.clamp(torch.round(tx / ta), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(ta.numpy(), a)
    np.testing.assert_array_equal(txq.numpy(), xq)
    got_acc = tlayers.conv2d_int8_accumulate(txq, tk)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), acc)
    got = tlayers.conv2d_int8(tk, torch.from_numpy(scale),
                              torch.from_numpy(bias), tx)
    np.testing.assert_array_max_ulp(got.numpy(), want, 1)


def test_calibration_records_what_jax_records(model):
    """Both calibrations over forwards that give every conv the same input
    (three batches of one random array per conv): the same maxima."""
    names = jax_conv_names()
    rng = np.random.default_rng(5)
    convs = {n: np.asarray(_node(model["folded"], names[n].split("/"))
                           ["kernel"]).shape[2] for n in names}
    batches = [{n: (rng.standard_normal((BATCH, 4, 4, c)) * rng.uniform(
        0.1, 10)).astype(np.float32) for n, c in convs.items()}
        for _ in range(3)]

    def jax_forward(p, chunk):
        for n in names:
            jlayers.conv2d(_node(p, names[n].split("/")), chunk[n])

    def port_forward(p, chunk):
        for n in names:
            tlayers.conv2d(p[f"{n}.weight"], p[f"{n}.bias"], chunk[n])

    want = jmu.calibrate_activation_scales(
        model["folded"], jax_forward,
        [{n: jnp.asarray(x) for n, x in b.items()} for b in batches])
    got = tmu.calibrate_activation_scales(
        model["tfolded"], port_forward,
        [{n: torch.from_numpy(x) for n, x in b.items()} for b in batches])
    assert len(got) == 33 and {names[n] for n in got} == set(want)
    for name, v in got.items():
        assert abs(v - want[names[name]]) <= 1e-6 * want[names[name]], name


def test_calibrated_scales_of_the_model_equal_jax(model, jax_scales):
    dense = dataclasses.replace(model["tcfg"], attn_impl="dense")

    def forward(p, x):
        tmu.apply(p, None, x, cfg=dense, masks=model["tmasks"], folded=True)

    got = tmu.calibrate_activation_scales(
        model["tfolded"], forward,
        [torch.from_numpy(x) for x in model["images"]])
    names = jax_conv_names()
    assert len(got) == 33 and set(names) == set(got)
    for name, v in got.items():
        want = jax_scales[names[name]]
        assert abs(v - want) <= 1e-5 * abs(want), (name, v, want)


@pytest.mark.parametrize("mode", ["dynamic", "calibrated"])
def test_every_int8_conv_of_the_model_equals_jax(model, jax_scales, jax_int8,
                                                 mode):
    """Each of the 33 convs of JAX's quantized forward, given JAX's input
    to it: the same quantized activations and int32 sums, the output
    within 2 ulp of its largest entry."""
    tq = _port_quantized(model, jax_scales, mode)
    names = {j: t for t, j in jax_conv_names().items()}
    calls = jax_int8[mode][1]
    assert len(calls) == 33
    for path, x, want in calls:
        name = names[path]
        a_scale = tq.get(f"{name}.a_scale")
        tx = torch.from_numpy(x.copy())
        if a_scale is None:
            a = torch.clamp(tx.abs().amax(dim=(1, 2, 3), keepdim=True)
                            / 127.0, min=1e-12)
            ja = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)),
                                     axis=(1, 2, 3), keepdims=True) / 127.0,
                             1e-12)
        else:
            a, ja = a_scale, jnp.asarray(a_scale.numpy())
        xq = torch.clamp(torch.round(tx / a), -127, 127).to(torch.int8)
        jxq = jnp.clip(jnp.round(jnp.asarray(x) / ja), -127,
                       127).astype(jnp.int8)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        kq = tq[f"{name}.kernel_q"]
        acc = jax.lax.conv_general_dilated(
            jxq, jnp.asarray(kq.permute(2, 3, 1, 0).numpy()), (1, 1),
            "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(
            tlayers.conv2d_int8_accumulate(xq, kq).numpy(), np.asarray(acc))
        got = tlayers.conv2d_int8(kq, tq[f"{name}.w_scale"],
                                  tq[f"{name}.bias"], tx, a_scale=a_scale)
        # jitted, XLA fuses the dequant and the bias into one FMA (one
        # rounding where the port has two): 2 f32 ulp of the largest output
        tol = 2.0 ** -22 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -22,
                                   atol=tol)


@pytest.mark.parametrize("mode", ["dynamic", "calibrated"])
def test_quantized_forward_matches_jax(model, jax_scales, jax_int8, mode):
    """The whole forward. A one-ulp difference of a conv's input (the two
    packages' GELU, norms and attention round differently) flips a
    rounding to int8 where x / a sits on a .5 boundary, which moves that
    activation by a whole quantization step, and the flips compound: the
    two int8 models differ by about int8's own error against the float
    model (1.1e-2 rms here), not by f32 noise. Bound: 2e-2 rms relative
    (measured 9.1e-3), argmax agreement >= 0.99 (measured 0.998)."""
    tq = _port_quantized(model, jax_scales, mode)
    with torch.no_grad():
        out, _ = tmu.apply(tq, None, torch.from_numpy(model["images"][0]),
                           cfg=model["tcfg"], masks=model["tmasks"],
                           folded=True)
    got, want = out.semantic.numpy(), jax_int8[mode][0]
    assert np.mean(want > 0) > 0.2          # logits that mean something
    rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert rel <= 2e-2, rel
    assert agree >= 0.99, agree


@pytest.fixture(scope="module")
def tiny_recipe():
    return dataclasses.replace(trecipes.get("synthetic_semantic"),
                               img_size=IMG, batch_size=BATCH)


def test_int8_batch_composition_invariance(tiny_recipe):
    """Per-sample activation scales: an image's int8 prediction does not
    depend on its batch-mates."""
    runner, _ = tserve.build_model_runner(
        tiny_recipe, C_OUT, None, compute_dtype="float32", quantize="int8",
        device="cpu")
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, (IMG, IMG, 3)).astype(np.uint8)
    bright = np.full((IMG, IMG, 3), 255, np.uint8)
    dark = np.zeros((IMG, IMG, 3), np.uint8)
    a = runner(np.stack([img, bright]))[0]
    b = runner(np.stack([img, dark]))[0]
    assert torch.equal(a, b)


def test_int8_composes_with_bf16_cast(tiny_recipe):
    """As JAX's `test_int8_composes_with_bf16_cast`: the int8 kernels and
    f32 scales survive the cast, the bias is cast."""
    forward, params, _, _ = tserve.build_inference_fn(
        tiny_recipe, C_OUT, None, compute_dtype="bfloat16", quantize="int8",
        device="cpu")
    name = "initial_conv.conv_block.0"
    assert params[f"{name}.kernel_q"].dtype == torch.int8
    assert params[f"{name}.w_scale"].dtype == torch.float32
    assert params[f"{name}.bias"].dtype == torch.bfloat16
    assert f"{name}.weight" not in params
    assert params["self_attention1.query.weight"].dtype == torch.bfloat16
    assert params["norm.weight"].dtype == torch.float32
    out = forward(np.zeros((BATCH, IMG, IMG, 3), np.uint8))
    assert out.shape == (BATCH, IMG, IMG) and int(out.max()) < C_OUT


def test_calibrate_images_through_the_server(tiny_recipe, tmp_path, capsys):
    """`calibrate_images`: every image counts (3 images at batch 2: two
    batches, the second padded by repetition), a static scale per conv."""
    import cv2
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i}.png"),
                    rng.integers(0, 256, (20, 24, 3)).astype(np.uint8))
    forward, params, _, _ = tserve.build_inference_fn(
        tiny_recipe, C_OUT, None, compute_dtype="float32", quantize="int8",
        calibrate_images=str(tmp_path), device="cpu")
    assert '{"calibration_images": 3, "calibration_batches": 2}' in \
        capsys.readouterr().out
    scales = [k for k in params if k.endswith(".a_scale")]
    assert len(scales) == 33
    assert all(float(params[k]) > 0 for k in scales)
    assert forward(np.zeros((BATCH, IMG, IMG, 3), np.uint8)).shape == (
        BATCH, IMG, IMG)


def test_error_messages(model, tiny_recipe, tmp_path):
    with pytest.raises(RuntimeError, match="recorded no conv activations"):
        tmu.calibrate_activation_scales(model["tfolded"],
                                        lambda p, x: None, [None])
    with pytest.raises(ValueError, match="no calibrated activation scale "
                                         "for conv 'final_layer.0'"):
        tmu.quantize_params_for_inference(
            model["tfolded"], act_scales={n: 1.0 for n in jax_conv_names()
                                          if n != "final_layer.0"})
    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        tserve.build_inference_fn(tiny_recipe, C_OUT, None,
                                  quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="--calibrate-images requires "
                                         "--quantize int8"):
        tserve.build_inference_fn(tiny_recipe, C_OUT, None,
                                  calibrate_images=str(tmp_path),
                                  device="cpu")
