"""The port's checkpoints (maskunet_tpu_torch.core.checkpoint) against the
JAX package's, both ways, on the CPU.

- The codec (`core/_msgpack.py`) writes the bytes flax's `to_bytes` writes
  for the same tree, and reads flax's bytes back to the same tree. Leaves
  over flax's MAX_CHUNK_SIZE are chunked on writing and joined on reading,
  as flax does (both limits lowered here to reach that path).
- JAX -> port: a JAX `setup_state` state (synthetic_semantic at 16 px,
  batch 2, c_out 4) with random BN statistics and AdamW moments, count 3,
  written by JAX's `CheckpointManager`. The port restores logits within
  `test_torch_model.py`'s F32 bound (1e-4 absolute and relative: f32 noise
  through ~25 convs), the moments and count exactly (a transpose is
  exact), and one AdamW step from there matches optax's within 1e-6 of
  each tensor's largest entry plus 2e-5 of its largest update: optax
  computes the bias correction 1 - 0.999^4 in f32, 1.5e-5 off (torch in
  f64), so a zero-initialised bias, all update, differs by ~1e-5 of it.
- port -> JAX: a file the port writes restores in JAX's
  `restore_inference`, with logits within the same F32 bound; the port's
  state dict has the JAX state's layout, leaf for leaf, with and without
  an lr schedule (apart from `rng`, a generator state here and a PRNG key
  there).
- Warm start, and the async saves.

Each full-width state is ~270 MB on disk; tests delete their files.
"""

import dataclasses
import os
import threading

import flax.serialization as fs
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from maskunet_tpu.core import checkpoint as jckpt
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu.tasks import recipes as jrecipes
from maskunet_tpu.train import loop as jloop
from maskunet_tpu_torch.core import _msgpack
from maskunet_tpu_torch.core import checkpoint as tckpt
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.train import loop as tloop
from maskunet_tpu_torch.train import step as tstep
from maskunet_tpu_torch.utils import jax_weights

F32 = dict(atol=1e-4, rtol=1e-4)
C_OUT = 4
SMALL = dict(img_size=16, batch_size=2)
JR = dataclasses.replace(jrecipes.get("synthetic_semantic"), **SMALL)
TR = dataclasses.replace(trecipes.get("synthetic_semantic"), **SMALL)


def _remove(directory) -> None:
    for name in os.listdir(directory):
        if ".msgpack" in name:
            os.remove(os.path.join(directory, name))


@pytest.fixture
def workdir(tmp_path):
    yield str(tmp_path)
    _remove(tmp_path)


def _structure(tree):
    """Nested keys with (shape, dtype) leaves."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if tree is None:
        return None
    return (tuple(np.shape(tree)), str(np.asarray(tree).dtype))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _codec_tree(rng):
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "bf16": rng.standard_normal((5, 2)).astype(ml_dtypes.bfloat16),
        "ints": {"i32": rng.integers(-9, 9, (7,)).astype(np.int32),
                 "u32": rng.integers(0, 2 ** 32, (2,), dtype=np.uint32),
                 "bool": rng.random((2, 3)) > 0.5,
                 "scalar0d": np.asarray(3, np.int32)},
        "np_scalars": {"f": np.float32(2.5), "i": np.int32(-7),
                       "b": np.bool_(True)},
        "python": (1, -40, 300, -300, 70000, -70000, 2 ** 40, -2 ** 40,
                   1.5, True, None, "x" * 40, b"raw"),
        "wide_map": {str(i): i for i in range(20)},
        "empty": {},
        "transposed": np.arange(6, dtype=np.float32).reshape(2, 3).T,
    }


def _as_port(tree):
    """The tree with bf16 as the port holds it (a torch tensor)."""
    out = dict(tree)
    out["bf16"] = torch.from_numpy(
        np.array(tree["bf16"]).view(np.uint16)).view(torch.bfloat16)
    return out


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.uint16), want.view(torch.uint16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


def test_codec_writes_flax_bytes_and_reads_them_back(rng):
    tree = _codec_tree(rng)
    want = fs.to_bytes(tree)
    assert _msgpack.packb(_as_port(tree)) == want
    # both readers give the same tree from either writer
    _assert_same(_msgpack.unpackb(want), _as_port(fs.msgpack_restore(want)))
    restored = fs.msgpack_restore(_msgpack.packb(_as_port(tree)))
    np.testing.assert_array_equal(restored["bf16"].view(np.uint16),
                                  tree["bf16"].view(np.uint16))
    assert restored["python"]["12"] == b"raw"


def test_codec_chunks_and_joins_large_leaves_as_flax(rng, monkeypatch):
    """Chunked arrays are joined on reading and written chunked (flax's
    form), the choice this codec makes for leaves over 2^30 bytes."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "small": np.arange(3, dtype=np.int32)}
    want = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in want
    assert _msgpack.packb(tree) == want
    back = _msgpack.unpackb(want)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(fs.msgpack_restore(want)["w"], tree["w"])


def test_codec_refuses_complex():
    with pytest.raises(ValueError, match="complex"):
        _msgpack.unpackb(fs.to_bytes({"c": 1 + 2j}))
    with pytest.raises(TypeError, match="complex"):
        _msgpack.packb({"c": 1 + 2j})
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(fs.to_bytes({"a": np.zeros(4, np.float32)})[:-3])


# ---------------------------------------------------------------------------
# JAX -> port
# ---------------------------------------------------------------------------

def _jax_state(schedule: str | None = None):
    jcfg = jloop.model_config(JR, C_OUT, attn_impl="dense")
    tx = jloop.make_optimizer(JR, lr_schedule=schedule, total_steps=10,
                              warmup_steps=2)
    return jloop.setup_state(JR, jcfg, tx), jcfg


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX state with random BN statistics and AdamW moments, count 3,
    written by JAX's CheckpointManager; (path, numpy state, cfg)."""
    ts, jcfg = _jax_state()
    rng = np.random.default_rng(1)
    draw = lambda scale: lambda p: (   # noqa: E731
        scale * rng.standard_normal(np.shape(p))).astype(np.float32)

    def randomize_bn(tree):
        if set(tree) == {"mean", "var"}:
            return {"mean": draw(0.1)(tree["mean"]),
                    "var": 1.0 + np.abs(draw(0.3)(tree["var"]))}
        return {k: randomize_bn(v) for k, v in tree.items()}

    mstate = randomize_bn(jax.tree.map(np.asarray, ts.model_state))
    params = jax.tree.map(np.asarray, ts.params)
    mu = jax.tree.map(draw(1e-3), params)
    nu = jax.tree.map(lambda p: draw(1e-3)(p) ** 2, params)
    adam = ts.opt_state[0]._replace(count=jnp.asarray(3, jnp.int32),
                                    mu=mu, nu=nu)
    ts = ts.replace(step=jnp.asarray(3, jnp.int32), model_state=mstate,
                    opt_state=(adam,) + tuple(ts.opt_state[1:]))
    directory = tmp_path_factory.mktemp("jax_ckpt")
    manager = jckpt.CheckpointManager(str(directory), JR.checkpoint_name)
    manager.save_latest(ts)
    manager.wait()
    yield (os.path.join(directory, f"{JR.checkpoint_name}_latest.msgpack"),
           jax.tree.map(np.asarray, jckpt._unkey(ts)), jcfg)
    _remove(directory)


def _port_state(schedule: str | None = None):
    tcfg = tloop.model_config(TR, C_OUT)
    opt = tloop.make_optimizer(TR, lr_schedule=schedule, total_steps=10,
                               warmup_steps=2)
    return tloop.setup_state(TR, tcfg, opt, device="cpu"), tcfg


def _images(seed=5):
    return np.random.default_rng(seed).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)


def _jax_logits(params, mstate, masks, jcfg, x):
    fn = jax.jit(lambda p, s: jmu.apply(
        p, s, jnp.asarray(x), cfg=jcfg,
        masks=tuple(jnp.asarray(m) for m in masks), train=False)[0].semantic)
    return np.asarray(fn(params, mstate))


def _port_logits(ts, tcfg, x):
    with torch.no_grad():
        out, _ = tmu.apply(ts.params, ts.model_state, torch.from_numpy(x),
                           cfg=tcfg, masks=ts.masks, train=False)
    return out.semantic.numpy()


def test_jax_checkpoint_restores_in_port(jax_checkpoint):
    path, jts, jcfg = jax_checkpoint
    ts, tcfg = _port_state()
    tckpt.restore(path, ts)
    assert ts.step == 3
    for got, want in zip(ts.masks, jts.masks):
        np.testing.assert_array_equal(got.numpy(), want)
    x = _images()
    np.testing.assert_allclose(
        _port_logits(ts, tcfg, x),
        _jax_logits(jts.params, jts.model_state, jts.masks, jcfg, x), **F32)
    # AdamW's moments and count are optax's, exactly
    adam = jts.opt_state[0]
    mu, _ = jax_weights.from_jax(adam.mu, jts.model_state, tcfg)
    nu, _ = jax_weights.from_jax(adam.nu, jts.model_state, tcfg)
    for k, p in ts.params.items():
        st = ts.optimizer.state[p]
        assert float(st["step"]) == 3.0
        assert torch.equal(st["exp_avg"], mu[k])
        assert torch.equal(st["exp_avg_sq"], nu[k])
    # the JAX key seeds the dropout generator, the same way each time
    ts2, _ = _port_state()
    tckpt.restore(path, ts2)
    assert torch.equal(ts.generator.get_state(), ts2.generator.get_state())


def test_adamw_step_after_jax_restore_matches_optax(jax_checkpoint):
    path, jts, _ = jax_checkpoint
    ts, tcfg = _port_state()
    tckpt.restore(path, ts)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        jts.params)
    tx = optax.adamw(JR.lr, weight_decay=JR.weight_decay)
    adam = jts.opt_state[0]
    opt_state = (optax.ScaleByAdamState(
        count=jnp.asarray(adam.count), mu=adam.mu, nu=adam.nu),
        optax.EmptyState(), optax.EmptyState())
    updates, _ = tx.update(grads, opt_state, jts.params)
    want, _ = jax_weights.from_jax(
        jax.tree.map(np.asarray, optax.apply_updates(jts.params, updates)),
        jts.model_state, tcfg)
    tgrads, _ = jax_weights.from_jax(grads, jts.model_state, tcfg)
    for k, p in ts.params.items():
        p.grad = tgrads[k]
    ts.optimizer.step()
    before, _ = jax_weights.from_jax(jts.params, jts.model_state, tcfg)
    for k, p in ts.params.items():
        w = want[k].numpy()
        update = np.abs(w - before[k].numpy()).max()
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=0,
            atol=1e-6 * np.abs(w).max() + 2e-5 * update, err_msg=k)


# ---------------------------------------------------------------------------
# port -> JAX
# ---------------------------------------------------------------------------

def test_port_checkpoint_restores_in_jax_inference(workdir):
    ts, tcfg = _port_state()
    # one training step, so params, BN statistics and moments are not init
    batch = {"image": torch.from_numpy(_images(7)),
             "label": torch.from_numpy(np.random.default_rng(8).integers(
                 0, C_OUT, (2, 16, 16)))}
    step = tstep.make_train_step(
        tcfg, TR.task_config, mask_plans=tmu.precompute_mask_plans(ts.masks),
        device="cpu")
    ts, _ = step(ts, batch)
    manager = tckpt.CheckpointManager(workdir, TR.checkpoint_name)
    manager.save_best(ts)
    manager.wait()
    template, jcfg = _jax_state()
    jts = jckpt.restore_inference(
        os.path.join(workdir, f"{TR.checkpoint_name}_best.msgpack"),
        template)
    assert int(jts.step) == 1
    x = _images()
    np.testing.assert_allclose(
        _jax_logits(jts.params, jts.model_state, jts.masks, jcfg, x),
        _port_logits(ts, tcfg, x), **F32)


@pytest.mark.parametrize("schedule", [None, "warmup_cosine"])
def test_port_state_dict_has_the_jax_layout(schedule):
    jts, _ = _jax_state(schedule)
    want = fs.to_state_dict(jax.device_get(jckpt._unkey(jts)))
    ts, _ = _port_state(schedule)
    got = tckpt.to_tree(tckpt.snapshot(ts))
    assert list(got) == list(want)
    assert _structure(got["rng"]) == ((5056,), "uint8")
    assert _structure(want["rng"]) == ((2,), "uint32")
    for tree in (got, want):
        del tree["rng"]
    assert _structure(_msgpack.unpackb(_msgpack.packb(got))) == \
        _structure(want)


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def donor_and_init():
    init = lambda c: jax.tree.map(np.asarray, jmu.init(   # noqa: E731
        jax.random.key(c), jmu.MaskAttnUNetConfig(c_out=c, img_size=16))[0])
    return init(C_OUT), init(6)


@pytest.mark.parametrize("drop", [(), ("attn1",), ("down1/block1",)])
def test_transfer_params_matches_jax(donor_and_init, drop):
    donor, fresh = donor_and_init
    want, want_skipped = jckpt.transfer_params(fresh, donor,
                                               drop_prefixes=drop)
    got, skipped = tckpt.transfer_params(fresh, donor, drop_prefixes=drop)
    assert skipped == want_skipped
    assert ("final_conv", "kernel") in skipped   # the c_out 6 head is fresh
    jax.tree.map(np.testing.assert_array_equal, got, want)
    # and on a port state: its parameters become JAX's merge of its own
    # fresh init and the donor
    tcfg = tmu.MaskAttnUNetConfig(c_out=6, img_size=16)
    ts = tloop.setup_state(TR, tcfg, tloop.make_optimizer(TR), device="cpu")
    fresh_tree, mstate = jax_weights.to_jax(ts.params, ts.model_state, tcfg)
    want, _ = jckpt.transfer_params(fresh_tree, donor, drop_prefixes=drop)
    assert tckpt.warm_start(ts, donor, drop) == skipped
    want_flat, _ = jax_weights.from_jax(want, mstate, tcfg)
    for k, p in ts.params.items():
        assert torch.equal(p.detach(), want_flat[k]), k


# ---------------------------------------------------------------------------
# async saves
# ---------------------------------------------------------------------------

def test_async_save_writes_the_state_at_save_time(workdir, monkeypatch):
    """The save thread writes the snapshot taken in `save_latest`, not the
    live state: it is held back until the parameters, moments and BN
    statistics have been overwritten in place."""
    ts, _ = _port_state()
    for p in ts.params.values():
        p.grad = torch.ones_like(p)
    ts.optimizer.step()
    want = {k: p.detach().clone() for k, p in ts.params.items()}
    want_m = {k: ts.optimizer.state[p]["exp_avg"].clone()
              for k, p in ts.params.items()}
    mutated = threading.Event()
    to_tree = tckpt.to_tree

    def held_back(snap):
        assert mutated.wait(30)
        return to_tree(snap)

    monkeypatch.setattr(tckpt, "to_tree", held_back)
    manager = tckpt.CheckpointManager(workdir, "c")
    manager.save_latest(ts)
    with torch.no_grad():
        for p in ts.params.values():
            p.add_(1.0)
            ts.optimizer.state[p]["exp_avg"].add_(1.0)
    mutated.set()
    manager.wait()
    back, _ = _port_state()
    manager.restore(back, "latest")
    for k, p in back.params.items():
        assert torch.equal(p.detach(), want[k]), k
        assert torch.equal(back.optimizer.state[p]["exp_avg"], want_m[k]), k


def test_failed_async_save_reraises_in_wait(workdir, monkeypatch):
    def full_disk(path, tree):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(tckpt, "_write", full_disk)
    ts, _ = _port_state()
    manager = tckpt.CheckpointManager(workdir, "c")
    manager.save_best(ts)
    with pytest.raises(RuntimeError, match="'best' failed") as err:
        manager.wait()
    assert isinstance(err.value.__cause__, OSError)
    manager.wait()          # reported once
    assert not manager.has("best")


def test_import_meta_round_trip(workdir):
    assert tckpt.read_import_meta(workdir, "c") is None
    tckpt.write_import_meta(workdir, "c", {"attn_output_layout": "reshape"})
    assert jckpt.read_import_meta(workdir, "c") == \
        tckpt.read_import_meta(workdir, "c") == \
        {"attn_output_layout": "reshape"}
