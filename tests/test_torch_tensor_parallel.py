"""The port's tensor parallelism on the CPU: a 2x2 (data, model) mesh of
four gloo ranks against one process and against JAX.

JAX's contract (tests/test_sharding.py:142-163): a 4x2 (data, model) mesh
step, the batch over 'data' and the 512-wide bottleneck over 'model',
equals the single-device step: the loss at rtol 1e-5, bottom2's first
conv kernel after one SGD update at atol 2e-5, its BatchNorm's running
mean at atol 1e-6. Here one spawn of four ranks
(`tests/torch_parallel_ranks.py::tp_all`, the setup of
tests/test_sharding.py:21-37: c_out 4, 16 px, dense attention, dropout 0,
SGD 1e-2) runs the 2x2 TP step (with `remat_attention`), and rank 0 the
port's one-process step, held at those tolerances (every parameter and
running stat, not only bottom2's). The TP eval forward, gathered over
'data', is held to JAX's single-device `mu.apply` (no mesh; jitted,
which takes 2.6 s here against 16 s op by op) on the same weights (1e-4,
tests/test_torch_model.py's bound). Also: the mesh's sizes,
refusals and rank mapping; the lead; the gathers' two backwards and the
model-parallel input's, each against autograd in one process; the TP eval
step, `loop.evaluate` and `evaluate_panoptic` against one process;
`loop.train` on the mesh for one step, one writer of its checkpoint and
log; and serving on a mesh of one process (1x2 and 2x2), whose class maps
equal one device's. Torch is pinned to one thread while the file runs.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu_torch.utils import jax_weights


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """One spawn of the 4 ranks runs every check (`tp_all`); the workdir
    of its `loop.train` is listed, then deleted (a full-width
    checkpoint)."""
    work = tmp_path_factory.mktemp("tp_loop")
    try:
        res = ranks.spawn(ranks.tp_all, 4, str(work))
        files = sorted(os.listdir(work))
        logs = {f: open(os.path.join(work, f)).read().count("\n")
                for f in files if f.endswith(".jsonl")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res, files, logs


def test_tp_mesh_sizes_and_refusals(tp):
    res, _, _ = tp
    for r in res:
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["refusals"] == ["mesh 2x2 != 3 devices",
                                 "mesh of 1x2 ranks in a process group of 4"]


def test_tp_rank_mapping_and_lead(tp):
    """Rank r is data index r // 2 and model index r % 2, as JAX's
    `reshape(n_data, n_model)` lays the devices out; only global rank 0
    leads."""
    res, _, _ = tp
    for r in res:
        g = r["global_rank"]
        assert (r["data_index"], r["model_index"]) == divmod(g, 2)
        assert r["lead"] == (g == 0) and r["device"] == "cpu"


@pytest.mark.parametrize("name", ["sharded", "replicated",
                                  "model_parallel_input"])
def test_tp_gather_backwards(tp, name):
    """A gather feeding a column-sharded consumer all-reduces its
    gradient before slicing; one feeding replicated code only slices; the
    whole input of a column-sharded consumer sums the partial gradients.
    Each against autograd on the whole tensors in one process."""
    res, _, _ = tp
    for r in res:
        assert r["gathers"][name] <= 1e-6, r["gathers"]


def test_tp_step_equals_one_process_step(tp):
    res, _, _ = tp
    r0 = res[0]
    want = r0["want_metrics"]
    assert set(r0["metrics"]) == set(want)
    for k in want:
        np.testing.assert_allclose(r0["metrics"][k], want[k], rtol=1e-5,
                                   err_msg=k)
    assert r0["bottom2_diff"] <= 2e-5
    assert r0["params_diff"] <= 2e-5
    assert r0["state_diff"] <= 1e-6
    # every rank made the same update and holds the same metrics
    for r in res[1:]:
        np.testing.assert_array_equal(r["sums"], r0["sums"])
        assert r["metrics"] == r0["metrics"]


def test_tp_eval_forward_equals_jax(tp):
    """The TP eval forward's logits, gathered over 'data', against JAX's
    single-device `mu.apply` on the same weights and masks; the
    bottleneck's output (bottom3's, whole on every rank) equals the
    forward without a mesh on the rank's rows."""
    res, _, _ = tp
    cfg, _, ts, batch = ranks.tp_scenario()
    jcfg = jmu.MaskAttnUNetConfig(c_out=cfg.c_out, img_size=cfg.img_size,
                                  attn_impl="dense", dropout_rate=0.0)
    jparams, jstate = jax_weights.to_jax(ts.params, ts.model_state, cfg)
    masks = tuple(jnp.asarray(m.numpy()) for m in ts.masks)
    want = np.asarray(jax.jit(lambda p, s, x: jmu.apply(
        p, s, x, cfg=jcfg, train=False, masks=masks)[0].semantic)(
        jparams, jstate, jnp.asarray(batch["image"])))
    for r in res:
        np.testing.assert_allclose(r["logits"], want, atol=1e-4, rtol=1e-4)
        assert r["bottleneck_shape"] == (4, 2, 2, 256)
        assert r["bottleneck_diff"] <= 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix: float(tree)}


@pytest.mark.parametrize("what", ["step", "evaluate", "panoptic"])
def test_tp_evaluation_equals_one_process(tp, what):
    """The TP eval step (its metrics and gathered class maps),
    `loop.evaluate` and `evaluate_panoptic` with the mesh, against the
    same without one (JAX's evaluation contract, atol 1e-5)."""
    res, _, _ = tp
    tp_, one = res[0]["evals"]["tp"], res[0]["evals"]["one"]
    got, want = _flat(tp_[what]), _flat(one[what])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    if what == "step":
        np.testing.assert_array_equal(tp_["pred"], one["pred"])


def test_loop_train_on_a_tp_mesh_writes_once(tp):
    """`loop.train(mesh=)` on the 2x2 mesh for one step: every rank ends
    with the same params, and only global rank 0 wrote (one checkpoint,
    one log record)."""
    res, files, logs = tp
    for r in res:
        assert r["loop"]["epochs"] == 1 and r["loop"]["stop"] == "max_steps"
        np.testing.assert_array_equal(r["loop"]["sums"],
                                      res[0]["loop"]["sums"])
    assert [f for f in files if f.endswith(".msgpack")] == [
        "checkpoint_synth_latest.msgpack"]
    assert list(logs.values()) == [1]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tp_serving_equals_one_device(shape):
    """`build_model_runner` on a (data, model) mesh driven by this one
    process (every shard on a CPU device of its own) gives the class maps
    of the single-device runner, exactly (f32)."""
    from maskunet_tpu_torch import serve as tserve
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.tasks import recipes as trecipes
    recipe = dataclasses.replace(trecipes.get("synthetic_semantic"),
                                 img_size=16, batch_size=4)
    kw = dict(compute_dtype="float32", device="cpu")
    n_data, n_model = shape
    mesh = mesh_lib.make_mesh(n_data, n_model=n_model,
                              devices=["cpu"] * (n_data * n_model))
    single, _ = tserve.build_model_runner(recipe, 5, None, **kw)
    tp, size = tserve.build_model_runner(recipe, 5, None, mesh=mesh, **kw)
    images = np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3),
                                               dtype=np.uint8)
    assert size == 16
    np.testing.assert_array_equal(tp(images).numpy(), single(images).numpy())
