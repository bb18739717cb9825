"""The port's data parallelism on the CPU: two gloo ranks against one
process, and the cross-replica forward against JAX's.

JAX's contract (tests/test_sharding.py:48-73, tests/test_eval_caching.py:
40-71) is that a data-parallel step equals the single-device step on the
global batch: loss and mIoU at rtol 1e-5, the params after one SGD update
at atol 1e-5, the BN running stats at atol 1e-6; evaluation with a mesh
equals evaluation without one (atol 1e-5). Here the port's 2-rank step
(spawned gloo processes, `tests/torch_parallel_ranks.py`) is held to the
port's one-process step at those tolerances, in four scenarios: cached
masks; 'fresh' masks with dropout 0.3 and the triplet blend; the
embedding triplet with ignored pixels under grad_accum 2; dp x pp (2 ranks
x 2 microbatches). The ranks' generators must end where the one-process
generator does (the same number of draws). The cross-replica forward is
held to JAX's `mu.apply(train=True)` on the global batch (dense, 16 px,
f32: 1e-4, tests/test_torch_model.py's bound), computed in this process.

Also: the mesh and its refusals, cross-replica BatchNorm (f32 and bf16
inputs: 1e-5 relative), the eval step and the evaluators with a mesh,
data-parallel serving (class maps equal exactly), and the CLI's
`--n-data` on the CPU. Torch is pinned to one thread while the file runs.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from maskunet_tpu.models import maskattn_unet as jmu
from maskunet_tpu_torch import cli as tcli
from maskunet_tpu_torch import serve as tserve
from maskunet_tpu_torch.models import maskattn_unet as tmu
from maskunet_tpu_torch.parallel import mesh as mesh_lib
from maskunet_tpu_torch.tasks import recipes as trecipes
from maskunet_tpu_torch.utils import jax_weights

CPU2 = ["cpu", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the mesh --------------------------------------------------------------

def test_make_mesh_and_its_refusals():
    mesh = mesh_lib.make_mesh(2, devices=CPU2)
    assert mesh.shape == {"data": 2, "model": 1} and mesh.group is None
    assert mesh.axis_names == ("data", "model") and mesh.rank == 0
    with pytest.raises(ValueError, match=r"mesh 2x1 != 3 devices"):
        mesh_lib.make_mesh(2, devices=["cpu"] * 3)
    tp = mesh_lib.make_mesh(1, n_model=2, devices=CPU2)
    assert tp.shape == {"data": 1, "model": 2} and tp.group is None
    assert tp.model_group is None and tp.rank == tp.model_rank == 0
    assert [mesh_lib.channels_tp_spec(tp, 512, i) for i in (0, 1)] == [
        slice(0, 256), slice(256, 512)]
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="mesh needs 2 devices"):
            mesh_lib.make_mesh(2)


def test_a_mesh_without_a_process_group_only_serves():
    """One process drives a multi-device mesh only to serve: training or
    evaluating on it would put every row on one device, so it raises."""
    from maskunet_tpu_torch.train import step as tstep
    cfg = tmu.MaskAttnUNetConfig(c_out=5, img_size=16)
    mesh = mesh_lib.make_mesh(2, devices=CPU2)
    for make in (tstep.make_train_step, tstep.make_eval_step):
        with pytest.raises(ValueError, match="one process per device"):
            make(cfg, tstep.TaskConfig(), device="cpu", mesh=mesh)


def test_local_rows_and_shards():
    mesh = mesh_lib.make_mesh(1, devices=["cpu"])
    assert mesh_lib.local_rows(mesh, 8) == slice(0, 8)
    assert mesh_lib.local_rows(None, 8, 2) == slice(None)
    batch = {"x": torch.arange(8)}
    assert torch.equal(mesh_lib.shard_batch(None, batch)["x"], batch["x"])
    masks = (torch.ones(4, 3, dtype=torch.bool),)
    assert mesh_lib.shard_masks(mesh, masks) == (masks, None)


# --- two ranks against one process ------------------------------------------

@pytest.fixture(scope="module")
def dp_steps():
    """Every scenario's step in one spawn of the two ranks."""
    results = ranks.spawn(ranks.dp_steps, 2, list(ranks.SCENARIOS))
    return {name: [r[name] for r in results] for name in ranks.SCENARIOS}


@pytest.mark.parametrize("name", list(ranks.SCENARIOS))
def test_dp_step_equals_one_process_step(dp_steps, name):
    r0, r1 = dp_steps[name]
    want = r0["want_metrics"]
    assert set(r0["metrics"]) == set(want)
    for k in want:
        np.testing.assert_allclose(r0["metrics"][k], want[k], rtol=1e-5,
                                   err_msg=k)
        assert r1["metrics"][k] == r0["metrics"][k], k
    assert r0["params_diff"] <= 1e-5
    assert r0["state_diff"] <= 1e-6
    # every rank made the same update
    np.testing.assert_array_equal(r0["sums"], r1["sums"])


@pytest.mark.parametrize("name", list(ranks.SCENARIOS))
def test_dp_generators_stay_in_lockstep(dp_steps, name):
    """Each rank drew exactly what the one-process step drew: masks,
    dropout and triplets for the global batch."""
    r0, r1 = dp_steps[name]
    np.testing.assert_array_equal(r0["generator"], r0["want_generator"])
    np.testing.assert_array_equal(r1["generator"], r0["want_generator"])


def test_cross_replica_batchnorm():
    r0, r1 = ranks.spawn(ranks.dp_batchnorm, 2)
    for r in (r0, r1):
        for dtype, diffs in r.items():
            # y, running mean, running var, dx, dweight, dbias
            assert max(diffs) <= 1e-5, (dtype, diffs)


def test_cross_replica_forward_equals_jax():
    """Two ranks' train-mode forward (BN over the global batch) against
    JAX's forward on the global batch, on the same weights and masks."""
    r0, r1 = ranks.spawn(ranks.dp_forward, 2)
    cfg, _, ts, batch, _, _ = ranks.scenario("cached")
    jcfg = jmu.MaskAttnUNetConfig(c_out=cfg.c_out, img_size=cfg.img_size,
                                  attn_impl="dense", dropout_rate=0.0)
    jparams, jstate = jax_weights.to_jax(ts.params, ts.model_state, cfg)
    out, new_state = jax.jit(lambda p, s, x: jmu.apply(
        p, s, x, cfg=jcfg, train=True,
        masks=tuple(jnp.asarray(m.numpy()) for m in ts.masks)))(
        jparams, jstate, batch["image"])
    want = np.asarray(out.semantic)
    for r in (r0, r1):
        np.testing.assert_allclose(r["logits"], want, atol=1e-4, rtol=1e-4)
    _, want_state = jax_weights.from_jax(
        jparams, jax.tree.map(np.asarray, new_state), cfg)
    for k, v in want_state.items():
        np.testing.assert_allclose(r0["state"][k], v.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_dp_eval_step_equals_one_process():
    r0, r1 = ranks.spawn(ranks.dp_eval, 2)
    want = r0["want_metrics"]
    for r in (r0, r1):
        assert set(r["metrics"]) == set(want)
        for k in want:
            np.testing.assert_allclose(r["metrics"][k], want[k], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(r["prob"], r0["want_prob"], atol=1e-5)
        np.testing.assert_array_equal(r["pred"], r0["want_pred"])


@pytest.fixture(scope="module")
def dp_evaluators():
    return ranks.spawn(ranks.dp_evaluators, 2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix: float(tree)}


@pytest.mark.parametrize("name", ["panoptic", "instances"])
def test_evaluators_with_a_mesh_equal_one_device(dp_evaluators, name):
    r0, r1 = dp_evaluators
    want = _flat(r0["want_" + name])
    for r in (r0, r1):
        got = _flat(r[name])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       err_msg=k)


# --- data-parallel serving (one process, two replicas) ----------------------

def test_dp_serving_equals_one_device():
    recipe = dataclasses.replace(trecipes.get("synthetic_semantic"),
                                 img_size=16, batch_size=4)
    kw = dict(compute_dtype="float32", device="cpu")
    single, _ = tserve.build_model_runner(recipe, 5, None, **kw)
    dp, size = tserve.build_model_runner(
        recipe, 5, None, mesh=mesh_lib.make_mesh(2, devices=CPU2), **kw)
    images = np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3),
                                               dtype=np.uint8)
    assert size == 16
    np.testing.assert_array_equal(dp(images).numpy(), single(images).numpy())
    with pytest.raises(ValueError, match="must divide by the data-axis"):
        tserve.build_model_runner(
            dataclasses.replace(recipe, batch_size=3), 5, None,
            mesh=mesh_lib.make_mesh(2, devices=CPU2), **kw)


def test_serve_n_data_on_the_cpu(capsys):
    """`serve --n-data 2 --device cpu` builds two CPU replicas; on a host
    with fewer cards than replicas the card default exits 2."""
    with pytest.raises(SystemExit) as e:
        tserve.main(["--recipe", "ade_semantic", "--n-data", "2"])
    err = capsys.readouterr().err
    assert e.value.code == 2 and "--n-data 2: mesh needs 2 devices" in err


# --- the command line --------------------------------------------------------

@pytest.fixture
def tiny(monkeypatch):
    recipe = dataclasses.replace(trecipes.get("synthetic_semantic"),
                                 name="tiny", img_size=16, batch_size=2,
                                 num_classes=5)
    monkeypatch.setitem(trecipes.RECIPES, "tiny", recipe)
    return recipe


def _line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def _cli(*argv) -> dict:
    """`cli.main(argv)` in a subprocess that registers the 'tiny' recipe
    first (the ranks it spawns get the recipe object itself), joined with
    a deadline; its last JSON line."""
    code = ("import dataclasses, sys\n"
            "from maskunet_tpu_torch import cli\n"
            "from maskunet_tpu_torch.tasks import recipes\n"
            "recipes.RECIPES['tiny'] = dataclasses.replace(\n"
            "    recipes.get('synthetic_semantic'), name='tiny', img_size=16,\n"
            "    batch_size=2, num_classes=5)\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    proc = subprocess.run([sys.executable, "-c", code, *argv],
                          capture_output=True, text=True,
                          timeout=ranks.DEADLINE_S, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sum(ln.startswith("{") for ln in proc.stdout.splitlines()) == 1
    return _line(proc.stdout)


def test_cli_n_data_trains_and_evaluates_as_one_process(tmp_path):
    """`train` and `evaluate --n-data 2 --platform cpu` (two spawned gloo
    ranks, rank 0 printing) give one process's numbers: the first step's
    loss (AdamW turns the rounding noise of gradients that are zero in
    exact arithmetic into whole steps, so later states differ), and the
    evaluation of one checkpoint."""
    common = ["--recipe", "tiny", "--platform", "cpu"]
    work = str(tmp_path / "wNone")
    lines = {}
    for n in (None, 2):
        extra = [] if n is None else ["--n-data", str(n)]
        train = _cli("train", "--workdir", str(tmp_path / f"w{n}"),
                     "--max-steps", "1", "--log-every", "0", *common,
                     *extra)
        evaluate = _cli("evaluate", "--workdir", work, "--tag", "latest",
                        "--max-batches", "2", *common, *extra)
        lines[n] = (train, evaluate)
    shutil.rmtree(tmp_path, ignore_errors=True)   # full-width checkpoints
    (t1, e1), (t2, e2) = lines[None], lines[2]
    np.testing.assert_allclose(t2["best_loss"], t1["best_loss"], rtol=1e-5)
    np.testing.assert_allclose(t2["best_iou"], t1["best_iou"], rtol=1e-5)
    for k in ("loss", "miou"):
        np.testing.assert_allclose(e2[k], e1[k], rtol=1e-5)


def test_cli_n_data_refusals(tiny, capsys):
    """JAX's preflight (batch % n_data) and a host with too few cards: one
    error line and exit 2, before any rank starts."""
    assert tcli.main(["train", "--recipe", "tiny", "--n-data", "3",
                      "--platform", "cpu"]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "not divisible by --n-data=3" in err[0]
    if torch.cuda.device_count() < 2:
        assert tcli.main(["train", "--recipe", "tiny", "--n-data",
                          "2"]) == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and "needs 2 CUDA devices" in err[0]


def test_cli_distributed_one_process(tiny, tmp_path, monkeypatch, capsys):
    """`--distributed` with a coordinator: this process is rank 0 of a
    one-process group, trains on its mesh and leaves no group behind."""
    import torch.distributed as dist
    seen = {}

    def train(recipe, data_root, workdir, **kw):
        seen.update(kw, group=dist.get_world_size())
        from types import SimpleNamespace
        return SimpleNamespace(best_loss=0.0, best_iou=0.0,
                               images_per_sec=0.0)

    from maskunet_tpu_torch.train import loop as tloop
    monkeypatch.setattr(tloop, "train", train)
    assert tcli.main(["train", "--recipe", "tiny", "--platform", "cpu",
                      "--distributed", "--coordinator",
                      f"localhost:{ranks.free_port()}", "--num-processes",
                      "1", "--process-id", "0"]) == 0
    assert seen["group"] == 1 and seen["mesh"].shape == {"data": 1,
                                                         "model": 1}
    assert not dist.is_initialized()
    assert _line(capsys.readouterr().out)["recipe"] == "tiny"
