"""`maskunet_tpu_torch.tools.remat_ab` and `opt_ab` on the CPU.

- The batch walk, with the trial patched to raise
  `torch.cuda.OutOfMemoryError` from a chosen batch on, reports the last
  batch that fit and the first that did not; any other exception
  propagates (JAX's tool re-raises all but RESOURCE_EXHAUSTED); a walk
  that never runs out reports no OOM.
- `remat_ab.run` at 16 px (f32, as JAX picks off the TPU; one window a
  round) and `opt_ab.run` at 16 px (its three arms): finite times and the
  keys, one torch thread.
"""

import math

import pytest
import torch

from maskunet_tpu_torch.tools import opt_ab, remat_ab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trial_failing_from(first_bad: int, exc=torch.cuda.OutOfMemoryError):
    tried = []

    def trial(remat, batch, img, device):
        tried.append(batch)
        if batch >= first_bad:
            raise exc("CUDA out of memory. Tried to allocate 2.00 GiB")
        return {"live_mb": 10.0 * batch, "peak_mb": 20.0 * batch,
                "loss": 1.0}

    return trial, tried


@pytest.mark.parametrize("first_bad,fit", [(32, 16), (8, None), (96, 64)])
def test_walk_reports_the_last_batch_that_fit(monkeypatch, first_bad, fit):
    trial, tried = _trial_failing_from(first_bad)
    monkeypatch.setattr(remat_ab, "trial", trial)
    w = remat_ab.walk(True, 16, "cpu")
    assert w["oom"] == first_bad
    assert tried == [b for b in remat_ab.BATCHES if b <= first_bad]
    if fit is None:
        assert w["fit"] is None
    else:
        assert w["fit"] == (fit, {"live_mb": 10.0 * fit,
                                  "peak_mb": 20.0 * fit, "loss": 1.0})


def test_walk_without_an_oom_tries_every_batch(monkeypatch):
    trial, tried = _trial_failing_from(10 ** 9)
    monkeypatch.setattr(remat_ab, "trial", trial)
    w = remat_ab.walk(False, 16, "cpu")
    assert tried == list(remat_ab.BATCHES) and w["oom"] is None
    assert w["fit"][0] == remat_ab.BATCHES[-1]


@pytest.mark.parametrize("exc", [RuntimeError, ValueError, MemoryError])
def test_walk_lets_any_other_exception_through(monkeypatch, exc):
    trial, tried = _trial_failing_from(32, exc)
    monkeypatch.setattr(remat_ab, "trial", trial)
    with pytest.raises(exc):
        remat_ab.walk(False, 16, "cpu")
    assert tried == [8, 16, 32]


def test_remat_ab_runs_on_the_cpu(capsys):
    # the walk's trials are the patched ones above: no batch here
    res = remat_ab.run(1, 1, 16, device="cpu", batches=(), rounds=1)
    assert set(res["cost"]) == {"plain", "remat"}
    assert all(math.isfinite(r["best_ms"]) and r["device_ms"] is None
               for r in res["cost"].values())
    assert res["headroom"] == {name: {"fit": None, "oom": None}
                               for name in ("plain", "remat")}
    out = capsys.readouterr().out
    assert "dtype=float32" in out and "plain:" in out and "remat:" in out


def test_opt_ab_runs_on_the_cpu():
    res = opt_ab.run(1, 1, img_size=16, device="cpu", rounds=1)
    assert {"adamw", "adamw_bf16", "sgd"} <= set(res)
    assert all(math.isfinite(res[k]["best_ms"])
               for k in ("adamw", "adamw_bf16", "sgd"))
    assert math.isfinite(res["segment_ms"])
    assert res["segment_device_ms"] is None
