"""The port's `tools/training_parity.py` on the CPU: the port's train step
against tests/torch_oracle.py in lockstep, at 16 px for 3 steps.

Its gates hold in every loss pattern, and step 0's loss (the same weights
and batch on both sides, before any update) equals the oracle's within
1e-5 relative. The four patterns run in two files (this one: `semantic`
and `summed`; test_torch_training_parity_triplets.py: the two with a
triplet term), so that each file stays short on one worker. `--literal`
without the reference's checkout exits naming where it looked.
"""

import pytest
import torch

from maskunet_tpu_torch.tools import training_parity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the model runs in the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def check_parity(tasks, capsys):
    """`main` at 3 steps, 16 px on `tasks`: the gates and step 0."""
    worst = training_parity.main(["3", "16", *tasks, "--device", "cpu"])
    assert "training-dynamics parity OK" in capsys.readouterr().out
    assert list(worst) == list(tasks)
    for task, stats in worst.items():
        for name, limit in training_parity.LIMITS.items():
            assert stats[name] <= limit, (task, name, stats[name])
        port0, oracle0 = stats["port_losses"][0], stats["oracle_losses"][0]
        assert port0 == pytest.approx(oracle0, rel=1e-5), task
        assert len(stats["port_losses"]) == 3


def test_training_parity_holds_its_gates(capsys):
    check_parity(("semantic", "summed"), capsys)


def test_literal_without_the_reference_names_its_path(monkeypatch,
                                                      tmp_path):
    absent = str(tmp_path / "reference_code")
    load = training_parity.load_fixture

    def fixture(name):
        mod = load(name)
        if name == "literal_reference":
            mod.REF_CODE = absent
        return mod

    monkeypatch.setattr(training_parity, "load_fixture", fixture)
    with pytest.raises(SystemExit, match=absent):
        training_parity.main(["1", "16", "--literal", "--device", "cpu"])


def test_gate_failures_name_each_statistic_over_its_gate():
    over = {"semantic": {"traj": 0.0, "cum": 0.0, "win": 0.0},
            "embed": {"traj": 0.021, "cum": 0.0101, "win": 0.03}}
    assert training_parity.gate_failures(over) == [
        ("embed", "traj", 0.021), ("embed", "cum", 0.0101)]
