"""A second model takes new files only: the toy of `tests/toy/` (a module,
its plain reference, a configuration and a cell, laid out as under
`perfbench/`) is added to a copy of `perfbench/` whose every file stays as
it is (the fixture refuses a toy file that would overwrite one), with its
entries appended to `BENCHMARK.json`. The harness is
pointed at the copy (`spec.HERE`, `spec.BENCHMARK` and the lookup paths
of `perfbench.models` and `perfbench.reference`), loads the toy's cell,
refuses a wrong fixed key and an unknown model, and runs the cell to a
correct result on the CPU."""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

import perfbench.models
import perfbench.reference
from perfbench import run
from perfbench.harness import spec

TOY = Path(__file__).resolve().parent / "toy"
CELL = "toy_convnet.train_16"
SEED = 2 ** 31 + 613


def _files(root: Path) -> set:
    return {p.relative_to(root) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The copy with the toy's files added; returns its `perfbench/`."""
    root = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel in sorted(_files(TOY)):
        assert not (root / rel).exists(), rel
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(TOY / rel, root / rel)
    bench = spec.benchmark()
    config = json.loads((TOY / "configs" / "toy_convnet.json").read_text())
    bench["configs"].append({
        "name": config["name"], "source": config["source"],
        "file": "perfbench/configs/toy_convnet.json", "reduced": [],
        "why": "a toy second model"})
    bench["workloads"].append({
        "name": CELL, "config": "toy_convnet", "traffic": "train_loop",
        "chips": 1, "why": "16 px, batch 4: the toy's training step"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_img_s")["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", root)
    monkeypatch.setattr(spec, "BENCHMARK", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(perfbench.models, "__path__", [str(root / "models")])
    monkeypatch.setattr(perfbench.reference, "__path__",
                        [str(root / "reference"),
                         *perfbench.reference.__path__])
    yield root
    for name in ("perfbench.models.toy_convnet",
                 "perfbench.reference.toy_convnet"):
        sys.modules.pop(name, None)


def test_toy_config_loads(toy):
    cell = spec.load_cell(CELL)
    standing = spec.load_cell("ade_semantic.train_256")
    assert set(cell) == set(standing)
    assert cell["config"]["model"] == "Toy-ConvNet"
    assert spec.model(cell["config"]).FIXED["widths"] == [8, 16]
    assert spec.models() == ["MaskAttn-UNet", "Toy-ConvNet"]


def test_toy_config_with_a_wrong_fixed_key_is_refused(toy, monkeypatch):
    real = spec._json

    def wider(path):
        d = real(path)
        if path.name == "toy_convnet.json":
            d = {**d, "widths": [8, 32]}
        return d

    monkeypatch.setattr(spec, "_json", wider)
    with pytest.raises(ValueError, match="widths"):
        spec.load_cell(CELL)


@pytest.mark.parametrize("model", ["No-Such-Net", None])
def test_unknown_model_is_refused_naming_the_known(toy, monkeypatch, model):
    real = spec._json

    def other(path):
        d = real(path)
        if path.name == "toy_convnet.json":
            d = {**d, "model": model}
        return d

    monkeypatch.setattr(spec, "_json", other)
    with pytest.raises(ValueError, match="MaskAttn-UNet.*Toy-ConvNet"):
        spec.load_cell(CELL)


def test_toy_cell_runs_correct(toy):
    out = run.execute(spec.load_cell(CELL), SEED, 1.0, False, "cpu",
                      time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_img_s", "setup_s"}
    assert out["metrics"]["train_img_s"]["value"] > 0


@pytest.mark.parametrize("reading", ["control_fp8", "fault_half_batch"])
def test_toy_controls_are_not_correct(toy, reading):
    from perfbench.harness import training
    cell = spec.load_cell(CELL)
    r = training.run(cell, SEED, 0.2, False, "cpu", lambda **_: None)
    numbers = r["check"](**training.CONTROLS[reading])
    assert any(numbers[k] > v for k, v in cell["limits"].items()), numbers
