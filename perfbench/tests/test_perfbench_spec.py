"""Every cell of BENCHMARK.json finds its files, and the files agree."""

import json
import re

import pytest

from perfbench.harness import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_and_agrees(cell):
    c = spec.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["config"] == c["config_name"]
    assert entry["traffic"] == c["traffic"]
    assert entry["chips"] == c["chips"]
    assert spec.mix(c).__name__ == f"perfbench.harness.{c['kind']}"
    assert c["limits"] and all(v > 0 for v in c["limits"].values())
    e2e, layer = spec.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e:
        assert callable(spec.reader(m["name"], "end_to_end"))
    for m in layer:
        assert m["moves"] in names
        assert callable(spec.reader(m["name"]))


def test_configs_are_files_under_paths():
    for cfg in BENCH["configs"]:
        assert cfg["file"].startswith("perfbench/configs/")
        d = json.loads((spec.HERE.parent / cfg["file"]).read_text())
        assert d["name"] == cfg["name"] and d["source"] == cfg["source"]
        assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200


def test_run_seconds_fits_the_check():
    cells = 24
    run = BENCH["run_seconds"]
    total = (2 + 14 * cells) * (run + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_a_config_that_states_another_width_is_refused(monkeypatch):
    real = spec._json

    def wider(path):
        d = real(path)
        if path.parent.name == "configs":
            d = {**d, "attention_channels": [256] * 6}
        return d

    monkeypatch.setattr(spec, "_json", wider)
    with pytest.raises(ValueError, match="attention_channels"):
        spec.load_cell(CELLS[0])
