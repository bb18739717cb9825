"""Finding a cell's parts by name.

A cell (`BENCHMARK.json`'s `workloads`) is `workloads/<cell>.json`: its
configuration's name, its traffic's name, the traffic's parameters for
this cell and the comparison's limits. A configuration is
`configs/<name>.json`, a traffic mix `traffic/<name>.json` (its `kind`
and its default parameters, which the cell's override), a per-layer
metric `metrics/<name>.py` and an end-to-end one `end_to_end/<name>.py`
(each a `read(ctx)` that returns a number, or None where it finds nothing
to read). A mix's `kind` names the loop that runs it, the module
`harness/<kind>.py` (its `run` and its `CONTROLS`). The metrics a cell
reports are the entries of `BENCHMARK.json` that list the cell, or that
list none and move an end-to-end metric the cell reports.

A configuration names its model under `model`, and the model's module
is `models/<module>.py` (`model_module`: `MaskAttn-UNet` ->
`maskattn_unet`; see `perfbench/models/`). A configuration whose model has
no module is refused. The keys that the model's reference cannot vary
(its module's `FIXED`) must hold the reference's values: a file that
states another width or layout is refused, not run at the old one.

A new cell of a new model is new files: its module under `models/`, its
reference under `reference/`, `configs/<name>.json`, `workloads/<cell>.json`
and, where its traffic is new, `traffic/<name>.json`, with entries in
`BENCHMARK.json`; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pkgutil
import re
from pathlib import Path

import perfbench.models

HERE = Path(__file__).resolve().parent.parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(BENCHMARK)


def load_cell(name: str) -> dict:
    """{'name', 'config' (the file's dict), 'traffic', 'kind',
    'params', 'limits', 'chips'}."""
    w = _json(HERE / "workloads" / f"{name}.json")
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    params = {**traffic["params"], **w["params"]}
    config = _json(HERE / "configs" / f"{w['config']}.json")
    fixed = model(config).FIXED
    wrong = {k: config.get(k) for k, v in fixed.items() if config.get(k) != v}
    if wrong:
        want = {k: fixed[k] for k in wrong}
        raise ValueError(f"{w['config']}: the reference builds only {want}, "
                         f"not {wrong}")
    return {"name": name, "config_name": w["config"], "config": config,
            "traffic": w["traffic"], "kind": traffic["kind"],
            "params": params, "limits": w["limits"],
            "chips": w.get("chips", 1)}


def model_module(name: str) -> str:
    """The module of `models/` that a model's name gives: lowercased, each
    run of characters other than letters and digits made `_`."""
    return re.sub(r"[^a-z0-9]+", "_", name.lower())


def _modules() -> list[str]:
    return sorted({m.name for m in pkgutil.iter_modules(
        perfbench.models.__path__) if not m.name.startswith("_")})


def models() -> list[str]:
    """The models that have a module (each module's `FIXED["model"]`)."""
    return sorted(importlib.import_module(
        f"perfbench.models.{m}").FIXED["model"] for m in _modules())


def model(config: dict):
    """The module `models/<module>.py` of the configuration's `model`."""
    name = config.get("model")
    module = model_module(name) if isinstance(name, str) else ""
    if module not in _modules():
        raise ValueError(f"{config.get('name')}: no module "
                         f"models/{module}.py for model {name!r}; the "
                         f"models with one: {models()}")
    return importlib.import_module(f"perfbench.models.{module}")


def mix(cell: dict):
    """The module `harness/<kind>.py` that runs the cell's traffic."""
    kind = cell["kind"]
    if not kind.isidentifier() or not (HERE / "harness" /
                                       f"{kind}.py").is_file():
        raise ValueError(f"{cell['traffic']}: no loop harness/{kind}.py "
                         "for its kind")
    return importlib.import_module(f"perfbench.harness.{kind}")


def _listed(entry: dict, cell: str, e2e: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in e2e if "moves" in entry else True


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end entries, per-layer entries) that `cell` reports."""
    e2e = [m for m in bench["end_to_end"] if _listed(m, cell, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _listed(m, cell, names)]
    return e2e, layer


def reader(name: str, folder: str = "metrics"):
    """The `read` function of `<folder>/<name>.py`."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
