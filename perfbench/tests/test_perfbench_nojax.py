"""Nothing the benchmark imports loads JAX or the JAX package; the
reference loads nothing of the program either. Module names are compared
by their whole top-level name (`maskunet_tpu_torch` is not
`maskunet_tpu`)."""

import json
import subprocess
import sys

from perfbench.harness import spec

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "maskunet_tpu"]

_HARNESS = """
import importlib, json, sys
sys.path.insert(0, {root!r})
import perfbench.run
from perfbench.harness import spec
for m in ("card", "compare", "data", "flops", "spec", "trace", "training",
          "weights"):
    importlib.import_module("perfbench.harness." + m)
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
for m in bench["end_to_end"]:
    spec.reader(m["name"], "end_to_end")
for w in bench["workloads"]:
    spec.load_cell(w["name"])
# what the training loop imports of the program
for m in ("maskunet_tpu_torch.train.step",
          "maskunet_tpu_torch.train.loop", "maskunet_tpu_torch.data.pipeline",
          "maskunet_tpu_torch.core.state", "maskunet_tpu_torch.core.device",
          "maskunet_tpu_torch.ops.flash_kernels"):
    importlib.import_module(m)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.model, perfbench.reference.train
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    proc = subprocess.run([sys.executable, "-c",
                           code.format(root=str(spec.HERE.parent))],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _top_level(_HARNESS)
    assert "maskunet_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(_REFERENCE)
    assert not loaded & set(FORBIDDEN + ["maskunet_tpu_torch"])
