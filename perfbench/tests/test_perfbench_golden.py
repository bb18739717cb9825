"""The standing cells read what they read before their model's parts moved
to `perfbench/models/`: at the CPU's tiny size (`test_perfbench_run.TINY`)
and one seed, the seeded parameters, masks and pool (sha256), the FLOPs a
call, the attention bounds, the three checked losses, the program's leaf
norms and every number `check()` gives, sound and under both `CONTROLS`,
equal the values frozen below bit for bit.

The values were recorded with the harness as it stood before the move,
with torch's intra-op threads set to `THREADS` (the order of a
convolution's sums follows the thread count), on a CPU of the capability
`CAPABILITY` under torch `TORCH`. The seeded inputs, the FLOPs and the
bounds are integers or exact float draws and are held everywhere; the
losses, norms and `check()` numbers follow the kernels' order of sums,
which another ISA level or torch build changes, so they are held only
where both match. To record them again:
`python perfbench/tests/test_perfbench_golden.py`.
"""

import hashlib
import inspect
import json
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.harness import compare, data, spec, training, weights  # noqa: E402

TINY = {"img_size": 32, "batch": 4, "pool_batches": 3, "profiled_steps": 2}
SEED = 2 ** 31 + 977
THREADS = 4
CAPABILITY = "AVX512"
TORCH = "2.13.0+cpu"
EXACT = ("weights", "masks", "pool", "flops_per_call", "bounds")
CELLS = ["ade_semantic.train_256", "city_instance.train_128"]


def digest(obj) -> str:
    """sha256 over the dtypes, shapes and bytes of the tensors and arrays
    in `obj` (dicts in their own order, with their keys)."""
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, dict):
            for k, v in x.items():
                h.update(repr(k).encode())
                feed(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                feed(v)
        else:
            a = (x.detach().cpu().contiguous().numpy()
                 if isinstance(x, torch.Tensor) else np.ascontiguousarray(x))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())

    feed(obj)
    return h.hexdigest()


def readings(name: str) -> dict:
    """What the harness makes and reads of `name` at the tiny size."""
    cell = spec.load_cell(name)
    cell["params"].update(TINY)
    seen = {}
    real = {"make_weights": weights.make_weights,
            "make_masks": weights.make_masks, "pool": data.pool,
            "train_numbers": compare.train_numbers}

    def spy(module, fn, label):
        def wrapped(*a, **kw):
            out = real[fn](*a, **kw)
            seen.setdefault(label, digest(out))
            return out
        setattr(module, fn, wrapped)

    def numbers(*a, **kw):
        args = inspect.signature(real["train_numbers"]).bind(*a, **kw)
        seen.setdefault("losses", list(args.arguments["losses"]))
        seen.setdefault("program_norms", digest(
            [list(args.arguments["grad_norms"].items()),
             list(args.arguments["change_norms"].items())]))
        return real["train_numbers"](*a, **kw)

    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        spy(weights, "make_weights", "weights")
        spy(weights, "make_masks", "masks")
        spy(data, "pool", "pool")
        compare.train_numbers = numbers
        r = training.run(cell, SEED, 0.2, False, "cpu", lambda **_: None)
        checks = {"sound": r["check"]()}
        for reading, fault in training.CONTROLS.items():
            checks[reading] = r["check"](**fault)
    finally:
        torch.set_num_threads(threads)
        weights.make_weights = real["make_weights"]
        weights.make_masks = real["make_masks"]
        data.pool = real["pool"]
        compare.train_numbers = real["train_numbers"]
    return {**seen, "flops_per_call": r["flops_per_call"],
            "bounds": r["bounds"], "check": checks}


FROZEN = {
    "ade_semantic.train_256": {
        "weights":
            "049ed8e9787b8a0e21b649e8b7be98860df2602260eabe774e02b78c8e1d3c07",
        "masks":
            "9d5c89254dafd149a6393c440c298de104bba645f9cce4ab4463a6500ed0e916",
        "pool":
            "c4379929c028bc05c046b863b5502c5d0150ddb3c7919fa5857a58309672fa11",
        "losses": [5.472567558288574, 5.394894599914551, 5.409980773925781],
        "program_norms":
            "a2672f14fb968ece4fd6d896a83d707d922c4d0b3e28f7699793af43cb9fd430",
        "flops_per_call": 42032758784,
        "bounds": {
            "fwd": 1.107363689496725e-06,
            "bwd": 2.8642802685179317e-06,
        },
        "check": {
            "sound": {
                "loss_gap": 8.565834450391925e-05,
                "loss_gap_first": 8.565834450391925e-05,
                "loss_gaps": [8.565834450391925e-05, 1.7677660934331557e-05,
                              3.03193330874882e-05],
                "grad_gap": 0.06528888120423394,
                "grad_leaf": "downsample1.maxpool_conv.1.conv_block.1.bias",
                "grad_gap_median": 0.00624781345767594,
                "change_gap": 0.03393677342996188,
                "change_leaf": "initial_conv.conv_block.1.bias",
                "leaves_compared": 143,
                "leaves": 162,
            },
            "control_fp8": {
                "loss_gap": 0.0018147886715184774,
                "loss_gap_first": 0.0009533956736697665,
                "loss_gaps": [0.0009533956736697665, 0.0018147886715184774,
                              0.001049013669788618],
                "grad_gap": 0.2610176835223757,
                "grad_leaf": "initial_conv.conv_block.0.weight",
                "grad_gap_median": 0.03793491652857157,
                "change_gap": 0.0855340372107415,
                "change_leaf": "self_attention3.value.bias",
                "leaves_compared": 143,
                "leaves": 162,
            },
            "fault_half_batch": {
                "loss_gap": 0.008058245582909391,
                "loss_gap_first": 0.008058245582909391,
                "loss_gaps": [0.008058245582909391, 0.007837479363540567,
                              0.0055380377186605625],
                "grad_gap": 3.155403970052071,
                "grad_leaf": "self_attention5.value.weight",
                "grad_gap_median": 0.8555616691159157,
                "change_gap": 0.10602460417147458,
                "change_leaf": "self_attention5.value.weight",
                "leaves_compared": 143,
                "leaves": 162,
            },
        },
    },
    "city_instance.train_128": {
        "weights":
            "8539cd067b60decb8d4e4c3691f9501987dbfb70e0c7214b5d7cd20772d34c4a",
        "masks":
            "9d5c89254dafd149a6393c440c298de104bba645f9cce4ab4463a6500ed0e916",
        "pool":
            "7b5e1aa6624cb725f2d36ff1e54a3324baece4794b592f12c050b94b34d7ff9b",
        "losses": [3.7855565547943115, 3.243875503540039, 3.180901527404785],
        "program_norms":
            "e10fdc59108043c387679b63a8fbda896d8bbeb687806bd7cbb2606814f520e2",
        "flops_per_call": 41987145728,
        "bounds": {
            "fwd": 1.107363689496725e-06,
            "bwd": 2.8642802685179317e-06,
        },
        "check": {
            "sound": {
                "loss_gap": 0.001469562501321021,
                "loss_gap_first": 0.00044446625959841397,
                "loss_gaps": [0.00044446625959841397, 0.001469562501321021,
                              0.00046411923766373687],
                "grad_gap": 0.08735126102336277,
                "grad_leaf": "downsample1.maxpool_conv.1.conv_block.1.bias",
                "grad_gap_median": 0.008744965177511048,
                "change_gap": 0.051203543020787855,
                "change_leaf": "self_attention6.query.bias",
                "leaves_compared": 146,
                "leaves": 172,
            },
            "control_fp8": {
                "loss_gap": 0.01773107850613718,
                "loss_gap_first": 0.01773107850613718,
                "loss_gaps": [0.01773107850613718, 0.0054128836538619605,
                              0.012413522674004071],
                "grad_gap": 0.2401778547346458,
                "grad_leaf": "upsample3.conv.2.weight",
                "grad_gap_median": 0.058678645805049445,
                "change_gap": 0.07835921671667834,
                "change_leaf": "upsample1.conv.1.conv_block.1.weight",
                "leaves_compared": 146,
                "leaves": 172,
            },
            "fault_half_batch": {
                "loss_gap": 0.02476760304551123,
                "loss_gap_first": 0.01213864196843987,
                "loss_gaps": [0.01213864196843987, 0.02476760304551123,
                              0.0009868246325273192],
                "grad_gap": 1.606889298960881,
                "grad_leaf": "self_attention6.value.weight",
                "grad_gap_median": 0.42115019029742107,
                "change_gap": 0.08100730068176049,
                "change_leaf": "upsample1.conv.1.conv_block.1.weight",
                "leaves_compared": 146,
                "leaves": 172,
            },
        },
    },
}


_READ = {}


def read(name: str) -> dict:
    """`readings(name)` through JSON, computed once per test process."""
    if name not in _READ:
        _READ[name] = json.loads(json.dumps(readings(name)))
    return _READ[name]


@pytest.mark.parametrize("name", CELLS)
def test_cell_builds_what_it_built(name):
    got, want = read(name), FROZEN[name]
    for key in EXACT:
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", CELLS)
def test_cell_reads_what_it_read(name):
    here = (torch.backends.cpu.get_cpu_capability(), torch.__version__)
    if here != (CAPABILITY, TORCH):
        pytest.skip(f"float readings recorded on {CAPABILITY} under torch "
                    f"{TORCH}; this is {here[0]} under torch {here[1]}, "
                    "whose order of sums may differ")
    got, want = read(name), FROZEN[name]
    for key in want:
        assert got[key] == want[key], key
    assert got == want


if __name__ == "__main__":
    print(torch.backends.cpu.get_cpu_capability(), torch.__version__,
          file=sys.stderr)
    print(json.dumps({n: readings(n) for n in CELLS}, indent=1))
