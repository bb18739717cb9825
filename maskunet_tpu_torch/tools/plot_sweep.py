"""Plot the data-fraction sweep (the reference's
Segmentation_performance.png).

Counterpart of tools/plot_sweep.py: reads sweep_results.jsonl (from
`maskunet_tpu_torch.tools.run_fraction_sweep`) and draws the mIoU / PQ /
AP bar chart the reference publishes, with matplotlib's Agg backend.

    python -m maskunet_tpu_torch.tools.plot_sweep \\
        runs/sweep/sweep_results.jsonl out.png

Host only. matplotlib is imported in `main`; a host without it (the
card's host has none) raises `ModuleNotFoundError` naming it, as the
panels of `utils/visualize.py` do.
"""

from __future__ import annotations

import json
import sys


def main(argv: list[str] | None = None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "plot_sweep draws with matplotlib, which this host does not "
            "have", name="matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    path = argv[0]
    out = argv[1] if len(argv) > 1 else "sweep.png"
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows.sort(key=lambda r: r["fraction"])
    fracs = [f"{int(r['fraction'] * 100)}%" for r in rows]
    series = {
        "mIoU": [100 * r["val_miou"] for r in rows],
        "PQ": [100 * r["pq"] for r in rows],
        "AP": [100 * r["ap"] for r in rows],
    }

    x = np.arange(len(fracs))
    width = 0.27
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for i, (name, vals) in enumerate(series.items()):
        ax.bar(x + (i - 1) * width, vals, width, label=name)
    ax.set_xticks(x)
    ax.set_xticklabels(fracs)
    ax.set_xlabel("fraction of training data")
    ax.set_ylabel("metric (%)")
    ax.set_title("Segmentation performance vs training-data fraction")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
