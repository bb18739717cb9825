"""Rebuild recipes_plateau.json's band_comparison from its rows (host
only, no device).

This package's own copy of tools/plateau_bands.py (`build_comparison`
and `main`, the same rules, arguments and printed summary; a test holds
`build_comparison` equal to the original). The plateau artifact
(`run_all_recipes --plateau` in the JAX package) compares each recipe's
plateau metrics against the committed 8-epoch demo-lr artifact
(recipes_e2e.json). This tool recomputes that comparison
deterministically after any re-run, instead of hand-editing:

- For each metric the demo artifact records (val_miou / pq / ap), the
  plateau value is the better of the final-state eval and the
  BEST-checkpoint eval (`*_best` columns, written when the run used
  keep_best_state); both raw values are recorded per entry.
- reaches_band follows the artifact-test rule: plateau >= band - tol.
- documented_gaps entries whose metric now reaches the band are pruned
  (they would be stale prose); still-missing metrics keep their text and
  the tool FAILS if any miss lacks one, so the gap must be written
  before the artifact is committed.

    python -m maskunet_tpu_torch.tools.plateau_bands
        [--plateau recipes_plateau.json] [--demo recipes_e2e.json]
        [--dry-run]

Without `--dry-run` it rewrites the `--plateau` file in place; the
committed recipes_plateau.json belongs to the JAX package, so run it with
`--dry-run` or on a copy.
"""

from __future__ import annotations

import argparse
import json

METRICS = ("val_miou", "pq", "ap")


def build_comparison(plateau: dict, demo: dict) -> tuple[dict, list]:
    demo_rows = {r["recipe"]: r for r in demo["rows"]}
    # freshly generated artifacts (run_all_recipes --plateau) carry the
    # tolerance; older hand-assembled ones may not — same default
    tol = plateau.get("band_tolerance", 0.02)
    comparison: dict = {}
    misses: list[tuple[str, str]] = []
    for row in plateau["rows"]:
        name = row["recipe"]
        d = demo_rows[name]
        comparison[name] = {}
        for metric in METRICS:
            if metric not in d:
                continue
            if metric not in row:
                # the demo artifact records this metric but the re-run
                # row lost it (e.g. a crashed eval): that's a MISS that
                # must be documented, not silently pruned
                misses.append((name, metric))
                continue
            final = row[metric]
            best = row.get(metric + "_best")
            val = final if best is None else max(final, best)
            entry = {
                "plateau": val,
                "demo_band": d[metric],
                "delta": round(val - d[metric], 4),
                "reaches_band": val >= d[metric] - tol,
            }
            if best is not None:
                entry["plateau_final"] = final
                entry["plateau_best"] = best
            comparison[name][metric] = entry
            if not entry["reaches_band"]:
                misses.append((name, metric))
    return comparison, misses


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="plateau_bands")
    ap.add_argument("--plateau", default="recipes_plateau.json")
    ap.add_argument("--demo", default="recipes_e2e.json")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    with open(args.plateau) as f:
        plateau = json.load(f)
    with open(args.demo) as f:
        demo = json.load(f)

    comparison, misses = build_comparison(plateau, demo)
    plateau["band_comparison"] = comparison

    gaps = plateau.get("documented_gaps", {})
    stale = [k for k in gaps
             if tuple(k.split(".", 1)) not in misses]
    for k in stale:
        del gaps[k]
    undocumented = [f"{n}.{m}" for n, m in misses if f"{n}.{m}" not in gaps
                    or len(gaps[f"{n}.{m}"]) <= 50]
    plateau["documented_gaps"] = gaps

    summary = {
        "metrics_compared": sum(len(v) for v in comparison.values()),
        "misses": [f"{n}.{m}" for n, m in misses],
        "pruned_stale_gaps": stale,
        "undocumented_misses": undocumented,
    }
    print(json.dumps(summary, indent=1))
    if args.dry_run:
        return summary
    if undocumented:
        raise SystemExit(
            f"write documented_gaps entries (>50 chars) for {undocumented} "
            f"in {args.plateau} first, then re-run")
    with open(args.plateau, "w") as f:
        json.dump(plateau, f, indent=1)
    print(f"wrote {args.plateau}")
    return summary


if __name__ == "__main__":
    main()
