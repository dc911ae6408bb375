"""Evidence-record generator: the head-to-head table (counterpart of
tpdlp/bench/report.py).

Runs the seeded head-to-head protocol (tpdlp_torch.bench.runner) once,
saves the raw rows as a JSON artifact, and prints the markdown table from
it, so the table can be regenerated from the artifact at any time.

Usage:
    python -m tpdlp_torch.bench.report --run --out bench_rows.json
    python -m tpdlp_torch.bench.report --from bench_rows.json
"""

from __future__ import annotations

import argparse
import json


def _fmt_iters(all_iters):
    if all_iters is None:
        return "—"
    if len(set(all_iters)) == 1:
        return f"{all_iters[0]} (all)"
    return ",".join(str(k) for k in all_iters)


def markdown_table(rows) -> str:
    out = [
        "| Instance | shape (m, n) | ours (s) | k (per seed) | "
        "reference (s) | ref k (per seed) | speedup (time) | "
        "speedup (it/s) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for row in rows:
        ours = row["ours"]
        ref = row.get("reference")
        m, n = row["shape"]
        cells = [
            row["instance"],
            f"{m} x {n}",
            f"{ours['time']:.3f}",
            _fmt_iters(row.get("ours_iters_all")),
        ]
        if ref:
            cells += [
                f"{ref['time']:.3f}",
                _fmt_iters(row.get("ref_iters_all")),
                f"{row['speedup_time']:.1f}x",
                f"{row['speedup_iters_per_sec']:.1f}x",
            ]
        else:
            cells += ["—", "—", "—", "—"]
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", action="store_true",
                    help="execute the head-to-head protocol now")
    ap.add_argument("--from", dest="src",
                    help="re-print the table from a saved artifact")
    ap.add_argument("--out", default="bench_rows.json",
                    help="artifact path for --run")
    ap.add_argument("--classes", default="small,medium,large")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.run:
        from tpdlp_torch.bench import runner

        rows = runner.main(
            ["--classes", args.classes, "--tol", str(args.tol),
             "--reps", str(args.reps)]
            + (["--skip-reference"] if args.skip_reference else [])
            + (["--device", args.device] if args.device else [])
        )
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"\n[report] artifact written: {args.out}\n")
    elif args.src:
        with open(args.src) as f:
            rows = json.load(f)
    else:
        ap.error("one of --run / --from is required")
        return
    print(markdown_table(rows))


if __name__ == "__main__":
    main()
