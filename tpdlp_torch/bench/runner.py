"""Head-to-head benchmark: the port against the reference torchPDLP
(counterpart of tpdlp/bench/runner.py; `bench.py`'s protocol).

The same instance and settings on both sides (Ruiz, adaptive steps,
primal-weight update, tol 1e-4), each side best of `--reps` seeded runs by
iterations/s, with every seed's iteration count recorded so the spread is
visible.  The stepsize init is a random variable on both sides (the
port's power-iteration start is seeded; the reference draws unseeded
`torch.rand`, which run_reference seeds).  Ours runs on CUDA (or the
device named), after one warm solve on another seed.  The reference side
is bench/reference_runner.py: where its source tree is absent its rows
are None, and no speedup is reported.

Usage: python -m tpdlp_torch.bench.runner [--classes small,medium]
       [--tol 1e-4] [--dtype float32] [--reps 3] [--skip-reference]
       [--device cuda|cpu] [--json]
"""

from __future__ import annotations

import argparse
import json
import time


def run_ours(problem, tol, max_kkt, dtype_name, seed=0, device=None):
    """One timed solve (after a warm solve on seed + 7919): wall time,
    k, j, n, objective, status and iterations/s."""
    import torch

    from tpdlp_torch import SolverConfig, solve
    from tpdlp_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = SolverConfig(
        tol=tol, max_kkt=max_kkt, scaling="ruiz", adaptive=True,
        primal_weight_update=True, time_limit=600,
    )
    dtype = getattr(torch, dtype_name)
    solve(problem, cfg, dtype=dtype, device=dev, seed=seed + 7919)
    t0 = time.perf_counter()
    r = solve(problem, cfg, dtype=dtype, device=dev, seed=seed)
    wall = time.perf_counter() - t0
    return {
        "time": wall,
        "iterations": r.iterations,
        "kkt_passes": r.kkt_passes,
        "restarts": r.restarts,
        "objective": r.objective,
        "status": r.status_string,
        "iters_per_sec": r.iterations / wall if wall > 0 else float("nan"),
    }


def _best(runs):
    return max(runs, key=lambda r: r["iters_per_sec"])


def compare(problem, tol, max_kkt, dtype_name, reps, reference=True,
            device=None) -> dict:
    """One row of the table: ours and the reference, each best of `reps`
    seeds, the speedups where the reference ran."""
    ours_runs = [run_ours(problem, tol, max_kkt, dtype_name, seed=s,
                          device=device) for s in range(reps)]
    ours = _best(ours_runs)
    ref = ref_runs = None
    if reference:
        from tpdlp_torch.bench.reference_runner import run_reference

        ref_runs = [r for r in (run_reference(problem, tol=tol,
                                              max_kkt=max_kkt, seed=s)
                                for s in range(reps)) if r is not None]
        ref = _best(ref_runs) if ref_runs else None
    row = {"instance": problem.name, "shape": list(problem.shape),
           "ours": ours, "reference": ref,
           "ours_iters_all": [r["iterations"] for r in ours_runs],
           "ref_iters_all": ([r["iterations"] for r in ref_runs]
                             if ref else None)}
    if ref:
        row["speedup_time"] = ref["time"] / ours["time"]
        row["speedup_iters_per_sec"] = (ours["iters_per_sec"]
                                        / ref["iters_per_sec"])
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", default="small,medium")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--max_kkt", type=int, default=100_000)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=3,
                    help="seeded repetitions per side; best-of-N reported "
                         "(the stepsize init is a random variable on both "
                         "sides)")
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="JSON-lines output")
    args = ap.parse_args(argv)

    from tpdlp_torch.bench.suite import build_suite

    rows = []
    for p in build_suite(tuple(args.classes.split(","))):
        row = compare(p, args.tol, args.max_kkt, args.dtype, args.reps,
                      not args.skip_reference, args.device)
        rows.append(row)
        ours, ref = row["ours"], row["reference"]
        if args.json:
            print(json.dumps(row))
        else:
            print(
                f"{p.name:16s} {str(p.shape):14s} "
                f"ours: {ours['time']:7.3f}s k={ours['iterations']:6d} "
                f"[{ours['status'][:6]}]"
                + (f"  ref: {ref['time']:8.3f}s k={ref['iterations']:6d} "
                   f"[{ref['status'][:6]}]  speedup "
                   f"x{row['speedup_time']:.1f}" if ref else ""),
                flush=True,
            )
    return rows


if __name__ == "__main__":
    main()
