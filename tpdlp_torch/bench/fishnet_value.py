"""Measure what the fishnet warm start is worth (counterpart of
tpdlp/bench/fishnet_value.py).

For every suite and corpus instance: a cold solve (x0 = y0 = 0, the
reference default) and a warm one from the fishnet point
(tpdlp_torch/fishnet.py, wired as the CLI's --fishnet wires it), with
otherwise identical settings, and their iteration counts.  The search runs
in the solve's dtype (the JAX harness searches in fp32 everywhere).

Usage:
    python -m tpdlp_torch.bench.fishnet_value [--tol 1e-4] [--seed 0]
        [--classes small,medium,real] [--device cuda|cpu]
        [--out artifact.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def measure(problem, cfg, dtype, seed, device):
    """(cold result, warm result, the fishnet's seconds)."""
    from tpdlp_torch.fishnet import fishnet_start
    from tpdlp_torch.solver.solve import default_dtype, solve

    cold = solve(problem, cfg, dtype=dtype, seed=seed, device=device)
    t0 = time.perf_counter()
    x0, y0 = fishnet_start(problem, dtype or default_dtype(device), device,
                           "dense", cfg.scaling, seed)
    cast_s = time.perf_counter() - t0
    warm = solve(problem, cfg, dtype=dtype, seed=seed, device=device,
                 x0=x0, y0=y0, time_used=cast_s)
    return cold, warm, cast_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--classes", default="small,medium,real")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write raw rows as a JSON artifact")
    args = ap.parse_args(argv)

    from tpdlp_torch.bench.suite import build_corpus, build_suite
    from tpdlp_torch.config import SolverConfig
    from tpdlp_torch.device import describe, resolve_device

    dev = resolve_device(args.device)
    classes = tuple(args.classes.split(","))
    problems = build_suite(tuple(c for c in classes if c != "real"))
    if "real" in classes:
        problems += build_corpus()

    cfg = SolverConfig(tol=args.tol, scaling="ruiz", adaptive=True,
                       primal_weight_update=True)
    rows = []
    for p in problems:
        cold, warm, cast_s = measure(p, cfg, None, args.seed, dev)
        row = dict(
            instance=p.name,
            cold_k=int(cold.iterations), warm_k=int(warm.iterations),
            cold_status=cold.status.describe(),
            warm_status=warm.status.describe(),
            delta_k=int(cold.iterations) - int(warm.iterations),
            cold_s=cold.solve_time, warm_s=warm.solve_time, cast_s=cast_s,
        )
        rows.append(row)
        print(f"{row['instance']:<16} cold k={row['cold_k']:>6} "
              f"warm k={row['warm_k']:>6} delta={row['delta_k']:>+6} "
              f"({row['cold_status'][:3]}/{row['warm_status'][:3]})")

    saved = [r for r in rows if r["delta_k"] > 0]
    print(f"\n{len(saved)}/{len(rows)} instances improve; median saving "
          f"{np.median([r['delta_k'] / max(1, r['cold_k']) for r in rows]):.0%}"
          " of cold iterations")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**describe(dev), "rows": rows}, f, indent=1)
        print(f"[fishnet_value] artifact written: {args.out}")
    return rows


if __name__ == "__main__":
    main()
