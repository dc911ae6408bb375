"""Corpus-wide 1e-8 |gap| certification sweep (counterpart of
tpdlp/bench/refine_corpus.py, plus --device).

Every instance of the deterministic suite (the mixed-bounds ``-free``
variants included), the vendored corpus and the vendored Netlib afiro, at
tol=1e-8 with the strict |gap| criterion and dtype=None, so on CUDA the
default escalation (iterative refinement) runs.  One row per instance,
failures recorded per row; the artifact carries the card's name and power
limit.

Usage:
    python -m tpdlp_torch.bench.refine_corpus [--out refine_corpus.json]
        [--only name1,name2] [--skip nameA] [--max_kkt 100000]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from tpdlp_torch.bench.refine_1e8 import oracle_objective
from tpdlp_torch.bench.suite import build_corpus, build_suite
from tpdlp_torch.config import SolverConfig
from tpdlp_torch.device import describe, resolve_device
from tpdlp_torch.solver.solve import solve


def build_instances():
    """The suite, the vendored corpus and the vendored afiro (no network:
    a Netlib instance is loaded only from the package's own copy)."""
    problems = list(build_suite(("small", "medium", "large", "xl")))
    problems += build_corpus()
    from tpdlp_torch.io import netlib

    problems.append(netlib.load("afiro", mirrors=[]))
    return problems


def run_one(problem, tol, max_kkt, seed, warm=True, device=None):
    dev = resolve_device(device)
    cfg = SolverConfig(tol=tol, scaling="ruiz", adaptive=True,
                       primal_weight_update=True, max_kkt=max_kkt,
                       abs_gap_termination=True)
    if warm:
        solve(problem, cfg, seed=seed + 7919, device=dev)
    t0 = time.perf_counter()
    r = solve(problem, cfg, seed=seed, device=dev)
    wall = time.perf_counter() - t0
    gap_band = tol * (1.0 + abs(r.objective - problem.obj_offset)
                      + abs(r.objective - problem.obj_offset - r.gap))
    row = {
        "instance": problem.name,
        "shape": list(problem.K.shape),
        "status": r.status.describe(),
        "kkt": int(r.kkt_passes),
        "wall": wall,
        "objective": r.objective,
        "primal_res": float(r.primal_res),
        "dual_res": float(r.dual_res),
        "abs_gap": abs(float(r.gap)),
        "gap_band": gap_band,
        "route": (r.escalation or {}).get("route"),
    }
    oracle = oracle_objective(problem)
    if oracle is not None:
        row["oracle_obj"] = oracle
        row["rel_err"] = abs(r.objective - oracle) / max(1.0, abs(oracle))
    return row


def _artifact(rows, args, dev):
    return {
        **describe(dev),
        "tol": args.tol,
        "criterion": "abs |gap| <= tol(1+|p|+|d|)",
        "solved": sum(r.get("status") == "Solved" for r in rows),
        "total": len(rows),
        "rows": rows,
        "protocol": (
            f"python -m tpdlp_torch.bench.refine_corpus --tol {args.tol:g} "
            f"--max_kkt {args.max_kkt} --seed {args.seed} "
            f"--device {dev.type} (abs_gap_termination, "
            "ruiz+adaptive+pwu, escalation_mode=auto -> refine)"
        ),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max_kkt", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None)
    ap.add_argument("--skip", default="")
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    only = set(args.only.split(",")) if args.only else None
    skip = set(args.skip.split(",")) if args.skip else set()
    rows = []
    for p in build_instances():
        if only is not None and p.name not in only:
            continue
        if p.name in skip:
            continue
        try:
            row = run_one(p, args.tol, args.max_kkt, args.seed,
                          warm=not args.no_warm, device=dev)
        except Exception as e:  # record, keep sweeping
            row = {"instance": p.name, "status": f"ERROR: {e}"}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:  # incremental: a killed sweep still leaves its rows
            with open(args.out, "w") as f:
                json.dump(_artifact(rows, args, dev), f, indent=1)
    print(json.dumps({
        "solved": sum(r.get("status") == "Solved" for r in rows),
        "total": len(rows),
    }))
    return rows


if __name__ == "__main__":
    main()
