"""Infeasibility-detection battery (counterpart of
tpdlp/bench/infeasibility.py: the same rows, flags and JSON rows).

The terminal corpus (infeas01/unbnd01, this package's copies under
tpdlp_torch/bench/instances) plus planted-infeasible and planted-unbounded
LPs up to Mittelmann scale, each solved with the ray and normalized
certificates on, the status checked against the scipy/HiGHS oracle's
verdict (linprog status 2 = infeasible, 3 = unbounded).

Usage:
    python -m tpdlp_torch.bench.infeasibility [--device cuda|cpu]
        [--dtype float32|float64] [--tol 1e-6] [--max_kkt 100000]
        [--out infeasibility.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.config import SolverConfig, Status
from tpdlp_torch.device import resolve_device
from tpdlp_torch.io.generator import (
    generate_infeasible_lp,
    generate_unbounded_lp,
)
from tpdlp_torch.io.mps import read_mps
from tpdlp_torch.solver.solve import solve

INSTANCES_DIR = pathlib.Path(__file__).resolve().parent / "instances"

#: linprog status -> the certificate status the detector must produce.
EXPECT = {2: Status.PRIMAL_INFEASIBLE, 3: Status.DUAL_INFEASIBLE}


def oracle_status(problem, time_limit=600.0):
    """linprog/HiGHS status code: 0 optimal, 2 infeasible, 3 unbounded; 1
    when neither method decides within `time_limit` seconds.  HiGHS's
    interior point goes first: it decides the planted-infeasible rows in
    seconds where the default (dual simplex) takes minutes (the n5000 row)
    or more than ten (n10000)."""
    for method in ("highs-ipm", "highs"):
        status = _linprog_status(problem, method, time_limit)
        if status != 1:
            return status
    return status


def _linprog_status(problem, method, time_limit):
    from scipy.optimize import linprog

    K = problem.K
    if not sp.issparse(K):
        K = sp.csr_matrix(K)
    G, A = K[: problem.m_ineq], K[problem.m_ineq:]
    h, b = problem.q[: problem.m_ineq], problem.q[problem.m_ineq:]
    bounds = [
        (None if np.isneginf(lo) else lo, None if np.isposinf(up) else up)
        for lo, up in zip(problem.l, problem.u)
    ]
    res = linprog(
        problem.c,
        A_ub=-G if G.shape[0] else None,
        b_ub=-h if G.shape[0] else None,
        A_eq=A if A.shape[0] else None,
        b_eq=b if A.shape[0] else None,
        bounds=bounds, method=method,
        options={"time_limit": time_limit},
    )
    return int(res.status)


def build_battery():
    """(name, problem, expected linprog status) rows."""
    rows = []
    for fname, st in (("infeas01.mps", 2), ("unbnd01.mps", 3)):
        p = read_mps(INSTANCES_DIR / fname)
        p.name = fname.removesuffix(".mps")
        rows.append((p.name, p, st))
    # Planted families, small through Mittelmann scale.
    for n, m_eq, density, seed in (
        (40, 10, 0.4, 0), (757, 280, 0.05, 1),
        (5000, 1500, 0.01, 7), (10000, 3000, 0.004, 7),
    ):
        p = generate_infeasible_lp(n=n, m_eq=m_eq, density=density,
                                   seed=seed)
        rows.append((p.name, p, 2))
    for n, m_ineq, seed in ((30, 10, 0), (757, 280, 1), (5000, 1500, 7)):
        p = generate_unbounded_lp(n=n, m_ineq=m_ineq, seed=seed)
        rows.append((p.name, p, 3))
    return rows


def battery_config(tol=1e-6, max_kkt=100_000) -> SolverConfig:
    """The battery's flag set: Ruiz, adaptive steps, the primal-weight
    update, ray and normalized certificates."""
    return SolverConfig(tol=tol, max_kkt=max_kkt, scaling="ruiz",
                        adaptive=True, primal_weight_update=True,
                        infeasibility_detect=True,
                        normalized_certificates=True)


def solve_row(name, p, oracle_st, cfg: SolverConfig, *, seed=0, device=None,
              dtype=None, warm=True):
    """Solve one battery row; returns (its JSON row, the SolveResult).  The
    wall time covers one solve, after a warm-up solve with another seed
    when `warm`."""
    dev = resolve_device(device)
    if warm:
        solve(p, cfg, seed=seed + 7919, device=dev, dtype=dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r = solve(p, cfg, seed=seed, device=dev, dtype=dtype)
    wall = time.perf_counter() - t0
    row = {
        "instance": name,
        "shape": list(p.K.shape),
        "status": r.status.describe(),
        "oracle_linprog_status": oracle_st,
        "oracle_verified": oracle_status(p) == oracle_st,
        "expected_status": EXPECT[oracle_st].describe(),
        "match": r.status == EXPECT[oracle_st],
        "iterations": int(r.iterations),
        "kkt": int(r.kkt_passes),
        "wall": round(wall, 2),
    }
    return row, r


def run(tol=1e-6, max_kkt=100_000, seed=0, warm=True, device=None,
        dtype=None):
    cfg = battery_config(tol, max_kkt)
    rows = []
    for name, p, oracle_st in build_battery():
        row, _ = solve_row(name, p, oracle_st, cfg, seed=seed,
                           device=device, dtype=dtype, warm=warm)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max_kkt", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"),
                    help="default: float32 on cuda, float64 on the cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype) if args.dtype else None
    rows = run(tol=args.tol, max_kkt=args.max_kkt, seed=args.seed,
               warm=not args.no_warm, device=dev, dtype=dtype)
    artifact = {
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "matched": sum(r["match"] for r in rows),
        "total": len(rows),
        "rows": rows,
        "protocol": (
            f"python -m tpdlp_torch.bench.infeasibility --tol {args.tol:g} "
            f"--max_kkt {args.max_kkt} --seed {args.seed} "
            f"--device {dev.type} --dtype {args.dtype or 'default'} "
            "(ray + normalized certificates, ruiz+adaptive+pwu; statuses "
            "checked against scipy/HiGHS linprog verdicts)"
        ),
    }
    print(json.dumps({"matched": artifact["matched"],
                      "total": artifact["total"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"[infeasibility] artifact written: {args.out}")
    return artifact


if __name__ == "__main__":
    main()
