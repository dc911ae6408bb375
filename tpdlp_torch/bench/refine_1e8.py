"""High-accuracy (1e-8) certification benchmark (counterpart of
tpdlp/bench/refine_1e8.py: same flags, defaults and JSON row, plus
--device).

Solves a suite instance end to end at tol=1e-8 with dtype=None, so on
CUDA (fp32) the default escalation runs (`escalation_mode="auto"` ->
iterative refinement, tpdlp_torch/solver/refine.py), and checks the
objective against the scipy HiGHS oracle.  The row records the card's
name and power limit, the refinement's rounds and the split of its wall
between the inner device solves and the host.

Usage:
    python -m tpdlp_torch.bench.refine_1e8 [--instance mittelmann-s]
        [--tol 1e-8] [--seed 0] [--matrix_format dense] [--device cuda]
        [--escalation_mode auto|refine|fp64_tail] [--out art.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from tpdlp_torch.bench.suite import build_suite
from tpdlp_torch.config import SolverConfig
from tpdlp_torch.device import describe, resolve_device
from tpdlp_torch.ops._kernels import BUILD_DIR
from tpdlp_torch.solver.solve import solve

#: HiGHS optima by instance name (a fixed suite instance's optimum never
#: changes; HiGHS can take hours on the largest), beside the kernels'
#: build outputs (ignored by git).
ORACLE_CACHE = BUILD_DIR / "oracle_cache.json"


def oracle_objective(problem, time_limit=900.0, cache=True):
    """HiGHS (scipy.optimize.linprog) optimum, obj_offset included; None
    when neither the dual simplex nor the interior point method reaches an
    optimum within `time_limit` seconds each."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    name = getattr(problem, "name", None)
    table = {}
    if cache and ORACLE_CACHE.exists():
        table = json.loads(ORACLE_CACHE.read_text())
        if name and name in table:
            return table[name]
    K = problem.K if sp.issparse(problem.K) else sp.csr_matrix(problem.K)
    K = sp.csr_matrix(K)
    G, A = K[: problem.m_ineq], K[problem.m_ineq:]
    h, b = problem.q[: problem.m_ineq], problem.q[problem.m_ineq:]
    bounds = [
        (None if np.isneginf(lo) else lo, None if np.isposinf(up) else up)
        for lo, up in zip(problem.l, problem.u)
    ]
    res = None
    for method in ("highs", "highs-ipm"):
        res = linprog(
            problem.c,
            A_ub=-G if G.shape[0] else None,
            b_ub=-h if G.shape[0] else None,
            A_eq=A if A.shape[0] else None,
            b_eq=b if A.shape[0] else None,
            bounds=bounds, method=method,
            options={"time_limit": time_limit},
        )
        if res.status == 0:
            break
    obj = (float(res.fun) + getattr(problem, "obj_offset", 0.0)
           if res is not None and res.status == 0 else None)
    if cache and name:
        table[name] = obj
        os.makedirs(ORACLE_CACHE.parent, exist_ok=True)
        tmp = ORACLE_CACHE.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(table, indent=1))
        os.replace(tmp, ORACLE_CACHE)
    return obj


def load_instance(instance):
    """A suite instance by name, or "banded-<n>-<m_ineq>-<m_eq>-<bw>"
    (generate_banded_lp's default seed) or "banded-<n>-<m_ineq>-<m_eq>-
    <bw>-<seed>"."""
    if instance.startswith("banded-"):
        from tpdlp_torch.io.generator import generate_banded_lp

        n_, mi_, me_, bw_, *seed = (int(v) for v in instance.split("-")[1:])
        problem = generate_banded_lp(n=n_, m_ineq=mi_, m_eq=me_,
                                     bandwidth=bw_,
                                     **({"seed": seed[0]} if seed else {}))
        problem.name = instance
        return problem
    (problem,) = build_suite(("small", "medium", "large", "xl"),
                             names=(instance,))
    return problem


def run(instance="mittelmann-s", tol=1e-8, seed=0, matrix_format="dense",
        warm=True, verbose=False, max_kkt=100_000, escalation_tol=None,
        chunk_kkt_max=None, abs_gap=False, device=None,
        escalation_mode="auto"):
    dev = resolve_device(device)
    problem = load_instance(instance)
    extra = {}
    if escalation_tol is not None:
        extra["escalation_tol"] = escalation_tol
    if chunk_kkt_max is not None:
        extra["chunk_kkt_max"] = chunk_kkt_max
    cfg = SolverConfig(tol=tol, scaling="ruiz", adaptive=True,
                       primal_weight_update=True, verbose=verbose,
                       max_kkt=max_kkt, abs_gap_termination=abs_gap,
                       escalation_mode=escalation_mode, **extra)
    if warm:
        # The kernels' first build and the allocator's warm-up stay out of
        # the measured wall; another seed, as bench.py does.
        solve(problem, cfg, seed=seed + 7919, matrix_format=matrix_format,
              device=dev)
    start = time.perf_counter()
    r = solve(problem, cfg, seed=seed, matrix_format=matrix_format,
              device=dev)
    wall = time.perf_counter() - start

    esc = r.escalation or {}
    row = {
        "instance": instance,
        **describe(dev),
        "status": r.status.describe(),
        "iterations": int(r.iterations),
        "kkt": int(r.kkt_passes),
        "wall": wall,
        "objective": r.objective,
        "primal_res": float(r.primal_res),
        "dual_res": float(r.dual_res),
        "gap": float(r.gap),
        "route": esc.get("route"),
        "rounds": esc.get("rounds"),
        "inner_s": esc.get("inner_s"),
        "host_s": esc.get("host_s"),
    }
    oracle_obj = oracle_objective(problem)
    if oracle_obj is not None:
        row["oracle_obj"] = oracle_obj
        row["rel_err"] = abs(r.objective - oracle_obj) / max(1.0,
                                                             abs(oracle_obj))
    row["gap_criterion"] = "abs" if abs_gap else "signed (reference)"
    row["protocol"] = (
        f"python -m tpdlp_torch.bench.refine_1e8 --instance {instance} "
        f"--tol {tol:g} --seed {seed} --matrix_format {matrix_format} "
        f"--max_kkt {max_kkt} --device {dev.type} "
        f"--escalation_mode {escalation_mode} "
        + ("--abs_gap " if abs_gap else "")
        + (f"--escalation_tol {escalation_tol:g} "
           if escalation_tol is not None else "")
        + (f"--chunk_kkt_max {chunk_kkt_max} "
           if chunk_kkt_max is not None else "")
        + "(ruiz+adaptive+pwu)"
    )
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--instance", default="mittelmann-s")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--matrix_format", default="dense")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--escalation_mode", default="auto",
                    choices=["auto", "refine", "fp64_tail"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the warm-up solve")
    ap.add_argument("--verbose", action="store_true",
                    help="per-chunk progress records from the inner solves")
    ap.add_argument("--max_kkt", type=int, default=100_000,
                    help="global KKT-pass budget")
    ap.add_argument("--escalation_tol", type=float, default=None,
                    help="coarse-stage tolerance override")
    ap.add_argument("--chunk_kkt_max", type=int, default=None,
                    help="cap KKT passes per chunk between host checks")
    ap.add_argument("--abs_gap", action="store_true",
                    help="certify |gap| <= tol(1+|p|+|d|) instead of the "
                         "reference's signed gap")
    args = ap.parse_args(argv)

    row = run(args.instance, args.tol, args.seed, args.matrix_format,
              warm=not args.no_warm, verbose=args.verbose,
              max_kkt=args.max_kkt, escalation_tol=args.escalation_tol,
              chunk_kkt_max=args.chunk_kkt_max, abs_gap=args.abs_gap,
              device=args.device, escalation_mode=args.escalation_mode)
    print(json.dumps(row, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
        print(f"[refine_1e8] artifact written: {args.out}")
    return row


if __name__ == "__main__":
    main()
