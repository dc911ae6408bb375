"""Presolve reduction statistics over the vendored MPS corpus
(counterpart of tpdlp/bench/presolve_stats.py).

Per instance and engine (python / C++): status, the rows/cols/nnz
reduction percentages, passes and wall time.  The first C++ call builds
the core with g++ (presolve/cpp.py); `build_s` reports that build apart.

Usage: python -m tpdlp_torch.bench.presolve_stats [--backend python,cpp]
       [--json]
"""

from __future__ import annotations

import argparse
import json
import time


def build_cpp() -> float:
    """Seconds to build the C++ core (0 when it is already built)."""
    from tpdlp_torch.presolve import cpp

    t0 = time.perf_counter()
    if not cpp.library_path().exists():
        cpp.build()
        return time.perf_counter() - t0
    return 0.0


def run_stats(backends=("python", "cpp"), problems=None):
    from tpdlp_torch.bench.suite import build_corpus
    from tpdlp_torch.config import Status
    from tpdlp_torch.presolve import presolve

    if problems is None:
        problems = build_corpus()
    rows = []
    for p in problems:
        nnz0 = p.K.nnz
        for backend in backends:
            t0 = time.perf_counter()
            r = presolve(p, backend=backend)
            dt = time.perf_counter() - t0
            if r.problem is not None:
                m1, n1, nnz1 = r.problem.m, r.problem.n, r.problem.K.nnz
            else:
                m1 = n1 = nnz1 = 0
            rows.append({
                "instance": p.name,
                "backend": backend,
                "status": Status(r.status).name,
                "passes": r.passes,
                "rows_removed": r.rows_removed,
                "cols_removed": r.cols_removed,
                "rows_removed_pct": round(100 * (1 - m1 / p.m), 1),
                "cols_removed_pct": round(100 * (1 - n1 / p.n), 1),
                "nnz_removed_pct": round(100 * (1 - nnz1 / nnz0), 1),
                "time_ms": 1e3 * dt,
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="python,cpp")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    backends = tuple(args.backend.split(","))
    build_s = build_cpp() if "cpp" in backends else 0.0
    rows = run_stats(backends)
    if args.json:
        print(json.dumps({"build_s": build_s}))
        for r in rows:
            print(json.dumps(r))
    else:
        print(f"C++ core build: {build_s:.2f} s")
        print(f"{'instance':12s} {'eng':6s} {'status':10s} "
              f"{'rows%':>6s} {'cols%':>6s} {'nnz%':>6s} "
              f"{'passes':>6s} {'ms':>8s}")
        for r in rows:
            print(f"{r['instance']:12s} {r['backend']:6s} "
                  f"{r['status']:10s} {r['rows_removed_pct']:6.1f} "
                  f"{r['cols_removed_pct']:6.1f} "
                  f"{r['nnz_removed_pct']:6.1f} {r['passes']:6d} "
                  f"{r['time_ms']:8.2f}")
    return rows


if __name__ == "__main__":
    main()
