"""Run the reference torchPDLP on an LPProblem, for baseline measurement
(counterpart of tpdlp/bench/reference_runner.py).

This executes the reference implementation where its source tree is
present: the directory named by the environment variable
`TPDLP_REFERENCE_PATH` (nothing of it is vendored here).  Without it,
`run_reference` returns None and the benchmarks report `vs_baseline` as
null.  The standard form is handed over as torch tensors in the
reference's layout ((n, 1) column vectors, stacked K).
"""

from __future__ import annotations

import os
import sys
import time

REFERENCE_ENV = "TPDLP_REFERENCE_PATH"


def run_reference(problem, tol=1e-4, max_kkt=100_000, precondition=True,
                  adaptive=True, primal_update=True, time_limit=600,
                  seed=0):
    """dict(time, iterations, kkt_passes, restarts, objective, status,
    iters_per_sec) from the reference pdlp_algorithm, or None if it is not
    available.

    `seed` seeds torch's global generator: the reference's stepsize init
    draws unseeded `torch.rand`, which makes its iteration count a random
    variable."""
    path = os.environ.get(REFERENCE_ENV)
    if not path or not os.path.isdir(path):
        print(f"[baseline] reference unavailable: ${REFERENCE_ENV} does "
              "not name its source tree", file=sys.stderr)
        return None
    if path not in sys.path:
        sys.path.insert(0, path)
    try:
        import torch
        # The reference's own main.py imports a `preconditioning` that
        # does not exist; the function is ruiz_precondition.
        from enhancements import ruiz_precondition as preconditioning
        from primal_dual_hybrid_gradient import pdlp_algorithm
    except Exception as e:  # pragma: no cover
        print(f"[baseline] reference unavailable: {e}", file=sys.stderr)
        return None

    torch.manual_seed(seed)
    device = torch.device("cpu")
    K = torch.tensor(
        problem.K.toarray() if hasattr(problem.K, "toarray") else problem.K,
        dtype=torch.float32,
    )
    c = torch.tensor(problem.c, dtype=torch.float32).view(-1, 1)
    q = torch.tensor(problem.q, dtype=torch.float32).view(-1, 1)
    l = torch.tensor(problem.l, dtype=torch.float32).view(-1, 1)
    u = torch.tensor(problem.u, dtype=torch.float32).view(-1, 1)

    t0 = time.perf_counter()
    time_used = 0.0
    dt_precond = None
    if precondition:
        K, c, q, l, u, dt_precond, time_used = preconditioning(
            c, K, q, l, u, device=device
        )
    x, obj, k, n, j, status, total_time = pdlp_algorithm(
        K, problem.m_ineq, c, q, l, u, device,
        max_kkt=max_kkt, tol=tol, verbose=False,
        restart_period=40, precondition=precondition,
        primal_update=primal_update, adaptive=adaptive,
        data_precond=dt_precond, infeasibility_detect=False,
        time_limit=time_limit, time_used=time_used,
    )
    wall = time.perf_counter() - t0
    return {
        "time": wall,
        "iterations": int(k),
        "kkt_passes": int(j),
        "restarts": int(n),
        "objective": float(obj),
        "status": str(status),
        "iters_per_sec": int(k) / wall if wall > 0 else float("nan"),
    }
