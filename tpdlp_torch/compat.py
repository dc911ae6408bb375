"""Reference-compatible one-call entry points (counterpart of
tpdlp/compat.py).

The same three MPS-path-in, tuple-out solvers, with the JAX package's
signatures, defaults and return tuples (numpy arrays), on top of
:func:`tpdlp_torch.solve`:

    from tpdlp_torch.compat import pdlp_solver
    x, obj, k, n, j = pdlp_solver("instance.mps", tol=1e-4)

- ``pdhg_solver(mps_path, ...)`` returns (minimizer, objective,
  iterations); it runs the restarted core with restart checks every
  ``term_period`` iterations.
- ``restarted_solver(mps_path, ...)`` returns (minimizer, objective,
  iterations, restarts).
- ``pdlp_solver(mps_path, ...)`` returns (minimizer, objective,
  iterations, restarts, kkt_passes).

``max_iter`` budgets KKT passes, as in the JAX package.  Every print (the
device banner and the result block) is gated on ``verbose``.  The
signatures have no device argument: the solves run on the device named by
the module attribute ``DEVICE``, None for CUDA (the port's default, which
raises when there is none); set it to "cpu" to run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tpdlp_torch.config import SolverConfig
from tpdlp_torch.device import resolve_device
from tpdlp_torch.io.mps import read_mps
from tpdlp_torch.solver.solve import solve

#: The device the entry points solve on: None means CUDA.
DEVICE = None


def _print_result(result, verbose: bool, with_restarts: bool,
                  with_kkt: bool) -> None:
    if not verbose:
        return
    print("Objective Value:", result.objective)
    print("Iterations:", result.iterations)
    if with_restarts:
        print("Restarts:", result.restarts)
    if with_kkt:
        print("KKT Passes:", result.kkt_passes)
    print("\nMinimizer (first 10 variables):")
    print(np.asarray(result.x)[:10])


def _device(verbose: bool):
    dev = resolve_device(DEVICE)
    if verbose:
        name = (f" ({torch.cuda.get_device_name(dev)})"
                if dev.type == "cuda" else "")
        print(f"tpdlp_torch is using torch device: {dev}{name}")
    return dev


def pdhg_solver(mps_file_path, max_iter=10000, tol=1e-4, term_period=1000,
                verbose=True):
    """Plain-PDHG convenience entry.

    Returns ``(minimizer, objective_value, iterations)``.
    """
    dev = _device(verbose)
    problem = read_mps(mps_file_path)
    cfg = SolverConfig(
        tol=tol,
        max_kkt=max_iter,
        restart_period=term_period,
        verbose=verbose,
    )
    result = solve(problem, cfg, device=dev)
    _print_result(result, verbose, with_restarts=False, with_kkt=False)
    return np.asarray(result.x), result.objective, result.iterations


def restarted_solver(mps_file_path, tol=1e-4, restart_period=40,
                     verbose=True, max_iter=100_000):
    """Restarted-PDHG convenience entry.

    Returns ``(minimizer, objective_value, iterations, restarts)``.
    """
    dev = _device(verbose)
    problem = read_mps(mps_file_path)
    cfg = SolverConfig(
        tol=tol,
        max_kkt=max_iter,
        restart_period=restart_period,
        verbose=verbose,
    )
    result = solve(problem, cfg, device=dev)
    _print_result(result, verbose, with_restarts=True, with_kkt=False)
    return (np.asarray(result.x), result.objective, result.iterations,
            result.restarts)


def pdlp_solver(mps_file_path, tol=1e-4, restart_period=40, verbose=True,
                max_iter=1_000_000, precondition=True, adaptive_step=True,
                primal_update=True):
    """Full-PDLP convenience entry.

    Returns ``(minimizer, objective_value, iterations, restarts,
    kkt_passes)``.
    """
    dev = _device(verbose)
    problem = read_mps(mps_file_path)
    cfg = SolverConfig(
        tol=tol,
        max_kkt=max_iter,
        restart_period=restart_period,
        scaling="ruiz" if precondition else "none",
        adaptive=adaptive_step,
        primal_weight_update=primal_update,
        verbose=verbose,
    )
    result = solve(problem, cfg, device=dev)
    _print_result(result, verbose, with_restarts=True, with_kkt=True)
    return (np.asarray(result.x), result.objective, result.iterations,
            result.restarts, result.kkt_passes)


__all__ = ["pdhg_solver", "restarted_solver", "pdlp_solver", "DEVICE"]
