"""Entry points of the port (counterpart of __graft_entry__.py).

`entry()` returns (fn, example_args): one restarted-PDHG iteration of the
flagship configuration (Ruiz, adaptive steps, primal-weight update, the
ray certificates) as a state transition, `solver/loop.py::make_body`, on
the card.

`dryrun_multichip(n)` spawns n ranks joined by a process group
(tpdlp_torch/shard: gloo ranks on the CPU, NCCL ranks with a card each on
CUDA) and solves to Solved under all three sharded layouts: dense 2D
blocks, block-ELL flat strips ("sparse") and band flat strips, on the JAX
function's instances.

    python -m tpdlp_torch.entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _flagship(dtype=None, n=256, m_ineq=160, m_eq=64, scaling="ruiz",
              device=None):
    """(pb, cfg, state) of the flagship configuration: the JAX
    `_flagship`'s instance, settings and starting point (eta 0.01, omega
    1)."""
    from tpdlp_torch import SolverConfig, generate_feasible_lp
    from tpdlp_torch.device import resolve_device
    from tpdlp_torch.problem import to_device_arrays
    from tpdlp_torch.solver.solve import build_device_problem, default_dtype
    from tpdlp_torch.solver.state import init_state

    dev = resolve_device(device)
    if dtype is None:
        dtype = default_dtype(dev)
    cfg = SolverConfig(tol=1e-6, adaptive=True, primal_weight_update=True,
                       infeasibility_detect=True, scaling=scaling)
    problem = generate_feasible_lp(n=n, m_ineq=m_ineq, m_eq=m_eq, seed=0)
    op, c, q, l, u = to_device_arrays(problem, dtype, device=dev)
    mask = torch.arange(problem.m, device=dev) < problem.m_ineq
    pb = build_device_problem(op, c, q, l, u, mask, cfg)
    st = init_state(pb, torch.tensor(0.01, dtype=dtype, device=dev),
                    torch.tensor(1.0, dtype=dtype, device=dev))
    return pb, cfg, st


def entry(device=None, dtype=None):
    """(fn, example_args): fn(state) is one iteration of the flagship
    solve on `device` (CUDA unless the caller names another)."""
    from tpdlp_torch.solver.loop import make_body

    pb, cfg, st = _flagship(dtype=dtype, device=device)
    return make_body(pb, cfg), (st,)


def _dryrun_rank(mesh, dev):
    """One rank of dryrun_multichip: the three sharded solves."""
    from tpdlp_torch import (
        SolverConfig,
        Status,
        generate_banded_lp,
        generate_feasible_lp,
        solve,
    )

    problem = generate_feasible_lp(n=45, m_ineq=26, m_eq=9, seed=0)
    cfg = SolverConfig(tol=1e-5, max_kkt=40_000, scaling="ruiz",
                       adaptive=True, primal_weight_update=True)
    banded = generate_banded_lp(n=520, m_ineq=260, m_eq=130, bandwidth=33,
                                seed=1)
    out = {}
    for name, p, fmt in (("dense", problem, "dense"),
                         ("sparse", problem, "sparse"),
                         ("band", banded, "band")):
        r = solve(p, cfg, device=dev, mesh=mesh, matrix_format=fmt)
        if r.status != Status.SOLVED or not np.isfinite(r.x).all():
            raise AssertionError(f"{name}: {r.status_string}")
        out[name] = (r.iterations, r.objective)
    d, s = out["dense"][1], out["sparse"][1]
    if abs(d - s) > 1e-3 * (1 + abs(d)):
        raise AssertionError(f"dense {d} and sparse {s} objectives differ")
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn `n_devices` ranks and solve to Solved under the three sharded
    layouts; returns rank 0's {layout: (k, objective)}, which every rank
    must share.

    `device`: None means CUDA (raises without it), "cpu" runs the ranks on
    the CPU.  The backend follows from it: gloo on the CPU, NCCL on CUDA
    with a card for each rank (ValueError where there are fewer cards
    than ranks)."""
    from tpdlp_torch.device import resolve_device
    from tpdlp_torch.shard.launch import rank_devices, run_ranks
    from tpdlp_torch.shard.mesh import default_shape

    dev = resolve_device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    results = run_ranks(_dryrun_rank, n_devices, backend=backend,
                        device=rank_devices(n_devices, dev, backend))
    if any(r != results[0] for r in results):
        raise AssertionError(f"ranks disagree: {results}")
    out = results[0]
    print(f"dryrun_multichip OK: mesh {default_shape(n_devices)} "
          f"({n_devices} ranks, {backend} on {dev.type}); "
          + "; ".join(f"{k} solve k={v[0]} obj={v[1]:.6f}"
                      for k, v in out.items()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: 4 on the CPU, "
                         "one for each card on CUDA)")
    args = ap.parse_args(argv)
    fn, (st,) = entry(device=args.device)
    out = fn(st)
    print(f"entry OK: one flagship iteration, k={int(out.k)} "
          f"j={int(out.j)} on {out.x.device}")
    ranks = args.ranks or (4 if out.x.device.type == "cpu"
                           else torch.cuda.device_count())
    dryrun_multichip(ranks, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
