"""Sharded-solve scaling: the same chunk of iterations over 1, 2 and 4
ranks (counterpart of tpdlp/bench/scaling.py).

Each row times a chunk of `--iters` KKT passes from the same warm state
(Ruiz, adaptive steps, tol 0 so nothing terminates) and checks the
communication structure: where the JAX harness reads the all-reduces from
the compiled HLO, this one counts the all_reduces each rank issued over
the chunk (`Mesh.counts`), which must be one per operator product.  Under
the port's design every vector is replicated, so a product reduces a
full-length vector: m_pad + n_pad elements per iteration, whatever the
mesh.  The trajectory must match the single-rank run (padding is exact).

The backend is the caller's: gloo runs the ranks on the CPU or shares the
cards among them (staging CUDA tensors through the host), NCCL gives each
rank a card of its own (`shard.launch.rank_devices`).  Gloo ranks on one
machine are no guide to NCCL over several cards.

Usage: python -m tpdlp_torch.bench.scaling --backend gloo|nccl
       [--m 512] [--n 1024] [--iters 200] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _timed_chunk(mesh, dev, problem, cfg, iters, dtype_name):
    """One rank's measurement: a warm chunk of 32 KKT passes, then the
    timed chunk of `iters` more."""
    import torch

    from tpdlp_torch.solver import loop as L
    from tpdlp_torch.solver.solve import prepare

    dtype = getattr(torch, dtype_name)
    pb, st = prepare(problem, cfg, dtype=dtype, device=dev, mesh=mesh)
    st = L.run_chunk(st, pb, 32, cfg, aligned=True)
    j0, k0 = L.read_ints(st.j, st.k)
    if mesh is not None:
        mesh.reset_counts()
    L.reset_launched()
    t0 = time.perf_counter()
    st = L.run_chunk(st, pb, j0 + iters, cfg, aligned=True)
    j1, k1 = L.read_ints(st.j, st.k)  # waits for the device
    dt = time.perf_counter() - t0
    return {
        "k": k1 - k0, "kkt_passes": j1 - j0, "seconds": dt,
        # Two products per issued iteration and restart check.
        "products": 2 * (L.launched["iterations"]
                         + L.launched["restart_checks"]),
        "all_reduces": 0 if mesh is None else mesh.counts["product"],
        "shape": list(pb.op.shape), "itemsize": pb.c.element_size(),
        "objective": float(torch.dot(pb.c, st.x)),
    }


def run_scaling(m, n, iters, *, backend, ranks=(1, 2, 4),
                dtype_name="float32", device=None):
    from tpdlp_torch import SolverConfig, generate_feasible_lp
    from tpdlp_torch.device import resolve_device
    from tpdlp_torch.shard.launch import rank_devices, run_ranks
    from tpdlp_torch.shard.mesh import default_shape

    dev = resolve_device(device)
    cfg = SolverConfig(tol=0.0, max_kkt=10**9, scaling="ruiz", adaptive=True)
    problem = generate_feasible_lp(n=n, m_ineq=int(0.75 * m),
                                   m_eq=m - int(0.75 * m), seed=0)
    rows = []
    for world in ranks:
        if world == 1:
            res = _timed_chunk(None, dev, problem, cfg, iters, dtype_name)
        else:
            out = run_ranks(_timed_chunk, world, backend=backend,
                            device=rank_devices(world, dev, backend),
                            args=(problem, cfg, iters, dtype_name))
            res = out[0]
            if any((o["k"], o["objective"]) != (res["k"], res["objective"])
                   for o in out):
                raise AssertionError(f"ranks disagree: {out}")
        R, C = default_shape(world)
        m_pad, n_pad = res["shape"]
        elems = 0 if world == 1 else m_pad + n_pad
        rows.append({
            "devices": world,
            "mesh": {"row": R, "col": C},
            "backend": None if world == 1 else backend,
            "device": str(dev),
            "iters_per_sec": res["k"] / res["seconds"],
            "all_reduces_per_kkt_pass": res["all_reduces"]
            / res["kkt_passes"],
            "all_reduces_per_product": res["all_reduces"] / res["products"],
            "comm_elems_per_iteration": elems,
            "comm_bytes_per_iteration": elems * res["itemsize"],
            "scaled_objective_after_chunks": res["objective"],
        })
        if world > 1 and rows[-1]["all_reduces_per_product"] != 1.0:
            raise AssertionError(f"{world} ranks: {res['all_reduces']} "
                                 f"all_reduces for {res['products']} "
                                 "products")
        print(f"[scaling] {world} ranks {rows[-1]['mesh']}: "
              f"{rows[-1]['iters_per_sec']:.0f} it/s, "
              f"{rows[-1]['all_reduces_per_product']:.3f} all_reduces a "
              f"product, {rows[-1]['comm_bytes_per_iteration']} comm "
              f"B/iter, obj {res['objective']:.8f}", file=sys.stderr)
    base = rows[0]["scaled_objective_after_chunks"]
    for row in rows[1:]:
        row["trajectory_rel_err_vs_single"] = abs(
            row["scaled_objective_after_chunks"] - base) / (1.0 + abs(base))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    rows = run_scaling(args.m, args.n, args.iters, backend=args.backend,
                       dtype_name=args.dtype, device=args.device)
    print(json.dumps({"metric": "sharded_scaling_validation", "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
