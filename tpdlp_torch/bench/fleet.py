"""Scenario-batched fleet benchmark: many perturbed LPs solved together on
one device (counterpart of tpdlp/bench/fleet.py).

Workload: B cost-perturbed copies of a suite instance (perturbing c leaves
the planted-feasible region untouched, so every element stays feasible but
has its own optimum), solved by `tpdlp_torch.solve_batch` as one fleet over
one shared K; or, with --banded, B distinct banded LPs (one per seed) in
the stacked band-slab layout.  Reported: instances/s of the batched solve,
and the reference's sequential per-instance rate where its source tree is
present (bench/reference_runner.py; otherwise `vs_baseline` is null).

Usage: python -m tpdlp_torch.bench.fleet [--batch 64] [--instance
       deg2-class] [--tol 1e-4] [--device cuda|cpu] [--banded]
       [--ref-samples 2] [--skip-reference] [--out artifact.json]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np


def perturbed_fleet(base, batch: int, rel: float = 0.05, seed: int = 0):
    """B copies of `base` with independently perturbed costs (the K object
    is shared, so the fleet is a shared-K fleet)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batch):
        p = copy.copy(base)
        p.c = base.c * (1.0 + rel * rng.standard_normal(base.c.shape))
        p.name = f"{base.name}#{b}"
        out.append(p)
    return out


def fleet_config(tol: float, max_kkt: int):
    """The benchmark's solver settings: Ruiz, adaptive steps, the
    primal-weight update, time_limit 1200 s."""
    from tpdlp_torch import SolverConfig

    return SolverConfig(tol=tol, max_kkt=max_kkt, scaling="ruiz",
                        adaptive=True, primal_weight_update=True,
                        time_limit=1200)


def run_fleet(problems, tol, max_kkt, dtype_name="float32",
              restart_sync="global", warm_problems=None,
              matrix_format="dense", shared_operator="auto", device=None):
    """instances/s of one batched solve, after one solve of
    `warm_problems` (same shapes, other data; default a re-perturbed copy
    of `problems`), which builds the kernels and warms the allocator (the
    JAX harness warms twice, for its compile caches)."""
    import torch

    from tpdlp_torch.batch import solve_batch
    from tpdlp_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = fleet_config(tol, max_kkt)
    kw = dict(dtype=getattr(torch, dtype_name), restart_sync=restart_sync,
              matrix_format=matrix_format, shared_operator=shared_operator,
              device=dev)
    if warm_problems is None:
        rng = np.random.default_rng(104729)
        warm_problems = []
        for p in problems:
            w = copy.copy(p)
            w.c = p.c * (1.0 + 0.01 * rng.standard_normal(p.c.shape))
            warm_problems.append(w)
    solve_batch(warm_problems, cfg, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rs = solve_batch(problems, cfg, **kw)
    wall = time.perf_counter() - t0
    solved = sum(r.status_string == "Solved" for r in rs)
    return {
        "time": wall,
        "batch": len(problems),
        "solved": solved,
        "instances_per_sec": len(problems) / wall,
        "max_iterations": max(r.iterations for r in rs),
        "results": rs,
    }


def banded_fleet(spec: str, batch: int, seed0: int = 0):
    """B distinct banded LPs, seeds seed0 ... seed0 + B - 1, of the shape
    "n,m_ineq,m_eq,bandwidth"."""
    from tpdlp_torch.io.generator import generate_banded_lp

    n, mi, me, bw = (int(v) for v in spec.split(","))
    return [generate_banded_lp(n=n, m_ineq=mi, m_eq=me, bandwidth=bw,
                               seed=seed0 + s) for s in range(batch)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--instance", default="deg2-class")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--max_kkt", type=int, default=100_000)
    ap.add_argument("--ref-samples", type=int, default=2)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--matrix_format", default="dense",
                    choices=("dense", "sparse", "band", "auto"))
    ap.add_argument("--banded", action="store_true",
                    help="use a DISTINCT banded fleet (one banded LP per "
                         "seed, stacked band-slab layout) instead of the "
                         "cost-perturbed shared-K fleet; --instance is "
                         "then n,m_ineq,m_eq,bandwidth")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the full result row (with protocol and "
                         "device) to this JSON artifact path")
    args = ap.parse_args(argv)

    from tpdlp_torch.device import describe, resolve_device

    dev = resolve_device(args.device)
    if args.banded:
        fleet = banded_fleet(args.instance, args.batch)
        warm = banded_fleet(args.instance, args.batch, seed0=10_000)
        n, mi, me, bw = (int(v) for v in args.instance.split(","))
        args.instance = f"banded_{n}x{mi + me}_bw{bw}"
        ours = run_fleet(fleet, args.tol, args.max_kkt, warm_problems=warm,
                         matrix_format=args.matrix_format,
                         shared_operator=False, device=dev)
    else:
        from tpdlp_torch.bench.suite import build_suite

        base = next(p for p in build_suite(("small", "medium", "large"))
                    if p.name == args.instance)
        fleet = perturbed_fleet(base, args.batch)
        ours = run_fleet(fleet, args.tol, args.max_kkt,
                         matrix_format=args.matrix_format, device=dev)
    print(
        f"[fleet] ours: {ours['batch']} instances in {ours['time']:.2f}s "
        f"({ours['instances_per_sec']:.1f} inst/s, "
        f"{ours['solved']}/{ours['batch']} solved)",
        file=sys.stderr,
    )

    ref_rate = None
    if not args.skip_reference:
        from tpdlp_torch.bench.reference_runner import run_reference

        times = []
        for p in fleet[: args.ref_samples]:
            r = run_reference(p, tol=args.tol, max_kkt=args.max_kkt)
            if r is None:
                break
            times.append(r["time"])
        if times:
            ref_rate = 1.0 / (sum(times) / len(times))
            print(f"[fleet] reference (torch cpu, sequential): "
                  f"{1.0 / ref_rate:.2f}s/instance ({ref_rate:.2f} inst/s)",
                  file=sys.stderr)

    row = {
        "metric": f"fleet_{args.instance}_instances_per_sec",
        "value": ours["instances_per_sec"],
        "unit": "instances/s",
        "vs_baseline": (ours["instances_per_sec"] / ref_rate
                        if ref_rate else None),
    }
    print(json.dumps(row))
    if args.out:
        row.update({
            **describe(dev),
            "batch": ours["batch"],
            "solved": ours["solved"],
            "wall": ours["time"],
            "tol": args.tol,
            "reference_inst_per_sec": ref_rate,
            "protocol": "python -m tpdlp_torch.bench.fleet " + " ".join(
                argv if argv is not None else sys.argv[1:]),
        })
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
        print(f"[fleet] artifact written: {args.out}", file=sys.stderr)
    return ours


if __name__ == "__main__":
    main()
