"""Banded 100k x 100k LP on one device in the band layout (counterpart of
tpdlp/bench/band_scale.py: same flags, defaults and JSON row).

The instance's dense fp32 K would take 40 GB; the band layout stores K and
K' in about 308 MB.  Prints one JSON row: status, iterations, wall, it/s,
and the band layout's stored bytes against the dense envelope.

Usage:
    python -m tpdlp_torch.bench.band_scale [--n 100000] [--tol 1e-4]
        [--device cuda|cpu] [--out band_100k.json]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tpdlp_torch.config import SolverConfig
from tpdlp_torch.io.generator import generate_banded_lp
from tpdlp_torch.ops.band import band_stored_elems
from tpdlp_torch.device import resolve_device
from tpdlp_torch.solver.solve import solve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m_ineq", type=int, default=75_000)
    ap.add_argument("--m_eq", type=int, default=25_000)
    ap.add_argument("--bandwidth", type=int, default=105)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--max_kkt", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    p = generate_banded_lp(n=args.n, m_ineq=args.m_ineq, m_eq=args.m_eq,
                           bandwidth=args.bandwidth, seed=args.seed)
    cfg = SolverConfig(tol=args.tol, max_kkt=args.max_kkt, scaling="ruiz",
                       adaptive=True, primal_weight_update=True,
                       time_limit=3000)
    elems = band_stored_elems(p.K)
    if elems is None:
        raise ValueError("the instance's K is not band-like: lower "
                         "--bandwidth")
    stored = elems * 4  # fp32 bytes of the K and K' slabs
    if not args.no_warm:
        solve(p, cfg, seed=args.seed + 7919, matrix_format="band",
              device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r = solve(p, cfg, seed=args.seed, matrix_format="band", device=dev)
    wall = time.perf_counter() - t0
    row = {
        "instance": f"banded-{args.n}-{args.m_ineq}-{args.m_eq}-"
                    f"{args.bandwidth}",
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "nnz": int(p.K.nnz),
        "dense_envelope_gb": round(
            (args.m_ineq + args.m_eq) * args.n * 4 / 1e9, 1
        ),
        "band_stored_mb": round(stored / 1e6, 1),
        "status": r.status.describe(),
        "iterations": int(r.iterations),
        "kkt": int(r.kkt_passes),
        "wall": round(wall, 1),
        "it_per_s": round(r.iterations / wall, 1),
        "objective": r.objective,
        "primal_res": float(r.primal_res),
        "dual_res": float(r.dual_res),
        "gap": float(r.gap),
        "protocol": (
            f"python -m tpdlp_torch.bench.band_scale --n {args.n} "
            f"--m_ineq {args.m_ineq} --m_eq {args.m_eq} "
            f"--bandwidth {args.bandwidth} --tol {args.tol:g} "
            f"--max_kkt {args.max_kkt} --seed {args.seed} "
            f"--device {dev.type} "
            "(matrix_format=band, ruiz+adaptive+pwu)"
        ),
    }
    print(json.dumps(row, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
        print(f"[band_scale] artifact written: {args.out}")
    return row


if __name__ == "__main__":
    main()
