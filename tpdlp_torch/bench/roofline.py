"""Speed-of-light model for the PDHG iteration on the card (counterpart of
tpdlp/bench/roofline.py).

PDHG is bound by memory: each iteration streams the constraint operator
twice (K x and K'y) plus O(m + n) vector traffic.  This harness times the
device loop on a synthetic instance, derives the achieved HBM rate from a
byte model, and reports it against the card's peak (default: the H100's
3.35 TB/s), beside the card's name and power limit.

Byte models (per iteration = one mv + one rmv), as in the JAX harness:
    dense : 2 * m * n * itemsize          (the whole matrix, both ways)
    band  : BandOp.stored_bytes()         (the slabs of K and K')
    ell   : the stored tiles of K and K'  (padded tiles, not m * n)
times the restart check's resweep factor (1 + 2 / restart_period), plus
14 (m + n) itemsize of vector traffic (lower order).

Measurement: two chunk lengths from the same warm state, each the best of
three runs (CUDA events on the card, the host clock on the CPU); the
marginal seconds per iteration of the two-point fit cancels the fixed cost
of a chunk.  A fit whose slope is not positive is noise, not a rate: it is
rejected with an error, never reported.

Usage: python -m tpdlp_torch.bench.roofline [--m 4000] [--n 10000]
       [--format dense|band|ell] [--iters 2000] [--dtype float32]
       [--peak-gbs 3350] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: NVIDIA H100 SXM HBM3, GB/s (NVIDIA's data sheet).
H100_PEAK_GBS = 3350.0
#: Runs per chunk length; the fastest is kept.
REPS = 3


def _seconds(fn, dev):
    """Seconds of fn(): CUDA events around it on a card (the last event
    waited for), the host clock on the CPU."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def _measure_chunk(st, pb, cfg, j_lo, j_hi, dev):
    """(marginal seconds per iteration, iterations between the two
    lengths); raises when the fit's slope is not positive."""
    from tpdlp_torch.solver.loop import read_ints, run_chunk

    def timed(budget):
        runs = [_seconds(lambda: run_chunk(st, pb, budget, cfg,
                                           aligned=True), dev)
                for _ in range(REPS)]
        return min(t for t, _ in runs), read_ints(runs[0][1].k)[0]

    t_lo, k_lo = timed(j_lo)
    t_hi, k_hi = timed(j_hi)
    slope = (t_hi - t_lo) / (k_hi - k_lo) if k_hi > k_lo else float("nan")
    if not slope > 0:
        raise RuntimeError(
            f"roofline: the two-point fit is not a rate (chunks of {k_lo} "
            f"and {k_hi} iterations took {t_lo:.6f} s and {t_hi:.6f} s): "
            "the timings are noise at this size; raise --iters")
    return slope, k_hi - k_lo


def run_roofline(m, n, iters, dtype_name="float32", fmt="dense",
                 density=1.0, bandwidth=145, seed=0, device=None):
    import torch

    from tpdlp_torch import SolverConfig
    from tpdlp_torch.device import resolve_device
    from tpdlp_torch.io.generator import (
        generate_banded_lp,
        generate_feasible_lp,
    )
    from tpdlp_torch.problem import device_vectors, to_device_arrays
    from tpdlp_torch.solver.loop import read_ints, run_chunk
    from tpdlp_torch.solver.solve import build_device_problem, eta_omega_of
    from tpdlp_torch.solver.state import init_state

    dev = resolve_device(device)
    dtype = getattr(torch, dtype_name)
    itemsize = torch.empty((), dtype=dtype).element_size()
    cfg = SolverConfig(
        tol=0.0,  # never terminate: the pure iteration rate
        max_kkt=10**9,
        scaling="ruiz",
        adaptive=True,
        primal_weight_update=True,
    )
    mi = int(0.75 * m)
    if fmt == "dense":
        problem = generate_feasible_lp(n=n, m_ineq=mi, m_eq=m - mi,
                                       density=density, seed=seed)
        op, c, q, l, u = to_device_arrays(problem, dtype, device=dev)
        op_bytes = 2 * m * n * itemsize
    else:
        problem = generate_banded_lp(n=n, m_ineq=mi, m_eq=m - mi,
                                     bandwidth=bandwidth, seed=seed)
        c, q, l, u = device_vectors(problem, dtype, dev)
        if fmt == "band":
            from tpdlp_torch.ops.band import BandOp

            op = BandOp.from_scipy(problem.K, dtype, device=dev)
            if op is None:
                raise ValueError("roofline: the instance is not band-like")
            op_bytes = op.stored_bytes()
        elif fmt == "ell":
            from tpdlp_torch.ops.blocked import BlockEllOp

            op = BlockEllOp.from_scipy(problem.K.tocsr(), dtype, device=dev)
            op_bytes = (op.fwd.tiles.numel()
                        + op.bwd.tiles.numel()) * itemsize
        else:
            raise ValueError(f"unknown format {fmt!r}")

    mask = torch.arange(problem.m, device=dev) < problem.m_ineq
    pb = build_device_problem(op, c, q, l, u, mask, cfg)
    del op
    eta0, omega0 = eta_omega_of(pb, seed, cfg)
    st = init_state(pb, eta0, omega0)
    # Warm, then the two-point fit from a warm state.
    st = run_chunk(st, pb, 32, cfg, aligned=True)
    (j0,) = read_ints(st.j)
    sec_per_iter, k_done = _measure_chunk(
        st, pb, cfg, j0 + max(50, iters // 10), j0 + iters, dev)

    per_iter_bytes = op_bytes * (1 + 2 / cfg.restart_period) + 14 * (
        m + n) * itemsize
    return {
        "m": m,
        "n": n,
        "format": fmt,
        "dtype": dtype_name,
        "iterations": k_done,
        "sec_per_iter": sec_per_iter,
        "iters_per_sec": 1.0 / sec_per_iter,
        "op_mbytes": op_bytes / 1e6,
        "bytes_per_iter": per_iter_bytes,
        "achieved_gbs": per_iter_bytes / sec_per_iter / 1e9,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=4000)
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--format", default="dense",
                    choices=("dense", "band", "ell"))
    ap.add_argument("--bandwidth", type=int, default=145,
                    help="band width of the banded instance (band/ell)")
    ap.add_argument("--peak-gbs", type=float, default=H100_PEAK_GBS,
                    help="the card's HBM peak (H100 SXM: 3350 GB/s)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tpdlp_torch.device import describe, resolve_device

    dev = resolve_device(args.device)
    card = describe(dev)
    r = run_roofline(args.m, args.n, args.iters, args.dtype,
                     fmt=args.format, bandwidth=args.bandwidth, device=dev)
    # The peak is the card's: a CPU run has a rate but no share of it.
    on_card = dev.type == "cuda"
    r["peak_gbs"] = args.peak_gbs if on_card else None
    r["fraction_of_peak"] = (r["achieved_gbs"] / args.peak_gbs if on_card
                             else None)
    r.update(card)
    share = (f" = {100 * r['fraction_of_peak']:.1f}% of "
             f"{args.peak_gbs:.0f} GB/s" if on_card else "")
    print(
        f"[roofline] ({args.m} x {args.n}, {args.format}, {args.dtype}) "
        f"{r['iters_per_sec']:.0f} it/s -> {r['achieved_gbs']:.1f} GB/s"
        f"{share} on {card['device']} ({card['power_limit']})",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": f"fused_step_hbm_fraction_of_peak_{args.format}",
        "value": r["fraction_of_peak"],
        "unit": "fraction",
        "detail": r,
    }))
    return r


if __name__ == "__main__":
    main()
