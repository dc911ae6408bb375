"""Drive the PyTorch/CUDA port (tpdlp_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device  — the card's name and power limit; TF32 matmuls must be off.
2. build   — nvcc builds the port's CUDA kernels from tpdlp_torch/csrc.
3. kernels — each kernel against its plain PyTorch twin at the main path's
             shapes (and a few edge shapes): error, bit-identical repeats,
             and the times of the kernel, the twin and the one PyTorch call
             that computes the same function (CUDA events, median of 25
             single launches, each after a 256 MB write that evicts L2).
4. solve   — the main path: mittelmann-s and mittelmann-l at full size in
             fp32, tol 1e-4, Ruiz + adaptive steps + primal-weight update
             (the settings of the JAX package's bench runner); one warm-up
             solve, then seeds 0-2.  Checks Solved, the kernel launch count
             against the count the code implies, and recomputes the
             residuals of the returned (x, y) on the host in fp64.
5. profile — one mittelmann-s solve under torch.profiler (device activity
             only): the device's busy share of the wall time, and the
             device time by kernel.  A measurement, not a check.
6. cross   — maros-class on the card in fp32 and on the CPU in fp64.

Then the kernel summary line, the card's `nvidia-smi` name and power limit,
and last {"ok": true, "device": {...}}.  Needs one CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

TOL = 1e-4
MAX_KKT = 100_000
KERNEL_SHAPES = [(27, 51), (2000, 700), (257, 2049), (16, 9000),
                 (2000, 5000), (5000, 2000), (8000, 20000), (20000, 8000)]
#: The main path's shape the kernel summary line reports (mittelmann-s K).
HEADLINE_SHAPE = (2000, 5000)
FP64_SHAPE = (2000, 5000)
TIMED_LAUNCHES = 25

#: Data-sheet rates by card: HBM bytes/s, fp32 and fp64 flop/s outside the
#: tensor cores (NVIDIA data sheets; SXM unless the name says otherwise).
_CARD_RATES = [
    ("H200", 4.8e12, 67e12, 34e12),
    ("H100 NVL", 3.9e12, 60e12, 30e12),
    ("H100 PCIe", 2.0e12, 51e12, 26e12),
    ("H100", 3.35e12, 67e12, 34e12),
]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_rates(name: str):
    for key, bw, f32, f64 in _CARD_RATES:
        if key in name:
            return bw, f32, f64
    raise RuntimeError(f"no data-sheet rates for card {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_launches(fn, flush: torch.Tensor) -> float:
    """Median ms of TIMED_LAUNCHES single launches, L2 evicted before each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernels_phase(dev, rates):
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.ops.exact_dense import pad_rows

    bw, f32_peak, f64_peak = rates
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows = []
    cases = [(s, torch.float32) for s in KERNEL_SHAPES]
    cases.append((FP64_SHAPE, torch.float64))
    for (m, n), dtype in cases:
        M = pad_rows(torch.randn((m, n), generator=gen, dtype=dtype,
                                 device=dev))[:, :n]
        x = torch.randn((n,), generator=gen, dtype=dtype, device=dev)
        y = K.dense_matvec(M, x)
        y2 = K.dense_matvec(M, x)
        plain = K.dense_matvec_plain(M, x)
        torch.cuda.synchronize()
        eps = 6e-8 if dtype == torch.float32 else 1.2e-16
        tol = eps * max(4, n) ** 0.5 * 30
        rel = float(((y - plain).abs() / (1 + plain.abs())).max())
        abs_err = float((y - plain).abs().max())
        if not rel < tol:
            raise AssertionError(
                f"dense_matvec {m}x{n} {dtype}: rel err {rel} >= {tol}")
        if not torch.equal(y, y2):
            raise AssertionError(f"dense_matvec {m}x{n}: repeats differ")
        item = M.element_size()
        bytes_ = (m * n + n + m) * item
        flops = 2 * m * n
        peak = f32_peak if dtype == torch.float32 else f64_peak
        t_bytes = bytes_ / bw * 1e3
        t_ops = flops / peak * 1e3
        row = {
            "shape": [m, n], "dtype": str(dtype).replace("torch.", ""),
            "kernel_ms": time_launches(lambda: K.dense_matvec(M, x), flush),
            "plain_ms": time_launches(lambda: K.dense_matvec_plain(M, x),
                                      flush),
            "library_ms": time_launches(lambda: torch.mv(M, x), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_rel_err": rel, "max_abs_err": abs_err, "tol": tol,
        }
        emit("kernels", kernel="dense_matvec", **row)
        rows.append(row)
        del M, x, y, y2, plain
    del flush
    torch.cuda.empty_cache()
    return rows


def host_residuals(problem, x, y):
    """Relative primal residual, dual residual and gap of (x, y) on the
    unscaled problem, in fp64 on the host (residuals.py's definitions)."""
    K = sp.csr_matrix(problem.K)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    c, q, l, u = problem.c, problem.q, problem.l, problem.u
    mi = problem.m_ineq
    kx = K @ x
    res = kx - q
    res[:mi] = np.minimum(res[:mi], 0.0)
    grad = c - K.T @ y
    lam = grad.copy()
    lo_inf, hi_inf = np.isneginf(l), np.isposinf(u)
    lam[lo_inf & ~hi_inf] = np.minimum(grad[lo_inf & ~hi_inf], 0.0)
    lam[~lo_inf & hi_inf] = np.maximum(grad[~lo_inf & hi_inf], 0.0)
    lam[lo_inf & hi_inf] = 0.0
    l_d = np.where(lo_inf, 0.0, l)
    u_d = np.where(hi_inf, 0.0, u)
    prim = float(c @ x)
    adj = float(q @ y + l_d @ np.maximum(lam, 0) + u_d @ np.minimum(lam, 0))
    bound_viol = float(np.max(np.maximum(l - x, 0) + np.maximum(x - u, 0)))
    return {
        "rel_primal": float(np.linalg.norm(res)) / (1 + np.linalg.norm(q)),
        "rel_dual": float(np.linalg.norm(grad - lam))
        / (1 + np.linalg.norm(c)),
        "rel_gap": abs(adj - prim) / (1 + abs(prim) + abs(adj)),
        "bound_violation": bound_viol,
        "min_ineq_dual": float(y[:mi].min()) if mi else 0.0,
    }


def solve_phase(dev):
    from tpdlp_torch import SolverConfig, Status, solve
    from tpdlp_torch.bench.suite import build_suite
    from tpdlp_torch.ops import _kernels as K

    cfg = SolverConfig(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                       adaptive=True, primal_weight_update=True,
                       time_limit=600)
    problems = build_suite(("large", "xl"),
                           names=("mittelmann-s", "mittelmann-l"))
    K.reset_launches()
    runs = []
    for p in problems:
        for seed in (7919, 0, 1, 2):  # the first is the warm-up
            before = K.launches["dense_matvec"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            mem_before = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            r = solve(p, cfg, dtype=torch.float32, device=dev, seed=seed)
            wall = time.perf_counter() - t0
            launches = K.launches["dense_matvec"] - before
            T = cfg.restart_period
            if r.iterations % T:
                raise AssertionError("blocked cycles leave k % T == 0")
            expect = 2 * r.iterations + 2 * (r.iterations // T) + (
                2 * cfg.power_iters + 1) + 2
            check = host_residuals(p, r.x, r.y)
            row = {
                "instance": p.name, "shape": list(p.shape), "seed": seed,
                "warmup": seed == 7919, "status": r.status_string,
                "k": r.iterations, "n": r.restarts, "j": r.kkt_passes,
                "objective": r.objective, "solve_time_s": r.solve_time,
                "wall_s": wall, "it_per_s": r.iterations / wall,
                "launches": launches, "launches_expected": expect,
                "mem_before_gb": mem_before / 1e9,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                **check,
            }
            emit("solve", **row)
            if r.status != Status.SOLVED:
                raise AssertionError(f"{p.name} seed {seed}: {r.status}")
            if launches <= 0 or launches != expect:
                raise AssertionError(
                    f"{p.name}: {launches} kernel launches, expected "
                    f"{expect}")
            for key in ("rel_primal", "rel_dual", "rel_gap"):
                if not check[key] <= 10 * TOL:
                    raise AssertionError(f"{p.name}: {key} {check[key]}")
            if check["bound_violation"] > 10 * TOL or check[
                    "min_ineq_dual"] < 0:
                raise AssertionError(f"{p.name}: infeasible point {check}")
            runs.append(row)
    return runs, dict(K.launches)


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(dev):
    """Where the main path's time goes: one mittelmann-s solve (seed 0)
    under torch.profiler, device activity only.  Reports the device's busy
    share of the solve's wall time and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from tpdlp_torch import SolverConfig, solve
    from tpdlp_torch.bench.suite import build_suite

    (p,) = build_suite(("large",), names=("mittelmann-s",))
    cfg = SolverConfig(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                       adaptive=True, primal_weight_update=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = solve(p, cfg, dtype=torch.float32, device=dev, seed=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = _busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    matvec_us = sum(v for k, v in by_name.items() if "dense_matvec" in k)
    emit("profile", instance=p.name, seed=0, k=r.iterations,
         wall_ms=wall_us / 1e3, device_events=len(spans),
         device_busy_ms=busy / 1e3,
         device_busy_share=busy / wall_us if spans else None,
         dense_matvec_ms=matvec_us / 1e3,
         dense_matvec_share_of_busy=matvec_us / busy if busy else None,
         top_kernels_ms=[[k[:80], v / 1e3] for k, v in top])


def cross_phase(dev):
    from tpdlp_torch import SolverConfig, Status, solve
    from tpdlp_torch.bench.suite import build_suite

    (p,) = build_suite(("medium",), names=("maros-class",))
    cfg = SolverConfig(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                       adaptive=True, primal_weight_update=True)
    rg = solve(p, cfg, dtype=torch.float32, device=dev)
    rc = solve(p, cfg, dtype=torch.float64, device="cpu")
    d = abs(rg.objective - rc.objective)
    lim = 5 * TOL * (1 + abs(rc.objective))
    emit("cross", instance=p.name, gpu_status=rg.status_string,
         cpu_status=rc.status_string, gpu_objective=rg.objective,
         cpu_objective=rc.objective, gpu_k=rg.iterations,
         cpu_k=rc.iterations, abs_diff=d, limit=lim)
    if not (rg.status == rc.status == Status.SOLVED and d <= lim):
        raise AssertionError("maros-class: card and CPU disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import tpdlp_torch  # noqa: F401  (fails outside a checkout)
    from tpdlp_torch.ops import _kernels as K

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs fp32")
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    rates = card_rates(name)

    t0 = time.perf_counter()
    lib = K.build()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib))

    kernel_rows = kernels_phase(dev, rates)
    runs, launches = solve_phase(dev)
    profile_phase(dev)
    cross_phase(dev)

    head = next(r for r in kernel_rows if tuple(r["shape"]) == HEADLINE_SHAPE
                and r["dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "dense_matvec",
        "route": "cuda",
        "source": "tpdlp_torch/csrc/dense_matvec.cu",
        "replaces": "tpdlp/ops/pallas_dense.py:77",
        "launches": launches["dense_matvec"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows
                           if r["dtype"] == "float32"),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": list(HEADLINE_SHAPE),
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
