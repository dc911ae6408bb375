"""Drive the PyTorch/CUDA port (tpdlp_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device  — the card's name and power limit; TF32 matmuls must be off.
2. build   — nvcc builds the port's CUDA kernels from tpdlp_torch/csrc
             (one nvcc per source, all started together); then, as a
             yardstick, the same sources through one serial nvcc call; and
             one `nvcc -Xptxas -v` compile per source, whose registers,
             static shared memory and spills per kernel are printed.
3. kernels — each kernel against its plain PyTorch twin at its path's
             shapes (and a few edge shapes): error, bit-identical repeats,
             and the times of the kernel, the twin and the one PyTorch call
             that computes the same function, by CUDA events:
             cold — median of 25 single launches, each after a read-only
                    pass over a 256 MB buffer written once, so that L2
                    holds only clean lines and no write-back of an earlier
                    launch lands inside the timed window;
             loop — K and K' launched back to back, alternating, as a PDHG
                    iteration issues them, between two events, over the
                    launch count; the launches are queued behind a spin
                    of the card, so the loop times the card alone.
             K1 at 2000x5000 and its `torch.mv` are also timed after a
             256 MB write instead, which leaves dirty lines in L2, to show
             what their write-back costs a launch.  A `sum` over the same
             M, and over the 100k banded K's slabs, is timed cold beside
             them (`read_ms`): PyTorch's own pass that reads those bytes
             once, a yardstick for the rate the kernels stream them at.
             band_matvec runs on the 100k banded instance's K and K' slabs
             and on random slabs at windows of 128 and 2048; beside it a
             torch CSR product of the same K is timed as a yardstick.
4. solve   — the dense path: mittelmann-s and mittelmann-l at full size in
             fp32, tol 1e-4, Ruiz + adaptive steps + primal-weight update
             (the settings of the JAX package's bench runner); one warm-up
             solve, then seeds 0-2.  Checks Solved, the kernel launch count
             against the count the code implies, and recomputes the
             residuals of the returned (x, y) on the host in fp64.
5. band    — the band path: the 100k x 100k banded instance of
             tpdlp_torch/bench/band_scale.py at full size (its dense K
             would take 40 GB), matrix_format="band", the same settings,
             seed 0.  The same checks, and its peak device memory.
6. certify — the per-iteration loop (certificates, loop_mode="periter",
             Halpern) at full size: mittelmann-s blocked, with the ray and
             normalized certificates, and per-iteration without them (the
             last two must give the blocked k, n and x bit for bit, and the
             certificates j = j_blocked + k - 1); mittelmann-s under Halpern,
             blocked and with the ray certificates (the reported feasible
             point's fp64 residuals and bounds); the banded 100k instance
             with the ray certificates over K2 (the band phase's k, n and
             objective bits); and the infeasibility battery of
             tpdlp_torch/bench/infeasibility.py at its full sizes, each
             row's status held to the scipy linprog oracle's, which worker
             processes compute meanwhile (a row linprog cannot decide in
             ORACLE_SECONDS per method is held to the verdict its
             construction plants, and its line says so).
7. profile — one mittelmann-s solve blocked and one per-iteration with
             certificates, and the band instance over two bounded KKT
             budgets, under torch.profiler (device activity only): the
             device's busy share of the wall time, the device time by
             kernel, and device activities and wall per iteration; for the
             band path also the difference of the two solves, i.e. the
             steady loop, whose band_matvec launches (the wrapper's
             counter) must equal the count the code implies; the trace's
             band_matvec events are printed beside.
8. cross   — maros-class on the card in fp32 and on the CPU in fp64; a
             banded instance small enough to hold dense, on the card as
             band and as dense in fp32 and on the CPU as band in fp64.

Every solve's kernel launches are held to the count the code implies: two
per issued iteration and per issued restart check, plus the power
iteration's and init_state's.  Issued iterations are k, plus, when a
certificate fires mid-cycle, the masked rest of that cycle; both are
printed.

Then the kernel summary line, the card's `nvidia-smi` name and power limit,
and last {"ok": true, "device": {...}}.  Needs one CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import json
import multiprocessing
import re
import statistics
import subprocess
import sys
import tempfile
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
#: K/K' pairs per loop timing (2 launches each).
LOOP_PAIRS = 50
#: Cycles the card spins before a loop timing (about 10 ms at 2 GHz, above
#: the host's time to queue the loop's launches).
LOOP_SPIN_CYCLES = 20_000_000
#: Dense (K, K') shape pairs timed as a loop.
LOOP_SHAPES = [((2000, 5000), (5000, 2000)), ((8000, 20000), (20000, 8000))]
#: The band path's instance (tpdlp_torch/bench/band_scale.py's defaults):
#: n, m_ineq, m_eq, bandwidth.
BAND_100K = (100_000, 75_000, 25_000, 105)
#: Random band slabs (m, n, WB) beside the instance's: the narrowest and the
#: widest window the layout allows, m and n not multiples of 128.
BAND_RANDOM = [(5001, 777, 128), (30001, 40003, 2048)]
#: KKT budgets of the band path's two profiled solves; their difference is
#: the steady loop, without the operator build and the preprocessing.
BAND_PROFILE_KKT = (2000, 4000)
#: The band cross check's instance (small enough to hold dense).
BAND_CROSS = (8192, 4096, 2048, 65)
#: The infeasibility battery's rows: (dtype, KKT budget, must certify).  The
#: JAX package certifies the first seven in the stated precision; the two
#: largest planted-infeasible rows it does not certify in fp32 within its
#: budget, so there only Solved or the wrong certificate fails, and their
#: budget is cut to keep the script's time.
BATTERY = {
    "infeas01": ("float32", MAX_KKT, True),
    "unbnd01": ("float32", MAX_KKT, True),
    "synth_unbounded_n30_s0": ("float32", MAX_KKT, True),
    "synth_unbounded_n757_s1": ("float32", MAX_KKT, True),
    "synth_unbounded_n5000_s7": ("float32", MAX_KKT, True),
    "synth_infeasible_n40_m11_s0": ("float64", MAX_KKT, True),
    "synth_infeasible_n757_m281_s1": ("float64", MAX_KKT, True),
    "synth_infeasible_n5000_m1501_s7": ("float32", 15_000, False),
    "synth_infeasible_n10000_m3001_s7": ("float32", 15_000, False),
}
#: The certificate families on (the battery's and the certify phase's).
CERTIFICATES = dict(infeasibility_detect=True, normalized_certificates=True)
#: Seconds each linprog method may take on one battery row; the oracles run
#: in worker processes beside the card's solves.
ORACLE_SECONDS = 150.0
ORACLE_WORKERS = 3

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


def serial_build_seconds(K) -> float:
    """Seconds of the same build as one serial nvcc call over every source
    (a yardstick for the library's build, which runs one nvcc per source
    side by side)."""
    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        subprocess.run(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", f"{tmp}/serial.so",
             *[str(K.CSRC / s) for s in K.SOURCES]],
            capture_output=True, check=True, timeout=600)
        return time.perf_counter() - t0


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_KERNEL_NAME = re.compile(r"\d([a-z_]+_kernel)I([fd])E")


def ptxas_report(K) -> list:
    """Registers, static shared memory and spills of every kernel, from one
    `nvcc -Xptxas -v` compile per source (side by side).  The ring of
    shared-memory stages is dynamic and not counted here."""
    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as tmp:
        cmds = [[K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 f"{tmp}/{s}.o", str(K.CSRC / s)] for s in K.SOURCES]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    if any(proc.returncode for proc in procs):
        raise RuntimeError("nvcc -Xptxas -v failed:\n" + "\n".join(logs))
    out, cur = [], None
    for line in "\n".join(logs).splitlines():
        if m := _PTXAS_ENTRY.search(line):
            k = _KERNEL_NAME.search(m.group(1))
            name = m.group(1) if k is None else (
                f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}>")
            cur = {"kernel": name}
            out.append(cur)
        elif cur is not None and (m := _PTXAS_SPILL.search(line)):
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        elif cur is not None and (m := _PTXAS_USED.search(line)):
            cur["registers"] = int(m.group(1))
            smem = _PTXAS_SMEM.search(line)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    if not out:
        raise RuntimeError("nvcc -Xptxas -v reported no kernel")
    return out


def evict_l2(flush: torch.Tensor) -> None:
    """Read the whole flush buffer (written once, 5x L2): L2 then holds
    only its clean lines."""
    flush.view(torch.int64).sum()


def time_launches(fn, flush: torch.Tensor, dirty: bool = False) -> float:
    """Median ms of TIMED_LAUNCHES single launches, L2 evicted before each
    by a read-only pass (`dirty`: by a 256 MB write instead, which leaves
    up to an L2 of dirty lines to be written back inside the timed
    window)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_LAUNCHES):
        if dirty:
            flush.zero_()
        else:
            evict_l2(flush)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_loop(fn_k, fn_kt) -> float:
    """ms per launch of LOOP_PAIRS back-to-back (K, K') launch pairs between
    two events, as a PDHG iteration issues them.  The card first spins for
    LOOP_SPIN_CYCLES, so that the host has queued every launch before the
    first event: the loop times the card, not the wrappers' host cost."""
    fn_k()
    fn_kt()
    torch.cuda.synchronize()
    torch.cuda._sleep(LOOP_SPIN_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(LOOP_PAIRS):
        fn_k()
        fn_kt()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (2 * LOOP_PAIRS)


def kernels_phase(dev, rates):
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.ops.exact_dense import pad_rows

    bw, f32_peak, f64_peak = rates
    flush = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows, kept = [], {}
    cases = [(s, torch.float32) for s in KERNEL_SHAPES]
    cases.append((FP64_SHAPE, torch.float64))
    looped = {s for pair in LOOP_SHAPES for s in pair}
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
        if (m, n) == HEADLINE_SHAPE and dtype == torch.float32:
            row["kernel_ms_dirty_flush"] = time_launches(
                lambda: K.dense_matvec(M, x), flush, dirty=True)
            row["library_ms_dirty_flush"] = time_launches(
                lambda: torch.mv(M, x), flush, dirty=True)
            row["read_ms"] = time_launches(lambda: M.sum(), flush)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit("kernels", kernel="dense_matvec", **row)
        rows.append(row)
        if (m, n) in looped and dtype == torch.float32:
            kept[(m, n)] = (M, x, row)
        del M, x, y, y2, plain
    for sk, skt in LOOP_SHAPES:
        (M, x, row), (Mt, xt, row_t) = kept[sk], kept[skt]
        loop = {
            "kernel_loop_ms": time_loop(lambda: K.dense_matvec(M, x),
                                        lambda: K.dense_matvec(Mt, xt)),
            "library_loop_ms": time_loop(lambda: torch.mv(M, x),
                                         lambda: torch.mv(Mt, xt)),
        }
        emit("kernels_loop", kernel="dense_matvec", shapes=[sk, skt],
             bound_ms=(row["bound_ms"] + row_t["bound_ms"]) / 2, **loop)
        row.update(loop)
        row_t.update(loop)
    del kept, flush
    torch.cuda.empty_cache()
    return rows


def _band_bound(m, n, ngroups, R, WB, item, rates, dtype):
    """(bound_ms, bound_by) of one band product: the live slab rows, x,
    the live starts and y moved once, against 2 flops per live slab
    element."""
    bw, f32_peak, f64_peak = rates
    rows = min(m, ngroups * R)
    bytes_ = (rows * WB + n + m) * item + 4 * -(-rows // R)
    t_bytes = bytes_ / bw * 1e3
    peak = f32_peak if dtype == torch.float32 else f64_peak
    t_ops = 2 * rows * WB / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _random_band(m, n, WB, dtype, gen, dev):
    ngroups = -(-(-(-m // 128)) // 8) * 8
    n_pad = -(-n // 128) * 128
    starts = torch.randint(0, (n_pad - WB) // 128 + 1, (ngroups,),
                           generator=gen, device=dev) * 128
    slabs = torch.randn((ngroups, 128, WB), generator=gen, dtype=dtype,
                        device=dev)
    return slabs, starts.to(torch.int32)


def _torch_csr(K, dtype, dev):
    K = sp.csr_matrix(K)
    return torch.sparse_csr_tensor(
        torch.as_tensor(K.indptr.astype(np.int64), device=dev),
        torch.as_tensor(K.indices.astype(np.int64), device=dev),
        torch.as_tensor(K.data, dtype=dtype, device=dev),
        size=K.shape)


def band_kernels_phase(dev, rates, p_band):
    """band_matvec against its twin: on the 100k instance's K and K' slabs
    (fp32 and fp64) and on random slabs at windows of 128 and 2048."""
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.ops.band import BandOp, band_windows

    flush = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    op32 = BandOp.from_scipy(p_band.K, torch.float32, device=dev)
    cases = []
    for dtype in (torch.float32, torch.float64):
        op = op32 if dtype == torch.float32 else op32.astype(dtype)
        cases.append(("100k K", op.fwd.slabs, op.fwd.starts, op.fwd.m,
                      op.fwd.n, p_band.K, dtype))
        cases.append(("100k K'", op.bwd.slabs, op.bwd.starts, op.bwd.m,
                      op.bwd.n, p_band.K.T, dtype))
        for m, n, WB in BAND_RANDOM:
            slabs, starts = _random_band(m, n, WB, dtype, gen, dev)
            cases.append((f"random WB={WB}", slabs, starts, m, n, None,
                          dtype))
    del op
    rows, kept = [], {}
    for label, slabs, starts, m, n, Kh, dtype in cases:
        x = torch.randn((n,), generator=gen, dtype=dtype, device=dev)
        y = K.band_matvec(slabs, starts, x, m, n)
        y2 = K.band_matvec(slabs, starts, x, m, n)
        plain = K.band_matvec_plain(slabs, starts, x, m, n)
        torch.cuda.synchronize()
        ngroups, R, WB = slabs.shape
        eps = 6e-8 if dtype == torch.float32 else 1.2e-16
        tol = eps * WB ** 0.5 * 30
        rel = float(((y - plain).abs() / (1 + plain.abs())).max())
        abs_err = float((y - plain).abs().max())
        if not rel < tol:
            raise AssertionError(
                f"band_matvec {label} {dtype}: rel err {rel} >= {tol}")
        if not torch.equal(y, y2):
            raise AssertionError(f"band_matvec {label}: repeats differ")
        bound, bound_by = _band_bound(m, n, ngroups, R, WB,
                                      slabs.element_size(), rates, dtype)
        win = band_windows(starts, x, n, WB)[..., None]
        row = {
            "case": label, "slabs": [ngroups, R, WB], "m": m, "n": n,
            "dtype": str(dtype).replace("torch.", ""),
            "kernel_ms": time_launches(
                lambda: K.band_matvec(slabs, starts, x, m, n), flush),
            "plain_ms": time_launches(
                lambda: K.band_matvec_plain(slabs, starts, x, m, n), flush),
            "library_ms": time_launches(lambda: torch.bmm(slabs, win),
                                        flush),
            "csr_ms": None,
            "bound_ms": bound, "bound_by": bound_by,
            "max_rel_err": rel, "max_abs_err": abs_err, "tol": tol,
        }
        row["bound_share"] = bound / row["kernel_ms"]
        if label == "100k K" and dtype == torch.float32:
            row["read_ms"] = time_launches(lambda: slabs.sum(), flush)
        csr = None
        if Kh is not None:
            csr = _torch_csr(Kh, dtype, dev)
            row["csr_ms"] = time_launches(lambda: csr @ x, flush)
            row["nnz"] = int(csr.values().numel())
            kept[(label, dtype)] = (slabs, starts, x, m, n, win, csr, row)
        emit("kernels", kernel="band_matvec", **row)
        rows.append(row)
        del x, y, y2, plain, win, csr
    for dtype in (torch.float32, torch.float64):
        a, b = kept.pop(("100k K", dtype)), kept.pop(("100k K'", dtype))
        loop = {
            "kernel_loop_ms": time_loop(
                lambda: K.band_matvec(*a[:5]), lambda: K.band_matvec(*b[:5])),
            "library_loop_ms": time_loop(lambda: torch.bmm(a[0], a[5]),
                                         lambda: torch.bmm(b[0], b[5])),
            "csr_loop_ms": time_loop(lambda: a[6] @ a[2],
                                     lambda: b[6] @ b[2]),
        }
        emit("kernels_loop", kernel="band_matvec", case="100k K, K'",
             dtype=str(dtype).replace("torch.", ""),
             bound_ms=(a[7]["bound_ms"] + b[7]["bound_ms"]) / 2, **loop)
        a[7].update(loop)
        b[7].update(loop)
        del a, b
    del cases, flush, op32
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


def expected_launches(cfg, r, issued) -> int:
    """K products the code implies for one solve: two per issued iteration
    (K x+ and K'y+) and per issued restart check (the average's), the
    power iteration's 2 * power_iters + 1 and init_state's 2.  Issued
    iterations are k, plus, after a certificate fired mid-cycle, the masked
    rest of that cycle; any other difference fails."""
    from tpdlp_torch import Status

    tail = issued["iterations"] - r.iterations
    certified = r.status in (Status.DUAL_INFEASIBLE,
                             Status.PRIMAL_INFEASIBLE)
    if not 0 <= tail < (cfg.restart_period if certified else 1):
        raise AssertionError(
            f"{issued['iterations']} iterations issued for k = "
            f"{r.iterations} ({r.status_string})")
    return (2 * issued["iterations"] + 2 * issued["restart_checks"]
            + 2 * cfg.power_iters + 1 + 2)


def solve_phase(dev):
    from tpdlp_torch import SolverConfig, solve
    from tpdlp_torch.bench.suite import build_suite
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.solver import loop as L

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
            L.reset_launched()
            t0 = time.perf_counter()
            r = solve(p, cfg, dtype=torch.float32, device=dev, seed=seed)
            wall = time.perf_counter() - t0
            launches = K.launches["dense_matvec"] - before
            issued = dict(L.launched)
            if r.iterations % cfg.restart_period:
                raise AssertionError("blocked cycles leave k % T == 0")
            expect = expected_launches(cfg, r, issued)
            check = host_residuals(p, r.x, r.y)
            row = {
                "instance": p.name, "shape": list(p.shape), "seed": seed,
                "warmup": seed == 7919, "status": r.status_string,
                "k": r.iterations, "n": r.restarts, "j": r.kkt_passes,
                "objective": r.objective, "solve_time_s": r.solve_time,
                "wall_s": wall, "it_per_s": r.iterations / wall,
                "launches": launches, "launches_expected": expect,
                "iterations_issued": issued["iterations"],
                "restart_checks_issued": issued["restart_checks"],
                "mem_before_gb": mem_before / 1e9,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                **check,
            }
            emit("solve", **row)
            _check_solution(f"{p.name} seed {seed}", r, check)
            if launches <= 0 or launches != expect:
                raise AssertionError(
                    f"{p.name}: {launches} kernel launches, expected "
                    f"{expect}")
            runs.append(row)
    if K.launches["band_matvec"]:
        raise AssertionError("the dense path launched band_matvec")
    return runs, K.launches["dense_matvec"]


def _check_solution(name, r, check):
    from tpdlp_torch import Status

    if r.status != Status.SOLVED:
        raise AssertionError(f"{name}: {r.status}")
    for key in ("rel_primal", "rel_dual", "rel_gap"):
        if not check[key] <= 10 * TOL:
            raise AssertionError(f"{name}: {key} {check[key]}")
    if check["bound_violation"] > 10 * TOL or check["min_ineq_dual"] < 0:
        raise AssertionError(f"{name}: infeasible point {check}")


def band_phase(dev, p):
    """The band path at full size: one solve of the 100k banded instance,
    kernel launches counted from 0 just before it."""
    from tpdlp_torch import SolverConfig, solve
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.ops.band import band_stored_elems
    from tpdlp_torch.solver import loop as L

    cfg = SolverConfig(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                       adaptive=True, primal_weight_update=True,
                       time_limit=600)
    stored = band_stored_elems(p.K) * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    K.reset_launches()
    L.reset_launched()
    t0 = time.perf_counter()
    r = solve(p, cfg, dtype=torch.float32, device=dev, seed=0,
              matrix_format="band")
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    issued = dict(L.launched)
    peak = torch.cuda.max_memory_allocated(dev)
    if r.iterations % cfg.restart_period:
        raise AssertionError("blocked cycles leave k % T == 0")
    expect = expected_launches(cfg, r, issued)
    check = host_residuals(p, r.x, r.y)
    row = {
        "instance": p.name, "shape": list(p.shape), "nnz": int(p.K.nnz),
        "band_stored_mb": stored / 1e6, "seed": 0,
        "status": r.status_string, "k": r.iterations, "n": r.restarts,
        "j": r.kkt_passes, "objective": r.objective,
        "solve_time_s": r.solve_time, "wall_s": wall,
        "it_per_s": r.iterations / wall,
        "launches": launches["band_matvec"], "launches_expected": expect,
        "iterations_issued": issued["iterations"],
        "restart_checks_issued": issued["restart_checks"],
        "dense_launches": launches["dense_matvec"],
        "mem_before_gb": mem_before / 1e9, "peak_mem_gb": peak / 1e9,
        **check,
    }
    emit("band", **row)
    _check_solution(p.name, r, check)
    if launches["band_matvec"] <= 0 or launches["band_matvec"] != expect:
        raise AssertionError(
            f"{p.name}: {launches['band_matvec']} band_matvec launches, "
            f"expected {expect}")
    if launches["dense_matvec"]:
        raise AssertionError("the band path launched dense_matvec")
    # K and K' slabs twice (the caller's and Ruiz's scaled copy), plus
    # vectors and the build's triplets: far below one dense K (40 GB).
    if peak - mem_before > 3 * stored:
        raise AssertionError(
            f"{p.name}: peak {peak / 1e9} GB above 3 copies of the slabs")
    return row, launches["band_matvec"]


def _counted_solve(dev, p, cfg, dtype=torch.float32, **solve_kw):
    """One solve (seed 0), the kernel launch counts and the loop's issued
    iterations and restart checks set to 0 just before it and read just
    after.  Returns (result, wall seconds, launches, issued)."""
    from tpdlp_torch import solve
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.solver import loop as L

    torch.cuda.synchronize()
    K.reset_launches()
    L.reset_launched()
    t0 = time.perf_counter()
    r = solve(p, cfg, dtype=dtype, device=dev, seed=0, **solve_kw)
    wall = time.perf_counter() - t0
    return r, wall, dict(K.launches), dict(L.launched)


def _certify_row(name, way, kernel, cfg, r, wall, launches, issued):
    """The JSON row of one counted solve; fails unless `kernel`'s launches
    equal the count the code implies and the other kernel never ran."""
    expect = expected_launches(cfg, r, issued)
    other = next(k for k in launches if k != kernel)
    row = {
        "instance": name, "way": way, "status": r.status_string,
        "k": r.iterations, "n": r.restarts, "j": r.kkt_passes,
        "objective": r.objective, "wall_s": wall,
        "it_per_s": r.iterations / wall, "kernel": kernel,
        "launches": launches[kernel], "launches_expected": expect,
        "iterations_issued": issued["iterations"],
        "restart_checks_issued": issued["restart_checks"],
    }
    if launches[kernel] <= 0 or launches[kernel] != expect:
        raise AssertionError(f"{name} {way}: {launches[kernel]} {kernel} "
                             f"launches, expected {expect}")
    if launches[other]:
        raise AssertionError(f"{name} {way}: {other} launched")
    return row


def _same_run(name, r, ref, what):
    """k, n, objective and x of `r` bit-identical to `ref`'s."""
    if not ((r.iterations, r.restarts, r.objective)
            == (ref.iterations, ref.restarts, ref.objective)
            and np.array_equal(r.x, ref.x)):
        raise AssertionError(f"{name}: {what} differs from the blocked run "
                             f"(k {r.iterations} vs {ref.iterations})")


def timed_oracle(problem):
    """(linprog status, seconds) of one battery row, in a worker process."""
    from tpdlp_torch.bench.infeasibility import oracle_status

    t0 = time.perf_counter()
    return oracle_status(problem, ORACLE_SECONDS), time.perf_counter() - t0


def certify_phase(dev, p_band, band_blocked):
    """The per-iteration loop at full size: mittelmann-s three ways and
    under Halpern, the banded 100k instance with certificates, and the
    infeasibility battery, whose linprog oracles run in worker processes
    meanwhile.  Returns the K1 and K2 launches of the certificate-on
    mittelmann-s and banded solves."""
    from concurrent.futures import ProcessPoolExecutor

    from tpdlp_torch.bench import infeasibility as B

    battery = B.build_battery()
    pool = ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        oracles = {name: pool.submit(timed_oracle, prob)
                   for name, prob, _ in battery}
        return _certify(dev, p_band, band_blocked, battery, oracles)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _certify(dev, p_band, band_blocked, battery, oracles):
    from tpdlp_torch import SolverConfig, Status
    from tpdlp_torch.bench import infeasibility as B
    from tpdlp_torch.bench.suite import build_suite

    (p,) = build_suite(("large",), names=("mittelmann-s",))
    base = dict(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                primal_weight_update=True, time_limit=600)
    ways = {
        "blocked": dict(adaptive=True),
        "certificates": dict(adaptive=True, **CERTIFICATES),
        "periter": dict(adaptive=True, loop_mode="periter"),
        "halpern": dict(adaptive=False, step_scheme="halpern"),
        "halpern_certificates": dict(adaptive=False, step_scheme="halpern",
                                     infeasibility_detect=True),
    }
    runs, launches = {}, {}
    for way, extra in ways.items():
        cfg = SolverConfig(**base, **extra)
        r, wall, kl, issued = _counted_solve(dev, p, cfg)
        check = host_residuals(p, r.x, r.y)
        emit("certify", **_certify_row(p.name, way, "dense_matvec", cfg, r,
                                       wall, kl, issued), **check)
        _check_solution(f"{p.name} {way}", r, check)
        # The reported point is the feasible PDHG output, clamped to the
        # box in the scaled frame: only fp32 rounding of the unscaling.
        if extra.get("step_scheme") and check["bound_violation"] > 1e-5:
            raise AssertionError(f"{p.name} {way}: bounds {check}")
        runs[way] = r
        launches[way] = kl["dense_matvec"]
    for way, ref in (("certificates", "blocked"), ("periter", "blocked"),
                     ("halpern_certificates", "halpern")):
        _same_run(p.name, runs[way], runs[ref], way)
    ledger = {
        "certificates": runs["blocked"].kkt_passes
        + runs["blocked"].iterations - 1,
        "periter": runs["blocked"].kkt_passes,
        "halpern_certificates": runs["halpern"].kkt_passes
        + runs["halpern"].iterations - 1,
    }
    emit("certify_ledger", instance=p.name,
         j={way: runs[way].kkt_passes for way in ledger}, expected=ledger)
    if any(runs[way].kkt_passes != j for way, j in ledger.items()):
        raise AssertionError(f"{p.name}: KKT ledger {ledger}")

    # The band path at full width, with the ray certificates.
    cfg = SolverConfig(**base, adaptive=True, infeasibility_detect=True)
    r, wall, kl, issued = _counted_solve(dev, p_band, cfg,
                                         matrix_format="band")
    check = host_residuals(p_band, r.x, r.y)
    emit("certify", **_certify_row(p_band.name, "certificates",
                                   "band_matvec", cfg, r, wall, kl, issued),
         j_blocked=band_blocked["j"], **check)
    _check_solution(f"{p_band.name} certificates", r, check)
    if not ((r.iterations, r.restarts, r.objective)
            == (band_blocked["k"], band_blocked["n"],
                band_blocked["objective"])
            and r.kkt_passes == band_blocked["j"] + r.iterations - 1):
        raise AssertionError(f"{p_band.name}: certificates changed the run")
    launches["band_certificates"] = kl["band_matvec"]

    # The battery, each row's verdict held to the scipy linprog oracle's.
    # A row linprog leaves undecided within ORACLE_SECONDS per method is
    # held to the verdict its construction plants, and says so.
    for name, prob, planted in battery:
        dtype, max_kkt, certifies = BATTERY[name]
        cfg = B.battery_config(max_kkt=max_kkt)
        r, wall, kl, issued = _counted_solve(dev, prob, cfg,
                                             getattr(torch, dtype))
        oracle, oracle_s = oracles[name].result()
        decided = oracle in (0, 2, 3)
        want = B.EXPECT[planted]
        emit("certify_battery", **_certify_row(
            name, dtype, "dense_matvec", cfg, r, wall, kl, issued),
             shape=list(prob.shape), max_kkt=max_kkt, oracle=oracle,
             oracle_decided=decided, oracle_s=oracle_s,
             expected=want.describe(), must_certify=certifies)
        if decided and oracle != planted:
            raise AssertionError(f"{name}: linprog says {oracle}")
        wrong = r.status == Status.SOLVED or (
            r.status in B.EXPECT.values() and r.status != want)
        if wrong or (certifies and r.status != want):
            raise AssertionError(f"{name} {dtype}: {r.status_string}, "
                                 f"expected {want.describe()}")
    return launches["certificates"], launches["band_certificates"]


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _profile_solve(dev, p, kernel, max_kkt, extra=None, **solve_kw):
    """One solve (seed 0) under torch.profiler, device activity only: the
    device's busy share of the solve's wall time and the device time by
    kernel, `kernel`'s share of the busy time among them.  `extra`: more
    SolverConfig fields."""
    from torch.profiler import ProfilerActivity, profile

    from tpdlp_torch import SolverConfig, solve
    from tpdlp_torch.ops import _kernels as K

    cfg = SolverConfig(tol=TOL, max_kkt=max_kkt, scaling="ruiz",
                       adaptive=True, primal_weight_update=True,
                       **(extra or {}))
    torch.cuda.synchronize()
    before = K.launches[kernel]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = solve(p, cfg, dtype=torch.float32, device=dev, seed=0,
                  **solve_kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    counted = K.launches[kernel] - before
    spans, by_name, kernel_events = [], {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        kernel_events += kernel in e.name
    busy = _busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    kernel_us = sum(v for k, v in by_name.items() if kernel in k)
    emit("profile", instance=p.name, seed=0, status=r.status_string,
         extra=extra or {}, k=r.iterations, j=r.kkt_passes, max_kkt=max_kkt,
         wall_ms=wall_us / 1e3, device_events=len(spans),
         device_busy_ms=busy / 1e3,
         device_busy_share=busy / wall_us if spans else None,
         kernel=kernel, kernel_launches=counted, kernel_events=kernel_events,
         trace_complete=kernel_events == counted,
         kernel_ms=kernel_us / 1e3,
         kernel_us_per_launch=kernel_us / kernel_events if kernel_events
         else None,
         kernel_share_of_busy=kernel_us / busy if busy else None,
         top_kernels_ms=[[k[:80], v / 1e3] for k, v in top])
    if not kernel_events:
        raise AssertionError(f"profile: no {kernel} event in the trace")
    return {"k": r.iterations, "wall_us": wall_us, "busy_us": busy,
            "events": len(spans), "kernel_us": kernel_us,
            "kernel_events": kernel_events, "launches": counted,
            "restart_period": cfg.restart_period}


def profile_phase(dev, p_band):
    """Where the time goes: one mittelmann-s solve blocked and one
    per-iteration with the certificates, and the band path over a bounded
    KKT budget."""
    from tpdlp_torch.bench.suite import build_suite

    (p,) = build_suite(("large",), names=("mittelmann-s",))
    loops = {"blocked": _profile_solve(dev, p, "dense_matvec", MAX_KKT),
             "certificates": _profile_solve(dev, p, "dense_matvec", MAX_KKT,
                                            CERTIFICATES)}
    emit("profile_periter", instance=p.name, **{
        way: {"k": v["k"], "device_events": v["events"],
              "device_events_per_iteration": v["events"] / v["k"],
              "wall_ms_per_iteration": v["wall_us"] / v["k"] / 1e3,
              "device_busy_ms_per_iteration": v["busy_us"] / v["k"] / 1e3}
        for way, v in loops.items()})
    a, b = (_profile_solve(dev, p_band, "band_matvec", kkt,
                           matrix_format="band")
            for kkt in BAND_PROFILE_KKT)
    dk = b["k"] - a["k"]
    wall, busy = b["wall_us"] - a["wall_us"], b["busy_us"] - a["busy_us"]
    # K2 launches in the steady loop by the wrapper's counter, held to the
    # count the code implies (2 per iteration + 2 per restart check).  The
    # trace's own event count is printed beside it: CUPTI may drop or
    # carry over records between profiler sessions, so the time per launch
    # divides traced time by traced events, which stay paired.
    launches = b["launches"] - a["launches"]
    events = b["kernel_events"] - a["kernel_events"]
    kern = b["kernel_us"] - a["kernel_us"]
    expect = 2 * dk + 2 * (dk // a["restart_period"])
    emit("profile_loop", instance=p_band.name, k=dk, wall_ms=wall / 1e3,
         ms_per_iteration=wall / dk / 1e3 if dk else None,
         device_busy_ms=busy / 1e3,
         device_busy_share=busy / wall if wall > 0 else None,
         kernel="band_matvec", kernel_launches=launches,
         kernel_launches_expected=expect, kernel_events=events,
         kernel_us_per_launch=kern / events if events else None,
         kernel_share_of_busy=kern / busy if busy > 0 else None)
    if launches != expect:
        raise AssertionError(
            f"profile: {launches} band_matvec launches in the steady loop, "
            f"expected {expect}")


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


def band_cross_phase(dev):
    """A banded instance small enough to hold dense: band and dense on the
    card in fp32, band on the CPU in fp64.  Same status, objectives within
    5*tol."""
    from tpdlp_torch import SolverConfig, Status, generate_banded_lp, solve

    n, mi, me, bw = BAND_CROSS
    p = generate_banded_lp(n=n, m_ineq=mi, m_eq=me, bandwidth=bw, seed=2)
    cfg = SolverConfig(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                       adaptive=True, primal_weight_update=True)
    rb = solve(p, cfg, dtype=torch.float32, device=dev,
               matrix_format="band")
    rd = solve(p, cfg, dtype=torch.float32, device=dev,
               matrix_format="dense")
    rc = solve(p, cfg, dtype=torch.float64, device="cpu",
               matrix_format="band")
    lim = 5 * TOL * (1 + abs(rc.objective))
    diffs = {"band_vs_cpu": abs(rb.objective - rc.objective),
             "dense_vs_cpu": abs(rd.objective - rc.objective),
             "band_vs_dense": abs(rb.objective - rd.objective)}
    emit("band_cross", instance=p.name, shape=list(p.shape),
         statuses=[rb.status_string, rd.status_string, rc.status_string],
         objectives=[rb.objective, rd.objective, rc.objective],
         k=[rb.iterations, rd.iterations, rc.iterations], limit=lim,
         **diffs)
    if not (rb.status == rd.status == rc.status == Status.SOLVED
            and max(diffs.values()) <= lim):
        raise AssertionError(f"{p.name}: band, dense and CPU disagree")


def _kernel_entry(name, source, replaces, launches, rows, head):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "loop_ms": head["kernel_loop_ms"],
        "library_loop_ms": head["library_loop_ms"],
    }


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

    t_start = t0 = time.perf_counter()
    lib = K.build()
    seconds = time.perf_counter() - t0
    emit("build", seconds=seconds, library=str(lib),
         serial_seconds=serial_build_seconds(K), ptxas=ptxas_report(K))

    from tpdlp_torch import generate_banded_lp

    n, mi, me, bw = BAND_100K
    t0 = time.perf_counter()
    p_band = generate_banded_lp(n=n, m_ineq=mi, m_eq=me, bandwidth=bw,
                                seed=0)
    emit("band_instance", instance=p_band.name, nnz=int(p_band.K.nnz),
         seconds=time.perf_counter() - t0)

    dense_rows = kernels_phase(dev, rates)
    band_rows = band_kernels_phase(dev, rates, p_band)
    _, dense_launches = solve_phase(dev)
    band_row, band_launches = band_phase(dev, p_band)
    dense_certify, band_certify = certify_phase(dev, p_band, band_row)
    profile_phase(dev, p_band)
    cross_phase(dev)
    band_cross_phase(dev)

    dense_head = next(r for r in dense_rows
                      if tuple(r["shape"]) == HEADLINE_SHAPE
                      and r["dtype"] == "float32")
    band_head = next(r for r in band_rows if r["case"] == "100k K"
                     and r["dtype"] == "float32")
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        {**_kernel_entry("dense_matvec", "tpdlp_torch/csrc/dense_matvec.cu",
                         "tpdlp/ops/pallas_dense.py:77", dense_launches,
                         dense_rows, dense_head),
         "launches_certificates": dense_certify,
         "shape": list(HEADLINE_SHAPE)},
        {**_kernel_entry("band_matvec", "tpdlp_torch/csrc/band_matvec.cu",
                         "tpdlp/ops/band.py:160", band_launches, band_rows,
                         band_head),
         "launches_certificates": band_certify,
         "csr_ms": band_head["csr_ms"], "shape": band_head["slabs"]},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
