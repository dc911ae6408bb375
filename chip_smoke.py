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
             csr_matvec runs on the CSR K and K' of mittelmann-l (fp32,
             fp64) and of the sparse-1M instance (fp32), beside cuSPARSE's
             product of the same tensors (torch.mv), whose two repeats are
             also compared bit for bit.
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
9. sparse  — the sparse and auto layouts at full size, the main path's
             settings: mittelmann-l through "sparse" (the dense phase's
             objective within 5*tol) and through the autotune (each
             candidate's seconds per K/K' pair and the label printed), both
             layouts profiled per iteration; the sparse-1M instance (about
             10M nonzeros, 1.6 TB as a dense fp32 K) through "auto", which
             must build and time nothing but CSR, and through "sparse":
             Solved, x and y bit-identical, peak device memory; the banded
             100k instance through the autotune (where it picks band, the
             band phase's k, n, j and objective); an LP with empty rows and
             columns through "sparse".
10. checkpoint — mittelmann-s stopped by a KKT budget with a checkpoint,
             then resumed: the uninterrupted solve's k, n, j, objective and
             x bits.
11. autotune_stable — the banded 100k instance through the autotune three
             times: each candidate's ms a K/K' pair, timed on the card
             (captured chains, CUDA events), the same choice every call,
             the autotune's launches its formula; the solve through "auto"
             bit for bit the chosen layout's own run.
12. cli    — `python -m tpdlp_torch.cli.main` over the port's vendored
             corpus with the reference-parity flags and the certificates,
             through the autotune (--support_sparse) and then dense: exit
             0, and every row's status the scipy linprog verdict.
13. presolve — the same sweep (dense) with --presolve python, then cpp
             (the C++ core's g++ build timed first): linprog's verdict on
             every row, Solved objectives within 10*tol of the sweep
             without presolve, both engines' reductions per file equal.
14. refine — mittelmann-s at tol 1e-8 with dtype=None, so the solve
             escalates to iterative refinement (fp32 solves on the card,
             fp64 outer loop on the host), the refine_1e8 protocol with
             |gap| termination and max_kkt 500,000: Solved, the criteria
             held by an fp64 host recomputation, the objective within 1e-8
             relative of HiGHS (run in a worker process meanwhile), and its
             coarse stage replayed with the same k, n, j, x and y bits (the
             whole run, replayed in full until PR 6, is cut to that for the
             time limit); rounds, the wall and its split between the inner
             device solves and the host.
15. refine_band — the same on banded 8192 with matrix_format="band"
             (max_kkt 200,000), refined from the JAX package's fp32 stage
             result (tests/data/jax_coarse_banded_8192.npz): every
             correction through K2 (an elastic retry through CSR, as in
             the JAX package), no K1 launch; its replay is the first
             correction solve twice at 10,000 KKT passes, bit for bit (the
             whole run until PR 6).
16. fp64_tail — mittelmann-s at 1e-8 with escalation_mode="fp64_tail"
             (max_kkt 200,000): the fp32 and the fp64 stage apart (k, j,
             wall, launches), the status the JAX package's CPU run gives
             (Solved), held to the criteria on the host.
17. fleet  — tpdlp_torch.solve_batch at its users' sizes, bench/fleet.py's
             settings (tol 1e-4, fp32, Ruiz + adaptive + PWU,
             restart_sync="global"): afiro-class x 10,000 over one shared
             K (the JAX package's "10k perturbed instances" fleet), every
             element Solved and held to 10*tol by a vectorised fp64 host
             recomputation, instances/s; deg2-class x 64 with compaction,
             then in fp64 with fixed steps and restart_sync="element",
             whose elements 0, 21, 42 and 63 must give the k, n, j and
             status of single solves on the card; 16 distinct deg2-shaped
             LPs through the stacked K1; the banded 8192 fleet (8 seeds)
             through "auto", which must choose the stacked band layout
             (K2, no K1 launch); mittelmann-l x 8 through "sparse" (the
             batched CSR kernel), replayed with the same x bits.  Each
             fleet's launches equal its formula: two per issued iteration
             and restart check, the initial state's two, the power
             iteration's (single launches for a shared K).  The afiro
             fleet is solved once more under torch.profiler: the device's
             busy share, activities and busy time per iteration.
18. fishnet — spectral_cast on mittelmann-s (the CLI's wiring: the scaled
             problem, the dense layout), then the warm solve: Solved, held
             on the host, cold and warm k and the cast's seconds;
             `python -m tpdlp_torch.bench.fishnet_value --device cuda`:
             cold and warm Solved on every row; the CLI sweep of the corpus
             with --fishnet, then --batch_solve: every row linprog's
             verdict.

19. shard  — sharded solves over torch.distributed on the one card, at
             full width, the main path's settings: one NCCL rank (1x1, this
             process) and four gloo ranks (a 2x2 mesh; NCCL refuses two
             ranks on one card, so gloo stages the CUDA tensors through
             the host).
             mittelmann-s through dense 2D blocks (K1 on each rank's
             block): Solved, held on the host at 10*tol, within 5*tol of
             the unsharded objective; banded 8192 through band strips (K2
             on each rank's groups) and mittelmann-s through block-ELL
             strips: Solved; banded 100k through band strips for
             SHARD_BAND_KKT passes, each rank's peak device memory below
             the unsharded band solve's.  On every rank the kernel's
             launches equal the single solve's formula and the product
             all_reduces one per product; every rank returns the same bits.
             entry.dryrun_multichip(1) runs on the card beside the 2x2
             group (one NCCL rank; four would need four cards).
20. harness — bench/runner.py on mittelmann-s (3 seeds; one row of
             bench.py's schema, vs_baseline null: no reference tree here)
             and bench/roofline.py for dense, band and block-ELL at
             mittelmann-s-class sizes (achieved GB/s and the share of
             3.35 TB/s, beside the card's name and power limit).

Every solve's kernel launches are held to the count the code implies: two
per issued iteration and per issued restart check, plus the power
iteration's and init_state's (an escalated solve: the sum over its inner
solves); the other kernels must not launch.  Each phase's seconds are
printed.  Issued iterations are k, plus, when a certificate fires
mid-cycle, the masked rest of that cycle; both are printed.

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
                 (2000, 5000), (5000, 2000), (8000, 20000), (20000, 8000),
                 (2000, 6500), (6500, 2000)]
#: The main path's shape the kernel summary line reports (mittelmann-s K).
HEADLINE_SHAPE = (2000, 5000)
#: Refinement's slack form K_aug = [G -I; A 0] of mittelmann-s (1500
#: inequality rows): the operator the correction rounds launch K1 on.
KAUG_SHAPE = (2000, 6500)
FP64_SHAPE = (2000, 5000)
TIMED_LAUNCHES = 25
#: K/K' pairs per loop timing (2 launches each).
LOOP_PAIRS = 50
#: Cycles the card spins before a loop timing (about 10 ms at 2 GHz, above
#: the host's time to queue the loop's launches).
LOOP_SPIN_CYCLES = 20_000_000
#: Dense (K, K') shape pairs timed as a loop.
LOOP_SHAPES = [((2000, 5000), (5000, 2000)), ((8000, 20000), (20000, 8000)),
               ((2000, 6500), (6500, 2000))]
#: The band path's instance (tpdlp_torch/bench/band_scale.py's defaults):
#: n, m_ineq, m_eq, bandwidth.
BAND_100K = (100_000, 75_000, 25_000, 105)
#: Random band slabs (m, n, WB) beside the instance's: the narrowest and the
#: widest window the layout allows, m and n not multiples of 128.
BAND_RANDOM = [(5001, 777, 128), (30001, 40003, 2048)]
#: KKT budgets of the band path's two profiled solves; their difference is
#: the steady loop, without the operator build and the preprocessing.
BAND_PROFILE_KKT = (1000, 2000)
#: KKT budget of the profiled mittelmann-s solve with the certificates
#: (about 300 iterations: the profile reads per-iteration figures).
PROFILE_CERT_KKT = 600
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
    "synth_infeasible_n5000_m1501_s7": ("float32", 4_000, False),
    "synth_infeasible_n10000_m3001_s7": ("float32", 4_000, False),
}
#: The certificate families on (the battery's and the certify phase's).
CERTIFICATES = dict(infeasibility_detect=True, normalized_certificates=True)
#: Seconds each linprog method may take on one battery row; the oracles run
#: in worker processes beside the card's solves.
ORACLE_SECONDS = 110.0
ORACLE_WORKERS = 3

#: The sparse path's large instance: about 10M nonzeros, 1.6 TB as a
#: dense fp32 K, its block-ELL estimate far over the autotune's budget, and
#: not band-like (generate_feasible_lp arguments).
SPARSE_1M = dict(n=1_000_000, m_ineq=300_000, m_eq=100_000, density=2.5e-5,
                 seed=0)
#: An LP with 13 empty rows and 411 empty columns in K, whose empty
#: segments stop the JAX package's sparse operator (-inf norms) at k = 40.
EMPTY_SEGMENTS = dict(n=2000, m_ineq=600, m_eq=200, density=0.002, seed=0)
#: KKT budget of the first of the checkpoint phase's two solves.
CHECKPOINT_SPLIT = 600
#: Calls of the autotune on banded 100k whose choices must agree.
AUTOTUNE_CALLS = 3
#: High accuracy: the refine_1e8 protocol's tolerance under |gap|
#: termination (`--abs_gap`), which certifies the objective (the signed
#: gap passes every primal and dual feasible pair).  refine's budget: the
#: round budgets grow with it (max_kkt / 12, 45% of what remains), and at
#: 200,000 mittelmann-s stops at KKT_LIMIT in both packages (PERF.md §6).
HIGH_TOL = 1e-8
REFINE_KKT = 500_000
#: refine_band's budget and start: banded 8192 refined from the JAX
#: package's fp32 stage result (tests/jax_reference_high_accuracy.py
#: coarse-band), from which both packages certify; from the card's own
#: coarse result both stall (ROADMAP.md queue 3).
REFINE_BAND_KKT = 200_000
REFINE_BAND_START = "tests/data/jax_coarse_banded_8192.npz"
#: The bit-for-bit replays of the refinement phases, cut for the time
#: limit (each phase's whole run twice until PR 6): refine replays its
#: coarse stage against the first run's; refine_band runs its first
#: correction solve (round 0, 66,000 iterations in full) twice at this
#: budget.
REPLAY_PREFIX_KKT = 10_000
BAND_8192 = dict(n=8192, m_ineq=4096, m_eq=2048, bandwidth=65, seed=2)
#: The fp64 tail's budget, and the JAX package's status for the phase's
#: instance, config and budget from its own run on the CPU (PERF.md §6,
#: tests/jax_reference_high_accuracy.py tail --lift-guard).
TAIL_KKT = 200_000
#: At 200,000 the JAX fp64 stage (its TPU element guard lifted: as
#: shipped it skips the stage on mittelmann-s) is Solved at j 165,967; at
#: 100,000 it stops at KKT_LIMIT.
TAIL_JAX_STATUS = "SOLVED"
#: Seconds HiGHS may take per method on an oracle of the high-accuracy
#: phases (it runs in a worker process from the end of the kernel timings).
HIGHS_SECONDS = 900.0
#: The fleets (tpdlp_torch/bench/fleet.py's settings: Ruiz, adaptive steps,
#: PWU, tol 1e-4, fp32, restart_sync="global").  afiro-class x 10,000 with
#: one shared K is the JAX package's "10k perturbed instances" fleet
#: (perturbed_fleet, rel 0.05, seed 0); deg2-class x 64 is fleet.py's
#: default batch, run again in fp64 with fixed steps and
#: restart_sync="element", whose FLEET_ELEMENTS must give single solves'
#: k, n, j and status; FLEET_DISTINCT distinct LPs of deg2-class's shape
#: (seeds 0-15) stack K1; fleet.py --banded's banded 8192 x 8 (seeds 0-7)
#: stacks K2 through "auto"; mittelmann-l x FLEET_SPARSE through "sparse"
#: shares one CSR K.
FLEET_AFIRO = 10_000
FLEET_DEG2 = 64
FLEET_ELEMENTS = (0, 21, 42, 63)
FLEET_DISTINCT = 16
DEG2_SHAPE = dict(n=757, m_ineq=280, m_eq=164, density=0.05)
FLEET_BAND = ("8192,4096,2048,65", 8)
FLEET_SPARSE = 8
#: The batched kernels' rows: the afiro fleet's K and K' at a ragged
#: B = 37 as well as at 10,000.
RAGGED_B = 37
#: The shard phase: the banded 100k instance on four ranks for this many
#: KKT passes (the per-rank memory is what it shows); ranks share the card
#: under gloo (NCCL refuses two ranks on one card), and a 1x1 mesh drives
#: NCCL.
SHARD_BAND_KKT = 2_000
SHARD_RANKS = 4
#: Timed all_reduces of the transport probe, on the host and on the card.
ALL_REDUCE_PROBES = 100
#: The harness phase: runner seeds (bench.py's 3), roofline's iterations
#: (the JAX harness's default 2,000 halved for the time limit) and
#: mittelmann-s-class sizes (m, n) for dense, band and block-ELL.
RUNNER_SEEDS = 3
ROOFLINE_ITERS = 1_000
ROOFLINE_SHAPE = (2000, 5000)

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
_KERNEL_NAME = re.compile(
    r"\d([a-z_]+_kernel)I([fd])(?:Li(\d+)E)?(?:Lb([01])E)?E")


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
                f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}"
                f"{', ' + k.group(3) if k.group(3) else ''}"
                f"{', batched' if k.group(4) == '1' else ''}>")
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


def _bound(bytes_, flops, rates, dtype):
    """(bound_ms, bound_by) of `bytes_` moved once against `flops` at the
    card's peak for `dtype`."""
    bw, f32_peak, f64_peak = rates
    t_bytes = bytes_ / bw * 1e3
    t_ops = flops / (f32_peak if dtype == torch.float32 else f64_peak) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _band_bound(m, n, ngroups, R, WB, item, rates, dtype):
    """(bound_ms, bound_by) of one band product: the live slab rows, x,
    the live starts and y moved once, against 2 flops per live slab
    element."""
    rows = min(m, ngroups * R)
    return _bound((rows * WB + n + m) * item + 4 * -(-rows // R),
                  2 * rows * WB, rates, dtype)


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
    if K.launches["band_matvec"] or K.launches["csr_matvec"]:
        raise AssertionError("the dense path launched another kernel")
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
    if launches["dense_matvec"] or launches["csr_matvec"]:
        raise AssertionError("the band path launched another kernel")
    # K and K' slabs twice (the caller's and Ruiz's scaled copy), plus
    # vectors and the build's triplets: far below one dense K (40 GB).
    if peak - mem_before > 3 * stored:
        raise AssertionError(
            f"{p.name}: peak {peak / 1e9} GB above 3 copies of the slabs")
    return row, launches["band_matvec"], r


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
    others = [k for k in launches if k != kernel and launches[k]]
    if others:
        raise AssertionError(f"{name} {way}: {others} launched")
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
    decided_rows = {}
    for name, prob, planted in battery:
        dtype, max_kkt, certifies = BATTERY[name]
        cfg = B.battery_config(max_kkt=max_kkt)
        r, wall, kl, issued = _counted_solve(dev, prob, cfg,
                                             getattr(torch, dtype))
        oracle, oracle_s = oracles[name].result()
        decided = oracle in (0, 2, 3)
        decided_rows[name] = (decided, oracle_s)
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
    emit("battery_oracles", seconds_per_method=ORACLE_SECONDS,
         decided=sorted(n for n, (d, _) in decided_rows.items() if d),
         undecided=sorted(n for n, (d, _) in decided_rows.items() if not d),
         slowest_decided_s=max((s for d, s in decided_rows.values() if d),
                               default=None))
    return launches["certificates"], launches["band_certificates"]


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _device_trace(prof, kernel):
    """The device records of a torch.profiler trace: (busy us, events,
    us by name, `kernel`'s us, `kernel`'s events)."""
    spans, by_name, kernel_events = [], {}, 0
    # The trace's raw records: prof.events() first builds a Python event
    # tree, about 70 µs an event (these traces hold up to 240,000).
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, us = e.start_ns() / 1e3, e.duration_ns() / 1e3
        spans.append((start, start + us))
        name = e.name()
        by_name[name] = by_name.get(name, 0.0) + us
        kernel_events += kernel in name
    kernel_us = sum(v for k, v in by_name.items() if kernel in k)
    return _busy_us(spans), len(spans), by_name, kernel_us, kernel_events


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
    busy, events, by_name, kernel_us, kernel_events = _device_trace(prof,
                                                                    kernel)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit("profile", instance=p.name, seed=0, status=r.status_string,
         extra=extra or {}, k=r.iterations, j=r.kkt_passes, max_kkt=max_kkt,
         wall_ms=wall_us / 1e3, device_events=events,
         device_busy_ms=busy / 1e3,
         device_busy_share=busy / wall_us if events else None,
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
            "events": events, "kernel_us": kernel_us,
            "kernel_events": kernel_events, "launches": counted,
            "restart_period": cfg.restart_period}


def profile_phase(dev, p_band):
    """Where the time goes: one mittelmann-s solve blocked and one
    per-iteration with the certificates, and the band path over a bounded
    KKT budget."""
    from tpdlp_torch.bench.suite import build_suite

    (p,) = build_suite(("large",), names=("mittelmann-s",))
    loops = {"blocked": _profile_solve(dev, p, "dense_matvec", MAX_KKT),
             "certificates": _profile_solve(dev, p, "dense_matvec",
                                            PROFILE_CERT_KKT, CERTIFICATES)}
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


def _csr_bound(rows, cols, nnz, item, rates, dtype):
    """(bound_ms, bound_by) of one CSR product: each value and column
    index, the row offsets, x and y moved once, against 2 flops a
    nonzero."""
    return _bound(nnz * (item + 4) + (rows + 1) * 4 + (cols + rows) * item,
                  2 * nnz, rates, dtype)


def csr_kernels_phase(dev, rates, p_l, p_1m):
    """csr_matvec against its twin on the sparse path's matrices: K and K'
    of mittelmann-l (fp32 and fp64) and of the sparse-1M instance (fp32),
    cold and in a K/K' loop, beside cuSPARSE's product of the same CSR
    tensor (torch.mv), whose repeats are also compared bit for bit."""
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.ops.sparse import SparseOp

    flush = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    rows = []
    for inst, prob, dtypes in (("mittelmann-l", p_l,
                                (torch.float32, torch.float64)),
                               ("sparse-1M", p_1m, (torch.float32,))):
        for dtype in dtypes:
            op = SparseOp.from_scipy(prob.K, dtype, device=dev)
            pair = []
            for label, mat in (("K", op.mat), ("K'", op.mat_t)):
                crow, col, val = (mat.crow_indices(), mat.col_indices(),
                                  mat.values())
                m, n = mat.shape
                x = torch.randn((n,), generator=gen, dtype=dtype,
                                device=dev)
                y = K.csr_matvec(crow, col, val, x)
                y2 = K.csr_matvec(crow, col, val, x)
                plain = K.csr_matvec_plain(crow, col, val, x)
                lib = torch.mv(mat, x)
                lib2 = torch.mv(mat, x)
                torch.cuda.synchronize()
                longest = int(crow.diff().max())
                eps = 6e-8 if dtype == torch.float32 else 1.2e-16
                tol = eps * max(4, longest) ** 0.5 * 30
                rel = float(((y - plain).abs() / (1 + plain.abs())).max())
                if not rel < tol:
                    raise AssertionError(
                        f"csr_matvec {inst} {label} {dtype}: rel err {rel}")
                if not torch.equal(y, y2):
                    raise AssertionError(f"csr_matvec {inst} {label}: "
                                         "repeats differ")
                bound, bound_by = _csr_bound(m, n, val.numel(),
                                             val.element_size(), rates,
                                             dtype)
                row = {
                    "case": f"{inst} {label}", "shape": [m, n],
                    "nnz": int(val.numel()), "max_row": longest,
                    "group": K.csr_group(m, val.numel()),
                    "dtype": str(dtype).replace("torch.", ""),
                    "kernel_ms": time_launches(
                        lambda: K.csr_matvec(crow, col, val, x), flush),
                    "plain_ms": time_launches(
                        lambda: K.csr_matvec_plain(crow, col, val, x),
                        flush),
                    "library_ms": time_launches(lambda: torch.mv(mat, x),
                                                flush),
                    "library_repeat_identical": bool(torch.equal(lib,
                                                                 lib2)),
                    "library_max_rel_diff": float(
                        ((lib - plain).abs() / (1 + plain.abs())).max()),
                    "bound_ms": bound, "bound_by": bound_by,
                    "max_rel_err": rel,
                    "max_abs_err": float((y - plain).abs().max()),
                    "tol": tol,
                }
                row["bound_share"] = bound / row["kernel_ms"]
                emit("kernels", kernel="csr_matvec", **row)
                rows.append(row)
                pair.append((crow, col, val, x, mat, row))
            (a, b) = pair
            loop = {
                "kernel_loop_ms": time_loop(
                    lambda: K.csr_matvec(*a[:4]),
                    lambda: K.csr_matvec(*b[:4])),
                "library_loop_ms": time_loop(lambda: torch.mv(a[4], a[3]),
                                             lambda: torch.mv(b[4], b[3])),
            }
            emit("kernels_loop", kernel="csr_matvec", case=inst,
                 dtype=str(dtype).replace("torch.", ""),
                 bound_ms=(a[5]["bound_ms"] + b[5]["bound_ms"]) / 2, **loop)
            a[5].update(loop)
            b[5].update(loop)
            del op, pair, a, b
    del flush
    torch.cuda.empty_cache()
    return rows


def _main_cfg():
    from tpdlp_torch import SolverConfig

    return SolverConfig(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                        adaptive=True, primal_weight_update=True,
                        time_limit=600)


def _autotuned(dev, p):
    """choose_operator on `p` with its candidates' seconds per K/K' pair
    printed, and an op_cache that hands the chosen operator to a
    matrix_format="auto" solve (so that solve's launches are the formula's
    alone).  Returns (label, cache, timed candidates)."""
    from tpdlp_torch.ops.autotune import choose_operator

    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op, label = choose_operator(p.K, torch.float32, device=dev,
                                timings=timings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    emit("autotune", instance=p.name, label=label, seconds=seconds,
         candidate_s_per_pair=timings, timed=sorted(timings))
    key = ("auto", str(torch.float32), str(dev), p.K.shape)
    return label, {key: op}, timings


def _autotune_steps(dev, p):
    """Host seconds of choose_operator's steps on a K that goes to CSR:
    the COO view, the band and block-ELL size estimates, the CSR build."""
    from tpdlp_torch.ops.band import band_stored_elems
    from tpdlp_torch.ops.blocked import ell_stored_elems
    from tpdlp_torch.ops.sparse import SparseOp

    t0 = time.perf_counter()
    coo = p.K.tocoo()
    steps = {"tocoo": time.perf_counter() - t0}
    for name, step in (("band_estimate", lambda: band_stored_elems(coo)),
                       ("ell_estimate", lambda: ell_stored_elems(coo)),
                       ("csr_build", lambda: SparseOp.from_scipy(
                           coo, torch.float32, device=dev))):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
    return steps


def _sparse_solve_row(dev, p, cfg, kernel, way, **solve_kw):
    """One counted solve: its row, held to Solved, the fp64 host residual
    check and `kernel`'s launches equal to the formula (no other kernel
    launched).  Returns (result, row)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    r, wall, kl, issued = _counted_solve(dev, p, cfg, **solve_kw)
    check = host_residuals(p, r.x, r.y)
    row = {**_certify_row(p.name, way, kernel, cfg, r, wall, kl, issued),
           "shape": list(p.shape), "nnz": int(sp.csr_matrix(p.K).nnz),
           "solve_time_s": r.solve_time,
           "mem_before_gb": mem_before / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           **check}
    emit("sparse", **row)
    _check_solution(f"{p.name} {way}", r, check)
    return r, row


def sparse_phase(dev, p_l, dense_l, p_1m):
    """The sparse and auto layouts at full size: mittelmann-l through CSR
    (against the dense phase's objective) and through the autotune, with
    both paths profiled; the sparse-1M instance through "auto" (which must
    build nothing but CSR) and "sparse", bit-identical; the empty-segment
    LP through CSR (the banded 100k instance through the autotune is the
    autotune_stable phase).  Returns (the mittelmann-l CSR row, the
    sparse-1M CSR launches)."""
    from tpdlp_torch import generate_feasible_lp

    cfg = _main_cfg()
    r_l, row_l = _sparse_solve_row(dev, p_l, cfg, "csr_matvec", "sparse",
                                   matrix_format="sparse")
    lim = 5 * TOL * (1 + abs(dense_l["objective"]))
    emit("sparse_vs_dense", instance=p_l.name, sparse=r_l.objective,
         dense=dense_l["objective"], dense_k=dense_l["k"],
         sparse_k=r_l.iterations,
         abs_diff=abs(r_l.objective - dense_l["objective"]), limit=lim)
    if abs(r_l.objective - dense_l["objective"]) > lim:
        raise AssertionError(f"{p_l.name}: sparse and dense disagree")

    label, cache, _ = _autotuned(dev, p_l)
    kernel = {"dense": "dense_matvec", "band": "band_matvec",
              "sparse": "csr_matvec"}.get(label)
    if kernel is None:
        raise AssertionError(f"{p_l.name}: auto chose {label}")
    _sparse_solve_row(dev, p_l, cfg, kernel, f"auto ({label})",
                      matrix_format="auto", op_cache=cache)
    del cache

    # Where the time goes, per iteration: CSR against dense on one LP.
    prof = {fmt: _profile_solve(dev, p_l, kern, MAX_KKT, matrix_format=fmt)
            for fmt, kern in (("sparse", "csr_matvec"),
                              ("dense", "dense_matvec"))}
    emit("profile_sparse", instance=p_l.name, **{
        fmt: {"k": v["k"], "device_events": v["events"],
              "wall_ms_per_iteration": v["wall_us"] / v["k"] / 1e3,
              "device_busy_ms_per_iteration": v["busy_us"] / v["k"] / 1e3,
              "device_busy_share": v["busy_us"] / v["wall_us"],
              "kernel_us_per_launch": v["kernel_us"] / v["kernel_events"]}
        for fmt, v in prof.items()})

    # sparse-1M: "auto" must find nothing but CSR to build or time.
    label, cache, timings = _autotuned(dev, p_1m)
    if label != "sparse" or timings:
        raise AssertionError(f"sparse-1M: auto chose {label}, timed "
                             f"{timings}")
    del cache
    emit("autotune_host", instance=p_1m.name, seconds=_autotune_steps(
        dev, p_1m))
    torch.cuda.empty_cache()
    r_auto, row_1m = _sparse_solve_row(dev, p_1m, cfg, "csr_matvec", "auto",
                                       matrix_format="auto")
    r_again, _ = _sparse_solve_row(dev, p_1m, cfg, "csr_matvec", "sparse",
                                   matrix_format="sparse")
    same = (r_auto.iterations, r_auto.restarts, r_auto.kkt_passes,
            r_auto.objective) == (r_again.iterations, r_again.restarts,
                                  r_again.kkt_passes, r_again.objective)
    emit("sparse_replay", instance=p_1m.name, same_counters=same,
         x_identical=bool(np.array_equal(r_auto.x, r_again.x)),
         y_identical=bool(np.array_equal(r_auto.y, r_again.y)))
    if not (same and np.array_equal(r_auto.x, r_again.x)
            and np.array_equal(r_auto.y, r_again.y)):
        raise AssertionError("sparse-1M: the two solves differ")
    torch.cuda.empty_cache()

    p_e = generate_feasible_lp(**EMPTY_SEGMENTS)
    p_e.name = "empty-segments n2000"
    K_e = sp.csr_matrix(p_e.K)
    emit("empty_segments", instance=p_e.name,
         empty_rows=int((np.diff(K_e.indptr) == 0).sum()),
         empty_cols=int((np.diff(K_e.tocsc().indptr) == 0).sum()))
    _sparse_solve_row(dev, p_e, cfg, "csr_matvec", "sparse",
                      matrix_format="sparse")
    return row_l, row_1m["launches"]


def checkpoint_phase(dev):
    """mittelmann-s in two solves through a checkpoint (the first stops at
    CHECKPOINT_SPLIT KKT passes, the second resumes): the uninterrupted
    solve's k, n, j, status, objective and x bits."""
    from tpdlp_torch import Status, solve
    from tpdlp_torch.bench.suite import build_suite
    from tpdlp_torch.ops import _kernels as K

    (p,) = build_suite(("large",), names=("mittelmann-s",))
    cfg = _main_cfg()
    ref = solve(p, cfg, dtype=torch.float32, device=dev, seed=0)
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as tmp:
        path = f"{tmp}/mittelmann-s"
        t0 = time.perf_counter()
        first = solve(p, cfg.replace(max_kkt=CHECKPOINT_SPLIT),
                      dtype=torch.float32, device=dev, seed=0,
                      checkpoint_path=path)
        resumed = solve(p, cfg, dtype=torch.float32, device=dev, seed=0,
                        checkpoint_path=path, resume=True)
        wall = time.perf_counter() - t0
    same = ((resumed.status, resumed.iterations, resumed.restarts,
             resumed.kkt_passes, resumed.objective)
            == (ref.status, ref.iterations, ref.restarts, ref.kkt_passes,
                ref.objective))
    emit("checkpoint", instance=p.name, split_kkt=CHECKPOINT_SPLIT,
         first=[first.status_string, first.iterations, first.kkt_passes],
         resumed=[resumed.status_string, resumed.iterations,
                  resumed.restarts, resumed.kkt_passes, resumed.objective],
         uninterrupted=[ref.status_string, ref.iterations, ref.restarts,
                        ref.kkt_passes, ref.objective],
         x_identical=bool(np.array_equal(resumed.x, ref.x)),
         wall_s=wall)
    if first.status != Status.KKT_LIMIT or ref.status != Status.SOLVED:
        raise AssertionError(f"checkpoint: {first.status}, {ref.status}")
    if not (same and np.array_equal(resumed.x, ref.x)):
        raise AssertionError("checkpoint: the resumed solve differs")


#: The CLI phases' reference-parity flags (with the certificates).
CLI_FLAGS = ["--precondition", "--adaptive_stepsize", "--primal_weight_update",
             "--infeasibility_detect"]


def _cli_sweep(extra, oracle, files, tag):
    """One `python -m tpdlp_torch.cli.main` sweep of the vendored corpus
    with CLI_FLAGS and `extra`: exit 0, a row per file, each row's status
    the linprog verdict.  Returns ({file: row}, wall seconds)."""
    import csv
    import os

    from tpdlp_torch import Status
    from tpdlp_torch.bench.suite import INSTANCES_DIR
    from tpdlp_torch.ops import _kernels as K

    root = os.path.dirname(os.path.abspath(__file__))
    verdict = {0: Status.SOLVED, 2: Status.PRIMAL_INFEASIBLE,
               3: Status.DUAL_INFEASIBLE}
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpdlp_torch.cli.main", "--instance_path",
             os.path.relpath(INSTANCES_DIR, root), *CLI_FLAGS, *extra,
             "--output_path", out],
            capture_output=True, text=True, timeout=600, cwd=root)
        wall = time.perf_counter() - t0
        rows = []
        if proc.returncode == 0:
            with open(f"{out}/solver_results.csv", newline="") as f:
                rows = list(csv.DictReader(f))
    got = {r["File"]: r for r in rows}
    emit(tag, flags=extra, returncode=proc.returncode, wall_s=wall,
         rows=[[r["File"], r["Status"], r["Iterations (k)"],
                r["KKT Passes (j)"], r["Objective"]] for r in rows],
         oracle={f: verdict.get(s, Status.RUNNING).describe()
                 for f, s in oracle.items()})
    if proc.returncode != 0:
        raise AssertionError(f"{tag} {extra}: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    if sorted(got) != files:
        raise AssertionError(f"{tag} {extra}: rows {sorted(got)}")
    for f in files:
        want = verdict.get(oracle[f])
        if want is None:
            raise AssertionError(f"{tag}: linprog leaves {f} undecided")
        if "N/A" in got[f].values() or got[f]["Status"] != (
                want.describe()):
            raise AssertionError(f"{tag} {extra}: {f} {got[f]}, linprog "
                                 f"says {want.describe()}")
    return got, wall


def cli_phase():
    """python -m tpdlp_torch.cli.main over the port's vendored corpus with
    the reference-parity flags, through the autotune and then dense: exit
    0, a status in every row, and each row's status the scipy linprog
    verdict (Solved, PRIMAL_INFEASIBLE or DUAL_INFEASIBLE).  Returns (the
    linprog statuses, the dense sweep's rows)."""
    import os

    from tpdlp_torch import read_mps
    from tpdlp_torch.bench.infeasibility import oracle_status
    from tpdlp_torch.bench.suite import INSTANCES_DIR

    files = sorted(f for f in os.listdir(INSTANCES_DIR) if f.endswith(".mps"))
    oracle = {f: oracle_status(read_mps(os.path.join(INSTANCES_DIR, f)),
                               ORACLE_SECONDS) for f in files}
    rows = {}
    for layout in (["--support_sparse"], ["--matrix_format", "dense"]):
        rows[layout[-1]], _ = _cli_sweep(layout, oracle, files, "cli")
    return oracle, rows["dense"]


def autotune_stable_phase(dev, p_band, band_run):
    """banded 100k through "auto" AUTOTUNE_CALLS times: each call's
    candidates timed on the card (ms a K/K' pair) and its choice printed,
    the calls' choices equal, each call's kernel launches the captured
    chains' count (ops/autotune.py::autotune_launches per timed candidate
    with a kernel); then the solve through "auto" with the chosen operator
    bit for bit that layout's own run (the band phase's where band wins, a
    "sparse" solve where CSR wins).  Returns the chosen label."""
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.ops.autotune import autotune_launches

    kernel_of = {"dense": "dense_matvec", "band": "band_matvec",
                 "sparse": "csr_matvec"}
    labels, cache = [], None
    for call in range(AUTOTUNE_CALLS):
        del cache
        torch.cuda.empty_cache()
        K.reset_launches()
        label, cache, timings = _autotuned(dev, p_band)
        launches = dict(K.launches)
        expect = {k: 0 for k in launches}
        for cand in timings:
            if cand in kernel_of:
                expect[kernel_of[cand]] += autotune_launches(1)
        emit("autotune_stable", instance=p_band.name, call=call,
             label=label, ms_per_pair={k: v * 1e3 for k, v in
                                       timings.items()},
             launches=launches, launches_expected=expect)
        if launches != expect:
            raise AssertionError(f"autotune call {call}: launches "
                                 f"{launches}, expected {expect}")
        labels.append(label)
    if len(set(labels)) != 1:
        raise AssertionError(f"{p_band.name}: auto chose {labels}")
    label = labels[0]
    cfg = _main_cfg()
    kernel = kernel_of.get(label)
    if kernel is None:  # block-ELL runs no kernel of its own
        r, wall, kl, issued = _counted_solve(dev, p_band, cfg,
                                             matrix_format="auto",
                                             op_cache=cache)
        check = host_residuals(p_band, r.x, r.y)
        emit("sparse", instance=p_band.name, way="auto (blocked)",
             status=r.status_string, k=r.iterations, launches=kl, **check)
        _check_solution(f"{p_band.name} auto", r, check)
        ref = _counted_solve(dev, p_band, cfg, matrix_format="auto",
                             op_cache=cache)[0]
    else:
        r, _ = _sparse_solve_row(dev, p_band, cfg, kernel,
                                 f"auto ({label})", matrix_format="auto",
                                 op_cache=cache)
        if label == "band":
            ref = band_run
        else:
            del cache
            torch.cuda.empty_cache()
            cache = None
            ref, _ = _sparse_solve_row(dev, p_band, cfg, kernel, label,
                                       matrix_format=label)
    same = ((r.iterations, r.restarts, r.kkt_passes, r.objective)
            == (ref.iterations, ref.restarts, ref.kkt_passes, ref.objective)
            and np.array_equal(r.x, ref.x))
    emit("autotune_stable_solve", instance=p_band.name, label=label,
         k=r.iterations, j=r.kkt_passes, objective=r.objective,
         reference_k=ref.iterations, reference_objective=ref.objective,
         bit_identical=same)
    if not same:
        raise AssertionError(f"{p_band.name}: auto ({label}) differs from "
                             f"the {label} run")
    del cache
    torch.cuda.empty_cache()
    return label


def highs_objective(problem):
    """(HiGHS optimum, seconds) of one instance, in a worker process."""
    from tpdlp_torch.bench.refine_1e8 import oracle_objective

    t0 = time.perf_counter()
    obj = oracle_objective(problem, time_limit=HIGHS_SECONDS, cache=False)
    return obj, time.perf_counter() - t0


def _stage_launches(cfg, stages):
    """K products the code implies for an escalated solve: each inner
    solve's own count (expected_launches), summed."""
    total = 0
    for st in stages:
        it = st["issued"]
        total += (2 * it["iterations"] + 2 * it["restart_checks"]
                  + 2 * cfg.power_iters + 1 + 2)
    return total


def _start_result(path):
    """The SolveResult of a coarse stage saved by
    tests/jax_reference_high_accuracy.py (x, y, k, n, j; Solved)."""
    from pathlib import Path

    from tpdlp_torch import SolveResult, Status

    d = np.load(Path(__file__).resolve().parent / path)
    return SolveResult(x=d["x"], y=d["y"], objective=0.0,
                       iterations=int(d["k"]), restarts=int(d["n"]),
                       kkt_passes=int(d["j"]), status=Status.SOLVED,
                       solve_time=0.0, primal_res=0.0, dual_res=0.0, gap=0.0)


def _high_accuracy_run(dev, p, cfg, kernel, start=None, record=None,
                       **solve_kw):
    """One dtype=None solve of `p` at cfg.tol through the public entry
    (the escalation reroute), counted: (result, wall, launches, its row).
    The reroute hands solver/solve.py's module-level `solve` to
    refinement as its inner solver; for this call that name is wrapped:
    with `start` (a coarse stage's SolveResult) the coarse stage is handed
    back instead of solved, and with a list `record` each inner solve's
    (problem, config, kwargs, result) is appended to it."""
    import tpdlp_torch.solver.solve as S
    from tpdlp_torch import solve
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.solver.refine import _terminated
    from tpdlp_torch.solver.refine import host_residuals as refine_res

    inner = S.solve

    def staged(problem, config, **kw):
        if start is not None and "+refine" not in problem.name:
            return start
        r = inner(problem, config, **kw)
        if record is not None:
            record.append((problem, config, kw, r))
        return r

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    S.solve = staged
    try:
        r = solve(p, cfg, device=dev, seed=0, **solve_kw)
    finally:
        S.solve = inner
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    esc = r.escalation or {}
    stages = esc.get("stages", [])
    K64 = sp.csr_matrix(p.K).astype(np.float64)
    res = refine_res(K64, p.c, p.q, p.l, p.u, p.m_ineq,
                     np.asarray(r.x, np.float64), np.asarray(r.y, np.float64))
    q_n, c_n = float(np.linalg.norm(p.q)), float(np.linalg.norm(p.c))
    by_dtype = {}
    for st in stages:
        d = by_dtype.setdefault(st["dtype"], {"k": 0, "j": 0, "wall_s": 0.0,
                                              "launches": {}})
        d["k"] += st["k"]
        d["j"] += st["j"]
        d["wall_s"] += st["wall_s"]
        for name_, v in st["launches"].items():
            if v:
                d["launches"][name_] = d["launches"].get(name_, 0) + v

    def expected(st):
        # A coarse stage handed back ran nothing on the card.
        handed = start is not None and st["stage"] == "coarse"
        return 0 if handed else _stage_launches(cfg, [st])

    row = {
        "instance": p.name, "shape": list(p.shape), "tol": cfg.tol,
        "route": esc.get("route"), "status": r.status_string,
        "k": r.iterations, "n": r.restarts, "j": r.kkt_passes,
        "objective": r.objective, "wall_s": wall,
        "rounds": esc.get("rounds"), "inner_solves": len(stages),
        "inner_s": sum(st["wall_s"] for st in stages),
        "host_s": wall - sum(st["wall_s"] for st in stages),
        "by_dtype": by_dtype, "launches": launches,
        "launches_expected": sum(expected(st) for st in stages),
        "stages": [[st["stage"], st["dtype"], st["status"], st["k"],
                    st["j"], st["wall_s"]] for st in stages],
        "host_rel_primal": res.primal_res / (1 + q_n),
        "host_rel_dual": res.dual_res / (1 + c_n),
        "host_rel_gap": res.gap / (1 + abs(res.prim_obj)
                                   + abs(res.adjusted_dual)),
        "host_certified": _terminated(res, q_n, c_n, cfg.tol,
                                      cfg.abs_gap_termination),
    }
    # Each inner solve's products in `kernel`; an elastic retry's in CSR
    # (its layout in both packages, solver/refine.py), never another.
    wrong = []
    for st in stages:
        want = "csr_matvec" if st["stage"].endswith("elastic") else kernel
        if any(v for k, v in st["launches"].items() if k != want) or (
                st["launches"][want] != expected(st)):
            wrong.append(st["stage"])
    if wrong or sum(launches.values()) != row["launches_expected"]:
        emit("high_accuracy_launches", **row)
        raise AssertionError(f"{p.name} {row['route']}: launches {launches}"
                             f", expected {row['launches_expected']} in "
                             f"{kernel} (stages {wrong})")
    return r, wall, row


def refine_phase(dev, name, p, oracle, kernel, max_kkt, replay, start=None,
                 **solve_kw):
    """1e-8 through the default escalation (dtype=None on CUDA:
    refinement), the refine_1e8 protocol with |gap| termination (Ruiz,
    adaptive steps, PWU) and a budget of `max_kkt` (from `start`, a saved
    coarse stage, if given): Solved, the criteria held by an fp64
    recomputation on the host, the objective within HIGH_TOL relative of
    HiGHS (run in a worker process from the start), every inner product
    in `kernel` (an elastic retry's in CSR) and launches = the inner
    solves' formulas; then a replay, bit for bit: with replay="coarse" its
    first inner solve again (the same k, n, j, x and y bits); with
    "prefix" its first inner solve, its budget cut to REPLAY_PREFIX_KKT,
    twice (the same bits).  Both cut the phase's depth for the script's
    time limit (until PR 6 it replayed the whole run).  Returns the first
    run's row."""
    from tpdlp_torch import SolverConfig, Status, solve

    cfg = SolverConfig(tol=HIGH_TOL, scaling="ruiz", adaptive=True,
                       primal_weight_update=True, max_kkt=max_kkt,
                       abs_gap_termination=True)
    s1 = _start_result(start) if start else None
    record = []
    r, _, row = _high_accuracy_run(dev, p, cfg, kernel, s1, record,
                                   **solve_kw)
    t0 = time.perf_counter()
    problem, config, kw, first = record[0]
    if replay == "prefix":
        config = config.replace(max_kkt=REPLAY_PREFIX_KKT)
        first = solve(problem, config, **kw)
    r2 = solve(problem, config, **kw)
    same = ((first.iterations, first.restarts, first.kkt_passes)
            == (r2.iterations, r2.restarts, r2.kkt_passes)
            and np.array_equal(first.x, r2.x)
            and np.array_equal(first.y, r2.y))
    oracle_obj, oracle_s = oracle.result()
    rel_err = (abs(r.objective - oracle_obj) / max(1.0, abs(oracle_obj))
               if oracle_obj is not None else None)
    emit(name, gap_criterion="abs", max_kkt=max_kkt, start=start, **row,
         oracle_obj=oracle_obj, oracle_s=oracle_s, rel_err=rel_err,
         replay=replay, replay_wall_s=time.perf_counter() - t0,
         replay_j=r2.kkt_passes, replay_bit_identical=same)
    if row["route"] != "refine" or r.status != Status.SOLVED:
        raise AssertionError(f"{name}: {r.status_string} by "
                             f"{row['route']}")
    if not row["host_certified"]:
        raise AssertionError(f"{name}: Solved, host residuals {row}")
    if rel_err is None or rel_err > HIGH_TOL:
        raise AssertionError(f"{name}: objective {r.objective}, HiGHS "
                             f"{oracle_obj}")
    if not same:
        raise AssertionError(f"{name}: the {replay} replay differs")
    return row


def fp64_tail_phase(dev, p, refine_row):
    """mittelmann-s at 1e-8 with escalation_mode="fp64_tail" (max_kkt
    TAIL_KKT): the fp32 and fp64 stages' k, j, walls and K1 launches,
    each stage's launches its formula, the status the JAX package gives on
    the CPU (TAIL_JAX_STATUS), a Solved point held to the criteria on the
    host; its wall beside the refine phase's."""
    from tpdlp_torch import SolverConfig, Status

    cfg = SolverConfig(tol=HIGH_TOL, scaling="ruiz", adaptive=True,
                       primal_weight_update=True, max_kkt=TAIL_KKT,
                       escalation_mode="fp64_tail")
    r, wall, row = _high_accuracy_run(dev, p, cfg, "dense_matvec")
    emit("fp64_tail", **row, max_kkt=TAIL_KKT,
         jax_cpu_status=TAIL_JAX_STATUS,
         refine_wall_s=refine_row["wall_s"], refine_j=refine_row["j"])
    stages = r.escalation["stages"] if r.escalation else []
    if row["route"] != "fp64_tail" or [s["dtype"] for s in stages] != [
            "float32", "float64"] or stages[0]["status"] != "Solved":
        raise AssertionError(f"fp64_tail: {r.status_string} by "
                             f"{row['route']}, stages {row['stages']}")
    if r.status != getattr(Status, TAIL_JAX_STATUS):
        raise AssertionError(f"fp64_tail: {r.status_string}, the JAX "
                             f"package {TAIL_JAX_STATUS}")
    if r.status == Status.SOLVED and not row["host_certified"]:
        raise AssertionError(f"fp64_tail: Solved, host residuals {row}")


def presolve_phase(oracle, dense_rows):
    """The vendored corpus through the CLI with --presolve python, then
    cpp (the C++ core built with g++ first, timed): every row's status the
    linprog verdict, every Solved row's objective within 10*tol of the
    no-presolve dense sweep's; the reductions of both engines
    (bench/presolve_stats.py) printed per row and equal."""
    import os

    from tpdlp_torch.bench import presolve_stats
    from tpdlp_torch.bench.suite import INSTANCES_DIR
    from tpdlp_torch.presolve import cpp

    built_before = cpp.library_path().exists()
    t0 = time.perf_counter()
    cpp.build()
    build_s = time.perf_counter() - t0
    stats = presolve_stats.run_stats(("python", "cpp"))
    by = {}
    for row in stats:
        by.setdefault(row["instance"], {})[row["backend"]] = row
    keys = ("status", "passes", "rows_removed", "cols_removed",
            "rows_removed_pct", "cols_removed_pct", "nnz_removed_pct")
    emit("presolve_stats", gxx_build_s=build_s, built_before=built_before,
         rows={name: {"python": {k: v["python"][k] for k in keys},
                      "cpp_equal": all(v["python"][k] == v["cpp"][k]
                                       for k in keys),
                      "ms": [v["python"]["time_ms"], v["cpp"]["time_ms"]]}
               for name, v in by.items()})
    for name, v in by.items():
        if any(v["python"][k] != v["cpp"][k] for k in keys):
            raise AssertionError(f"presolve_stats {name}: {v}")
    files = sorted(f for f in os.listdir(INSTANCES_DIR) if f.endswith(".mps"))
    for backend in ("python", "cpp"):
        got, _ = _cli_sweep(["--matrix_format", "dense", "--presolve",
                             backend], oracle, files, "presolve")
        for f, row in got.items():
            if row["Status"] != "Solved":
                continue
            a, b = float(row["Objective"]), float(dense_rows[f]["Objective"])
            if abs(a - b) > 10 * TOL * (1 + abs(b)):
                raise AssertionError(f"presolve {backend}: {f} objective "
                                     f"{a}, without presolve {b}")


def fleet_instances(p_l):
    """The fleets' instances: afiro-class and deg2-class (suite seed 7,
    perturbed per fleet), the FLEET_DISTINCT deg2-shaped LPs (seeds 0-15),
    fleet.py --banded's banded 8192 fleet and mittelmann-l."""
    from tpdlp_torch import generate_feasible_lp
    from tpdlp_torch.bench.fleet import banded_fleet
    from tpdlp_torch.bench.suite import build_suite

    (afiro,) = build_suite(("small",), names=("afiro-class",))
    (deg2,) = build_suite(("medium",), names=("deg2-class",))
    spec, batch = FLEET_BAND
    return {
        "afiro": afiro, "deg2": deg2,
        "distinct": [generate_feasible_lp(**DEG2_SHAPE, seed=s)
                     for s in range(FLEET_DISTINCT)],
        "banded": banded_fleet(spec, batch),
        "mittelmann-l": p_l,
    }


def _batch_dense_side(M, B):
    """One direction of a dense batch case: M (m, n) shared or
    (B, m, n) stacked."""
    from tpdlp_torch.ops import _kernels as K

    stacked = M.dim() == 3
    m, n = M.shape[-2:]
    return dict(
        cols=n, inner=n, kernel="dense_matvec",
        batch=lambda X: K.dense_matvec_batch(M, X),
        single=lambda b, x: K.dense_matvec(M[b] if stacked else M, x),
        plain=lambda X: K.dense_matvec_batch_plain(M, X),
        # torch.bmm for a stack; K @ X' (cuBLAS, TF32 off) for a shared K.
        library=((lambda X: (lambda: torch.bmm(M, X[:, :, None])))
                 if stacked else (lambda X: (lambda: torch.matmul(M, X.T)))),
        bytes=((B if stacked else 1) * m * n + B * (m + n))
        * M.element_size(),
        flops=2 * B * m * n, shape=list(M.shape))


def _batch_band_side(mat, B):
    """One direction of a band stack (StackedBandMat)."""
    from tpdlp_torch.ops import _kernels as K

    slabs, starts, m, n = mat.slabs, mat.starts, mat.m, mat.n
    _, G, R, WB = slabs.shape
    rows = min(m, G * R)

    def library(X):
        # torch.bmm over the gathered windows (the gather outside the
        # timed call, as for the single kernel's yardstick).
        win = K._band_windows_batch(starts, X, n, WB).reshape(-1, WB, 1)
        S = slabs.reshape(-1, R, WB)
        return lambda: torch.bmm(S, win)

    return dict(
        cols=n, inner=WB, kernel="band_matvec",
        batch=lambda X: K.band_matvec_batch(slabs, starts, X, m, n),
        single=lambda b, x: K.band_matvec(slabs[b], starts[b], x, m, n),
        plain=lambda X: K.band_matvec_batch_plain(slabs, starts, X, m, n),
        library=library,
        bytes=B * ((rows * WB + n + m) * slabs.element_size()
                   + 4 * -(-rows // R)),
        flops=2 * B * rows * WB, shape=list(slabs.shape))


def _batch_csr_side(mat, B):
    """One direction of a shared CSR K (torch sparse_csr)."""
    from tpdlp_torch.ops import _kernels as K

    crow, col, val = mat.crow_indices(), mat.col_indices(), mat.values()
    rows, cols = mat.shape
    nnz = val.numel()
    return dict(
        cols=cols, inner=int(crow.diff().max()), kernel="csr_matvec",
        batch=lambda X: K.csr_matvec_batch(crow, col, val, X),
        single=lambda b, x: K.csr_matvec(crow, col, val, x),
        plain=lambda X: K.csr_matvec_batch_plain(crow, col, val, X),
        # cuSPARSE's product of the same CSR tensor with X'.
        library=lambda X: (lambda: mat @ X.T),
        bytes=nnz * (val.element_size() + 4) + (rows + 1) * 4
        + B * (rows + cols) * val.element_size(),
        flops=2 * B * nnz, shape=[rows, cols], nnz=nnz)


def batch_kernels_phase(dev, rates, fleets):
    """Each kernel's batch axis at this slice's shapes (the fleets' K and
    K'): against its twin (error, bit-identical repeats), every element
    bit for bit a single launch on it, cold and loop times by CUDA events
    beside the twin and the one PyTorch call that computes the same
    function (torch.bmm for a stack, K @ X' for a shared dense or CSR K),
    and the bound (a shared K's bytes counted once)."""
    from tpdlp_torch.batch.stacked import (
        StackedDenseOp,
        band_stack,
        band_stack_op,
    )
    from tpdlp_torch.ops.exact_dense import ExactDenseOp
    from tpdlp_torch.ops.sparse import SparseOp

    flush = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    afiro, deg2, distinct, banded, p_l = (
        fleets["afiro"], fleets["deg2"], fleets["distinct"],
        fleets["banded"], fleets["mittelmann-l"])

    def dense_shared(p, dtype):
        op = ExactDenseOp.build(torch.as_tensor(p.K.toarray(), dtype=dtype,
                                                device=dev))
        return op.mat, op.bwd[:, : op.m]

    cases = []
    for label, p, B, dtype in (
            ("afiro-class shared", afiro, FLEET_AFIRO, torch.float32),
            ("afiro-class shared, ragged", afiro, RAGGED_B, torch.float32),
            ("deg2-class shared", deg2, FLEET_DEG2, torch.float32),
            ("deg2-class shared", deg2, FLEET_DEG2, torch.float64)):
        fwd, bwd = dense_shared(p, dtype)
        cases.append((label, B, dtype, _batch_dense_side(fwd, B),
                      _batch_dense_side(bwd, B)))
    m, n = max(q.m for q in distinct), max(q.n for q in distinct)
    st = StackedDenseOp.from_problems(distinct, m, n, torch.float32, dev)
    cases.append(("deg2-shaped stack", len(distinct), torch.float32,
                  _batch_dense_side(st.mat, len(distinct)),
                  _batch_dense_side(st.bwd[:, :, :m], len(distinct))))
    m, n = max(q.m for q in banded), max(q.n for q in banded)
    bop = band_stack_op(band_stack(banded, torch.float32, m, n), m, n, dev)
    cases.append(("banded-8192 stack", len(banded), torch.float32,
                  _batch_band_side(bop.fwd, len(banded)),
                  _batch_band_side(bop.bwd, len(banded))))
    sop = SparseOp.from_scipy(p_l.K, torch.float32, device=dev)
    cases.append(("mittelmann-l shared", FLEET_SPARSE, torch.float32,
                  _batch_csr_side(sop.mat, FLEET_SPARSE),
                  _batch_csr_side(sop.mat_t, FLEET_SPARSE)))

    rows = []
    for label, B, dtype, *sides in cases:
        pair = []
        for side, c in zip(("K", "K'"), sides):
            X = torch.randn((B, c["cols"]), generator=gen, dtype=dtype,
                            device=dev)
            Y = c["batch"](X)
            Y2 = c["batch"](X)
            plain = c["plain"](X)
            # Each single launch gets its element's x as a vector of its
            # own (the single kernel takes a 16-byte-aligned x).
            xs = [X[b].clone() for b in range(B)]
            singles = torch.stack([c["single"](b, xs[b]) for b in range(B)])
            torch.cuda.synchronize()
            eps = 6e-8 if dtype == torch.float32 else 1.2e-16
            tol = eps * max(4, c["inner"]) ** 0.5 * 30
            rel = float(((Y - plain).abs() / (1 + plain.abs())).max())
            name = c["kernel"] + "_batch"
            if not rel < tol:
                raise AssertionError(f"{name} {label} {side}: rel err {rel}")
            if not torch.equal(Y, Y2):
                raise AssertionError(f"{name} {label} {side}: repeats "
                                     "differ")
            if not torch.equal(Y, singles):
                bad = int((Y != singles).any(dim=1).nonzero()[0])
                raise AssertionError(f"{name} {label} {side}: element {bad}"
                                     " differs from its single launch")
            bound, bound_by = _bound(c["bytes"], c["flops"], rates, dtype)
            lib = c["library"](X)
            row = {
                "kernel": name, "case": f"{label} {side}", "batch": B,
                "shape": c["shape"],
                "dtype": str(dtype).replace("torch.", ""),
                "kernel_ms": time_launches(lambda: c["batch"](X), flush),
                "plain_ms": time_launches(lambda: c["plain"](X), flush),
                "library_ms": time_launches(lib, flush),
                "single_launches_ms": time_launches(
                    lambda: [c["single"](b, xs[b]) for b in range(B)],
                    flush) if B <= FLEET_DEG2 else None,
                "bound_ms": bound, "bound_by": bound_by,
                "max_rel_err": rel, "max_abs_err": float(
                    (Y - plain).abs().max()), "tol": tol,
                "per_element_bit_identical": True,
                "last_element": B - 1,
            }
            if "nnz" in c:
                row["nnz"] = c["nnz"]
            row["bound_share"] = bound / row["kernel_ms"]
            emit("kernels", **row)
            rows.append(row)
            pair.append((c, X, lib, row))
            del Y, Y2, plain, singles, xs
        (a, xa, la, ra), (b, xb, lb, rb) = pair
        loop = {
            "kernel_loop_ms": time_loop(lambda: a["batch"](xa),
                                        lambda: b["batch"](xb)),
            "library_loop_ms": time_loop(la, lb),
        }
        emit("kernels_loop", kernel=a["kernel"] + "_batch", case=label,
             batch=B, dtype=str(dtype).replace("torch.", ""),
             bound_ms=(ra["bound_ms"] + rb["bound_ms"]) / 2, **loop)
        ra.update(loop)
        rb.update(loop)
        del pair, a, b, xa, xb, la, lb
    del cases, st, bop, sop, flush
    torch.cuda.empty_cache()
    return rows


def fleet_residuals(problems, results):
    """Each element's relative primal residual, dual residual and gap, its
    bound violation and least inequality dual, on its unscaled problem in
    fp64 on the host (residuals.py's definitions); a fleet that shares one
    K in one vectorised pass.  Returns a dict of (B,) arrays."""
    shared = all(p.K is problems[0].K for p in problems)
    if not shared:
        rows = [host_residuals(p, r.x, r.y)
                for p, r in zip(problems, results)]
        return {k: np.array([row[k] for row in rows]) for k in rows[0]}
    p0 = problems[0]
    K = sp.csr_matrix(p0.K).astype(np.float64)
    X = np.stack([np.asarray(r.x, np.float64) for r in results])
    Y = np.stack([np.asarray(r.y, np.float64) for r in results])
    C = np.stack([p.c for p in problems])
    Q = np.stack([p.q for p in problems])
    L = np.stack([p.l for p in problems])
    U = np.stack([p.u for p in problems])
    mi = p0.m_ineq
    res = (K @ X.T).T - Q
    res[:, :mi] = np.minimum(res[:, :mi], 0.0)
    grad = C - (K.T @ Y.T).T
    lo, hi = np.isneginf(L), np.isposinf(U)
    lam = grad.copy()
    lam = np.where(lo & ~hi, np.minimum(grad, 0.0), lam)
    lam = np.where(~lo & hi, np.maximum(grad, 0.0), lam)
    lam = np.where(lo & hi, 0.0, lam)
    l_d, u_d = np.where(lo, 0.0, L), np.where(hi, 0.0, U)
    prim = np.sum(C * X, axis=1)
    adj = (np.sum(Q * Y, axis=1) + np.sum(l_d * np.maximum(lam, 0), axis=1)
           + np.sum(u_d * np.minimum(lam, 0), axis=1))
    return {
        "rel_primal": np.linalg.norm(res, axis=1)
        / (1 + np.linalg.norm(Q, axis=1)),
        "rel_dual": np.linalg.norm(grad - lam, axis=1)
        / (1 + np.linalg.norm(C, axis=1)),
        "rel_gap": np.abs(adj - prim) / (1 + np.abs(prim) + np.abs(adj)),
        "bound_violation": np.max(np.maximum(L - X, 0)
                                  + np.maximum(X - U, 0), axis=1),
        "min_ineq_dual": Y[:, :mi].min(axis=1) if mi else np.zeros(len(X)),
    }


def _fleet_run(dev, name, problems, cfg, kernel, single_kernel=None,
               dtype=torch.float32, check=True, **kw):
    """One counted solve_batch (launch counts and issued iterations and
    restart checks set to 0 just before it): every element Solved and
    held to 10*tol by fleet_residuals (`check`), `kernel` launched its
    formula's count (two per issued iteration and restart check, the
    initial state's two, and a stack's batched power iteration), a shared
    K's power iteration in `single_kernel`, nothing else launched.
    Returns (results, row)."""
    from tpdlp_torch import Status, solve_batch
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.solver import loop as L

    torch.cuda.synchronize()
    K.reset_launches()
    L.reset_launched()
    t0 = time.perf_counter()
    rs = solve_batch(problems, cfg, dtype=dtype, device=dev, **kw)
    wall = time.perf_counter() - t0
    launches, issued = dict(K.launches), dict(L.launched)
    power = 2 * cfg.power_iters + 1
    expect = {kernel: 2 * issued["iterations"]
              + 2 * issued["restart_checks"] + 2
              + (0 if single_kernel else power)}
    if single_kernel:
        expect[single_kernel] = power
    statuses = {}
    for r in rs:
        statuses[r.status_string] = statuses.get(r.status_string, 0) + 1
    ks = [r.iterations for r in rs]
    row = {
        "fleet": name, "batch": len(problems),
        "shape": [max(p.m for p in problems), max(p.n for p in problems)],
        "dtype": str(dtype).replace("torch.", ""), "statuses": statuses,
        "wall_s": wall, "instances_per_s": len(problems) / wall,
        "k_max": max(ks), "k_median": float(np.median(ks)),
        "launches": launches, "launches_expected": expect,
        "iterations_issued": issued["iterations"],
        "restart_checks_issued": issued["restart_checks"],
        **{k: v for k, v in kw.items() if isinstance(v, (str, bool))},
    }
    if check:
        res = fleet_residuals(problems, rs)
        row.update({f"max_{k}": float(v.max()) for k, v in res.items()
                    if k != "min_ineq_dual"})
        row["min_ineq_dual"] = float(res["min_ineq_dual"].min())
    emit("fleet", **row)
    if check:
        if statuses != {"Solved": len(problems)}:
            raise AssertionError(f"{name}: {statuses}")
        worst = max(row["max_rel_primal"], row["max_rel_dual"],
                    row["max_rel_gap"], row["max_bound_violation"])
        if not worst <= 10 * cfg.tol or row["min_ineq_dual"] < 0:
            raise AssertionError(f"{name}: host check {row}")
    for k, v in launches.items():
        if v != expect.get(k, 0):
            raise AssertionError(f"{name}: {k} launched {v} times, "
                                 f"expected {expect.get(k, 0)}")
    if any(r.status == Status.RUNNING for r in rs):
        raise AssertionError(f"{name}: an element left RUNNING")
    return rs, row


def _profile_fleet(dev, problems, cfg, kernel, counted_row):
    """The fleet solved again under torch.profiler (device activity only):
    the device's busy share of the wall, device activities and busy time
    per issued iteration, `kernel`'s time a launch and its share of the
    busy time, beside the counted run's wall."""
    from torch.profiler import ProfilerActivity, profile

    from tpdlp_torch import solve_batch

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_batch(problems, cfg, dtype=torch.float32, device=dev,
                    restart_sync="global")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # The batch axis is the single kernel's own symbol (the trace's name):
    # its events include the power iteration's single launches.
    busy, events, by_name, kernel_us, kernel_events = _device_trace(
        prof, kernel.removesuffix("_batch"))
    iters = counted_row["iterations_issued"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit("profile_fleet", fleet=counted_row["fleet"],
         batch=counted_row["batch"], wall_ms=wall_us / 1e3,
         counted_wall_ms=counted_row["wall_s"] * 1e3, device_events=events,
         device_busy_ms=busy / 1e3,
         device_busy_share=busy / wall_us if events else None,
         events_per_iteration=events / iters,
         busy_us_per_iteration=busy / iters,
         wall_us_per_iteration=wall_us / iters,
         kernel=kernel, kernel_events=kernel_events,
         kernel_us_per_launch=kernel_us / kernel_events if kernel_events
         else None,
         kernel_share_of_busy=kernel_us / busy if busy else None,
         top_kernels_ms=[[k[:80], v / 1e3] for k, v in top])
    if not kernel_events:
        raise AssertionError(f"profile_fleet: no {kernel} event")


def fleet_phase(dev, fleets):
    """The fleets (FLEET_* above) through `solve_batch` at full size: the
    afiro-class x 10,000 shared-K fleet, deg2-class x 64 (fp32 adaptive
    with compaction; fp64 fixed steps, "element", FLEET_ELEMENTS held to
    single solves on the card), the distinct deg2-shaped stack over K1,
    the distinct banded 8192 stack over K2 through "auto" (band chosen, K1
    never launched) and mittelmann-l x 8 through "sparse" (replayed: the
    same x bits).  Returns {kernel: its launches in its fleet}."""
    from tpdlp_torch import SolverConfig, Status, solve
    from tpdlp_torch.bench.fleet import fleet_config, perturbed_fleet

    cfg = fleet_config(TOL, MAX_KKT)
    sync = dict(restart_sync="global")
    afiro_fleet = perturbed_fleet(fleets["afiro"], FLEET_AFIRO, rel=0.05,
                                  seed=0)
    # A warm-up fleet (other costs) takes the allocator's first growth.
    _fleet_run(dev, "afiro-class warm-up", perturbed_fleet(
        fleets["afiro"], FLEET_DEG2, rel=0.05, seed=1), cfg,
        "dense_matvec_batch", "dense_matvec", **sync)
    _, afiro = _fleet_run(dev, "afiro-class", afiro_fleet, cfg,
                          "dense_matvec_batch", "dense_matvec", **sync)
    _profile_fleet(dev, afiro_fleet, cfg, "dense_matvec_batch", afiro)

    deg2_fleet = perturbed_fleet(fleets["deg2"], FLEET_DEG2, rel=0.05,
                                 seed=0)
    _fleet_run(dev, "deg2-class", deg2_fleet, cfg, "dense_matvec_batch",
               "dense_matvec", compact=True, **sync)
    fixed = SolverConfig(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz",
                         adaptive=False, primal_weight_update=True,
                         time_limit=600)
    rs, _ = _fleet_run(dev, "deg2-class fp64 element", deg2_fleet, fixed,
                       "dense_matvec_batch", "dense_matvec",
                       dtype=torch.float64, restart_sync="element")
    same = []
    for b in FLEET_ELEMENTS:
        s = solve(deg2_fleet[b], fixed, dtype=torch.float64, device=dev,
                  seed=0)
        r = rs[b]
        same.append([b, r.status_string, s.status_string,
                     [r.iterations, r.restarts, r.kkt_passes],
                     [s.iterations, s.restarts, s.kkt_passes]])
        if (r.status, r.iterations, r.restarts, r.kkt_passes) != (
                s.status, s.iterations, s.restarts, s.kkt_passes):
            emit("fleet_elements", elements=same)
            raise AssertionError(f"deg2 fp64 element {b}: fleet {same[-1]}")
    emit("fleet_elements", elements=same)

    _fleet_run(dev, "deg2-shaped distinct", fleets["distinct"], cfg,
               "dense_matvec_batch", matrix_format="dense", **sync)
    _, band = _fleet_run(dev, "banded-8192 distinct", fleets["banded"], cfg,
                         "band_matvec_batch", matrix_format="auto",
                         shared_operator=False, **sync)

    sparse_fleet = perturbed_fleet(fleets["mittelmann-l"], FLEET_SPARSE,
                                   rel=0.05, seed=0)
    rs1, sparse = _fleet_run(dev, "mittelmann-l shared sparse",
                             sparse_fleet, cfg, "csr_matvec_batch",
                             "csr_matvec", matrix_format="sparse", **sync)
    rs2, _ = _fleet_run(dev, "mittelmann-l shared sparse replay",
                        sparse_fleet, cfg, "csr_matvec_batch", "csr_matvec",
                        check=False, matrix_format="sparse", **sync)
    replay = all(a.iterations == b.iterations and np.array_equal(a.x, b.x)
                 and np.array_equal(a.y, b.y) for a, b in zip(rs1, rs2))
    emit("fleet_replay", fleet="mittelmann-l shared sparse",
         bit_identical=replay)
    if not replay or any(r.status != Status.SOLVED for r in rs2):
        raise AssertionError("mittelmann-l sparse fleet: the replay differs")
    return {"dense_matvec": afiro["launches"]["dense_matvec_batch"],
            "band_matvec": band["launches"]["band_matvec_batch"],
            "csr_matvec": sparse["launches"]["csr_matvec_batch"]}


def fishnet_phase(dev, p_s, cold, oracle):
    """The fishnet warm start: spectral_cast on mittelmann-s at full size
    (the CLI's wiring: the scaled problem, the solve's dense layout), then
    the warm solve (Solved, held on the host; cold k from the solve phase
    beside it); `python -m tpdlp_torch.bench.fishnet_value --device cuda`
    over its default classes (cold and warm Solved on every row); and the
    CLI sweep of the corpus with --fishnet, then --batch_solve (every
    row's status linprog's verdict)."""
    import os

    from tpdlp_torch import solve
    from tpdlp_torch.bench.suite import INSTANCES_DIR
    from tpdlp_torch.fishnet import fishnet_start
    from tpdlp_torch.ops import _kernels as K

    cfg = _main_cfg()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    x0, y0 = fishnet_start(p_s, torch.float32, dev, "dense", cfg.scaling,
                           seed=0)
    cast_s = time.perf_counter() - t0
    cast_launches = dict(K.launches)
    warm = solve(p_s, cfg, dtype=torch.float32, device=dev, seed=0, x0=x0,
                 y0=y0, time_used=cast_s)
    check = host_residuals(p_s, warm.x, warm.y)
    emit("fishnet", instance=p_s.name, cast_s=cast_s,
         cast_launches=cast_launches, cold_k=cold["k"], warm_k=warm.iterations,
         warm_j=warm.kkt_passes, warm_status=warm.status_string,
         warm_solve_time_s=warm.solve_time, **check)
    _check_solution(f"{p_s.name} fishnet warm", warm, check)

    root = os.path.dirname(os.path.abspath(__file__))
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpdlp_torch.bench.fishnet_value",
             "--device", "cuda", "--out", f"{tmp}/fishnet.json"],
            capture_output=True, text=True, timeout=600, cwd=root)
        wall = time.perf_counter() - t0
        art = {}
        if proc.returncode == 0:
            with open(f"{tmp}/fishnet.json") as f:
                art = json.load(f)
    rows = art.get("rows", [])
    emit("fishnet_value", returncode=proc.returncode, wall_s=wall,
         device=art.get("device"), power_limit=art.get("power_limit"),
         rows=[[r["instance"], r["cold_status"], r["warm_status"],
                r["cold_k"], r["warm_k"], r["cast_s"]] for r in rows])
    if proc.returncode != 0 or not rows:
        raise AssertionError(f"fishnet_value: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    bad = [r["instance"] for r in rows
           if (r["cold_status"], r["warm_status"]) != ("Solved", "Solved")]
    if bad:
        raise AssertionError(f"fishnet_value: not Solved cold and warm: {bad}")

    files = sorted(f for f in os.listdir(INSTANCES_DIR) if f.endswith(".mps"))
    for extra, tag in ((["--fishnet"], "cli_fishnet"),
                       (["--batch_solve"], "cli_batch")):
        _cli_sweep([*extra, "--matrix_format", "dense"], oracle, files, tag)


def _shard_rank(mesh, dev, cases):
    """One rank of the shard phase: each case solved on this rank's mesh
    (fp32, the main path's settings), kernel launches, the loop's issued
    counts, the mesh's collectives and the peak device memory set to 0
    just before each solve and read just after (the memory as the peak
    above what was allocated before).  A case names its problem or the
    generator call that makes it (each rank makes its own).  Returns
    {"cases": a result per case, "entered", "left": this call's wall-clock
    times, which place the spawn and exit around it, "all_reduce_ms": the
    time of one all_reduce of 8,192 fp32 on the host and on the card}."""
    entered = time.time()
    from tpdlp_torch import SolverConfig, generate_banded_lp, solve
    from tpdlp_torch.ops import _kernels as K
    from tpdlp_torch.solver import loop as L

    import torch.distributed as dist

    # The transport alone: an all_reduce of 8,192 fp32 over the group on
    # the card, and under gloo on the host too (about mittelmann-s's
    # vector lengths).
    probe = {}
    nccl = dist.get_backend(mesh.group) == "nccl"
    for where in (dev,) if nccl else ("cpu", dev):
        t = torch.zeros(8192, device=where)
        dist.all_reduce(t, group=mesh.group)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(ALL_REDUCE_PROBES):
            dist.all_reduce(t, group=mesh.group)
        torch.cuda.synchronize(dev)
        probe[str(where)] = (time.perf_counter() - t0) / ALL_REDUCE_PROBES
    out = []
    for case in cases:
        p = case.get("problem") or generate_banded_lp(**case["banded"])
        cfg = SolverConfig(**case["cfg"])
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        K.reset_launches()
        L.reset_launched()
        mesh.reset_counts()
        t0 = time.perf_counter()
        r = solve(p, cfg, dtype=torch.float32, device=dev, seed=0,
                  mesh=mesh, matrix_format=case["format"])
        out.append({
            "wall_s": time.perf_counter() - t0, "status": int(r.status),
            "status_string": r.status_string, "k": r.iterations,
            "n": r.restarts, "j": r.kkt_passes, "objective": r.objective,
            "x": r.x, "y": r.y, "launches": dict(K.launches),
            "issued": dict(L.launched), "collectives": dict(mesh.counts),
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev)
                            - before) / 1e9,
        })
    return {"cases": out, "entered": entered, "left": time.time(),
            "all_reduce_ms": {k: v * 1e3 for k, v in probe.items()}}


def _shard_rows(tag, cases, per_rank, kernel, expect_fn):
    """Check one group's runs: every rank the same result bits; the path's
    kernel launched as the single solve's formula says (none for
    block-ELL), and one product all_reduce for each product; no other
    kernel.  Returns (row, rank 0's result) pairs."""
    rows = []
    for i, case in enumerate(cases):
        runs = [rank["cases"][i] for rank in per_rank]
        r0 = runs[0]
        for r in runs[1:]:
            if (r["k"], r["j"], r["status"]) != (r0["k"], r0["j"],
                                                 r0["status"]) or not (
                    np.array_equal(r["x"], r0["x"])
                    and np.array_equal(r["y"], r0["y"])):
                raise AssertionError(f"{tag} {case['name']}: ranks differ")
        products = expect_fn(case, r0)
        kern = kernel[i]
        for rank, r in enumerate(runs):
            got = r["launches"][kern] if kern else products
            others = {k: v for k, v in r["launches"].items()
                      if k != kern and v}
            if got != products or others:
                raise AssertionError(
                    f"{tag} {case['name']} rank {rank}: launches "
                    f"{r['launches']}, expected {products} of {kern}")
            if r["collectives"]["product"] != products:
                raise AssertionError(
                    f"{tag} {case['name']} rank {rank}: "
                    f"{r['collectives']['product']} product all_reduces "
                    f"for {products} products")
        row = {"mesh": tag, "instance": case["name"],
               "format": case["format"], "status": r0["status_string"],
               "k": r0["k"], "n": r0["n"], "j": r0["j"],
               "objective": r0["objective"], "wall_s": r0["wall_s"],
               "kernel": kern, "launches_per_rank": products,
               "all_reduces_per_product":
                   r0["collectives"]["product"] / products,
               "collectives_per_rank": r0["collectives"],
               "iterations_issued": r0["issued"]["iterations"],
               "restart_checks_issued": r0["issued"]["restart_checks"],
               "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in runs]}
        rows.append((row, r0))
    return rows


def shard_phase(dev, p_s, p_b8, cold_s, band_row):
    """Sharded solves over torch.distributed on the one card, at full
    width: one NCCL rank (a 1x1 mesh, in this process) and four gloo ranks
    sharing the card (2x2 mesh).  mittelmann-s through dense 2D blocks
    (Solved, held on the host at 10 * tol, within 5 * tol of the
    unsharded objective), banded 8192 through band strips, mittelmann-s
    through block-ELL strips ("sparse"), and banded 100k through band
    strips for SHARD_BAND_KKT passes, whose per-rank peak memory must stay
    below the unsharded band solve's.  Each rank's kernel launches equal
    the single solve's formula, and its product all_reduces one per
    product.  The NCCL rank runs first, alone; then the 2x2 group, with
    entry.dryrun_multichip(1) (the entry point on the card: one NCCL rank,
    spawned) beside it."""
    from concurrent.futures import ThreadPoolExecutor

    from tpdlp_torch.entry import dryrun_multichip
    from tpdlp_torch.shard import run_ranks

    main = dict(tol=TOL, max_kkt=MAX_KKT, scaling="ruiz", adaptive=True,
                primal_weight_update=True, time_limit=600)
    n, mi, me, bw = BAND_100K
    cases = [
        {"name": p_s.name, "problem": p_s, "format": "dense", "cfg": main},
        {"name": p_b8.name, "problem": p_b8, "format": "band", "cfg": main},
        {"name": p_s.name, "problem": p_s, "format": "sparse", "cfg": main},
        {"name": "banded-100k", "format": "band",
         "banded": dict(n=n, m_ineq=mi, m_eq=me, bandwidth=bw, seed=0),
         "cfg": dict(main, max_kkt=SHARD_BAND_KKT)},
    ]
    kernels = ["dense_matvec", "band_matvec", None, "band_matvec"]

    def products(case, r):
        from tpdlp_torch import SolverConfig

        return expected_launches(SolverConfig(**case["cfg"]), _as_result(r),
                                 r["issued"])

    def timed(fn, *a, **kw):
        t = time.perf_counter()
        return fn(*a, **kw), time.perf_counter() - t

    nccl, nccl_s = timed(_nccl_in_process, dev, cases[:1])
    # The dry run's one NCCL rank beside the 2x2 group: each all_reduce of
    # the group waits on the host's loopback (gloo), which leaves the card
    # mostly idle.
    with ThreadPoolExecutor(2) as pool:
        spawned = time.time()
        gloo_f = pool.submit(timed, run_ranks, _shard_rank, SHARD_RANKS,
                             backend="gloo", device=str(dev), shape=(2, 2),
                             args=(cases,), timeout=900)
        dry_f = pool.submit(timed, dryrun_multichip, 1, device=dev)
        gloo, gloo_s = gloo_f.result()
        returned = time.time()
        dry, dry_s = dry_f.result()
    emit("dryrun_multichip", ranks=1, backend="nccl", seconds=dry_s,
         **{k: {"k": v[0], "objective": v[1]} for k, v in dry.items()})
    rows = (_shard_rows("2x2 gloo", cases, gloo, kernels, products)
            + _shard_rows("1x1 nccl", cases[:1], nccl, kernels, products))
    problems = {p_s.name: p_s, p_b8.name: p_b8}
    launches = {"dense_matvec": {}, "band_matvec": {}}
    for row, r0 in rows:
        p = problems.get(row["instance"])
        if p is not None:
            check = host_residuals(p, r0["x"], r0["y"])
            row.update(check)
            _check_solution(f"{row['mesh']} {row['instance']} "
                            f"{row['format']}", _as_result(r0), check)
        if row["instance"] == p_s.name and row["format"] == "dense":
            row["unsharded_objective"] = cold_s["objective"]
            if abs(r0["objective"] - cold_s["objective"]) > 5 * TOL * (
                    1 + abs(cold_s["objective"])):
                raise AssertionError(f"{row['mesh']}: objective "
                                     f"{r0['objective']} against the "
                                     f"unsharded {cold_s['objective']}")
        if row["instance"] == "banded-100k":
            row["unsharded_peak_mem_gb"] = (band_row["peak_mem_gb"]
                                            - band_row["mem_before_gb"])
            if max(row["peak_mem_gb_per_rank"]) >= row[
                    "unsharded_peak_mem_gb"]:
                raise AssertionError(f"banded-100k: a rank peaked at "
                                     f"{row['peak_mem_gb_per_rank']} GB")
        if row["kernel"]:
            key = f"{row['mesh']} {row['instance']}"
            launches[row["kernel"]][key] = row["launches_per_rank"]
        emit("shard", **row)
    emit("shard_spawns", gloo_2x2_s=gloo_s, nccl_1x1_s=nccl_s,
         all_reduce_ms={"2x2 gloo": gloo[0]["all_reduce_ms"],
                        "1x1 nccl": nccl[0]["all_reduce_ms"]},
         gloo_solves_s=sum(r["wall_s"] for r in gloo[0]["cases"]),
         gloo_start_s=max(r["entered"] for r in gloo) - spawned,
         gloo_exit_s=returned - min(r["left"] for r in gloo))
    return launches


def _nccl_in_process(dev, cases):
    """The cases on a 1x1 NCCL mesh joined by this process itself (a rank
    spawned for it costs seconds to reach the card); the process group is
    destroyed before returning.  [rank 0's _shard_rank result]."""
    import datetime

    import torch.distributed as dist

    from tpdlp_torch.shard import init_distributed
    from tpdlp_torch.shard.launch import free_port

    mesh = init_distributed(
        "nccl", shape=(1, 1), init_method=f"tcp://localhost:{free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=600))
    try:
        return [_shard_rank(mesh, dev, cases)]
    finally:
        dist.destroy_process_group()


def _as_result(r):
    """The fields of a SolveResult that expected_launches and
    _check_solution read, from a rank's result."""
    from types import SimpleNamespace

    from tpdlp_torch import Status

    return SimpleNamespace(status=Status(r["status"]), iterations=r["k"])


def harness_phase(dev, p_s, smi):
    """The harnesses on the card: bench/runner.py on mittelmann-s
    (RUNNER_SEEDS seeds after a warm solve each, best by iterations/s),
    printed as one row of bench.py's schema; bench/roofline.py for dense,
    band and block-ELL at mittelmann-s-class sizes (achieved GB/s and its
    share of the H100's 3.35 TB/s, the card's name and power limit
    beside).  (entry.dryrun_multichip runs in the shard phase.)"""
    from tpdlp_torch.bench import roofline, runner

    runs = [runner.run_ours(p_s, TOL, MAX_KKT, "float32", seed=s,
                            device=dev) for s in range(RUNNER_SEEDS)]
    best = runner._best(runs)
    if any(r["status"] != "Solved" for r in runs):
        raise AssertionError(f"runner: {[r['status'] for r in runs]}")
    emit("runner", metric="mittelmann_s_pdhg_iterations_per_sec",
         value=best["iters_per_sec"], unit="iter/s", vs_baseline=None,
         platform="gpu", ours=best,
         ours_iters_all=[r["iterations"] for r in runs],
         ours_time_all=[r["time"] for r in runs], nvidia_smi=smi)
    m, n = ROOFLINE_SHAPE
    for fmt in ("dense", "band", "ell"):
        r = roofline.run_roofline(m, n, ROOFLINE_ITERS, "float32", fmt=fmt,
                                  density=0.01, device=dev)
        emit("roofline", **r, peak_gbs=roofline.H100_PEAK_GBS,
             fraction_of_peak=r["achieved_gbs"] / roofline.H100_PEAK_GBS,
             nvidia_smi=smi)


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

    from concurrent.futures import ProcessPoolExecutor

    from tpdlp_torch import generate_banded_lp
    from tpdlp_torch.bench.suite import build_suite

    (p_s,) = build_suite(("large",), names=("mittelmann-s",))
    p_b8 = generate_banded_lp(**BAND_8192)
    p_b8.name = "banded-8192"
    # HiGHS optima of the high-accuracy phases, computed meanwhile (from
    # the end of the kernel timings on, whose launches a busy host would
    # delay).
    highs = ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    try:
        return _run_phases(dev, rates, smi, name, t_start, p_s, p_b8, highs)
    finally:
        highs.shutdown(wait=True, cancel_futures=True)


def _run_phases(dev, rates, smi, name, t_start, p_s, p_b8, highs):
    from tpdlp_torch import generate_banded_lp, generate_feasible_lp
    from tpdlp_torch.bench.suite import build_suite

    def phase(tag, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        emit("phase_seconds", name=tag, seconds=time.perf_counter() - t0)
        return out

    n, mi, me, bw = BAND_100K
    t0 = time.perf_counter()
    p_band = generate_banded_lp(n=n, m_ineq=mi, m_eq=me, bandwidth=bw,
                                seed=0)
    emit("band_instance", instance=p_band.name, nnz=int(p_band.K.nnz),
         seconds=time.perf_counter() - t0)
    (p_l,) = build_suite(("xl",), names=("mittelmann-l",))
    t0 = time.perf_counter()
    p_1m = generate_feasible_lp(**SPARSE_1M)
    p_1m.name = "sparse-1M"
    emit("sparse_instance", instance=p_1m.name, shape=list(p_1m.shape),
         nnz=int(p_1m.K.nnz), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    fleets = fleet_instances(p_l)
    emit("fleet_instances", seconds=time.perf_counter() - t0,
         **{k: len(v) if isinstance(v, list) else v.name
            for k, v in fleets.items()})

    out = {}
    out["dense_rows"] = phase("kernels", kernels_phase, dev, rates)
    out["band_rows"] = phase("band_kernels", band_kernels_phase, dev, rates,
                             p_band)
    out["csr_rows"] = phase("csr_kernels", csr_kernels_phase, dev, rates,
                            p_l, p_1m)
    out["batch_rows"] = phase("batch_kernels", batch_kernels_phase, dev,
                              rates, fleets)
    oracles = {"refine": highs.submit(highs_objective, p_s),
               "refine_band": highs.submit(highs_objective, p_b8)}
    out["dense_runs"], out["dense_launches"] = phase("solve", solve_phase,
                                                     dev)
    band_row, out["band_launches"], band_run = phase("band", band_phase,
                                                     dev, p_band)
    out["dense_certify"], out["band_certify"] = phase(
        "certify", certify_phase, dev, p_band, band_row)
    phase("profile", profile_phase, dev, p_band)
    phase("cross", cross_phase, dev)
    phase("band_cross", band_cross_phase, dev)
    dense_l = next(r for r in out["dense_runs"]
                   if r["instance"] == p_l.name and r["seed"] == 0)
    out["sparse_row"], out["csr_launches_1m"] = phase(
        "sparse", sparse_phase, dev, p_l, dense_l, p_1m)
    del p_1m
    out["auto_label"] = phase("autotune_stable", autotune_stable_phase,
                              dev, p_band, band_run)
    del band_run
    phase("checkpoint", checkpoint_phase, dev)
    oracle, dense_cli = phase("cli", cli_phase)
    phase("presolve", presolve_phase, oracle, dense_cli)
    out["refine_row"] = phase("refine", refine_phase, dev, "refine", p_s,
                              oracles["refine"], "dense_matvec", REFINE_KKT,
                              "coarse")
    out["refine_band_row"] = phase(
        "refine_band", refine_phase, dev, "refine_band", p_b8,
        oracles["refine_band"], "band_matvec", REFINE_BAND_KKT, "prefix",
        start=REFINE_BAND_START, matrix_format="band")
    phase("fp64_tail", fp64_tail_phase, dev, p_s, out["refine_row"])
    out["fleet_launches"] = phase("fleet", fleet_phase, dev, fleets)
    del fleets
    cold_s = next(r for r in out["dense_runs"]
                  if r["instance"] == p_s.name and r["seed"] == 0)
    phase("fishnet", fishnet_phase, dev, p_s, cold_s, oracle)
    out["shard_launches"] = phase("shard", shard_phase, dev, p_s, p_b8,
                                  cold_s, band_row)
    phase("harness", harness_phase, dev, p_s, smi)
    emit("total", seconds=time.perf_counter() - t_start)

    print(json.dumps(_summary(out)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _summary(out):
    """The kernel summary line: each kernel against its twin, its launches
    on the main path, and its bound; K1 also at refinement's K_aug."""
    dense_rows = out["dense_rows"]
    dense_head = next(r for r in dense_rows
                      if tuple(r["shape"]) == HEADLINE_SHAPE
                      and r["dtype"] == "float32")
    kaug = next(r for r in dense_rows if tuple(r["shape"]) == KAUG_SHAPE
                and r["dtype"] == "float32")
    band_head = next(r for r in out["band_rows"] if r["case"] == "100k K"
                     and r["dtype"] == "float32")
    csr_head = next(r for r in out["csr_rows"]
                    if r["case"] == "mittelmann-l K"
                    and r["dtype"] == "float32")
    refine, refine_band = out["refine_row"], out["refine_band_row"]
    return {"kernels": [
        {**_kernel_entry("dense_matvec", "tpdlp_torch/csrc/dense_matvec.cu",
                         "tpdlp/ops/pallas_dense.py:77",
                         out["dense_launches"], dense_rows, dense_head),
         "launches_certificates": out["dense_certify"],
         "launches_refine": refine["launches"]["dense_matvec"],
         "launches_shard_per_rank": out["shard_launches"]["dense_matvec"],
         "shape": list(HEADLINE_SHAPE),
         "k_aug": {"shape": list(KAUG_SHAPE), "ms": kaug["kernel_ms"],
                   "plain_ms": kaug["plain_ms"],
                   "bound_ms": kaug["bound_ms"],
                   "library_ms": kaug["library_ms"],
                   "loop_ms": kaug["kernel_loop_ms"],
                   "library_loop_ms": kaug["library_loop_ms"]}},
        {**_kernel_entry("band_matvec", "tpdlp_torch/csrc/band_matvec.cu",
                         "tpdlp/ops/band.py:160", out["band_launches"],
                         out["band_rows"], band_head),
         "launches_certificates": out["band_certify"],
         "launches_refine_band": refine_band["launches"]["band_matvec"],
         "launches_shard_per_rank": out["shard_launches"]["band_matvec"],
         "csr_ms": band_head["csr_ms"], "shape": band_head["slabs"]},
        {**_kernel_entry("csr_matvec", "tpdlp_torch/csrc/csr_matvec.cu",
                         "tpdlp/ops/sparse.py:65",
                         out["sparse_row"]["launches"], out["csr_rows"],
                         csr_head),
         "replaces_note": "SparseOp.mv, an XLA BCOO product: no Pallas "
                          "kernel",
         "launches_sparse_1m": out["csr_launches_1m"],
         "shape": csr_head["shape"], "nnz": csr_head["nnz"]},
        *_batch_entries(out["batch_rows"], out["fleet_launches"]),
    ]}


#: Each batched kernel's summary row: the case of the fleet that is its
#: main path (afiro-class x 10,000; the banded 8192 stack; mittelmann-l x
#: 8), and its source and TPU kernel.
_BATCH_HEADS = {
    "dense_matvec": ("afiro-class shared K", "tpdlp_torch/csrc/dense_matvec.cu",
                     "tpdlp/ops/pallas_dense.py:77"),
    "band_matvec": ("banded-8192 stack K", "tpdlp_torch/csrc/band_matvec.cu",
                    "tpdlp/ops/band.py:160"),
    "csr_matvec": ("mittelmann-l shared K", "tpdlp_torch/csrc/csr_matvec.cu",
                   "tpdlp/ops/sparse.py:65"),
}


def _batch_entries(rows, launches):
    """The summary entries of the three kernels' batch axis: launches in
    their fleets, the head case's times and bound, the largest fp32 error
    over every batched case of the kernel."""
    out = []
    for kernel, (case, source, replaces) in _BATCH_HEADS.items():
        name = kernel + "_batch"
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["case"] == case
                    and r["dtype"] == "float32")
        out.append({
            **_kernel_entry(name, source, replaces, launches[kernel], mine,
                            head),
            "case": case, "batch": head["batch"], "shape": head["shape"],
            "single_launches_ms": head["single_launches_ms"],
        })
    return out


if __name__ == "__main__":
    sys.exit(main())
