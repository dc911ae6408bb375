"""Public solve API: preprocessing, chunked device loop, result assembly
(counterpart of tpdlp/solver/solve.py, its single-device dense and band
branches).

The device runs blocked restart cycles, or the per-iteration loop when
certificates, `loop_mode="periter"` or a restart period above 256 ask for
it; the host reads a few counters at most once per cycle and checks the
wall clock between chunks of KKT passes, on the JAX package's chunk
schedule (`chunk_kkt_init`, doubling up to `chunk_kkt_max`).  Options the
port does not run yet raise `NotImplementedError` naming the ROADMAP.md
item (queue 1) that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tpdlp_torch.config import SolverConfig, Status
from tpdlp_torch.device import resolve_device
from tpdlp_torch.ops.band import BandOp
from tpdlp_torch.problem import (
    as_problem,
    device_problem,
    device_vectors,
    to_device_arrays,
)
from tpdlp_torch.scaling.ruiz import scale_problem
from tpdlp_torch.solver.loop import final_eval, read_ints, run_chunk
from tpdlp_torch.solver.power_iteration import spectral_norm_estimate
from tpdlp_torch.solver.state import init_state


@dataclasses.dataclass
class SolveResult:
    """Solver output (reference CSV schema)."""

    x: np.ndarray  # primal solution in the original (unscaled) space
    y: np.ndarray  # dual solution in the original space
    #: c'x + obj_offset on the original problem, in minimisation form.
    objective: float
    iterations: int  # k
    restarts: int  # n
    kkt_passes: int  # j
    status: Status
    solve_time: float
    primal_res: float
    dual_res: float
    gap: float
    #: Per-chunk progress records (solve(log_history=True)).
    history: Optional[list] = None
    obj_offset: float = 0.0
    objective_sense: str = "MIN"

    @property
    def status_string(self) -> str:
        return self.status.describe()

    @property
    def objective_original_sense(self) -> float:
        """Objective in the source file's sense (negated back for MAX)."""
        if self.objective_sense == "MAX":
            return -(self.objective - self.obj_offset) + self.obj_offset
        return self.objective

    def csv_row(self, name: str) -> dict:
        return {
            "File": name,
            "Objective": f"{self.objective_original_sense:.6f}",
            "Iterations (k)": self.iterations,
            "Restarts (n)": self.restarts,
            "KKT Passes (j)": self.kkt_passes,
            "Time (s)": f"{self.solve_time:.4f}",
            "Status": self.status_string,
            "Sense": self.objective_sense,
        }


def default_dtype(device) -> torch.dtype:
    """fp64 on the CPU, fp32 on CUDA."""
    return torch.float64 if torch.device(device).type == "cpu" else (
        torch.float32)


def eta_omega_of(pb, seed: int, cfg: SolverConfig, om0=None):
    """eta = eta_safety/||K||_2 (power iteration), omega = ||c||/||q||
    guarded.  `om0`: optional 0-d override (NaN = use the norm rule)."""
    eta0 = cfg.eta_safety / spectral_norm_estimate(
        pb.op, seed, cfg.power_iters
    )
    c_norm = torch.linalg.vector_norm(pb.c)
    q_norm = torch.linalg.vector_norm(pb.q)
    one = torch.ones((), dtype=pb.c.dtype, device=pb.c.device)
    omega0 = torch.where(
        (q_norm > 1e-6) & (c_norm > 1e-6), c_norm / q_norm, one
    )
    if om0 is not None:
        om0 = torch.as_tensor(om0, dtype=pb.c.dtype, device=pb.c.device)
        omega0 = torch.where(torch.isnan(om0), omega0, om0)
    return eta0, omega0


def build_device_operator(problem, dtype, matrix_format: str = "dense",
                          device=None):
    """Single-device operator + (c, q, l, u) for the chosen layout.

    The band layout builds its operator from K's triplets and never
    materialises the dense matrix: it exists for instances whose dense
    form does not fit on the device."""
    dev = resolve_device(device)
    if matrix_format == "dense":
        return to_device_arrays(problem, dtype, device=dev)
    if matrix_format == "band":
        op = BandOp.from_scipy(problem.K, dtype, device=dev)
        if op is None:
            raise ValueError(
                "matrix_format='band': K is not band-like (some "
                "row-group's column span exceeds the window "
                "budget); use 'auto' or 'sparse'"
            )
        return (op, *device_vectors(problem, dtype, dev))
    raise _format_error(matrix_format)


def _device_arrays(problem, dtype, dev, op_cache, matrix_format):
    """(op, c, q, l, u) on the device; the operator comes from `op_cache`
    when it holds one for this layout, dtype, device and K's shape."""
    key = (matrix_format, str(dtype), str(dev), problem.K.shape)
    if op_cache is not None and key in op_cache:
        return (op_cache[key], *device_vectors(problem, dtype, dev))
    op, c, q, l, u = build_device_operator(problem, dtype, matrix_format,
                                           dev)
    if op_cache is not None:
        op_cache[key] = op
    return op, c, q, l, u


def _prepare(problem, dtype, dev, op_cache, matrix_format, ineq_mask, seed,
             x0, y0, om0, cfg: SolverConfig):
    """Device arrays, scaling, problem assembly, power-iteration stepsize,
    primal weight and state init.  Returns (pb, state, t_arrays), the last
    the perf_counter time at which the arrays were on the device.

    The unscaled operator lives only in this frame (and in `op_cache`), so
    it is freed once scaled, before the power iteration builds K': the
    device holds at most two copies of K at any time."""
    op, c, q, l, u = _device_arrays(problem, dtype, dev, op_cache,
                                    matrix_format)
    t_arrays = time.perf_counter()
    op_s, c_s, q_s, l_s, u_s, d_row, d_col = scale_problem(
        op, c, q, l, u,
        method=cfg.scaling,
        ruiz_iters=cfg.ruiz_iters,
        ruiz_eps=cfg.ruiz_eps,
        pc_alpha=cfg.pock_chambolle_alpha,
    )
    del op
    if cfg.scaling == "none":
        pb = device_problem(
            op_s, c_s, q_s, l_s, u_s, 0, ineq_mask=ineq_mask,
            compat_scaled_norms=cfg.compat_scaled_norms,
        )
    else:
        pb = device_problem(
            op_s, c_s, q_s, l_s, u_s, 0,
            d_row=d_row, d_col=d_col, c0=c, q0=q, l0=l, u0=u,
            ineq_mask=ineq_mask,
            compat_scaled_norms=cfg.compat_scaled_norms,
        )
    eta0, omega0 = eta_omega_of(pb, seed, cfg, om0)
    # Warm starts arrive in the original frame; the loop iterates in the
    # scaled one (x = d_col * x_s).
    if x0 is not None:
        x0 = x0 / d_col
    if y0 is not None:
        y0 = y0 / d_row
    return pb, init_state(pb, eta0, omega0, x0, y0), t_arrays


def _extract(pb, st, use_prev: bool = False):
    """Unscaled solution and objective (x = d_col x_s, y = d_row y_s).

    `use_prev` (Halpern scheme): report the last feasible PDHG output (the
    *_prev slots); the carried z iterate may lie outside the box."""
    x = pb.d_col * (st.x_prev if use_prev else st.x)
    y = pb.d_row * (st.y_prev if use_prev else st.y)
    return x, y, torch.dot(pb.c0, x)


#: Operator layouts not ported yet, by ROADMAP.md item.
_FORMAT_ITEMS = {"sparse": 13, "auto": 14}


def _unported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to tpdlp_torch yet (ROADMAP.md queue 1 "
        f"item {item})"
    )


def _format_error(matrix_format: str) -> Exception:
    if matrix_format in _FORMAT_ITEMS:
        return _unported(f"matrix_format={matrix_format!r}",
                         _FORMAT_ITEMS[matrix_format])
    return ValueError(f"unknown matrix_format: {matrix_format!r}")


def _check_ported(cfg: SolverConfig, mesh, matrix_format, presolve,
                  checkpoint_path, resume):
    if mesh is not None:
        raise _unported("solve(mesh=...)", 21)
    if matrix_format not in ("dense", "band"):
        raise _format_error(matrix_format)
    if presolve != "off":
        raise _unported(f"presolve={presolve!r}", 18)
    if checkpoint_path is not None or resume:
        raise _unported("checkpoint/resume", 16)


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def solve(
    problem,
    config: SolverConfig = SolverConfig(),
    *,
    dtype=None,
    device=None,
    x0: Optional[np.ndarray] = None,
    y0: Optional[np.ndarray] = None,
    seed: int = 0,
    time_used: float = 0.0,
    mesh=None,
    matrix_format: str = "dense",
    presolve: str = "off",
    checkpoint_path=None,
    resume: bool = False,
    log_history: bool = False,
    op_cache: Optional[dict] = None,
    omega0: Optional[float] = None,
) -> SolveResult:
    """Solve a standard-form LP with restarted PDHG.

    `device`: None means CUDA (raises when there is none); pass "cpu" to
    run on the CPU.  `matrix_format`: "dense" (ExactDenseOp) or "band"
    (BandOp; ValueError when K is not band-like).  `dtype`: None means fp32 on CUDA and fp64 on the CPU.
    `problem`: an LPProblem of this package or any object with its fields
    (the JAX package's LPProblem included).

    `x0`/`y0` are warm-start points in the original (unscaled) frame, the
    frame SolveResult.x/.y are reported in.  `time_used` is time already
    spent, counted against config.time_limit.  `op_cache`: a dict reused
    across solves of problems with the same K; the built operator is kept
    under (matrix_format, dtype, device, shape).  `omega0` pins the initial
    primal weight.
    """
    start = time.perf_counter()
    cfg = config
    problem = as_problem(problem)
    problem.validate()
    _check_ported(cfg, mesh, matrix_format, presolve, checkpoint_path,
                  resume)
    dev = resolve_device(device)

    if dtype is None:
        dtype = default_dtype(dev)
        if (
            cfg.precision_escalation
            and dtype == torch.float32
            and cfg.tol < cfg.escalation_tol
            and x0 is None
            and y0 is None
        ):
            raise _unported(
                "precision escalation (dtype=None with tol < "
                "escalation_tol in fp32)", 15,
            )
    dtype = _as_dtype(dtype)

    m, n = problem.m, problem.n
    mask = torch.arange(m, device=dev) < problem.m_ineq
    om0 = torch.tensor(np.nan if omega0 is None else float(omega0),
                       dtype=dtype, device=dev)
    x0t = y0t = None
    if x0 is not None or y0 is not None:
        x0t = torch.as_tensor(
            np.array(x0) if x0 is not None else np.zeros(n),
            dtype=dtype, device=dev)
        y0t = torch.as_tensor(
            np.array(y0) if y0 is not None else np.zeros(m),
            dtype=dtype, device=dev)

    pb, st, t_arrays = _prepare(problem, dtype, dev, op_cache,
                                matrix_format, mask, seed, x0t, y0t, om0,
                                cfg)
    # Never run a chunk when the wall clock was spent by the time the
    # arrays reached the device (where the JAX package checks it).
    budget_spent = t_arrays - start + time_used >= cfg.time_limit

    history = [] if log_history else None

    def probe(st):
        if history is None and not cfg.verbose:
            return read_ints(st.j, st.status)
        vals = read_ints(st.j, st.status, st.k, st.n_restarts)
        f = torch.stack([st.prim_obj, st.primal_res, st.dual_res, st.gap,
                         st.eta, st.omega]).tolist()
        rec = {
            "k": vals[2], "j": vals[0], "restarts": vals[3],
            "prim_obj": f[0], "primal_res": f[1], "dual_res": f[2],
            "gap": f[3], "eta": f[4], "omega": f[5],
            "time": time.perf_counter() - start + time_used,
        }
        if history is not None:
            history.append(rec)
        if cfg.verbose:
            print(
                f"[k={rec['k']} j={rec['j']} n={rec['restarts']}] "
                f"obj={rec['prim_obj']:.6e} rp={rec['primal_res']:.2e} "
                f"rd={rec['dual_res']:.2e} gap={rec['gap']:.2e}"
            )
        return vals[:2]

    # ---- chunked loop with host-side wall-clock enforcement ----
    chunk = cfg.chunk_kkt_init
    planned = 0
    j_done, status_now = 0, int(Status.RUNNING)
    if not budget_spent:
        # The first chunk runs right after preprocessing, with no clock
        # check in between (the JAX package fuses the two).
        planned = min(cfg.max_kkt, chunk)
        chunk = min(chunk * 2, cfg.chunk_kkt_max)
        st = run_chunk(st, pb, planned, cfg, aligned=True)
        j_done, status_now = probe(st)

    timed_out = False
    while status_now == int(Status.RUNNING) and j_done < cfg.max_kkt:
        if time.perf_counter() - start + time_used >= cfg.time_limit:
            timed_out = True
            break
        planned = min(cfg.max_kkt, planned + chunk)
        chunk = min(chunk * 2, cfg.chunk_kkt_max)
        # Blocked chunks exit at a cycle boundary; a per-iteration chunk
        # may stop mid-cycle, and its runner reads t itself.
        st = run_chunk(st, pb, planned, cfg, aligned=True)
        j_done, status_now = probe(st)

    status = Status(status_now)
    if timed_out and status == Status.RUNNING:
        status = Status.TIME_LIMIT
    elif status == Status.RUNNING:
        # KKT budget exhausted: one last residual evaluation may still
        # declare Solved.
        st = final_eval(st, pb, cfg)

    x, y, obj = _extract(pb, st, use_prev=cfg.step_scheme == "halpern")
    vec = torch.cat([x, y, torch.stack([obj, st.primal_res, st.dual_res,
                                        st.gap])]).cpu().numpy()
    j_v, st_v, k_v, n_v = read_ints(st.j, st.status, st.k, st.n_restarts)
    if st_v != int(Status.RUNNING):
        status = Status(st_v)
    obj_v, rp_v, rd_v, gap_v = (float(v) for v in vec[n + m:])
    return SolveResult(
        x=vec[:n].copy(),
        y=vec[n:n + m].copy(),
        objective=obj_v + problem.obj_offset,
        obj_offset=problem.obj_offset,
        objective_sense=problem.objsense,
        iterations=k_v,
        restarts=n_v,
        kkt_passes=j_v,
        status=status,
        solve_time=time.perf_counter() - start + time_used,
        primal_res=rp_v,
        dual_res=rd_v,
        gap=gap_v,
        history=history,
    )
