"""Public solve API: preprocessing, chunked device loop, result assembly
(counterpart of tpdlp/solver/solve.py, its single-device dense and band
branches).

The device runs blocked restart cycles, or the per-iteration loop when
certificates, `loop_mode="periter"` or a restart period above 256 ask for
it; the host reads a few counters at most once per cycle and checks the
wall clock between chunks of KKT passes, on the JAX package's chunk
schedule (`chunk_kkt_init`, doubling up to `chunk_kkt_max`).  With a
`checkpoint_path` the state is saved after every chunk, and `resume=True`
continues from the saved state.

`mesh=` (tpdlp_torch/shard) solves one LP sharded over the ranks of a
torch.distributed group: the operator of the JAX package's mesh layout
(dense 2D blocks, band or block-ELL flat strips), built on the host shard
by shard, each rank's products over its own shard with one collective
each; every vector is cut on the host to the rank's slice of its space, as
the JAX package places it (shard/mesh.py::Placement), and the solver's
reductions run over the group (solver/reduce.py); the result on every
rank is the full x and y, gathered.

With dtype=None on CUDA (fp32) and `tol` below `escalation_tol`, the solve
escalates as the JAX package's does: `escalation_mode` "auto" and "refine"
run iterative refinement (solver/refine.py), "fp64_tail" an fp32 stage to
`escalation_tol` and then a warm-started fp64 stage on the card
(`_solve_escalated`).  `presolve="python"|"cpp"` solves the reduced LP of
tpdlp_torch/presolve and maps the solution back.

Left out on purpose, as ROADMAP.md's precision rule says: the JAX
package's guards for the TPU's rounding matrix unit (`_mxu_noisy`, the
warning and the escalation reroute for sparse layouts below 1e-4) and for
its emulated fp64 (`_f64_guard`, `_F64_DENSE_ELEM_LIMIT` and the fp64
tail's automatic reroute through a mesh).  On the H100 an fp32 product is
exact in every layout and fp64 is native.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from tpdlp_torch.config import SolverConfig, Status
from tpdlp_torch.device import resolve_device
from tpdlp_torch.ops.autotune import choose_operator, dense_candidate_allowed
from tpdlp_torch.ops.band import BandOp
from tpdlp_torch.ops.sparse import SparseOp
from tpdlp_torch.problem import (
    as_problem,
    device_problem,
    device_vectors,
    to_device_arrays,
)
from tpdlp_torch.scaling.ruiz import scale_problem
from tpdlp_torch.shard import mesh as shard_mesh
from tpdlp_torch.solver.checkpoint import load_state, npz_path, save_state
from tpdlp_torch.solver.loop import final_eval, read_ints, run_chunk
from tpdlp_torch.solver.power_iteration import spectral_norm_estimate
from tpdlp_torch.solver.reduce import reduce
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
    #: An escalated solve's route and stages ("refine" or "fp64_tail";
    #: see `run_stage`); None for a direct solve.
    escalation: Optional[dict] = None

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
    c_norm, q_norm = reduce(pb.red, ("norm", "x", pb.c), ("norm", "y", pb.q))
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
    """Single-device operator + (c, q, l, u) for the chosen layout:
    "dense" (ExactDenseOp), "sparse" (SparseOp, CSR), "band" (BandOp;
    ValueError when K is not band-like) or "auto" (the fastest candidate,
    ops/autotune.py).

    Layouts other than dense build their operator from K's triplets and
    never materialise the dense matrix: they exist for instances whose
    dense form does not fit on the device."""
    dev = resolve_device(device)
    if matrix_format == "dense":
        return to_device_arrays(problem, dtype, device=dev)
    if matrix_format == "sparse":
        op = SparseOp.from_scipy(problem.K, dtype, device=dev)
    elif matrix_format == "band":
        op = BandOp.from_scipy(problem.K, dtype, device=dev)
        if op is None:
            raise ValueError(
                "matrix_format='band': K is not band-like (some "
                "row-group's column span exceeds the window "
                "budget); use 'auto' or 'sparse'"
            )
    elif matrix_format == "auto":
        op, _ = choose_operator(problem.K, dtype, device=dev)
    else:
        raise ValueError(f"unknown matrix_format: {matrix_format!r}")
    return (op, *device_vectors(problem, dtype, dev))


def _device_arrays(problem, dtype, dev, op_cache, matrix_format,
                   mesh=None):
    """(op, c, q, l, u) on the device; the operator comes from `op_cache`
    when it holds one for this layout, dtype, device and K's shape (and
    mesh shape, under a mesh, where `problem` holds this rank's slices of
    the vectors and the whole padded K)."""
    key = (matrix_format, str(dtype), str(dev), problem.K.shape)
    if mesh is not None:
        key += (mesh.shape,)
    if op_cache is not None and key in op_cache:
        return (op_cache[key], *device_vectors(problem, dtype, dev))
    if mesh is None:
        op, c, q, l, u = build_device_operator(problem, dtype,
                                               matrix_format, dev)
    else:
        from tpdlp_torch.shard.ops import build_shard

        op = build_shard(problem.K, matrix_format, mesh, dtype, dev)
        c, q, l, u = device_vectors(problem, dtype, dev)
    if op_cache is not None:
        op_cache[key] = op
    return op, c, q, l, u


def mesh_layout(matrix_format: str, m: int, n: int, dtype) -> str:
    """The sharded layout `matrix_format` names under a mesh: "dense" (2D
    blocks), "band" or "sparse" (block-ELL, flat strips); "auto" is dense
    while the dense matrix fits the autotune's budget, block-ELL beyond it
    (the JAX package's rule)."""
    if matrix_format == "auto":
        return "dense" if dense_candidate_allowed(m, n, dtype) else "sparse"
    return matrix_format


def _padded_problem(problem, mesh, layout: str):
    """The mesh-padded problem of `layout` (K's triplets, padded as
    `shard.mesh.pad_vectors` says, and this rank's slices of the padded
    vectors), this rank's slice of its inequality mask, and the vectors'
    placement."""
    import types

    import scipy.sparse as sp

    m, n = problem.m, problem.n
    sizes = {"dense": shard_mesh.padded_sizes,
             "band": shard_mesh.padded_sizes_band,
             "sparse": shard_mesh.padded_sizes_sparse}[layout]
    m_pad, n_pad = sizes(m, n, mesh)
    pl = shard_mesh.placement(mesh, layout, m_pad, n_pad)
    K = problem.K
    coo = K.tocoo() if sp.issparse(K) else sp.coo_matrix(np.asarray(K))
    K_p = sp.coo_matrix((coo.data, (coo.row, coo.col)), shape=(m_pad, n_pad))
    c, q, l, u, mask = shard_mesh.pad_vectors(
        *(np.asarray(v, np.float64) for v in (problem.c, problem.q,
                                              problem.l, problem.u)),
        np.arange(m) < problem.m_ineq, m_pad, n_pad)
    return types.SimpleNamespace(
        K=K_p, c=pl.cut_x(c), q=pl.cut_y(q), l=pl.cut_x(l),
        u=pl.cut_x(u)), pl.cut_y(mask), pl


def build_device_problem(op, c, q, l, u, ineq_mask, cfg: SolverConfig):
    """Scale (K, c, q, l, u) by `cfg.scaling` and assemble the
    DeviceProblem (the JAX `_build_device_problem`).  `op` is scaled on a
    copy (Ruiz never touches the caller's operator)."""
    op_s, c_s, q_s, l_s, u_s, d_row, d_col = scale_problem(
        op, c, q, l, u,
        method=cfg.scaling,
        ruiz_iters=cfg.ruiz_iters,
        ruiz_eps=cfg.ruiz_eps,
        pc_alpha=cfg.pock_chambolle_alpha,
    )
    if cfg.scaling == "none":
        return device_problem(
            op_s, c_s, q_s, l_s, u_s, 0, ineq_mask=ineq_mask,
            compat_scaled_norms=cfg.compat_scaled_norms,
        )
    return device_problem(
        op_s, c_s, q_s, l_s, u_s, 0,
        d_row=d_row, d_col=d_col, c0=c, q0=q, l0=l, u0=u,
        ineq_mask=ineq_mask,
        compat_scaled_norms=cfg.compat_scaled_norms,
    )


def _layout_of(problem, mesh, matrix_format, dtype, dev):
    """(the problem the device arrays come from, its layout, its
    inequality mask on `dev`, the placement): the problem itself (and
    None), or under a mesh its padded form, this rank's slices, and the
    sharded layout `matrix_format` names."""
    if mesh is None:
        return (problem, matrix_format,
                torch.arange(problem.m, device=dev) < problem.m_ineq, None)
    layout = mesh_layout(matrix_format, problem.m, problem.n, dtype)
    padded, mask, pl = _padded_problem(problem, mesh, layout)
    return padded, layout, torch.as_tensor(mask, device=dev), pl


def prepare(problem, cfg: SolverConfig, *, dtype, device=None, mesh=None,
            matrix_format: str = "dense", seed: int = 0):
    """(pb, state): a solve's preprocessing (the operator of the layout,
    scaling, the power-iteration stepsize, the initial state), from which
    the harnesses time chunks of `solver/loop.py::run_chunk`.  Under a
    mesh every vector is this rank's slice of its padded space."""
    dev = resolve_device(device)
    arrays_of, layout, mask, _ = _layout_of(as_problem(problem), mesh,
                                            matrix_format, dtype, dev)
    om0 = torch.tensor(np.nan, dtype=dtype, device=dev)
    pb, st, _ = _prepare(
        lambda: _device_arrays(arrays_of, dtype, dev, None, layout, mesh),
        mask, seed, None, None, om0, cfg)
    return pb, st


def _prepare(arrays, ineq_mask, seed, x0, y0, om0, cfg: SolverConfig):
    """Device arrays (from `arrays()`), scaling, problem assembly,
    power-iteration stepsize, primal weight and state init.  Returns (pb,
    state, t_arrays), the last the perf_counter time at which the arrays
    were on the device.

    The unscaled operator lives only in this frame (and in `op_cache`), so
    it is freed once scaled, before the power iteration builds K': the
    device holds at most two copies of K at any time."""
    op, c, q, l, u = arrays()
    t_arrays = time.perf_counter()
    pb = build_device_problem(op, c, q, l, u, ineq_mask, cfg)
    del op
    eta0, omega0 = eta_omega_of(pb, seed, cfg, om0)
    # Warm starts arrive in the original frame; the loop iterates in the
    # scaled one (x = d_col * x_s).
    if x0 is not None:
        x0 = x0 / pb.d_col
    if y0 is not None:
        y0 = y0 / pb.d_row
    return pb, init_state(pb, eta0, omega0, x0, y0), t_arrays


def _resumed_state(path, pb, cfg: SolverConfig, dtype, dev, pl, st):
    """The checkpointed state on the device, its anchor products
    recomputed from the operator (they must equal K x_restart and
    K'y_restart; older checkpoints lack them).  Under Halpern the
    restart baseline is zeroed, so the criterion re-baselines at the next
    restart, as the JAX package does.  Under a mesh (`pl`, the placement)
    rank 0 reads the file and every rank takes its slices of that state
    (`st` gives the others the dtypes)."""
    if pl is None or pl.mesh.rank == 0:
        st = load_state(path, dtype=dtype, device=dev)
    if pl is not None:
        st = shard_mesh.shard_state(st, pl)
    st = st.replace(kx_restart=pb.op.mv(st.x_restart),
                    kty_restart=pb.op.rmv(st.y_restart))
    if cfg.step_scheme == "halpern":
        st = st.replace(kkt_first=torch.zeros_like(st.kkt_first),
                        fp_res=torch.zeros_like(st.fp_res))
    return st


def _extract(pb, st, use_prev: bool = False, pl=None):
    """Unscaled solution and objective (x = d_col x_s, y = d_row y_s), the
    whole (padded) x and y on every rank under a mesh (`pl`).

    `use_prev` (Halpern scheme): report the last feasible PDHG output (the
    *_prev slots); the carried z iterate may lie outside the box."""
    x = pb.d_col * (st.x_prev if use_prev else st.x)
    y = pb.d_row * (st.y_prev if use_prev else st.y)
    (obj,) = reduce(pb.red, ("dot", "x", pb.c0, x))
    if pl is not None:
        x, y = pl.gather(("x", x), ("y", y))
    return x, y, obj


#: The operator layouts `matrix_format` names.
MATRIX_FORMATS = ("dense", "sparse", "band", "auto")


def _check_options(matrix_format, presolve):
    if matrix_format not in MATRIX_FORMATS:
        raise ValueError(f"unknown matrix_format: {matrix_format!r}")
    if presolve not in ("off", "python", "cpp"):
        raise ValueError(f"unknown presolve backend: {presolve!r}")


def run_stage(stages: list, what: str, fn, *args, **kwargs):
    """Run one inner solve of an escalated solve, `fn(*args, **kwargs)`,
    and append its record to `stages`: what it was, dtype, status, k, n,
    j, its wall seconds, the kernel launches (`ops/_kernels.launches`) and
    the loop's issued iterations and restart checks (`loop.launched`)
    during it.  Returns its result."""
    from tpdlp_torch.ops import _kernels
    from tpdlp_torch.solver import loop

    k0, i0 = dict(_kernels.launches), dict(loop.launched)
    t0 = time.perf_counter()
    r = fn(*args, **kwargs)
    stages.append({
        "stage": what,
        "dtype": str(kwargs.get("dtype")).replace("torch.", ""),
        "status": r.status_string,
        "k": r.iterations, "n": r.restarts, "j": r.kkt_passes,
        "wall_s": time.perf_counter() - t0,
        "launches": {k: v - k0[k] for k, v in _kernels.launches.items()},
        "issued": {k: v - i0[k] for k, v in loop.launched.items()},
    })
    return r


def _solve_escalated(problem, cfg: SolverConfig, **kw):
    """Two-stage precision escalation (counterpart of the JAX
    `_solve_escalated`): an fp32 stage to `cfg.escalation_tol`, then an
    fp64 stage warm-started from its solution to `cfg.tol`, natively on
    the card.  Work and time budgets span both stages; counters and
    histories are summed, and a budget spent by the fp32 stage reports
    KKT_LIMIT (only `escalation_tol` was certified).

    escalation_scheme="auto" (with the vanilla scheme configured) runs the
    fp32 stage with adaptive steps and the fp64 stage as Halpern with fixed
    steps."""
    auto = cfg.escalation_scheme == "auto" and cfg.step_scheme == "vanilla"
    base = cfg
    if auto and not cfg.adaptive:
        base = cfg.replace(adaptive=True)
    coarse = base.replace(tol=max(cfg.escalation_tol, cfg.tol))
    stages: list = []
    s1 = run_stage(stages, "fp32", solve, problem, coarse,
                   dtype=torch.float32, **kw)
    route = {"route": "fp64_tail", "stages": stages}
    if s1.status != Status.SOLVED:
        # Certificates, budget exhaustion and timeouts are terminal.
        return dataclasses.replace(s1, escalation=route)
    kkt_left = cfg.max_kkt - s1.kkt_passes
    if kkt_left <= 0:
        # Only the coarse tolerance was certified.
        return dataclasses.replace(s1, status=Status.KKT_LIMIT,
                                   escalation=route)
    kw2 = dict(kw)
    kw2["time_used"] = s1.solve_time  # already includes the incoming time
    cfg2 = base.replace(max_kkt=kkt_left)
    if auto:
        cfg2 = cfg2.replace(step_scheme="halpern", adaptive=False)
    s2 = run_stage(stages, "fp64", solve, problem, cfg2,
                   dtype=torch.float64, x0=s1.x, y0=s1.y, **kw2)
    history = None
    if s1.history is not None or s2.history is not None:
        history = (s1.history or []) + (s2.history or [])
    return dataclasses.replace(
        s2,
        iterations=s1.iterations + s2.iterations,
        restarts=s1.restarts + s2.restarts,
        kkt_passes=s1.kkt_passes + s2.kkt_passes,
        history=history,
        escalation=route,
    )


def _solve_presolved(problem, cfg: SolverConfig, start, *, backend, dtype,
                     device, seed, time_used, mesh, matrix_format,
                     checkpoint_path, resume, log_history):
    """presolve -> solve of the reduced LP -> primal and dual postsolve
    (the JAX `solve`'s presolve branch).  A status presolve decides alone
    returns at once, with no device work."""
    from tpdlp_torch.presolve import presolve as run_presolve
    from tpdlp_torch.presolve.reductions import (
        postsolve as run_postsolve,
        postsolve_dual as run_postsolve_dual,
    )

    pres = run_presolve(problem, backend=backend)
    pre_time = time.perf_counter() - start
    if pres.status != Status.RUNNING:
        if pres.status == Status.SOLVED:
            x_full = run_postsolve(np.zeros(0), pres.data)
            y_full = run_postsolve_dual(np.zeros(0), x_full, pres.data)
        else:  # infeasible/unbounded: no meaningful point
            x_full = np.zeros(problem.n)
            y_full = np.zeros(problem.m)
        return SolveResult(
            x=x_full, y=y_full,
            objective=float(np.dot(problem.c, x_full)) + problem.obj_offset,
            obj_offset=problem.obj_offset,
            objective_sense=problem.objsense,
            iterations=0, restarts=0, kkt_passes=0, status=pres.status,
            solve_time=pre_time, primal_res=0.0, dual_res=0.0, gap=0.0,
        )
    # Checkpoint/resume and history ride on the inner (reduced) solve: a
    # resume must use the same presolve backend.
    inner = solve(
        pres.problem, cfg, dtype=dtype, device=device,
        seed=seed,
        time_used=time_used + pre_time, mesh=mesh,
        matrix_format=matrix_format, checkpoint_path=checkpoint_path,
        resume=resume, log_history=log_history,
    )
    x_full = run_postsolve(inner.x, pres.data)
    y_full = run_postsolve_dual(inner.y, x_full, pres.data)
    return dataclasses.replace(
        inner, x=x_full, y=y_full,
        objective=float(np.dot(problem.c, x_full)) + problem.obj_offset,
        obj_offset=problem.obj_offset, objective_sense=problem.objsense,
    )


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
    run on the CPU.  `matrix_format`: "dense" (ExactDenseOp), "sparse"
    (SparseOp, CSR), "band" (BandOp; ValueError when K is not band-like)
    or "auto" (the fastest of the candidate layouts, ops/autotune.py).
    `dtype`: None means fp32 on CUDA and fp64 on the CPU.
    `problem`: an LPProblem of this package or any object with its fields
    (the JAX package's LPProblem included).

    `x0`/`y0` are warm-start points in the original (unscaled) frame, the
    frame SolveResult.x/.y are reported in.  `time_used` is time already
    spent, counted against config.time_limit.  `op_cache`: a dict reused
    across solves of problems with the same K; the built operator is kept
    under (matrix_format, dtype, device, shape).  `omega0` pins the initial
    primal weight.

    `checkpoint_path`: the state is saved there (an .npz file) after every
    chunk.  `resume=True` with an existing checkpoint continues from it:
    the problem, config and layout must be the ones it was written with
    (a checkpoint of the JAX package's `solve` loads too).

    With dtype=None in fp32 (CUDA) and `config.tol` below
    `config.escalation_tol` (and `precision_escalation` on, no warm start)
    the solve escalates: `escalation_mode` "auto" or "refine" runs
    iterative refinement (solver/refine.py), "fp64_tail" an fp32 stage
    then a warm-started fp64 stage (except on `resume`).  The result's
    `escalation` records the route and its inner solves.

    `presolve`: "off" | "python" | "cpp" — reduce the LP first
    (tpdlp_torch/presolve), solve the reduced LP and map x and y back.
    Warm starts do not combine with presolve (ValueError).
    """
    start = time.perf_counter()
    cfg = config
    problem = as_problem(problem)
    problem.validate()
    _check_options(matrix_format, presolve)
    dev = resolve_device(device)

    if presolve != "off":
        if x0 is not None or y0 is not None:
            raise ValueError(
                "presolve + warm start is unsupported: x0/y0 are in the "
                "ORIGINAL variable/row space but the inner solve runs on "
                "the reduced problem; disable presolve or drop the warm "
                "start"
            )
        return _solve_presolved(
            problem, cfg, start, backend=presolve, dtype=dtype, device=dev,
            seed=seed, time_used=time_used, mesh=mesh,
            matrix_format=matrix_format, checkpoint_path=checkpoint_path,
            resume=resume, log_history=log_history,
        )

    if dtype is None:
        dtype = default_dtype(dev)
        if (
            cfg.precision_escalation
            and dtype == torch.float32
            and cfg.tol < cfg.escalation_tol
            and x0 is None
            and y0 is None
        ):
            if cfg.escalation_mode == "fp64_tail":
                if not resume:
                    return _solve_escalated(
                        problem, cfg, seed=seed, time_used=time_used,
                        device=dev, mesh=mesh, matrix_format=matrix_format,
                        checkpoint_path=checkpoint_path,
                        log_history=log_history,
                    )
            else:  # "refine" and "auto"
                from tpdlp_torch.solver.refine import solve_refined

                return solve_refined(
                    problem, cfg, solve_fn=solve, seed=seed,
                    time_used=time_used, device=dev, mesh=mesh,
                    matrix_format=matrix_format,
                    checkpoint_path=checkpoint_path, resume=resume,
                    log_history=log_history,
                )
    dtype = _as_dtype(dtype)

    m, n = problem.m, problem.n
    # Under a mesh every vector below is this rank's slice of its padded
    # space; the gathered results are cut back to (n,) and (m,).
    arrays_of, layout, mask, pl = _layout_of(problem, mesh, matrix_format,
                                             dtype, dev)
    n_op, m_op = (n, m) if pl is None else (pl.n, pl.m)
    om0 = torch.tensor(np.nan if omega0 is None else float(omega0),
                       dtype=dtype, device=dev)
    x0t = y0t = None
    if x0 is not None or y0 is not None:
        # Zeros where a point is not given, and in the padding.
        x0t, y0t = (torch.zeros(size, dtype=dtype, device=dev)
                    for size in (n_op, m_op))
        if x0 is not None:
            x0t[:n] = torch.as_tensor(np.array(x0), dtype=dtype)
        if y0 is not None:
            y0t[:m] = torch.as_tensor(np.array(y0), dtype=dtype)
        if pl is not None:
            # Every rank starts from its slices of rank 0's point (a warm
            # start computed per rank, such as the fishnet's, may differ
            # between them).
            x0t = pl.cut_x(mesh.broadcast(x0t))
            y0t = pl.cut_y(mesh.broadcast(y0t))

    pb, st, t_arrays = _prepare(
        lambda: _device_arrays(arrays_of, dtype, dev, op_cache, layout,
                               mesh),
        mask, seed, x0t, y0t, om0, cfg)
    will_resume = bool(resume and checkpoint_path
                       and os.path.exists(npz_path(checkpoint_path)))
    if mesh is not None:  # rank 0's file decides
        will_resume = mesh.agree(will_resume and mesh.rank == 0, dev)
    if will_resume:
        st = _resumed_state(checkpoint_path, pb, cfg, dtype, dev, pl, st)
    # Never run a chunk when the wall clock was spent by the time the
    # arrays reached the device (where the JAX package checks it).
    budget_spent = shard_mesh.clock_spent(t_arrays - start + time_used,
                                          cfg.time_limit, mesh, dev)

    history = [] if log_history else None

    def probe(st):
        if pl is not None:
            shard_mesh.check_replicated(st, mesh)
        if checkpoint_path is not None:
            # Under a mesh every rank sends its slices; rank 0 writes.
            full = st if pl is None else shard_mesh.gather_state(st, pl)
            if mesh is None or mesh.rank == 0:
                save_state(full, checkpoint_path)
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
    # Fresh and warm states start at t == 0 and blocked chunks exit at a
    # cycle boundary, so every chunk is aligned except the first one after
    # a resume (the checkpoint's t is arbitrary).
    aligned = not will_resume
    if will_resume:
        j_done, status_now = read_ints(st.j, st.status)
        planned = j_done
    elif not budget_spent:
        # The first chunk runs right after preprocessing, with no clock
        # check in between (the JAX package fuses the two).
        planned = min(cfg.max_kkt, chunk)
        chunk = min(chunk * 2, cfg.chunk_kkt_max)
        st = run_chunk(st, pb, planned, cfg, aligned=True)
        j_done, status_now = probe(st)

    timed_out = False
    while status_now == int(Status.RUNNING) and j_done < cfg.max_kkt:
        if shard_mesh.clock_spent(time.perf_counter() - start + time_used,
                                  cfg.time_limit, mesh, dev):
            timed_out = True
            break
        planned = min(cfg.max_kkt, planned + chunk)
        chunk = min(chunk * 2, cfg.chunk_kkt_max)
        # A per-iteration chunk may stop mid-cycle; its runner reads t
        # itself.
        st = run_chunk(st, pb, planned, cfg, aligned=aligned)
        aligned = True
        j_done, status_now = probe(st)

    status = Status(status_now)
    if timed_out and status == Status.RUNNING:
        status = Status.TIME_LIMIT
    elif status == Status.RUNNING:
        # KKT budget exhausted: one last residual evaluation may still
        # declare Solved.
        st = final_eval(st, pb, cfg)

    if pl is not None:
        mesh.held = shard_mesh.vector_bytes(pl, st, pb)
    x, y, obj = _extract(pb, st, use_prev=cfg.step_scheme == "halpern",
                         pl=pl)
    vec = torch.cat([x[:n], y[:m], torch.stack([obj, st.primal_res,
                                                st.dual_res, st.gap])]
                    ).cpu().numpy()
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
