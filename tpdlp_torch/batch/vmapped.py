"""Scenario-batched LP solves: a fleet of LPs per card (counterpart of
tpdlp/batch/vmapped.py, whose name the file keeps).

The JAX package vmaps the whole restarted solver over a stacked batch of
LPs.  Here the batch axis is written out: every vector of the state is
(B, n) or (B, m) and every per-element scalar (status, counters, eta,
omega, the restart metric) a (B, 1) column, so that the solver's
elementwise code (solver/loop.py, step.py, residuals.py, infeasibility.py)
broadcasts unchanged and its reductions go through solver/reduce.py, which
keeps a single solve's exact calls for 1-D data.  Each K product of the
whole fleet is one launch of a kernel's batch axis (ops/_kernels.py), where
the JAX package's vmap runs `pallas_call`'s batching rule.

Three operator layouts:
- a shared K (every instance has the same matrix, the perturbed-fleet
  case): one operator of any layout (`build_device_operator`), one set of
  scaling diagonals and one power iteration for the fleet;
- distinct dense K: a padded (B, m, n) stack over K1's matrix stride
  (batch/stacked.py);
- distinct banded K: one common (B, G, 128, WB) band-slab layout per
  direction over K2's per-element slabs and starts.

Instances of different shapes are zero-padded to the batch maximum with
the exactness-preserving padding (padded rows are inequality rows with 0
rhs and 0 coefficients; padded variables are fixed at 0).  Each element
keeps its own inequality mask, diagonals and termination norms, and every
iteration is gated per element by `status == RUNNING & j < j_budget`, so a
finished element holds its state.

Two restart schedules (`restart_sync`):
- "element": each element's check fires after the iteration that brings
  its t to a multiple of restart_period, as in a single solve; the host
  reads (status, j, t) once per block and ends the block at the first
  element's boundary, so a fleet in step runs one check per cycle.
- "global": checks at global boundaries (every restart_period steps from
  the chunk's start), each element gated by t >= restart_period, the JAX
  lockstep loop; one host read of (status, j) per cycle.

Left out on purpose: `_f64_guard` (the TPU's emulated fp64; ROADMAP.md's
precision rule) and the persistent compilation cache.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.batch.stacked import (
    StackedDenseOp,
    band_stack,
    band_stack_op,
)
from tpdlp_torch.config import SolverConfig, Status
from tpdlp_torch.device import resolve_device
from tpdlp_torch.problem import DeviceProblem, _zeroed_at_inf, as_problem
from tpdlp_torch.scaling.ruiz import scale_problem
from tpdlp_torch.solver import loop as L
from tpdlp_torch.solver.power_iteration import (
    initial_vector,
    spectral_norm_estimate,
)
from tpdlp_torch.solver.reduce import norm
from tpdlp_torch.solver.solve import (
    SolveResult,
    _as_dtype,
    build_device_operator,
    default_dtype,
)
from tpdlp_torch.solver.state import PDHGState
from tpdlp_torch.timer import host_read, span, until_read

_RUNNING = int(Status.RUNNING)

_MIN_COMPACT = 8  # don't compact below this batch size
#: Only compact when the last chunk took at least this long (seconds):
#: a compaction event costs host reads and gathers.
_COMPACT_MIN_CHUNK_WALL = 0.5


def _pad_vectors(problems, np_dtype):
    """(c, q, l, u, mask) host arrays of the fleet, zero-padded to the
    batch maximum: padded variables fixed at 0, padded rows inequalities
    with 0 rhs."""
    m_max = max(p.m for p in problems)
    n_max = max(p.n for p in problems)
    B = len(problems)
    c = np.zeros((B, n_max), np_dtype)
    q = np.zeros((B, m_max), np_dtype)
    l = np.zeros((B, n_max), np_dtype)
    u = np.zeros((B, n_max), np_dtype)
    mask = np.ones((B, m_max), dtype=bool)
    for i, p in enumerate(problems):
        c[i, : p.n] = p.c
        q[i, : p.m] = p.q
        l[i, : p.n] = p.l
        u[i, : p.n] = p.u
        mask[i, : p.m] = np.arange(p.m) < p.m_ineq
    return c, q, l, u, mask


def _shared_K(problems: Sequence) -> bool:
    """True when every instance has the SAME constraint matrix (the
    perturbed-fleet case).  Identity is checked first; structural equality
    only when the total comparison cost is modest."""
    K0 = problems[0].K
    sp0 = sp.issparse(K0)
    nnz0 = K0.nnz if sp0 else K0.size
    if nnz0 * len(problems) > 5 * 10**8:
        return all(p.K is K0 for p in problems[1:])
    C0 = K0.tocsr() if sp0 else np.asarray(K0)
    if sp0:
        C0.sum_duplicates()
    for p in problems[1:]:
        K = p.K
        if K is K0:
            continue
        if sp.issparse(K) != sp0 or K.shape != K0.shape:
            return False
        if sp0:
            C = K.tocsr()
            C.sum_duplicates()
            if (
                C.nnz != C0.nnz
                or not np.array_equal(C.indptr, C0.indptr)
                or not np.array_equal(C.indices, C0.indices)
                or not np.array_equal(C.data, C0.data)
            ):
                return False
        elif not np.array_equal(np.asarray(K), C0):
            return False
    return True


def element_vectors(n: int, seed: int, batch: int, dtype,
                    device) -> torch.Tensor:
    """(B, n) power-iteration starts of a distinct-K fleet, one seed per
    element derived from `seed` (the JAX package splits PRNGKey(seed) into
    B keys).  The parity tests replace this one function with the JAX
    package's draws."""
    seeds = np.random.SeedSequence(int(seed)).generate_state(batch)
    return torch.stack([initial_vector(n, int(s), dtype, device)
                        for s in seeds])


def _spectral_norms(op, b, num_iters: int):
    """(B, 1) ||K_b||_2 estimates: num_iters power iterations of
    b <- K_b'(K_b b) from the (B, n) starts `b`, each element normalised
    by its own norm."""
    for _ in range(num_iters):
        b = op.rmv(op.mv(b))
        b = b / norm(b)
    return norm(op.mv(b))


def _omega0(c_s, q_s):
    """Per-element primal weight ||c||/||q|| of the scaled data, guarded
    (eta_omega_of's rule)."""
    c_norm, q_norm = norm(c_s), norm(q_s)
    return torch.where((q_norm > 1e-6) & (c_norm > 1e-6), c_norm / q_norm,
                       torch.ones_like(c_norm))


def _batch_problem(op, c_s, q_s, l_s, u_s, mask, d_row, d_col, c, q, l, u,
                   cfg: SolverConfig) -> DeviceProblem:
    """The fleet's DeviceProblem: (B, .) vectors, (B, 1) termination
    norms; `op`, d_row and d_col shared or stacked."""
    is_neg_inf = torch.isneginf(l_s)
    is_pos_inf = torch.isposinf(u_s)
    if cfg.compat_scaled_norms:
        q_norm_term, c_norm_term = norm(q_s), norm(c_s)
    else:
        q_norm_term, c_norm_term = norm(q), norm(c)
    return DeviceProblem(
        op=op, c=c_s, q=q_s, l=l_s, u=u_s, ineq_mask=mask,
        is_neg_inf=is_neg_inf, is_pos_inf=is_pos_inf,
        l_dual=_zeroed_at_inf(l_s, is_neg_inf),
        u_dual=_zeroed_at_inf(u_s, is_pos_inf),
        d_row=d_row, d_col=d_col, c0=c, q0=q,
        l0_dual=_zeroed_at_inf(l, is_neg_inf),
        u0_dual=_zeroed_at_inf(u, is_pos_inf),
        q_norm_term=q_norm_term, c_norm_term=c_norm_term,
    )


def _batch_state(pb: DeviceProblem, eta0, omega0) -> PDHGState:
    """init_state for every element: zero iterates, their products (one
    batched launch each), (B, 1) scalars and counters."""
    B, n, m = pb.c.shape[0], pb.n, pb.m
    dtype, dev = pb.c.dtype, pb.c.device

    def zeros(*size):
        return torch.zeros(size, dtype=dtype, device=dev)

    def counter(v=0):
        return torch.full((B, 1), v, dtype=torch.int32, device=dev)

    x, y = zeros(B, n), zeros(B, m)
    kx, kty = pb.op.mv(x), pb.op.rmv(y)
    eta = eta0.expand(B, 1).clone()
    return PDHGState(
        x=x, y=y, kx=kx, kty=kty,
        x_prev=x, y_prev=y, kx_prev=kx, kty_prev=kty,
        lam_prev=zeros(B, n), x_norm_prev=zeros(B, n),
        y_norm_prev=zeros(B, m), x_plain_sum=zeros(B, n),
        y_plain_sum=zeros(B, m), kx_plain_sum=zeros(B, m),
        kty_plain_sum=zeros(B, n),
        x_sum=zeros(B, n), y_sum=zeros(B, m), eta_sum=zeros(B, 1),
        x_restart=x, y_restart=y, kx_restart=kx, kty_restart=kty,
        eta=eta, omega=omega0.clone(), omega_init=omega0.clone(),
        kkt_first=zeros(B, 1), fp_res=zeros(B, 1),
        k=counter(), t=counter(), n_restarts=counter(), j=counter(),
        status=counter(_RUNNING),
        prim_obj=zeros(B, 1), adjusted_dual=zeros(B, 1),
        primal_res=zeros(B, 1), dual_res=zeros(B, 1), gap=zeros(B, 1),
    )


def _shared_init(op, c, q, l, u, mask, seed: int, cfg: SolverConfig):
    """A fleet over ONE operator (the JAX `_shared_init`): Ruiz and
    Pock-Chambolle diagonals depend only on K, so scaling and the
    spectral-norm power iteration run once, on the first element's data,
    and the fleet shares op_s, d_row, d_col and eta; omega is per element."""
    with span("prep.scale"):
        op_s, _, _, _, _, d_row, d_col = scale_problem(
            op, c[0], q[0], l[0], u[0],
            method=cfg.scaling, ruiz_iters=cfg.ruiz_iters,
            ruiz_eps=cfg.ruiz_eps, pc_alpha=cfg.pock_chambolle_alpha,
        )
        if cfg.scaling != "none":
            c_s, q_s, l_s, u_s = c * d_col, q * d_row, l / d_col, u / d_col
        else:
            c_s, q_s, l_s, u_s = c, q, l, u
        pb = _batch_problem(op_s, c_s, q_s, l_s, u_s, mask, d_row, d_col,
                            c, q, l, u, cfg)
    with span("prep.power"):
        eta0 = cfg.eta_safety / spectral_norm_estimate(op_s, seed,
                                                        cfg.power_iters)
    with span("prep.init"):
        return pb, _batch_state(pb, eta0, _omega0(c_s, q_s))


def _stack_init(op, c, q, l, u, mask, seed: int, cfg: SolverConfig):
    """A fleet over a stack of distinct operators (the JAX `_batch_init`
    and `_batch_init_band`): per-element scaling, power iteration (B
    seeds), eta and omega."""
    with span("prep.scale"):
        op_s, c_s, q_s, l_s, u_s, d_row, d_col = scale_problem(
            op, c, q, l, u, method=cfg.scaling, ruiz_iters=cfg.ruiz_iters,
            ruiz_eps=cfg.ruiz_eps, pc_alpha=cfg.pock_chambolle_alpha,
        )
        pb = _batch_problem(op_s, c_s, q_s, l_s, u_s, mask, d_row, d_col,
                            c, q, l, u, cfg)
    with span("prep.power"):
        b0 = element_vectors(pb.n, seed, c.shape[0], c.dtype, c.device)
        eta0 = cfg.eta_safety / _spectral_norms(op_s, b0, cfg.power_iters)
    with span("prep.init"):
        return pb, _batch_state(pb, eta0, _omega0(c_s, q_s))


def _read(*cols) -> np.ndarray:
    """One device-to-host copy of a few (B, 1) int32 columns: (B, k)."""
    with host_read():
        return torch.cat(cols, dim=1).cpu().numpy()


def _steps(st, live, j_budget: int, n: int):
    """n iterations of the fleet, each gated per element by
    `status == RUNNING & j < j_budget` taken at its start.  Returns the
    state and the last iteration's mask."""
    mask = None
    with span("steps"):
        for _ in range(n):
            mask = (st.status == _RUNNING) & (st.j < j_budget)
            st = L._select(mask, live(st), st)
    L.launched["iterations"] += n
    return st, mask


def _chunk_element(st, pb, j_budget: int, cfg: SolverConfig, live, check):
    """"element" schedule: iterations until no element is RUNNING under
    its budget.  A block ends at the first element's cycle boundary (or
    once every active element has spent the budget); the check then fires
    for the elements whose last iteration ran and brought t to a multiple
    of restart_period, the JAX per-iteration body's condition."""
    T = cfg.restart_period
    per_step = 2 if cfg.infeasibility_detect else 1
    while True:
        status, j, t = _read(st.status, st.j, st.t).T
        active = (status == _RUNNING) & (j < j_budget)
        if not active.any():
            return st
        left = int((T - t[active] % T).min())
        spend = int((-(-(j_budget - j[active]) // per_step)).max())
        n = min(left, spend)
        st, mask = _steps(st, live, j_budget, n)
        if n == left:
            with span("check", st.x.device):
                fire = mask & (st.status == _RUNNING) & (st.t % T == 0)
                st = L._select(fire, check(pb, cfg, st), st)
            L.launched["restart_checks"] += 1


def _chunk_global(st, pb, j_budget: int, cfg: SolverConfig, live, check):
    """"global" schedule (the JAX `_batch_chunk_sync`): blocks of
    restart_period gated steps from the chunk's start, each followed by
    the check for the elements with t >= restart_period, RUNNING and under
    the budget; until no RUNNING element is under the budget.  The JAX
    loop tests that condition before every step: once it fails every step
    is masked and the check fires nowhere, so testing it per block gives
    the same state."""
    T = cfg.restart_period
    while True:
        status, j = _read(st.status, st.j).T
        running = status == _RUNNING
        if not running.any() or j[running].min() >= j_budget:
            return st
        st, _ = _steps(st, live, j_budget, T)
        with span("check", st.x.device):
            fire = ((st.t >= T) & (st.status == _RUNNING)
                    & (st.j < j_budget))
            st = L._select(fire, check(pb, cfg, st), st)
        L.launched["restart_checks"] += 1


def _take_state(st: PDHGState, sel) -> PDHGState:
    return PDHGState(**{name: getattr(st, name)[sel] for name in L._FIELDS})


def _take_problem(pb: DeviceProblem, sel) -> DeviceProblem:
    """The elements `sel` of the fleet's problem: a shared operator and
    shared diagonals stay whole."""
    kw = {}
    for name in pb.__dataclass_fields__:
        v = getattr(pb, name)
        if name == "op":
            kw[name] = v.take(sel) if hasattr(v, "take") else v
        elif name in ("d_row", "d_col") and v.dim() == 1:
            kw[name] = v
        else:
            kw[name] = v[sel]
    return DeviceProblem(**kw)


def _gather_results(st, pb, idx, cfg: SolverConfig, np_dtype):
    """Result data of the slots `idx`, in one device-to-host copy: x and y
    unscaled, c0, and (status, k, n, j, primal_res, dual_res, gap)."""
    sel = torch.as_tensor(np.asarray(idx, np.int64), device=pb.c.device)
    use_prev = cfg.step_scheme == "halpern"
    d_col = pb.d_col[sel] if pb.d_col.dim() == 2 else pb.d_col
    d_row = pb.d_row[sel] if pb.d_row.dim() == 2 else pb.d_row
    x = d_col * (st.x_prev if use_prev else st.x)[sel]
    y = d_row * (st.y_prev if use_prev else st.y)[sel]
    parts = [x, y, pb.c0[sel]] + [
        getattr(st, f)[sel] for f in ("status", "k", "n_restarts", "j",
                                      "primal_res", "dual_res", "gap")]
    flat = torch.cat([p.to(torch.float64) for p in parts], dim=1)
    with host_read():
        host = flat.cpu().numpy()
    n, m = pb.n, pb.m
    x_h = host[:, :n].astype(np_dtype)
    y_h = host[:, n:n + m].astype(np_dtype)
    c0_h = host[:, n + m:2 * n + m].astype(np_dtype)
    tail = host[:, 2 * n + m:]
    return [(x_h[i], y_h[i], c0_h[i], *tail[i]) for i in range(len(idx))]


def solve_batch(
    problems: Sequence,
    config: SolverConfig = SolverConfig(),
    *,
    dtype=None,
    seed: int = 0,
    restart_sync: str = "element",
    compact: bool = True,
    matrix_format: str = "dense",
    shared_operator: str | bool = "auto",
    device=None,
) -> list[SolveResult]:
    """Solve a batch of LPs together on one device (the JAX
    `solve_batch`'s signature and defaults, plus `device`: None means
    CUDA, "cpu" the CPU).

    `shared_operator` ("auto" | True | False): when every instance has the
    SAME constraint matrix, the fleet shares ONE operator, its scaling
    diagonals and its power iteration.  "auto" detects the case; True
    asserts it (ValueError if the matrices differ); False forces the
    per-element stack.

    `matrix_format` ("dense" | "sparse" | "band" | "auto"): the shared
    operator takes any layout.  Distinct-K fleets take "dense" (a padded
    stack) and "band" (one common slab layout); "auto" picks band when
    every instance is band-like and the slab stack is under half the
    dense stack, else dense.

    `restart_sync`: "element" (each element's check on its own
    t % restart_period schedule: single-solve trajectories) or "global"
    (checks at global boundaries with a per-element >= restart_period
    gate: fewer checks, a slightly looser cadence).

    `compact`: when at least half the batch has terminated at a chunk
    boundary (and the last chunk took at least `_COMPACT_MIN_CHUNK_WALL`
    seconds), finished elements are gathered and the batch shrinks to the
    next power of two of the running count (at least `_MIN_COMPACT`),
    padded with finished elements.  An element's result does not depend on
    the batch it runs in: every kernel's element b equals a single launch
    on it, bit for bit.
    """
    start = time.perf_counter()
    # Preprocessing's wall, its device work included: to the end of the
    # first host read, which waits for it.
    until_read("prep")
    cfg = config
    if restart_sync not in ("element", "global"):
        raise ValueError(f"unknown restart_sync: {restart_sync!r}")
    problems = [as_problem(p) for p in problems]
    for p in problems:
        p.validate()
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else _as_dtype(dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    m_max = max(p.m for p in problems)
    n_max = max(p.n for p in problems)
    if shared_operator not in ("auto", True, False):
        raise ValueError(f"unknown shared_operator: {shared_operator!r}")
    if isinstance(shared_operator, bool):
        shared = shared_operator
        if shared and not _shared_K(problems):
            raise ValueError(
                "shared_operator=True but the instances' constraint "
                "matrices differ; use shared_operator='auto' or False"
            )
    else:
        shared = len(problems) > 1 and _shared_K(problems)
    band_probe = None
    if not shared and matrix_format == "auto":
        # Stacked band slabs when every instance is band-like AND the slab
        # stack is under half the dense stack; dense otherwise.
        try:
            band_probe = band_stack(problems, dtype, m_max, n_max)
            slab_elems = band_probe[0][0].size + band_probe[1][0].size
            matrix_format = (
                "band"
                if slab_elems < 0.5 * len(problems) * m_max * n_max
                else "dense"
            )
        except ValueError:
            band_probe = None
            matrix_format = "dense"
    if not shared and matrix_format not in ("dense", "band"):
        raise ValueError(
            f"matrix_format={matrix_format!r} requires a shared-operator "
            "batch (identical K across instances); per-element distinct-K "
            "batches support 'dense', 'band' (common slab shapes after "
            "padding) and 'auto' only"
        )

    with span("prep.operator"):
        c, q, l, u, mask = (torch.as_tensor(a, device=dev)
                            for a in _pad_vectors(problems, np_dtype))
        if shared:
            op, *_ = build_device_operator(problems[0], dtype,
                                           matrix_format, dev)
        elif matrix_format == "band":
            stack = band_probe or band_stack(problems, dtype, m_max, n_max)
            op = band_stack_op(stack, m_max, n_max, dev)
            del stack, band_probe
        else:
            op = StackedDenseOp.from_problems(problems, m_max, n_max, dtype,
                                              dev)
    init = _shared_init if shared else _stack_init
    pbs, sts = init(op, c, q, l, u, mask, seed, cfg)
    del op

    chunk = cfg.chunk_kkt_init
    chunk_fn = _chunk_global if restart_sync == "global" else _chunk_element
    check = L._restart_for(cfg)
    live = L.make_live(pbs, cfg)
    timed_out = False
    orig = np.arange(len(problems))  # original problem index of each slot
    done: dict = {}  # original index -> gathered result tuple
    last_chunk_wall = 0.0
    t_dispatch: Optional[float] = None
    while True:
        # One host read of (status, j) per chunk; it waits for the chunk,
        # so it also ends the chunk's wall.
        statuses, js = _read(sts.status, sts.j).T
        if t_dispatch is not None:
            last_chunk_wall = time.perf_counter() - t_dispatch
        running = statuses == _RUNNING
        if not running.any() or js[running].min() >= cfg.max_kkt:
            break
        if time.perf_counter() - start >= cfg.time_limit:
            timed_out = True
            break

        n_run = int(running.sum())
        target = max(_MIN_COMPACT, 1 << max(0, (n_run - 1)).bit_length())
        if (
            compact
            and target <= len(statuses) // 2
            and last_chunk_wall >= _COMPACT_MIN_CHUNK_WALL
        ):
            with span("compact"):
                fin_idx = np.flatnonzero(~running)
                new_fin = [i for i in fin_idx if orig[i] not in done]
                if new_fin:
                    for i, vals in zip(new_fin, _gather_results(
                            sts, pbs, new_fin, cfg, np_dtype)):
                        done[int(orig[i])] = vals
                run_idx = np.flatnonzero(running)
                pad = fin_idx[: target - run_idx.size]  # no-op slots
                sel_np = np.concatenate([run_idx, pad])
                sel = torch.as_tensor(sel_np.astype(np.int64), device=dev)
                sts = _take_state(sts, sel)
                pbs = _take_problem(pbs, sel)
                live = L.make_live(pbs, cfg)
                orig = orig[sel_np]
                js = js[sel_np]
                running = running[sel_np]

        budget = min(cfg.max_kkt, int(js[running].min()) + chunk)
        t_dispatch = time.perf_counter()
        sts = chunk_fn(sts, pbs, budget, cfg, live, check)
        chunk = min(chunk * 2, cfg.chunk_kkt_max)

    with span("finish"):
        if not timed_out:
            # Budget-exhausted elements get the reference's final residual
            # evaluation (it may still declare Solved); on a timeout they
            # stay RUNNING and map to TIME_LIMIT below.
            sts = L._select(sts.status == _RUNNING,
                            L.final_eval(sts, pbs, cfg), sts)
        elapsed = time.perf_counter() - start

        rest = [i for i in range(len(orig)) if int(orig[i]) not in done]
        if rest:
            for i, vals in zip(rest, _gather_results(sts, pbs, rest, cfg,
                                                     np_dtype)):
                done[int(orig[i])] = vals

        results = []
        for gi, p in enumerate(problems):
            (x_row, y_row, c0_row, status_v, k_v, n_v, j_v, rp_v, rd_v,
             gap_v) = done[gi]
            status = Status(int(status_v))
            if timed_out and status == Status.RUNNING:
                status = Status.TIME_LIMIT
            x = x_row[: p.n]
            results.append(SolveResult(
                x=np.array(x),
                y=np.array(y_row[: p.m]),
                objective=float(c0_row[: p.n] @ x) + p.obj_offset,
                obj_offset=p.obj_offset,
                objective_sense=p.objsense,
                iterations=int(k_v),
                restarts=int(n_v),
                kkt_passes=int(j_v),
                status=status,
                solve_time=elapsed,
                primal_res=float(rp_v),
                dual_res=float(rd_v),
                gap=float(gap_v),
            ))
        return results
