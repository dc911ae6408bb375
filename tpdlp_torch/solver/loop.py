"""The restarted-PDHG loop as blocked restart cycles (counterpart of
tpdlp/solver/loop.py, its vanilla blocked path).

A cycle is `restart_period` PDHG iterations followed by the restart check.
Nothing inside a cycle reads the device: the restart decision and the
SOLVED / NUMERICAL_ERROR status are tensor selects (`torch.where`), as
`lax.cond`/`jnp.where` are in the JAX loop.  The host reads (status, j)
once per cycle boundary, in one small device-to-host copy, which is the
JAX loop's `_chunk_cond`.

KKT-pass ledger (as in the JAX package): j += 1 per step (+= trials under
the line search), += 3 per restart check, += 2 on a restart, += 2 in
`final_eval`.  The budget is checked per cycle, so a chunk may overrun it
by up to one cycle.
"""

from __future__ import annotations

import torch

from tpdlp_torch.config import SolverConfig, Status, fast_step_products
from tpdlp_torch.solver import residuals as R
from tpdlp_torch.solver import step as S
from tpdlp_torch.solver.state import PDHGState

_RUNNING = int(Status.RUNNING)


def primal_weight_update(x_restart, x, y_restart, y, omega, theta_smooth):
    """Log-smoothed primal-weight update:
    omega <- exp(theta log(||dy||/||dx||) + (1-theta) log(omega)),
    guarded on nonzero iterate movement."""
    dx = torch.linalg.vector_norm(x_restart - x)
    dy = torch.linalg.vector_norm(y_restart - y)
    new = torch.exp(
        theta_smooth * torch.log(dy / dx)
        + (1.0 - theta_smooth) * torch.log(omega)
    )
    return torch.where((dx > 0) & (dy > 0), new, omega)


def _clamped_pwu(x_restart, x, y_restart, y, omega, omega_init, cfg):
    """primal_weight_update clamped to cfg.omega_clamp decades around the
    initial omega; no clamp when omega_clamp == 0."""
    new = primal_weight_update(
        x_restart, x, y_restart, y, omega, cfg.theta_smooth
    )
    if not cfg.omega_clamp:
        return new
    return torch.clamp(
        new, omega_init / cfg.omega_clamp, omega_init * cfg.omega_clamp
    )


def _fresh_products(pb, cfg: SolverConfig, x, y, kx, kty):
    """Exact (K x, K'y) for a candidate about to be residual-evaluated:
    recomputed only when the step products take a distinct throughput
    path; otherwise the carried products are exact and pass through."""
    if fast_step_products(cfg) and pb.op.has_fast_products:
        return pb.op.mv(x), pb.op.rmv(y)
    return kx, kty


def _status_code(code, like):
    return torch.full((), int(code), dtype=torch.int32, device=like.device)


def _restart_check(pb, cfg: SolverConfig, st: PDHGState) -> PDHGState:
    """The every-restart_period evaluation plus, on restart, the
    reference's outer-loop tail.  The restart branch is computed always and
    selected with `torch.where` (no host read)."""
    dtype = st.x.dtype

    x_avg = st.x_sum / st.eta_sum
    y_avg = st.y_sum / st.eta_sum
    kx_avg = pb.op.mv(x_avg)
    kty_avg = pb.op.rmv(y_avg)

    kx_cur, kty_cur = _fresh_products(pb, cfg, st.x, st.y, st.kx, st.kty)
    st = st.replace(kx=kx_cur, kty=kty_cur)

    res_cur = R.residuals_scaled(pb, st.x, st.y, st.kx, st.kty)
    res_avg = R.residuals_scaled(pb, x_avg, y_avg, kx_avg, kty_avg)
    res_prev = R.residuals_scaled(pb, st.x_prev, st.y_prev, st.kx_prev,
                                  st.kty_prev)
    kkt_cur = R.kkt_error(res_cur, st.omega)
    kkt_avg = R.kkt_error(res_avg, st.omega)
    kkt_prev = R.kkt_error(res_prev, st.omega)

    st = st.replace(j=st.j + 3)  # three KKT passes per check

    kkt_min = torch.minimum(kkt_cur, kkt_avg)
    use_avg = kkt_cur >= kkt_avg  # candidate choice

    # fp32 divergence gives NaN/Inf iterates whose KKT error satisfies no
    # restart criterion: flag it instead of burning the whole budget.
    diverged = ~(torch.isfinite(kkt_cur) & torch.isfinite(kkt_avg))
    running = st.status == _RUNNING
    st = st.replace(
        status=torch.where(
            diverged & running, _status_code(Status.NUMERICAL_ERROR, st.j),
            st.status,
        )
    )

    sufficient = kkt_min <= cfg.beta_sufficient * st.kkt_first
    necessary = (kkt_min <= cfg.beta_necessary * st.kkt_first) & (
        kkt_min > kkt_prev
    )
    artificial = st.t.to(dtype) >= cfg.beta_artificial * st.k.to(dtype)
    do_restart = (sufficient | necessary | artificial) & ~diverged

    # The restart branch.
    def sel(a, b):
        return torch.where(use_avg, a, b)

    x_r = sel(x_avg, st.x)
    y_r = sel(y_avg, st.y)
    kx_r = sel(kx_avg, st.kx)
    kty_r = sel(kty_avg, st.kty)
    res_r = R.Residuals(
        *(sel(a, b) for a, b in zip(
            (res_avg.primal_res, res_avg.dual_res, res_avg.gap,
             res_avg.prim_obj, res_avg.adjusted_dual),
            (res_cur.primal_res, res_cur.dual_res, res_cur.gap,
             res_cur.prim_obj, res_cur.adjusted_dual),
        ))
    )
    omega_new = (
        _clamped_pwu(st.x_restart, x_r, st.y_restart, y_r, st.omega,
                     st.omega_init, cfg)
        if cfg.primal_weight_update
        else st.omega
    )
    # KKT_first refresh under the (possibly updated) omega: only the
    # weighting changes, so no new product (the +2 below keeps the
    # reference's ledger entries for it and the termination pass).
    kkt_first_new = R.kkt_error(res_r, omega_new)
    res_term = R.residuals_unscaled(pb, x_r, y_r, kx_r, kty_r)
    solved = R.check_termination(
        res_term, pb.q_norm_term, pb.c_norm_term, cfg.tol,
        abs_gap=cfg.abs_gap_termination,
    )
    status_r = torch.where(solved, _status_code(Status.SOLVED, st.j),
                           st.status)

    def on_restart(new, old):
        return torch.where(do_restart, new, old)

    zero = torch.zeros((), dtype=dtype, device=st.x.device)
    return st.replace(
        x=on_restart(x_r, st.x),
        y=on_restart(y_r, st.y),
        kx=on_restart(kx_r, st.kx),
        kty=on_restart(kty_r, st.kty),
        x_sum=on_restart(zero, st.x_sum),
        y_sum=on_restart(zero, st.y_sum),
        eta_sum=on_restart(zero, st.eta_sum),
        x_restart=on_restart(x_r, st.x_restart),
        y_restart=on_restart(y_r, st.y_restart),
        kx_restart=on_restart(kx_r, st.kx_restart),
        kty_restart=on_restart(kty_r, st.kty_restart),
        t=on_restart(torch.zeros_like(st.t), st.t),
        n_restarts=st.n_restarts + do_restart.to(torch.int32),
        omega=on_restart(omega_new, st.omega),
        kkt_first=on_restart(kkt_first_new, st.kkt_first),
        j=st.j + 2 * do_restart.to(torch.int32),
        status=on_restart(status_r, st.status),
        prim_obj=on_restart(res_term.prim_obj, st.prim_obj),
        adjusted_dual=on_restart(res_term.adjusted_dual, st.adjusted_dual),
        primal_res=on_restart(res_term.primal_res, st.primal_res),
        dual_res=on_restart(res_term.dual_res, st.dual_res),
        gap=on_restart(res_term.gap, st.gap),
    )


def make_live(pb, cfg: SolverConfig):
    """One ungated vanilla PDHG iteration without the restart check (the
    blocked runner schedules the check at cycle boundaries)."""
    mv_rmv = S.step_mv(pb, cfg)

    def live_body(st: PDHGState) -> PDHGState:
        k_new = st.k + 1
        if cfg.adaptive:
            result = S.adaptive_step(
                pb, cfg, st.x, st.y, st.kx, st.kty, st.eta, st.omega, k_new
            )
        else:
            result = S.fixed_step(
                pb, cfg, st.x, st.y, st.kx, st.kty, st.eta, st.omega
            )
        x_new, y_new, kx_new, eta_used, eta_next, j_inc = result
        kty_new = mv_rmv[1](y_new)
        # Averaging accumulation; the restart check follows at the
        # cycle boundary.
        return st.replace(
            x=x_new,
            y=y_new,
            kx=kx_new,
            kty=kty_new,
            x_prev=st.x,
            y_prev=st.y,
            kx_prev=st.kx,
            kty_prev=st.kty,
            k=k_new,
            j=st.j + j_inc,
            t=st.t + 1,
            x_sum=st.x_sum + eta_used * x_new,
            y_sum=st.y_sum + eta_used * y_new,
            eta_sum=st.eta_sum + eta_used,
            eta=eta_next,
        )

    return live_body


def blocked_allowed(cfg: SolverConfig) -> bool:
    """True when the blocked loop is what the JAX package runs for `cfg`:
    no per-iteration certificate families, no forced per-iteration loop,
    and a restart period the JAX package unrolls (<= 256)."""
    return (
        cfg.loop_mode != "periter"
        and not cfg.infeasibility_detect
        and not cfg.normalized_certificates
        and cfg.restart_period <= 256
    )


def read_ints(*scalars) -> list[int]:
    """One device-to-host copy of a few int32 scalars."""
    return torch.stack(scalars).tolist()


def run_chunk_blocked_impl(
    st: PDHGState, pb, j_budget: int, cfg: SolverConfig, aligned: bool = False
) -> PDHGState:
    """Run blocked cycles while the status is RUNNING and j < j_budget.

    A state entering mid-cycle (t not a multiple of restart_period) is
    first brought to a cycle boundary one iteration at a time, with the
    restart check where the JAX per-iteration body fires it; `aligned=True`
    asserts the caller's state is at a boundary (fresh states, and every
    state a blocked chunk leaves)."""
    if cfg.step_scheme != "vanilla":
        raise NotImplementedError(
            f"step_scheme={cfg.step_scheme!r} is not ported yet "
            "(ROADMAP.md queue 1 item 11)"
        )
    T = cfg.restart_period
    live = make_live(pb, cfg)
    if not aligned:
        while True:
            status, j, t = read_ints(st.status, st.j, st.t)
            if status != _RUNNING or j >= j_budget or t % T == 0:
                break
            st = live(st)
            if (t + 1) % T == 0:
                st = _restart_check(pb, cfg, st)
    while True:
        status, j = read_ints(st.status, st.j)
        if status != _RUNNING or j >= j_budget:
            return st
        for _ in range(T):
            st = live(st)
        # t is a multiple of T here by construction: the boundary check
        # always fires.
        st = _restart_check(pb, cfg, st)


def run_chunk(
    st: PDHGState, pb, j_budget: int, cfg: SolverConfig, aligned: bool = False
) -> PDHGState:
    """Run iterations until a terminal status or j >= j_budget (blocked
    cycles; the JAX package's per-iteration loop is not ported yet)."""
    if not blocked_allowed(cfg):
        raise NotImplementedError(
            "the per-iteration loop (loop_mode='periter', certificates, "
            "restart_period > 256) is not ported yet (ROADMAP.md queue 1 "
            "item 11)"
        )
    return run_chunk_blocked_impl(st, pb, j_budget, cfg, aligned)


def final_eval(st: PDHGState, pb, cfg: SolverConfig) -> PDHGState:
    """The reference's outer-loop tail on the KKT-budget-exhausted path:
    one last unscaled residual evaluation decides Solved vs 'KKT passes
    limit exceeded'; n and j advance as in the reference."""
    kx_c, kty_c = _fresh_products(pb, cfg, st.x, st.y, st.kx, st.kty)
    res_term = R.residuals_unscaled(pb, st.x, st.y, kx_c, kty_c)
    solved = R.check_termination(
        res_term, pb.q_norm_term, pb.c_norm_term, cfg.tol,
        abs_gap=cfg.abs_gap_termination,
    )
    status_new = torch.where(
        solved, _status_code(Status.SOLVED, st.j),
        _status_code(Status.KKT_LIMIT, st.j),
    )
    return st.replace(
        n_restarts=st.n_restarts + 1,
        j=st.j + 2,
        status=status_new,
        prim_obj=res_term.prim_obj,
        adjusted_dual=res_term.adjusted_dual,
        primal_res=res_term.primal_res,
        dual_res=res_term.dual_res,
        gap=res_term.gap,
    )
