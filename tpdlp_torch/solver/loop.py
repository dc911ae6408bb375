"""The restarted-PDHG loop (counterpart of tpdlp/solver/loop.py): the
vanilla and Halpern iterations with their infeasibility certificates, the
two restart checks, and the blocked and per-iteration chunk runners.

Nothing inside a restart cycle reads the device.  The restart decision, the
certificates and the SOLVED / NUMERICAL_ERROR status are tensor selects
(`torch.where`), as `lax.cond`/`jnp.where` are in the JAX loop.  The host
reads a few int32 counters in one small device-to-host copy at most once
per restart cycle, which is the JAX loop's `_chunk_cond`.

Two runners, as in the JAX package:
- blocked: `restart_period` ungated iterations, then the restart check.
  Legal when nothing inside a cycle can change the status
  (`blocked_allowed`); the budget is checked per cycle, so a chunk may
  overrun it by up to one cycle.
- per-iteration: each iteration is gated by a mask taken at its start,
  `status == RUNNING & j < j_budget`, and the new state is selected field
  by field, so a masked iteration is a no-op, as the JAX body is once its
  while condition fails.  The host places the restart check after every
  iteration that brings t to a multiple of `restart_period` (t advances by
  one per unmasked iteration, and a restart resets it only where it is
  already such a multiple), gated by the mask and by the status.  The state
  that results is the JAX per-iteration loop's, and the chunk stops exactly
  at its budget.  A certificate that fires mid-cycle leaves the rest of the
  cycle to run masked: those iterations still issue their K products.

KKT-pass ledger (as in the JAX package): j += 1 per step (+= trials under
the line search), += 1 per ray-certificate check (from k = 2 on), += 3 per
vanilla restart check (2 under Halpern), += 2 on a restart, += 2 in
`final_eval`.
"""

from __future__ import annotations

import dataclasses

import torch

from tpdlp_torch.config import SolverConfig, Status, fast_step_products
from tpdlp_torch.solver import residuals as R
from tpdlp_torch.solver import step as S
from tpdlp_torch.solver.infeasibility import (
    average_gen,
    cone_of,
    detect_gen,
    iterate_gen,
    keep_validated,
    project_to_cone,
    validate_gen,
)
from tpdlp_torch.solver.reduce import reduce, staged
from tpdlp_torch.solver.state import PDHGState

_RUNNING = int(Status.RUNNING)
_FIELDS = tuple(f.name for f in dataclasses.fields(PDHGState))

#: Iterations and restart checks the runners have issued to the device,
#: masked ones included (each issues its K products whether or not it
#: counts in k).  Like `ops._kernels.launches`, for launch accounting.
launched = {"iterations": 0, "restart_checks": 0}


def reset_launched() -> None:
    for name in launched:
        launched[name] = 0


def _pwu_terms(x_restart, x, y_restart, y) -> list:
    """The two norms of the primal-weight update, as requests."""
    return [("norm", "x", x_restart - x), ("norm", "y", y_restart - y)]


def _pwu_from(dx, dy, omega, theta_smooth):
    """Log-smoothed primal-weight update from ||dx|| and ||dy||:
    omega <- exp(theta log(||dy||/||dx||) + (1-theta) log(omega)),
    guarded on nonzero iterate movement."""
    new = torch.exp(
        theta_smooth * torch.log(dy / dx)
        + (1.0 - theta_smooth) * torch.log(omega)
    )
    return torch.where((dx > 0) & (dy > 0), new, omega)


def _clamped(new, omega_init, cfg):
    """The updated primal weight clamped to cfg.omega_clamp decades around
    the initial omega; no clamp when omega_clamp == 0."""
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


def _select(mask, new: PDHGState, old: PDHGState) -> PDHGState:
    """`new` where the 0-d bool `mask` holds, else `old`, field by field;
    a field that `new` shares with `old` needs no select."""
    out = {}
    for name in _FIELDS:
        a, b = getattr(new, name), getattr(old, name)
        out[name] = a if a is b else torch.where(mask, a, b)
    return PDHGState(**out)


def _flag_divergence(st: PDHGState, kkt_a, kkt_b):
    """fp32 divergence gives NaN/Inf iterates whose KKT error satisfies no
    restart criterion: flag it instead of burning the whole budget.
    Returns (state, diverged)."""
    diverged = ~(torch.isfinite(kkt_a) & torch.isfinite(kkt_b))
    status = torch.where(
        diverged & (st.status == _RUNNING),
        _status_code(Status.NUMERICAL_ERROR, st.j), st.status,
    )
    return st.replace(status=status), diverged


def _restart_to(pb, cfg, st, do_restart, x_r, y_r, kx_r, kty_r,
                res_r=None, **extra):
    """On `do_restart`, move to the candidate (x_r, y_r): the reference's
    outer-loop tail (reset averages and the restart point, the new primal
    weight, termination on the unscaled problem, j += 2).  `res_r`: the
    candidate's scaled residuals, whose KKT error under the new weight
    becomes kkt_first; `extra` gives further fields their restart values.
    Both branches are computed and selected (no host read); the new
    weight's and the termination's reductions share one `reduce`."""
    reqs = R.unscaled_terms(pb, x_r, y_r, kx_r, kty_r)
    if cfg.primal_weight_update:
        reqs += _pwu_terms(st.x_restart, x_r, st.y_restart, y_r)
    vals = reduce(pb.red, *reqs)
    res_term = R.residuals_from(vals[:6])
    omega_new = st.omega
    if cfg.primal_weight_update:
        omega_new = _clamped(_pwu_from(*vals[6:], st.omega,
                                       cfg.theta_smooth),
                             st.omega_init, cfg)
    if res_r is not None:
        # KKT_first refresh under the (possibly updated) omega: only the
        # weighting changes, so no new product (the +2 of a restart keeps
        # the reference's ledger entries for it and the termination pass).
        extra["kkt_first"] = R.kkt_error(res_r, omega_new)
    solved = R.check_termination(
        res_term, pb.q_norm_term, pb.c_norm_term, cfg.tol,
        abs_gap=cfg.abs_gap_termination,
    )
    zero = torch.zeros((), dtype=st.x.dtype, device=st.x.device)
    new = dict(
        x=x_r, y=y_r, kx=kx_r, kty=kty_r,
        x_sum=zero, y_sum=zero, eta_sum=zero,
        x_restart=x_r, y_restart=y_r, kx_restart=kx_r, kty_restart=kty_r,
        t=torch.zeros_like(st.t),
        omega=omega_new,
        status=torch.where(solved, _status_code(Status.SOLVED, st.j),
                           st.status),
        prim_obj=res_term.prim_obj, adjusted_dual=res_term.adjusted_dual,
        primal_res=res_term.primal_res, dual_res=res_term.dual_res,
        gap=res_term.gap,
    )
    step = do_restart.to(torch.int32)
    return st.replace(
        **{name: torch.where(do_restart, v, getattr(st, name))
           for name, v in {**new, **extra}.items()},
        n_restarts=st.n_restarts + step,
        j=st.j + 2 * step,
    )


def _residuals(pb, *points):
    """Scaled residuals of each (x, y, kx, kty) point, their reductions in
    one `reduce`."""
    vals = reduce(pb.red, *(t for p in points
                            for t in R.scaled_terms(pb, *p)))
    return [R.residuals_from(vals[6 * i:6 * i + 6])
            for i in range(len(points))]


def _restart_check(pb, cfg: SolverConfig, st: PDHGState) -> PDHGState:
    """The every-restart_period evaluation of the vanilla scheme (three
    candidates: current, average, previous) plus, on restart, the
    reference's outer-loop tail."""
    dtype = st.x.dtype

    x_avg = st.x_sum / st.eta_sum
    y_avg = st.y_sum / st.eta_sum
    kx_avg = pb.op.mv(x_avg)
    kty_avg = pb.op.rmv(y_avg)

    kx_cur, kty_cur = _fresh_products(pb, cfg, st.x, st.y, st.kx, st.kty)
    st = st.replace(kx=kx_cur, kty=kty_cur)

    res_cur, res_avg, res_prev = _residuals(
        pb, (st.x, st.y, st.kx, st.kty), (x_avg, y_avg, kx_avg, kty_avg),
        (st.x_prev, st.y_prev, st.kx_prev, st.kty_prev))
    kkt_cur = R.kkt_error(res_cur, st.omega)
    kkt_avg = R.kkt_error(res_avg, st.omega)
    kkt_prev = R.kkt_error(res_prev, st.omega)

    st = st.replace(j=st.j + 3)  # three KKT passes per check

    kkt_min = torch.minimum(kkt_cur, kkt_avg)
    use_avg = kkt_cur >= kkt_avg  # candidate choice
    st, diverged = _flag_divergence(st, kkt_cur, kkt_avg)

    sufficient = kkt_min <= cfg.beta_sufficient * st.kkt_first
    necessary = (kkt_min <= cfg.beta_necessary * st.kkt_first) & (
        kkt_min > kkt_prev
    )
    artificial = st.t.to(dtype) >= cfg.beta_artificial * st.k.to(dtype)
    do_restart = (sufficient | necessary | artificial) & ~diverged

    def sel(a, b):
        return torch.where(use_avg, a, b)

    res_r = R.Residuals(
        *(sel(a, b) for a, b in zip(
            (res_avg.primal_res, res_avg.dual_res, res_avg.gap,
             res_avg.prim_obj, res_avg.adjusted_dual),
            (res_cur.primal_res, res_cur.dual_res, res_cur.gap,
             res_cur.prim_obj, res_cur.adjusted_dual),
        ))
    )
    x_r, y_r = sel(x_avg, st.x), sel(y_avg, st.y)
    return _restart_to(
        pb, cfg, st, do_restart, x_r, y_r, sel(kx_avg, st.kx),
        sel(kty_avg, st.kty), res_r,
    )


def _restart_check_halpern(pb, cfg: SolverConfig, st: PDHGState) -> PDHGState:
    """Restart evaluation for the Halpern scheme.

    The carried z iterate may lie outside the box, so the candidates are the
    last feasible PDHG output (the *_prev slots) and the running average of
    feasible outputs.  The 'necessary' criterion is dropped; the sufficient
    one compares the fixed-point residual with its value at the cycle's
    first iteration (kept in kkt_first).  On restart the anchor, the z
    iterate and the feasible-output slots all reset to the candidate."""
    dtype = st.x.dtype
    x_f, y_f = st.x_prev, st.y_prev
    kx_f, kty_f = _fresh_products(pb, cfg, x_f, y_f, st.kx_prev,
                                  st.kty_prev)
    x_avg = st.x_sum / st.eta_sum
    y_avg = st.y_sum / st.eta_sum
    kx_avg = pb.op.mv(x_avg)
    kty_avg = pb.op.rmv(y_avg)

    res_f, res_avg = _residuals(pb, (x_f, y_f, kx_f, kty_f),
                                (x_avg, y_avg, kx_avg, kty_avg))
    kkt_f = R.kkt_error(res_f, st.omega)
    kkt_avg = R.kkt_error(res_avg, st.omega)
    st = st.replace(j=st.j + 2)

    use_avg = kkt_f >= kkt_avg
    st, diverged = _flag_divergence(st, kkt_f, kkt_avg)
    sufficient = (st.kkt_first > 0) & (
        st.fp_res <= cfg.beta_sufficient * st.kkt_first
    )
    artificial = st.t.to(dtype) >= cfg.beta_artificial * st.k.to(dtype)
    do_restart = (sufficient | artificial) & ~diverged

    def sel(a, b):
        return torch.where(use_avg, a, b)

    x_r, y_r = sel(x_avg, x_f), sel(y_avg, y_f)
    kx_r, kty_r = sel(kx_avg, kx_f), sel(kty_avg, kty_f)
    zero = torch.zeros((), dtype=dtype, device=st.x.device)
    return _restart_to(
        pb, cfg, st, do_restart, x_r, y_r, kx_r, kty_r,
        x_prev=x_r, y_prev=y_r, kx_prev=kx_r, kty_prev=kty_r,
        # Re-measured at the first iteration of the new cycle.
        kkt_first=zero, fp_res=zero,
    )


def _restart_for(cfg: SolverConfig):
    return (_restart_check_halpern if cfg.step_scheme == "halpern"
            else _restart_check)


def _certify(pb, cfg: SolverConfig, cone, st2, k_new, x_new, y_new,
             kx_new, kty_new, x_old, y_old, kx_old, kty_old):
    """Both certificate families on a feasible iterate pair: the rays of
    the (new, old) difference and of the difference from the restart point,
    then the normalized-iterate and normalized-average families.  Shared by
    the vanilla and Halpern iterations, which differ only in which pair is
    feasible.  `cone`: `cone_of(pb, cfg.infeas_tol)`.  Every test runs
    side by side (`staged`): two rounds of reductions in all."""
    tol = cfg.infeas_tol
    gens = []
    if cfg.infeasibility_detect:
        lam = project_to_cone(cone, pb.c - kty_new)
        # The restart-window ray: adaptive steps make consecutive diffs
        # noisy, and the diff from the last restart point averages that
        # out.  Its products and lambda come from the carried restart
        # products: no K product.
        lam_restart = project_to_cone(cone, pb.c - st2.kty_restart)
        gens += [
            detect_gen(pb, x_new, y_new, x_old, y_old, lam, st2.lam_prev,
                       kx_new - kx_old, kty_new - kty_old, tol, cone),
            detect_gen(pb, x_new, y_new, st2.x_restart, st2.y_restart, lam,
                       lam_restart, kx_new - st2.kx_restart,
                       kty_new - st2.kty_restart, tol, cone),
        ]
    if cfg.normalized_certificates:
        xs = st2.x_plain_sum + x_new
        ys = st2.y_plain_sum + y_new
        kxs = st2.kx_plain_sum + kx_new
        ktys = st2.kty_plain_sum + kty_new
        conv, nonzero = cfg.normalized_tol_conv, cfg.normalized_tol_nonzero
        gens += [
            iterate_gen(x_new, y_new, st2.x_norm_prev, st2.y_norm_prev,
                        k_new, conv, nonzero, cone),
            # Rays are normalised inside, so the iterate and its carried
            # products stand in for x/k and Kx/k.
            validate_gen(pb, x_new, kx_new, y_new, kty_new, tol, cone),
            average_gen(xs, ys, x_new, y_new, k_new, conv, nonzero, cone),
            validate_gen(pb, xs, kxs, ys, ktys, tol, cone),
        ]
    out = staged(pb.red, *gens)

    if cfg.infeasibility_detect:
        cert, cert_win = out[:2]
        out = out[2:]
        cert = torch.where(cert != _RUNNING, cert, cert_win)
        # Needs two iterates (the reference's k > 1 guard), which also
        # gates lam_prev and the KKT pass.
        fire = k_new > 1
        st2 = st2.replace(
            lam_prev=torch.where(fire, lam, st2.lam_prev),
            j=st2.j + fire.to(torch.int32),
            status=torch.where(fire & (cert != _RUNNING), cert, st2.status),
        )

    if cfg.normalized_certificates:
        (cert, x_norm, y_norm), oks, cert_avg, oks_avg = out
        cert = keep_validated(cert, oks, cone)
        cert_avg = keep_validated(cert_avg, oks_avg, cone)
        fireable = k_new > 2  # both families need two history points
        status = torch.where(
            (cert != _RUNNING) & fireable, cert,
            torch.where((cert_avg != _RUNNING) & fireable, cert_avg,
                        st2.status),
        )
        st2 = st2.replace(
            x_norm_prev=x_norm, y_norm_prev=y_norm,
            x_plain_sum=xs, y_plain_sum=ys,
            kx_plain_sum=kxs, kty_plain_sum=ktys,
            status=status,
        )
    return st2


def make_live(pb, cfg: SolverConfig):
    """One ungated PDHG iteration of cfg.step_scheme, certificates included
    and without the restart check (the runners schedule it).  Halpern with
    the adaptive rule raises the JAX package's ValueError."""
    cone = (cone_of(pb, cfg.infeas_tol)
            if cfg.infeasibility_detect or cfg.normalized_certificates
            else None)
    halpern = cfg.step_scheme == "halpern"

    def take_step(st: PDHGState, k_new):
        """The configured step, K'y of its output (feasible) included;
        under Halpern with its dx'dx and dy'dy."""
        if cfg.adaptive:
            return S.adaptive_step(
                pb, cfg, st.x, st.y, st.kx, st.kty, st.eta, st.omega, k_new
            )
        return S.fixed_step(
            pb, cfg, st.x, st.y, st.kx, st.kty, st.eta, st.omega,
            dots=halpern,
        )

    def live_body(st: PDHGState) -> PDHGState:
        k_new = st.k + 1
        result = take_step(st, k_new)
        x_new, y_new, kx_new, eta_used, eta_next, j_inc, kty_new, _ = (
            result)
        st2 = st.replace(
            x=x_new, y=y_new, kx=kx_new, kty=kty_new,
            x_prev=st.x, y_prev=st.y, kx_prev=st.kx, kty_prev=st.kty,
            k=k_new, j=st.j + j_inc,
        )
        st2 = _certify(pb, cfg, cone, st2, k_new, x_new, y_new, kx_new,
                       kty_new, st.x, st.y, st.kx, st.kty)
        # Averaging accumulation; the restart check follows at the cycle
        # boundary.
        return st2.replace(
            t=st2.t + 1,
            x_sum=st2.x_sum + eta_used * x_new,
            y_sum=st2.y_sum + eta_used * y_new,
            eta_sum=st2.eta_sum + eta_used,
            eta=eta_next,
        )

    def live_body_halpern(st: PDHGState) -> PDHGState:
        """One reflected-Halpern iteration.  The carry (x, y, kx, kty) is
        the anchored point z_t, possibly outside the box; the PDHG step
        T(z_t) is feasible and is what the certificates, the averages and
        the restart candidates use (held in the *_prev slots)."""
        k_new = st.k + 1
        result = take_step(st, k_new)
        x_f, y_f, kx_f, eta_used, eta_next, j_inc, kty_f, dots = result
        st2 = st.replace(k=k_new, j=st.j + j_inc)
        st2 = _certify(pb, cfg, cone, st2, k_new, x_f, y_f, kx_f, kty_f,
                       st.x_prev, st.y_prev, st.kx_prev, st.kty_prev)

        # The anchored combination of the reflected step: linear in the
        # carried products, so no K product.
        t_new = st.t + 1
        tf = t_new.to(st.x.dtype)
        w = tf / (tf + 1.0)
        wa = 1.0 / (tf + 1.0)
        z_x = w * (2.0 * x_f - st.x) + wa * st.x_restart
        z_y = w * (2.0 * y_f - st.y) + wa * st.y_restart
        z_kx = w * (2.0 * kx_f - st.kx) + wa * st.kx_restart
        z_kty = w * (2.0 * kty_f - st.kty) + wa * st.kty_restart

        # The omega-weighted fixed-point residual ||z - T(z)||, from the
        # step's exact dots dx'dx and dy'dy (dx = x_f - z_x; neither
        # torch.dot nor a row sum takes a TF32 path); its value at t == 1
        # is the cycle's baseline (kkt_first).
        dxdx, dydy = dots
        fp = torch.sqrt(st.omega * dxdx + dydy / st.omega)
        return st2.replace(
            fp_res=fp,
            kkt_first=torch.where(t_new == 1, fp, st2.kkt_first),
            x=z_x, y=z_y, kx=z_kx, kty=z_kty,
            x_prev=x_f, y_prev=y_f, kx_prev=kx_f, kty_prev=kty_f,
            t=t_new,
            x_sum=st2.x_sum + eta_used * x_f,
            y_sum=st2.y_sum + eta_used * y_f,
            eta_sum=st2.eta_sum + eta_used,
            eta=eta_next,
        )

    if cfg.step_scheme == "halpern":
        if cfg.adaptive:
            raise ValueError(
                "step_scheme='halpern' requires adaptive=False: the "
                "Malitsky-Pock stepsize rule is incompatible with the "
                "anchored reflected iteration (it stalls); the scheme is "
                "designed for the fixed eta = 0.9/||K|| step"
            )
        return live_body_halpern
    if cfg.step_scheme == "vanilla":
        return live_body
    raise ValueError(f"unknown step_scheme: {cfg.step_scheme!r}")


def make_body(pb, cfg: SolverConfig):
    """One PDHG iteration as a state transition (the JAX `make_body`): a
    no-op once the status is terminal, and the restart check where the
    iteration brings t to a multiple of `restart_period`, both as tensor
    selects (the restart check's products are issued either way)."""
    live = make_live(pb, cfg)
    check = _restart_for(cfg)

    def body(st: PDHGState) -> PDHGState:
        running = st.status == _RUNNING
        st = _select(running, live(st), st)
        fire = (running & (st.t % cfg.restart_period == 0)
                & (st.status == _RUNNING))
        return _select(fire, check(pb, cfg, st), st)

    return body


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


def _masked_block(st: PDHGState, pb, cfg: SolverConfig, live, j_budget: int,
                  n: int, left: int) -> PDHGState:
    """n gated iterations, then, when they reach the cycle boundary (n ==
    left, the iterations left in the cycle), the gated restart check.  The
    mask is monotone: once an iteration is masked, every later one is
    too."""
    for _ in range(n):
        mask = (st.status == _RUNNING) & (st.j < j_budget)
        st = _select(mask, live(st), st)
    launched["iterations"] += n
    if n == left:
        fire = mask & (st.status == _RUNNING)
        st = _select(fire, _restart_for(cfg)(pb, cfg, st), st)
        launched["restart_checks"] += 1
    return st


def _next_block(st: PDHGState, j_budget: int, cfg: SolverConfig):
    """(n, left) of the next masked block, or None when the chunk is done:
    one host read of (status, j, t).  left is the number of iterations to
    the cycle boundary.  The block stops there, or after the iterations
    that spend the budget at the ledger's usual rate (one KKT pass per
    step, two with the ray certificates), so that a chunk's end issues no
    masked iteration.  Any n <= left gives the same state: the next block
    reads the counters again."""
    status, j, t = read_ints(st.status, st.j, st.t)
    if status != _RUNNING or j >= j_budget:
        return None
    left = cfg.restart_period - t % cfg.restart_period
    per_step = 2 if cfg.infeasibility_detect else 1
    return min(left, -(-(j_budget - j) // per_step)), left


def run_chunk_periter_impl(st: PDHGState, pb, j_budget: int,
                           cfg: SolverConfig) -> PDHGState:
    """Per-iteration chunk: iterations until a terminal status or
    j >= j_budget, exactly (see the module docstring).  The entry state may
    be mid-cycle."""
    live = make_live(pb, cfg)
    while (block := _next_block(st, j_budget, cfg)):
        st = _masked_block(st, pb, cfg, live, j_budget, *block)
    return st


def run_chunk_blocked_impl(
    st: PDHGState, pb, j_budget: int, cfg: SolverConfig, aligned: bool = False
) -> PDHGState:
    """Run blocked cycles while the status is RUNNING and j < j_budget.

    A state entering mid-cycle (t not a multiple of restart_period) is
    first brought to the cycle boundary by one masked block, with the
    restart check where the JAX per-iteration body fires it;
    `aligned=True` asserts the caller's state is at a boundary (fresh
    states, and every state a blocked chunk leaves)."""
    T = cfg.restart_period
    live = make_live(pb, cfg)
    check = _restart_for(cfg)
    if not aligned:
        while (block := _next_block(st, j_budget, cfg)) and block[1] != T:
            st = _masked_block(st, pb, cfg, live, j_budget, *block)
    while True:
        status, j = read_ints(st.status, st.j)
        if status != _RUNNING or j >= j_budget:
            return st
        for _ in range(T):
            st = live(st)
        # t is a multiple of T here by construction: the boundary check
        # always fires.
        st = check(pb, cfg, st)
        launched["iterations"] += T
        launched["restart_checks"] += 1


def run_chunk(
    st: PDHGState, pb, j_budget: int, cfg: SolverConfig, aligned: bool = False
) -> PDHGState:
    """Run iterations until a terminal status or j >= j_budget: blocked
    cycles when `blocked_allowed(cfg)`, else the per-iteration runner,
    which reads t at entry and ignores `aligned`."""
    if blocked_allowed(cfg):
        return run_chunk_blocked_impl(st, pb, j_budget, cfg, aligned)
    return run_chunk_periter_impl(st, pb, j_budget, cfg)


def final_eval(st: PDHGState, pb, cfg: SolverConfig) -> PDHGState:
    """The reference's outer-loop tail on the KKT-budget-exhausted path:
    one last unscaled residual evaluation decides Solved vs 'KKT passes
    limit exceeded'; n and j advance as in the reference.  Under Halpern
    the carried z may lie outside the box, so the last feasible PDHG output
    (the *_prev slots) is evaluated instead."""
    if cfg.step_scheme == "halpern":
        kx_c, kty_c = _fresh_products(pb, cfg, st.x_prev, st.y_prev,
                                      st.kx_prev, st.kty_prev)
        res_term = R.residuals_unscaled(pb, st.x_prev, st.y_prev, kx_c,
                                        kty_c)
    else:
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
