"""PDHG steps: fixed stepsize and Malitsky-Pock adaptive stepsize
(counterpart of tpdlp/solver/step.py).

One step:
    grad  = c - K'y
    x+    = clip(x - (eta/omega) grad, l, u)
    x_bar = x+ + theta (x+ - x)
    y+    = proj_{>=0 on ineq rows}( y + eta*omega (q - K x_bar) )

Cost: one K'y (carried in from the previous iteration) and one K x+ per
step.  K x_bar comes from the carried products by linearity, and the
adaptive denominator dy'K dx uses K dx = K x+ - K x, so the adaptive rule
costs no extra product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpdlp_torch.config import SolverConfig, fast_step_products
from tpdlp_torch.solver.reduce import dot


def step_mv(pb, cfg: SolverConfig):
    """The K-product pair the step uses (op.mv_fast/rmv_fast when
    cfg.step_products resolves fast; every operator of this port makes
    them the exact products)."""
    if fast_step_products(cfg):
        return pb.op.mv_fast, pb.op.rmv_fast
    return pb.op.mv, pb.op.rmv


class StepResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    kx: torch.Tensor
    eta_used: torch.Tensor  # stepsize weight for iterate averaging
    eta_next: torch.Tensor  # stepsize for the next iteration
    j_inc: torch.Tensor  # KKT passes consumed (int32)


def _primal_dual_update(pb, cfg, x, y, kx, grad, eta, omega, theta):
    """The shared primal/dual update given grad = c - K'y."""
    tau = eta / omega
    sigma = eta * omega
    x_new = torch.clamp(x - tau * grad, pb.l, pb.u)
    kx_new = step_mv(pb, cfg)[0](x_new)
    k_xbar = (1.0 + theta) * kx_new - theta * kx
    y_new = y + sigma * (pb.q - k_xbar)
    y_new = torch.where(pb.ineq_mask, torch.clamp_min(y_new, 0.0), y_new)
    return x_new, y_new, kx_new


def _one(like):
    return torch.ones((), dtype=torch.int32, device=like.device)


def fixed_step(pb, cfg: SolverConfig, x, y, kx, kty, eta, omega) -> StepResult:
    """One fixed-stepsize PDHG step; j += 1."""
    grad = pb.c - kty
    x_new, y_new, kx_new = _primal_dual_update(
        pb, cfg, x, y, kx, grad, eta, omega, cfg.theta
    )
    return StepResult(x_new, y_new, kx_new, eta, eta, _one(x))


def adaptive_step(
    pb, cfg: SolverConfig, x, y, kx, kty, eta, omega, k_new
) -> StepResult:
    """Malitsky-Pock-style adaptive step.

    eta_bar  = (omega ||dx||^2 + ||dy||^2/omega) / (2 |dy' K dx|)
    eta'     = min((1 - (k+1)^p_shrink) eta_bar, (1 + (k+1)^p_grow) eta)

    Two rules (cfg.adaptive_rule):
    - "reference": the step is always taken with the incoming eta; if
      eta > eta_bar the averaging weight becomes eta'.  j += 1.  Nothing
      is read from the device.
    - "linesearch": retry the step with eta' until eta <= eta_bar (at most
      cfg.max_backtracks trials).  j += trials.  The accept test is read on
      the host once per trial.
    """
    grad = pb.c - kty

    # Exponents use the post-increment iteration counter + 1.
    kp1 = (k_new + 1).to(eta.dtype)
    shrink = 1.0 - kp1**cfg.adaptive_shrink_exponent
    grow = 1.0 + kp1**cfg.adaptive_grow_exponent
    inf = torch.full((), float("inf"), dtype=eta.dtype, device=eta.device)

    def trial(eta_t):
        x_new, y_new, kx_new = _primal_dual_update(
            pb, cfg, x, y, kx, grad, eta_t, omega, cfg.theta
        )
        dx = x_new - x
        dy = y_new - y
        k_dx = kx_new - kx  # K dx by linearity — no extra product
        denom = 2.0 * dot(dy, k_dx)
        num = omega * dot(dx, dx) + dot(dy, dy) / omega
        eta_bar = torch.where(denom != 0.0, num / torch.abs(denom), inf)
        eta_prime = torch.minimum(
            torch.where(torch.isinf(eta_bar), inf, shrink * eta_bar),
            grow * eta_t,
        )
        accepted = eta_t <= eta_bar
        return x_new, y_new, kx_new, eta_prime, accepted

    if cfg.adaptive_rule == "reference":
        x_new, y_new, kx_new, eta_prime, accepted = trial(eta)
        # Accepted: averaging weight = eta, next eta = eta'.  Rejected: the
        # step is kept and eta' is both the used and the next stepsize.
        eta_used = torch.where(accepted, eta, eta_prime)
        return StepResult(x_new, y_new, kx_new, eta_used, eta_prime, _one(x))

    if cfg.adaptive_rule != "linesearch":
        raise ValueError(f"unknown adaptive_rule: {cfg.adaptive_rule!r}")

    # Every element not yet accepted retries with its eta' while any does
    # (one solve's `accepted` is 0-d, a fleet's (B, 1)); an accepted
    # element keeps its step, as under the JAX package's vmap.
    x_f, y_f, kx_f, ep_f, accepted = trial(eta)
    eta_f = eta
    trials = torch.ones_like(accepted, dtype=torch.int32)
    done = 1
    while done < cfg.max_backtracks and not bool(accepted.all()):
        retry = ~accepted
        x_t, y_t, kx_t, ep_t, acc_t = trial(ep_f)
        x_f = torch.where(retry, x_t, x_f)
        y_f = torch.where(retry, y_t, y_f)
        kx_f = torch.where(retry, kx_t, kx_f)
        eta_f = torch.where(retry, ep_f, eta_f)
        ep_f = torch.where(retry, ep_t, ep_f)
        accepted = torch.where(retry, acc_t, accepted)
        trials = trials + retry.to(torch.int32)
        done += 1
    return StepResult(x_f, y_f, kx_f, eta_f, ep_f, trials)
