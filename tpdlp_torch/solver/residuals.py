"""Residuals, duality gap, KKT error and termination (counterpart of
tpdlp/solver/residuals.py).  Pure tensor math: nothing here reads the
device from the host."""

from __future__ import annotations

import dataclasses

import torch

from tpdlp_torch.solver.reduce import dot, norm


def project_lambda_box(grad, is_neg_inf, is_pos_inf):
    """Project the reduced cost onto the normal cone of [l, u].

    Per variable:
      (-inf, +inf) -> 0
      (-inf, real) -> min(grad, 0)
      (real, +inf) -> max(grad, 0)
      (real, real) -> grad
    """
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    free = is_neg_inf & is_pos_inf
    neg_only = is_neg_inf & ~is_pos_inf
    pos_only = ~is_neg_inf & is_pos_inf
    out = torch.where(neg_only, torch.minimum(grad, zero), grad)
    out = torch.where(pos_only, torch.maximum(grad, zero), out)
    return torch.where(free, zero, out)


@dataclasses.dataclass
class Residuals:
    """Scalar convergence measures of one primal-dual point."""

    primal_res: torch.Tensor
    dual_res: torch.Tensor
    gap: torch.Tensor
    prim_obj: torch.Tensor
    adjusted_dual: torch.Tensor


def compute_residuals(
    x, y, kx, kty, c, q, l_dual, u_dual, ineq_mask, is_neg_inf, is_pos_inf
) -> Residuals:
    """Primal/dual residual norms, duality gap and objectives from the
    carried products kx = K x and kty = K'y (O(n + m) vector work).

    primal residual = || [A x - b ; min(G x - h, 0)] ||_2
    dual residual   = || (c - K'y) - lambda ||_2
    adjusted dual   = q'y + l_dual'max(lam,0) + u_dual'min(lam,0)
    gap             = adjusted_dual - c'x
    """
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    grad = c - kty
    lam = project_lambda_box(grad, is_neg_inf, is_pos_inf)

    prim_obj = dot(c, x)
    dual_obj = dot(q, y)
    adjusted_dual = (
        dual_obj
        + dot(l_dual, torch.maximum(lam, zero))
        + dot(u_dual, torch.minimum(lam, zero))
    )
    gap = adjusted_dual - prim_obj

    full_res = kx - q
    # Inequality rows G x >= h only penalise violation.
    res = torch.where(ineq_mask, torch.minimum(full_res, zero), full_res)
    primal_res = norm(res)
    dual_res = norm(grad - lam)
    return Residuals(primal_res, dual_res, gap, prim_obj, adjusted_dual)


def residuals_scaled(pb, x, y, kx, kty) -> Residuals:
    """Residuals of the (scaled) working problem — the restart metric."""
    return compute_residuals(
        x, y, kx, kty,
        pb.c, pb.q, pb.l_dual, pb.u_dual,
        pb.ineq_mask, pb.is_neg_inf, pb.is_pos_inf,
    )


def residuals_unscaled(pb, x, y, kx, kty) -> Residuals:
    """Residuals of the original problem from scaled iterates, via
    x_orig = d_col * x, y_orig = d_row * y, K x_orig = kx / d_row and
    K' y_orig = kty / d_col (no unscaled matrix needed)."""
    return compute_residuals(
        pb.d_col * x, pb.d_row * y, kx / pb.d_row, kty / pb.d_col,
        pb.c0, pb.q0, pb.l0_dual, pb.u0_dual,
        pb.ineq_mask, pb.is_neg_inf, pb.is_pos_inf,
    )


def kkt_error(res: Residuals, omega):
    """omega-weighted combined KKT error, the restart metric:
    sqrt(omega^2 ||r_p||^2 + ||r_d||^2 / omega^2 + gap^2)."""
    w2 = omega * omega
    return torch.sqrt(
        w2 * res.primal_res**2 + res.dual_res**2 / w2 + res.gap**2
    )


def check_termination(res: Residuals, q_norm, c_norm, tol, *, abs_gap=False):
    """Relative KKT termination; a bool 0-d tensor.  The reference uses the
    signed gap; `abs_gap=True` switches to |gap| (standard PDLP)."""
    gap = torch.abs(res.gap) if abs_gap else res.gap
    cond1 = res.primal_res <= tol * (1.0 + q_norm)
    cond2 = res.dual_res <= tol * (1.0 + c_norm)
    cond3 = gap <= tol * (1.0 + torch.abs(res.prim_obj)
                          + torch.abs(res.adjusted_dual))
    return cond1 & cond2 & cond3
