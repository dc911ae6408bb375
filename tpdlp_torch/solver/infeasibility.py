"""Ray-based and normalized infeasibility certificates (counterpart of
tpdlp/solver/infeasibility.py, whose docstring gives the derivations and
the two deliberate fixes over the reference: unit-normalised rays with
strict objective conditions, and the true recession cone of [l, u]).

Every function is tensor work on the device: the verdicts are 0-d int32
status tensors (RUNNING, DUAL_INFEASIBLE or PRIMAL_INFEASIBLE), and nothing
here reads the device from the host.  The products of a ray come from the
carried K x / K'y by linearity, so a certificate issues no K product.

The loop calls these every iteration, each op a kernel launch from the
host, so the masks, bounds and constants that depend only on the problem
and the tolerance are built once (`Cone`, the optional `cone` argument)
instead of in every call: a Python scalar in `torch.where` would be a new
device tensor each time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpdlp_torch.config import Status
from tpdlp_torch.solver.reduce import all_, dot, norm

_INF = float("inf")


class Cone(NamedTuple):
    """The tests' per-problem constants for one tolerance."""

    eq_rows: torch.Tensor  # (m,) bool, the equality rows
    #: The recession cone of [l, u] widened by tol: r_lo <= r <= r_hi
    #: (both bounds finite: |r| <= tol; l only: r >= -tol; u only:
    #: r <= tol; free: anything).
    r_lo: torch.Tensor  # (n,)
    r_hi: torch.Tensor  # (n,)
    free: torch.Tensor  # (n,) bool, l = -inf and u = +inf
    lo_inf_only: torch.Tensor  # (n,) bool, l = -inf and u finite
    hi_inf_only: torch.Tensor  # (n,) bool, l finite and u = +inf
    # 0-d constants: 0, 1 and +inf in the problem's dtype, and the int32
    # status codes of the verdicts.
    zero: torch.Tensor
    one: torch.Tensor
    inf: torch.Tensor
    running: torch.Tensor
    dual_infeasible: torch.Tensor
    primal_infeasible: torch.Tensor


def cone_of(pb, tol) -> Cone:
    lo_inf, hi_inf = pb.is_neg_inf, pb.is_pos_inf

    def const(v, dtype=pb.c.dtype):
        return torch.full((), v, dtype=dtype, device=pb.c.device)

    return Cone(
        eq_rows=~pb.ineq_mask,
        r_lo=torch.where(lo_inf, -_INF, torch.full_like(pb.c, -tol)),
        r_hi=torch.where(hi_inf, _INF, torch.full_like(pb.c, tol)),
        free=lo_inf & hi_inf,
        lo_inf_only=lo_inf & ~hi_inf,
        hi_inf_only=~lo_inf & hi_inf,
        zero=const(0.0), one=const(1.0), inf=const(_INF),
        **_codes(pb.c.device),
    )


def _codes(device) -> dict:
    return {name: torch.full((), int(Status[name.upper()]),
                             dtype=torch.int32, device=device)
            for name in ("running", "dual_infeasible", "primal_infeasible")}


def _verdict(cone, dual_infeasible, primal_infeasible):
    """DUAL_INFEASIBLE first, then PRIMAL_INFEASIBLE, else RUNNING."""
    codes = cone._asdict() if cone is not None else _codes(
        dual_infeasible.device)
    return torch.where(
        dual_infeasible, codes["dual_infeasible"],
        torch.where(primal_infeasible, codes["primal_infeasible"],
                    codes["running"]),
    )


def _normalize_all(cone, norm, *vs):
    """Each of `vs` over `norm`, or zeros where norm is 0."""
    pos = norm > 0.0
    safe = torch.where(pos, norm, cone.one)
    return [torch.where(pos, v / safe, cone.zero) for v in vs]


def primal_ray_certifies(pb, r, k_r, tol, cone: Optional[Cone] = None):
    """Farkas conditions for a (unit-normalised) primal ray r with its
    product k_r = K r: A r ~ 0, G r >= -tol, strict descent c'r <= -tol,
    and recession-cone membership of [l, u]."""
    cone = cone or cone_of(pb, tol)
    equality_ok = norm(
        torch.where(cone.eq_rows, k_r, cone.zero)) <= tol
    inequality_ok = all_(
        torch.where(cone.eq_rows, cone.inf, k_r) >= -tol)
    objective_ok = dot(pb.c, r) <= -tol  # strict descent along the ray
    # A NaN in r fails objective_ok, so the cone test may pass it.
    bounds_ok = all_((r >= cone.r_lo) & (r <= cone.r_hi))
    return equality_ok & inequality_ok & objective_ok & bounds_ok


def dual_ray_certifies(pb, yr, lr, kt_yr, tol, cone: Optional[Cone] = None):
    """Farkas conditions for a (unit-normalised) dual ray (yr, lr) with
    kt_yr = K' yr: stationarity K'yr ~ lr, cone sign on inequality duals,
    and a strictly positive dual-objective growth rate (the adjusted-dual
    pairing)."""
    cone = cone or cone_of(pb, tol)
    dual_res_ok = norm(kt_yr - lr) <= tol
    dy_sign_ok = all_(torch.where(cone.eq_rows, cone.zero, yr) >= -tol)
    combo = (
        dot(pb.q, yr)
        + dot(pb.l_dual, torch.clamp_min(lr, 0.0))
        + dot(pb.u_dual, torch.clamp_max(lr, 0.0))
    )
    return dual_res_ok & dy_sign_ok & (combo >= tol)


def project_to_cone(cone: Cone, grad):
    """residuals.project_lambda_box(grad, ...) over the cone's masks."""
    out = torch.where(cone.lo_inf_only, torch.clamp_max(grad, 0.0), grad)
    out = torch.where(cone.hi_inf_only, torch.clamp_min(grad, 0.0), out)
    return torch.where(cone.free, cone.zero, out)


def detect_infeasibility(pb, x, y, x_prev, y_prev, lam, lam_prev, k_dx,
                         kt_dy, tol, cone: Optional[Cone] = None):
    """The ray certificates of one iterate difference: k_dx = K (x -
    x_prev) and kt_dy = K'(y - y_prev) come from the carried products.
    Returns an int32 status tensor."""
    cone = cone or cone_of(pb, tol)
    dx = x - x_prev
    dy = y - y_prev
    dlam = lam - lam_prev

    # Dual infeasibility (a primal unbounded ray).
    r, k_r = _normalize_all(cone, norm(dx), dx, k_dx)
    dual_infeasible = primal_ray_certifies(pb, r, k_r, tol, cone)

    # Primal infeasibility (a dual unbounded ray).
    ray_norm = torch.sqrt(dot(dy, dy) + dot(dlam, dlam))
    yr, lr, kt_yr = _normalize_all(cone, ray_norm, dy, dlam, kt_dy)
    primal_infeasible = dual_ray_certifies(pb, yr, lr, kt_yr, tol, cone)
    return _verdict(cone, dual_infeasible, primal_infeasible)


def validate_normalized_candidate(pb, cert, x_ray, kx_ray, y_ray, kty_ray,
                                  tol, cone: Optional[Cone] = None):
    """Keep a normalized-family verdict only when its ray certifies:
    DUAL_INFEASIBLE needs x_ray to be a Farkas primal ray, and
    PRIMAL_INFEASIBLE needs (y_ray, proj(K'y_ray)) to be a Farkas dual ray.
    (The raw convergence trigger also fires on converging feasible solves;
    see the JAX package's docstring.)"""
    cone = cone or cone_of(pb, tol)
    r, k_r = _normalize_all(cone, norm(x_ray), x_ray,
                            kx_ray)
    ok_primal_ray = primal_ray_certifies(pb, r, k_r, tol, cone)

    yr, kt_yr = _normalize_all(cone, norm(y_ray), y_ray,
                               kty_ray)
    # The bound-multiplier recession cone is the lambda-projection cone, so
    # lr = proj(K'yr) makes stationarity measure K'yr's distance from it.
    lr = project_to_cone(cone, kt_yr)
    ok_dual_ray = dual_ray_certifies(pb, yr, lr, kt_yr, tol, cone)

    keep = torch.where(cert == int(Status.DUAL_INFEASIBLE), ok_primal_ray,
                       (cert == int(Status.PRIMAL_INFEASIBLE)) & ok_dual_ray)
    return torch.where(keep, cert, cone.running)


def normalized_iterate_certificates(x, y, x_norm_prev, y_norm_prev, k,
                                    tol_conv=1e-4, tol_nonzero=1e-3,
                                    cone: Optional[Cone] = None):
    """x/k converging to a nonzero point => DUAL_INFEASIBLE; y/k likewise
    => PRIMAL_INFEASIBLE.  Returns (status, x_norm, y_norm), the last two
    this iteration's normalized iterates, to carry to the next call."""
    kf = torch.clamp_min(k.to(x.dtype), 1.0)
    x_norm = x / kf
    y_norm = y / kf
    x_conv = norm(x_norm - x_norm_prev) < tol_conv
    x_nonzero = norm(x_norm) > tol_nonzero
    y_conv = norm(y_norm - y_norm_prev) < tol_conv
    y_nonzero = norm(y_norm) > tol_nonzero
    status = _verdict(cone, x_conv & x_nonzero, y_conv & y_nonzero)
    return status, x_norm, y_norm


def normalized_average_certificates(x_sum, y_sum, x, y, k, tol_conv=1e-4,
                                    tol_nonzero=1e-3,
                                    cone: Optional[Cone] = None):
    """avg_k = 2 (sum_{i<=k} x_i) / (k (k+1)) converging to a nonzero point
    => DUAL_INFEASIBLE (on y => PRIMAL_INFEASIBLE).  The previous average
    comes from the running sum, avg_{k-1} = 2 (sum - x_k) / ((k-1) k), so
    `x_sum`/`y_sum` must already include this iteration's x/y."""
    kf = torch.clamp_min(k.to(x.dtype), 2.0)
    den = kf * (kf + 1.0)
    den_prev = (kf - 1.0) * kf
    avg_x = 2.0 * x_sum / den
    avg_y = 2.0 * y_sum / den
    prev_x = 2.0 * (x_sum - x) / den_prev
    prev_y = 2.0 * (y_sum - y) / den_prev
    x_conv = norm(avg_x - prev_x) < tol_conv
    x_nonzero = norm(avg_x) > tol_nonzero
    y_conv = norm(avg_y - prev_y) < tol_conv
    y_nonzero = norm(avg_y) > tol_nonzero
    return _verdict(cone, x_conv & x_nonzero, y_conv & y_nonzero)
