"""Fishnet / spectral-cast multi-point warm start (counterpart of
tpdlp/fishnet.py).

Sample 2^i points on a sphere of radius ~||K||_2 centred on the positive
diagonal, run k PDHG steps on the whole population, rank the points by
duality gap, keep the best 1/s, and on odd rounds breed new points as
random convex combinations of the survivors plus their midpoint, until one
point remains.  The population lives as (n, J) / (m, J) matrices and every
step is one operator-times-matrix product, `op.mm` / `op.rmm` (for the
dense operator `torch.matmul` with TF32 off, as the JAX operator does it
outside Pallas; for the band, CSR and block-ELL operators their `matmat`):
there is no kernel here.

The random draws come from CPU `torch.Generator`s seeded from `seed`, one
stream per draw, each in a function of its own (`radius_start`,
`initial_points`, `breed_weights`), so that the parity tests can replace
them with the JAX package's `jax.random` draws.  The points therefore
differ from the JAX package's for the same seed; the algorithm does not.
"""

from __future__ import annotations

import numpy as np
import torch

from tpdlp_torch.solver.power_iteration import spectral_norm_estimate
from tpdlp_torch.solver.residuals import project_lambda_box


def _generator(seed: int, *stream: int) -> torch.Generator:
    """A CPU generator for one draw: seeded from (seed, *stream)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(np.random.SeedSequence(
        [int(seed), *stream]).generate_state(1)[0]))
    return g


def radius_start(n: int, seed: int, dtype, device) -> torch.Tensor:
    """(n,) standard-normal start of both power iterations (the ball
    radius's and the stepsize's; the JAX package draws both from k_radius)."""
    g = _generator(seed, 0)
    return torch.randn((n,), generator=g, dtype=torch.float64).to(
        dtype=dtype, device=device)


def initial_points(n: int, j: int, seed: int, dtype,
                   device) -> torch.Tensor:
    """(n, j) standard-normal initial population."""
    g = _generator(seed, 1)
    return torch.randn((n, j), generator=g, dtype=torch.float64).to(
        dtype=dtype, device=device)


def breed_weights(keep: int, n_new: int, seed: int, round_idx: int, dtype,
                  device) -> torch.Tensor:
    """(keep, n_new) uniform [0, 1) breeding weights of round `round_idx`."""
    g = _generator(seed, 2, round_idx)
    return torch.rand((keep, n_new), generator=g, dtype=torch.float64).to(
        dtype=dtype, device=device)


def _round_schedule(j: int, s: int) -> list[tuple[int, int, bool]]:
    """[(j_in, j_keep, breed_to_j_in)] per round, the reference's
    while-loop parity rules."""
    sched = []
    i = 0
    while j > 1:
        keep = max(1, j // s)
        breed = (i % 2 == 1) and keep > 1
        sched.append((j, keep, breed))
        j = j if breed else keep
        i += 1
    return sched


def _batched_gap(op, pts, pts_y, c, q, l_dual, u_dual, is_neg_inf,
                 is_pos_inf):
    """Duality gap of every column point in one batched expression."""
    grad = c[:, None] - op.rmm(pts_y)  # (n, J)
    lam = project_lambda_box(grad, is_neg_inf[:, None], is_pos_inf[:, None])
    prim_obj = c @ pts  # (J,)
    dual_obj = q @ pts_y
    lam_pos = l_dual @ torch.clamp_min(lam, 0.0)
    lam_neg = u_dual @ torch.clamp_max(lam, 0.0)
    return (dual_obj + lam_pos + lam_neg) - prim_obj


def _pdhg_steps(op, pts, pts_y, c, q, l, u, ineq_mask, eta, omega, k: int):
    """k PDHG steps on the population (theta = 1 extrapolation written as
    2x - x_old)."""
    for _ in range(k):
        grad = c[:, None] - op.rmm(pts_y)
        new = torch.clamp(pts - (eta / omega) * grad, l[:, None], u[:, None])
        x_bar = 2.0 * new - pts
        y_new = pts_y + eta * omega * (q[:, None] - op.mm(x_bar))
        y_new = torch.where(ineq_mask[:, None], torch.clamp_min(y_new, 0.0),
                            y_new)
        pts, pts_y = new, y_new
    return pts, pts_y


def spectral_cast(op, c, q, l, u, m_ineq: int, k: int = 32, s: int = 2,
                  i: int = 5, seed: int = 0):
    """A promising (x0, y0) warm-start pair of the problem (op, c, q, l, u)
    as it is handed over (the CLI hands the scaled problem); tensors on the
    operator's device."""
    m, n = op.shape
    dtype, dev = c.dtype, c.device
    j0 = 2**i
    sched = _round_schedule(j0, s)

    # Ball radius ~ ||K||_2 (25 power iterations); eta from a 50-iteration
    # estimate from the same start.
    b0 = radius_start(n, seed, dtype, dev)
    r = spectral_norm_estimate(op, seed, 25, start=b0)
    pts = initial_points(n, j0, seed, dtype, dev)
    pts = pts * r / torch.linalg.vector_norm(pts, dim=0, keepdim=True)
    pts = pts + r / torch.sqrt(torch.tensor(float(n), dtype=dtype,
                                            device=dev))
    pts_y = op.mm(pts)
    eta = 0.9 / spectral_norm_estimate(op, seed, 50, start=b0)
    q_norm = torch.linalg.vector_norm(q)
    c_norm = torch.linalg.vector_norm(c)
    omega = torch.where((q_norm > 1e-6) & (c_norm > 1e-6), c_norm / q_norm,
                        torch.ones((), dtype=dtype, device=dev))

    ineq_mask = torch.arange(m, device=dev) < m_ineq
    is_neg_inf = torch.isneginf(l)
    is_pos_inf = torch.isposinf(u)
    l_dual = torch.where(is_neg_inf, 0.0, l)
    u_dual = torch.where(is_pos_inf, 0.0, u)

    for ridx, (j_in, keep, breed) in enumerate(sched):
        pts, pts_y = _pdhg_steps(op, pts, pts_y, c, q, l, u, ineq_mask, eta,
                                 omega, k)
        gap = _batched_gap(op, pts, pts_y, c, q, l_dual, u_dual, is_neg_inf,
                           is_pos_inf)
        order = torch.argsort(gap, stable=True)[:keep]
        best, best_y = pts[:, order], pts_y[:, order]
        if not breed:
            pts, pts_y = best, best_y
            continue
        # Odd-round repopulation: random convex combinations of the
        # survivors, plus their midpoint.
        n_new = j_in - keep - 1
        w = breed_weights(keep, n_new, seed, ridx, dtype, dev)
        w = w / torch.sum(w, dim=0, keepdim=True)
        pts = torch.cat([best, best @ w, best.mean(dim=1, keepdim=True)],
                        dim=1)
        pts_y = torch.cat([best_y, best_y @ w,
                           best_y.mean(dim=1, keepdim=True)], dim=1)
    return pts[:, 0], pts_y[:, 0]


def fishnet_start(problem, dtype, device, matrix_format: str = "dense",
                  scaling: str = "none", seed: int = 0):
    """(x0, y0) host arrays of the fishnet search for `problem`, in the
    original frame (solve()'s warm-start contract), as the CLI's --fishnet
    computes them: the search runs on the scaled problem (the reference's
    order), over the operator of the layout the solve uses (a sparse or
    band K is never densified), which scaling copies before it scales."""
    from tpdlp_torch.scaling.ruiz import scale_problem
    from tpdlp_torch.solver.solve import build_device_operator

    op, c, q, l, u = build_device_operator(problem, dtype, matrix_format,
                                           device)
    op_s, c_s, q_s, l_s, u_s, d_row, d_col = scale_problem(
        op, c, q, l, u, method=scaling)
    x0_s, y0_s = spectral_cast(op_s, c_s, q_s, l_s, u_s, problem.m_ineq,
                               k=32, seed=seed)
    return (d_col * x0_s).cpu().numpy(), (d_row * y0_s).cpu().numpy()
