"""Synthetic planted-feasible LP generator (a copy of
tpdlp/io/generator.py::generate_feasible_lp).

numpy/scipy code only, kept here so that this package never imports the JAX
package: the same arguments and seed give the same problem, byte for byte.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from tpdlp_torch.problem import LPProblem


def generate_feasible_lp(
    n: int = 50,
    m_ineq: int = 30,
    m_eq: int = 10,
    density: float = 0.3,
    seed: int = 0,
    box: bool = True,
    bounds: str | None = None,
) -> LPProblem:
    """Random LP guaranteed feasible via a planted point x*.

    Mirrors the reference construction (generate_feasible_lp.py:18-42):
    h = G x* - U(0.1, 5) (so G x* > h), b = A x*, box bounds straddling x*,
    normal objective.  Bounded below by the box, so an optimum exists.

    `bounds` (overrides `box` when given):
      "box"   — finite box straddling x* (the reference construction).
      "mixed" — a realistic bound mix: ~50% finite boxes, ~25%
                lower-bounded only (u = +inf), ~15% upper-bounded only
                (l = -inf), ~10% fully free.  With infinite bounds the
                box no longer guarantees boundedness, so the OBJECTIVE
                is planted from a dual-feasible pair instead:
                c = K'y* + lambda* with y*_ineq >= 0 and lambda* in the
                bound cone (>= 0 lower-only, <= 0 upper-only, 0 free) —
                weak duality then bounds the LP.  On such instances the
                dual residual ||(c - K'y) - lambda|| is NOT identically
                zero (lambda is a strict cone projection), which is what
                exercises termination condition 2 — on all-finite-box
                instances lambda == reduced cost and dual_res vanishes
                identically (round-3 verdict weak #6).
    """
    rng = np.random.default_rng(seed)
    G = sp.random(m_ineq, n, density=density, random_state=rng, format="csr")
    G.data = rng.standard_normal(G.nnz)
    A = sp.random(m_eq, n, density=density, random_state=rng, format="csr")
    A.data = rng.standard_normal(A.nnz)
    K = sp.vstack([G, A]).tocsr()

    x_star = rng.uniform(-5, 5, size=n)
    h = G @ x_star - rng.uniform(0.1, 5.0, size=m_ineq)
    b = A @ x_star
    q = np.concatenate([h, b])

    if bounds is None:
        bounds = "box" if box else "none"
    if bounds == "mixed":
        kind = rng.choice(4, size=n, p=(0.5, 0.25, 0.15, 0.10))
        l = np.clip(x_star - rng.uniform(1, 5, size=n), -1e4, None)
        u = np.clip(x_star + rng.uniform(1, 5, size=n), None, 1e4)
        u[kind == 1] = np.inf            # lower-bounded only
        l[kind == 2] = -np.inf           # upper-bounded only
        l[kind == 3] = -np.inf           # free
        u[kind == 3] = np.inf
        y_star = np.concatenate([
            rng.uniform(0.0, 1.0, size=m_ineq),   # cone-feasible
            rng.standard_normal(m_eq),
        ])
        lam_star = rng.standard_normal(n)
        lam_star[kind == 1] = np.abs(lam_star[kind == 1])
        lam_star[kind == 2] = -np.abs(lam_star[kind == 2])
        lam_star[kind == 3] = 0.0
        c = np.asarray(K.T @ y_star) + lam_star
    elif bounds == "none":
        l = np.full(n, -np.inf)
        u = np.full(n, np.inf)
        c = rng.standard_normal(n)
    else:
        l = np.clip(x_star - rng.uniform(1, 5, size=n), -1e4, None)
        u = np.clip(x_star + rng.uniform(1, 5, size=n), None, 1e4)
        c = rng.standard_normal(n)

    return LPProblem(
        c=c, K=K, q=q, m_ineq=m_ineq, l=l, u=u,
        name=f"synth_feasible_n{n}_m{m_ineq + m_eq}_s{seed}",
    )
