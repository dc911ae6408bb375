"""The planted-feasible LP of torchPDLP (`Packages/generate_feasible_lp.py`),
frozen for the benchmark.

A copy of `generate_feasible_lp` as the port carries it
(`tpdlp_torch/io/generator.py`), so that the yardstick does not move when
the program's copy does: the same arguments and seed give the same LP,
byte for byte.  numpy and scipy only.

    minimize c'x  s.t.  G x >= h,  A x = b,  l <= x <= u

with K = [G; A] (CSR), q = [h; b] and the first `m_ineq` rows
inequalities; h = G x* - U(0.1, 5) and b = A x* for a planted x*, so every
instance is feasible.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class LP:
    """A standard-form LP on the host, with the fields the solver's
    `LPProblem` has."""

    c: np.ndarray
    K: sp.csr_matrix
    q: np.ndarray
    m_ineq: int
    l: np.ndarray
    u: np.ndarray
    name: str = "lp"


def generate_feasible_lp(n: int, m_ineq: int, m_eq: int, density: float,
                         seed: int, bounds: str = "box") -> LP:
    """The upstream construction.  `bounds`: "box" (a finite box
    straddling x*, the upstream default), "mixed" (about half boxes, a
    quarter lower-bounded, 15% upper-bounded, 10% free, with c planted
    from a dual-feasible pair so the LP stays bounded) or "none"."""
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

    if bounds == "mixed":
        kind = rng.choice(4, size=n, p=(0.5, 0.25, 0.15, 0.10))
        l = np.clip(x_star - rng.uniform(1, 5, size=n), -1e4, None)
        u = np.clip(x_star + rng.uniform(1, 5, size=n), None, 1e4)
        u[kind == 1] = np.inf
        l[kind == 2] = -np.inf
        l[kind == 3] = -np.inf
        u[kind == 3] = np.inf
        y_star = np.concatenate([
            rng.uniform(0.0, 1.0, size=m_ineq),
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
    elif bounds == "box":
        l = np.clip(x_star - rng.uniform(1, 5, size=n), -1e4, None)
        u = np.clip(x_star + rng.uniform(1, 5, size=n), None, 1e4)
        c = rng.standard_normal(n)
    else:
        raise ValueError(f"unknown bounds {bounds!r}")

    return LP(c=c, K=K, q=q, m_ineq=m_ineq, l=l, u=u,
              name=f"synth_feasible_n{n}_m{m_ineq + m_eq}_s{seed}")


def build(instance: dict, seed: int) -> LP:
    """The LP of a configuration's `instance` parameters from `seed`."""
    return generate_feasible_lp(
        n=instance["n"], m_ineq=instance["m_ineq"], m_eq=instance["m_eq"],
        density=instance["density"], seed=seed,
        bounds=instance.get("bounds", "box"))
