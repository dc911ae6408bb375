"""The plain reference that decides `correct`: the KKT conditions of the
original LP, worked out again in float64 NumPy from the LP the benchmark
generated.  It imports nothing of the program and takes nothing the
program made: the program's answers (status, x, y, objective) are only
judged here.

For an answer (x, y) of  min c'x  s.t.  G x >= h, A x = b, l <= x <= u:

    primal residual  r_p = [A x - b ; min(G x - h, 0) ; max(l - x, 0) ;
                            max(x - u, 0)]
    reduced cost     g = c - K'y,  lambda = g projected on the normal cone
                     of the box (0 where a side is infinite)
    dual residual    r_d = [g - lambda ; min(y_ineq, 0)]
    dual objective   d = q'y + l'max(lambda, 0) + u'min(lambda, 0)

and the relative KKT error is the largest of

    ||r_p|| / (1 + ||q||),   ||r_d|| / (1 + ||c||),
    max(|c'x - d|, |objective - d|) / (1 + |c'x| + |d|),

the PDLP criterion with the absolute gap, taken twice: once for the primal
objective of x and once for the objective the program reports.  Norms are
the Euclidean norms of the original data.
"""

from __future__ import annotations

import numpy as np


class Reference:
    """The KKT check of one constraint system (K, q, bounds); the cost
    vector comes with each answer, since requests share K and differ in c."""

    def __init__(self, lp):
        K = lp.K.tocsr()
        self.m, self.n = K.shape
        self.indptr = np.array(K.indptr, dtype=np.int64)
        self.cols = np.array(K.indices, dtype=np.int64)
        self.vals = np.array(K.data, dtype=np.float64)
        self.rows = np.repeat(np.arange(self.m, dtype=np.int64),
                              np.diff(self.indptr))
        self.q = np.array(lp.q, dtype=np.float64)
        self.l = np.array(lp.l, dtype=np.float64)
        self.u = np.array(lp.u, dtype=np.float64)
        self.m_ineq = int(lp.m_ineq)
        self.q_norm = float(np.linalg.norm(self.q))
        self.has_l = np.isfinite(self.l)
        self.has_u = np.isfinite(self.u)

    def kx(self, x: np.ndarray) -> np.ndarray:
        return np.bincount(self.rows, weights=self.vals * x[self.cols],
                           minlength=self.m)

    def kty(self, y: np.ndarray) -> np.ndarray:
        return np.bincount(self.cols, weights=self.vals * y[self.rows],
                           minlength=self.n)

    def kkt(self, c, x, y, objective) -> dict:
        """The relative KKT error of one answer and its three parts."""
        c = np.asarray(c, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.shape != (self.n,) or y.shape != (self.m,):
            raise ValueError(f"answer of shape x {x.shape}, y {y.shape} for "
                             f"an LP of shape {(self.m, self.n)}")
        mi = self.m_ineq
        r = self.kx(x) - self.q
        r[:mi] = np.minimum(r[:mi], 0.0)
        r_p = np.concatenate([r, np.maximum(self.l - x, 0.0),
                              np.maximum(x - self.u, 0.0)])
        g = c - self.kty(y)
        lam = np.where(self.has_l, g, np.minimum(g, 0.0))
        lam = np.where(self.has_u, lam, np.maximum(lam, 0.0))
        r_d = np.concatenate([g - lam, np.minimum(y[:mi], 0.0)])
        p_obj = float(c @ x)
        d_obj = float(self.q @ y
                      + np.where(self.has_l, self.l, 0.0) @ np.maximum(lam, 0)
                      + np.where(self.has_u, self.u, 0.0) @ np.minimum(lam, 0))
        primal = float(np.linalg.norm(r_p)) / (1.0 + self.q_norm)
        dual = float(np.linalg.norm(r_d)) / (1.0 + float(np.linalg.norm(c)))
        gap = (max(abs(p_obj - d_obj), abs(float(objective) - d_obj))
               / (1.0 + abs(p_obj) + abs(d_obj)))
        parts = (primal, dual, gap)
        kkt = max(parts) if all(np.isfinite(parts)) else float("inf")
        return {"kkt_rel": kkt, "primal_rel": primal, "dual_rel": dual,
                "gap_rel": gap}
