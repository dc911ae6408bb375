"""MPS writer for standard-form problems (a copy of tpdlp/io/writer.py:
numpy/scipy code only, kept here so that this package never imports the
JAX package; the same problem gives the same bytes).

Used by the synthetic generators (the reference writes MPS via pulp,
Packages/generate_feasible_lp.py:44-60) and by the presolve round trip.
Writes free-format MPS with G rows for the inequality block and E rows for
the equality block, which `read_mps` maps back to the identical standard
form (round-trip tested).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def write_mps(problem, path) -> None:
    """Write an LPProblem to a free-format MPS file."""
    K = problem.K
    if not sp.issparse(K):
        K = sp.csr_matrix(K)
    else:
        K = K.tocsr()
    m, n = K.shape
    m_ineq = problem.m_ineq

    def rname(i: int) -> str:
        return f"G{i}" if i < m_ineq else f"E{i}"

    def vname(j: int) -> str:
        return f"X{j}"

    lines = [f"NAME {getattr(problem, 'name', 'lp')}", "ROWS", " N COST"]
    for i in range(m):
        sense = "G" if i < m_ineq else "E"
        lines.append(f" {sense} {rname(i)}")

    lines.append("COLUMNS")
    Kc = K.tocsc()
    for j in range(n):
        # A variable with zero cost AND an empty column must still be
        # declared (MPS variables exist only via COLUMNS entries; dropping
        # one breaks the presolve round trip's dimension contract).
        if problem.c[j] != 0.0 or Kc.indptr[j] == Kc.indptr[j + 1]:
            lines.append(f" {vname(j)} COST {problem.c[j]:.17g}")
        start, end = Kc.indptr[j], Kc.indptr[j + 1]
        for idx in range(start, end):
            i = Kc.indices[idx]
            v = Kc.data[idx]
            if v != 0.0:
                lines.append(f" {vname(j)} {rname(i)} {v:.17g}")

    lines.append("RHS")
    for i in range(m):
        if problem.q[i] != 0.0:
            lines.append(f" RHS {rname(i)} {problem.q[i]:.17g}")

    lines.append("BOUNDS")
    for j in range(n):
        lo, up = problem.l[j], problem.u[j]
        if lo == up:
            lines.append(f" FX BND {vname(j)} {lo:.17g}")
            continue
        if np.isneginf(lo) and np.isposinf(up):
            lines.append(f" FR BND {vname(j)}")
            continue
        if np.isneginf(lo):
            lines.append(f" MI BND {vname(j)}")
        elif lo != 0.0:
            lines.append(f" LO BND {vname(j)} {lo:.17g}")
        if not np.isposinf(up):
            lines.append(f" UP BND {vname(j)} {up:.17g}")

    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
