"""Diagonal preconditioning: Ruiz equilibration and Pock-Chambolle scaling
(counterpart of tpdlp/scaling/ruiz.py).

Ruiz iterates d_row /= sqrt(rowmax |K_s|), d_col /= sqrt(colmax |K_s|),
accumulating so that K_s = diag(d_row) K diag(d_col), and scales
c_s = c * d_col, q_s = q * d_row, l_s = l / d_col, u_s = u / d_col.  Its
stop test reads one flag from the device per iteration (preprocessing, not
the iteration loop).  Operators are scaled through `LinOp.scale`; the
dense operator scales only K there and builds K' once, afterwards.  Under
a mesh the diagonals are this rank's slices (`LinOp.slice_shape`), the
norms come from the sharded operator, and the stop test's two maxima are
one collective.
"""

from __future__ import annotations

import torch

from tpdlp_torch.solver.reduce import reduce


def _safe(v, eps):
    return torch.where(v < eps, torch.ones_like(v), v)


def ruiz_equilibrate(op, max_iter: int = 20, eps: float = 1e-6):
    """Run Ruiz iterations; returns (op_scaled, d_row, d_col).

    `op` itself is left as it is: the first pass scales a copy, and every
    later pass scales that copy in place, so the device holds at most two
    copies of K (the caller's and the scaled one).  A stack of B operators
    (`op.batch_shape` == (B,), tpdlp_torch/batch/stacked.py) gets (B, m) /
    (B, n) diagonals, and each element stops at its own convergence, as
    the JAX `while_loop` does under vmap: a converged element's factors
    become exactly 1, which leaves its matrix and diagonals as they are
    (and one operator's factors are its norms, bit for bit)."""
    m, n = op.slice_shape
    lead, dtype, dev = op.batch_shape, op.dtype, op.device
    d_row = torch.ones(lead + (m,), dtype=dtype, device=dev)
    d_col = torch.ones(lead + (n,), dtype=dtype, device=dev)
    ones_m, ones_n = d_row, d_col
    active = torch.ones(lead + (1,), dtype=torch.bool, device=dev)
    cur = op

    def scaled(dr, dc):
        return op.scale(dr, dc) if cur is op else cur.scale_(dr, dc)

    for _ in range(max_iter):
        row_norms = _safe(torch.sqrt(cur.row_abs_norms("inf")), eps)
        rn = torch.where(active, row_norms, 1.0)
        d_row = d_row / rn
        cur = scaled(1.0 / rn, ones_n)
        col_norms = _safe(torch.sqrt(cur.col_abs_norms("inf")), eps)
        cn = torch.where(active, col_norms, 1.0)
        d_col = d_col / cn
        cur = scaled(ones_m, 1.0 / cn)
        # The worst row and column: over the group under a mesh (one
        # collective), so that every rank stops at the same pass.
        worst_row, worst_col = reduce(
            op.red, ("max", "y", torch.abs(1.0 - row_norms)),
            ("max", "x", torch.abs(1.0 - col_norms)), kind="norm")
        active = active & ~((worst_row < eps) & (worst_col < eps))
        if not bool(active.any()):
            break
    return cur, d_row, d_col


def pock_chambolle(op, alpha: float = 1.0, eps: float = 1e-6):
    """Pock-Chambolle diagonal scaling on top of an (already scaled) op."""
    row = _safe(torch.sqrt(op.row_abs_norms(2.0 - alpha)), eps)
    col = _safe(torch.sqrt(op.col_abs_norms(alpha)), eps)
    d_row = 1.0 / row
    d_col = 1.0 / col
    return op.scale(d_row, d_col), d_row, d_col


def scale_problem(op, c, q, l, u, *, method: str, ruiz_iters=20,
                  ruiz_eps=1e-6, pc_alpha=1.0):
    """Scale (K, c, q, l, u); returns (op_s, c_s, q_s, l_s, u_s, d_row, d_col).

    d_row/d_col satisfy K_s = diag(d_row) K diag(d_col) ((B, m) / (B, n)
    for a stack of B, whose vectors are (B, m) / (B, n)); ones when
    method == "none"."""
    if method == "none":
        m, n = op.slice_shape
        lead, dtype, dev = op.batch_shape, op.dtype, op.device
        d_row = torch.ones(lead + (m,), dtype=dtype, device=dev)
        d_col = torch.ones(lead + (n,), dtype=dtype, device=dev)
        return op, c, q, l, u, d_row, d_col
    if method not in ("ruiz", "ruiz+pc"):
        raise ValueError(f"unknown scaling method: {method!r}")

    op, d_row, d_col = ruiz_equilibrate(op, ruiz_iters, ruiz_eps)
    if method == "ruiz+pc":
        op, dr2, dc2 = pock_chambolle(op, pc_alpha, ruiz_eps)
        d_row = d_row * dr2
        d_col = d_col * dc2

    c_s = c * d_col
    q_s = q * d_row
    l_s = l / d_col
    u_s = u / d_col
    return op, c_s, q_s, l_s, u_s, d_row, d_col
