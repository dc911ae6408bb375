"""LP problem containers (counterpart of tpdlp/problem.py).

`LPProblem` is the host-side standard form (numpy / scipy.sparse):

    minimize    c'x
    s.t.        G x >= h,  A x = b,  l <= x <= u

stacked as K = [G; A], q = [h; b] with the first `m_ineq` rows inequalities.

`DeviceProblem` holds the device tensors the solver iterates on: the
(possibly scaled) operator and vectors, bound masks, the diagonal scaling
(ones when unscaled) and the original data for unscaled termination.  With
K_s = diag(d_row) K diag(d_col) and x = x_s the scaled iterate,

    K x_orig = (K_s x_s) / d_row      and      K' y_orig = (K_s' y_s) / d_col

so the original matrix never needs to live on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpdlp_torch.device import resolve_device
from tpdlp_torch.ops.exact_dense import ExactDenseOp


@dataclasses.dataclass
class LPProblem:
    """Host-side standard-form LP (dense numpy or scipy.sparse K)."""

    c: np.ndarray  # (n,)
    K: Any  # (m, n) numpy array or scipy.sparse matrix
    q: np.ndarray  # (m,)
    m_ineq: int
    l: np.ndarray  # (n,)
    u: np.ndarray  # (n,)
    name: str = "lp"
    #: Constant objective offset, included in SolveResult.objective.
    obj_offset: float = 0.0
    #: Original objective sense ("MIN"/"MAX"); c is always minimisation form.
    objsense: str = "MIN"

    @property
    def shape(self) -> tuple[int, int]:
        return self.K.shape

    @property
    def n(self) -> int:
        return self.K.shape[1]

    @property
    def m(self) -> int:
        return self.K.shape[0]

    @property
    def m_eq(self) -> int:
        return self.m - self.m_ineq

    def validate(self) -> None:
        m, n = self.K.shape
        def _req(cond, msg):
            if not cond:
                raise ValueError(f"invalid LPProblem {self.name!r}: {msg}")
        _req(self.c.shape == (n,), f"c has shape {self.c.shape}, expected ({n},)")
        _req(self.q.shape == (m,), f"q has shape {self.q.shape}, expected ({m},)")
        _req(self.l.shape == (n,), f"l has shape {self.l.shape}, expected ({n},)")
        _req(self.u.shape == (n,), f"u has shape {self.u.shape}, expected ({n},)")
        _req(0 <= self.m_ineq <= m, f"m_ineq={self.m_ineq} outside [0, {m}]")
        bad = np.flatnonzero(~(self.l <= self.u))
        _req(bad.size == 0,
             f"box bounds l > u at variable indices {bad[:5].tolist()}")
        pinched_inf = np.flatnonzero(
            (self.l == self.u) & ~np.isfinite(self.l)
        )
        _req(pinched_inf.size == 0,
             "variables pinned at an infinite value (l == u == +-inf) at "
             f"indices {pinched_inf[:5].tolist()}")
        for label, v in (("c", self.c), ("q", self.q)):
            _req(np.all(np.isfinite(v)), f"non-finite entries in {label}")
        _req(not np.any(np.isnan(self.l)) and not np.any(np.isnan(self.u)),
             "NaN entries in bounds")


def as_problem(p) -> LPProblem:
    """This package's LPProblem for any object with LPProblem's fields (the
    JAX package's LPProblem included)."""
    if isinstance(p, LPProblem):
        return p
    return LPProblem(
        c=np.asarray(p.c), K=p.K, q=np.asarray(p.q), m_ineq=int(p.m_ineq),
        l=np.asarray(p.l), u=np.asarray(p.u),
        name=getattr(p, "name", "lp"),
        obj_offset=float(getattr(p, "obj_offset", 0.0)),
        objsense=getattr(p, "objsense", "MIN"),
    )


def _zeroed_at_inf(v, inf_mask):
    return torch.where(inf_mask, torch.zeros((), dtype=v.dtype,
                                             device=v.device), v)


@dataclasses.dataclass
class DeviceProblem:
    """Device-side problem (scaled data + unscaled termination data).

    A fleet (tpdlp_torch/batch) holds the same fields with a leading batch
    axis: (B, n) / (B, m) vectors and (B, 1) norms; a K shared by the fleet
    keeps one operator and (m,) / (n,) diagonals."""

    op: Any  # LinOp for the scaled K_s
    c: torch.Tensor  # (n,) scaled
    q: torch.Tensor  # (m,) scaled
    l: torch.Tensor  # (n,) scaled
    u: torch.Tensor  # (n,) scaled
    ineq_mask: torch.Tensor  # (m,) bool, True on inequality rows
    is_neg_inf: torch.Tensor  # (n,) bool, l == -inf
    is_pos_inf: torch.Tensor  # (n,) bool, u == +inf
    l_dual: torch.Tensor  # (n,) scaled l with -inf entries zeroed
    u_dual: torch.Tensor  # (n,) scaled u with +inf entries zeroed
    # Diagonal scaling (ones when unscaled): K_s = diag(d_row) K diag(d_col).
    d_row: torch.Tensor  # (m,)
    d_col: torch.Tensor  # (n,)
    # Original (unscaled) data for termination.
    c0: torch.Tensor
    q0: torch.Tensor
    l0_dual: torch.Tensor
    u0_dual: torch.Tensor
    # Termination norms (0-d tensors).
    q_norm_term: torch.Tensor
    c_norm_term: torch.Tensor

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.q.shape[-1]


def device_problem(
    op,
    c,
    q,
    l,
    u,
    m_ineq: int,
    *,
    d_row=None,
    d_col=None,
    c0=None,
    q0=None,
    l0=None,
    u0=None,
    ineq_mask=None,
    compat_scaled_norms: bool = True,
) -> DeviceProblem:
    """Assemble a DeviceProblem from (possibly scaled) tensors.

    When `d_row`/`d_col` are None the problem is unscaled and the original
    data coincides with the scaled data.  `ineq_mask` overrides the default
    prefix mask."""
    m, n = op.shape
    dtype, dev = c.dtype, c.device
    if d_row is None:
        d_row = torch.ones((m,), dtype=dtype, device=dev)
        d_col = torch.ones((n,), dtype=dtype, device=dev)
        c0, q0, l0, u0 = c, q, l, u

    is_neg_inf = torch.isneginf(l)
    is_pos_inf = torch.isposinf(u)
    if ineq_mask is None:
        ineq_mask = torch.arange(m, device=dev) < m_ineq
    else:
        ineq_mask = torch.as_tensor(ineq_mask, device=dev)

    # Infinite bounds are zeroed in the adjusted-dual inner products.
    l_dual = _zeroed_at_inf(l, is_neg_inf)
    u_dual = _zeroed_at_inf(u, is_pos_inf)
    l0_dual = _zeroed_at_inf(l0, is_neg_inf)
    u0_dual = _zeroed_at_inf(u0, is_pos_inf)

    # The reference takes the termination norms from the data handed to the
    # algorithm: the scaled data when preconditioned.
    if compat_scaled_norms:
        q_norm_term = torch.linalg.vector_norm(q)
        c_norm_term = torch.linalg.vector_norm(c)
    else:
        q_norm_term = torch.linalg.vector_norm(q0)
        c_norm_term = torch.linalg.vector_norm(c0)

    return DeviceProblem(
        op=op, c=c, q=q, l=l, u=u,
        ineq_mask=ineq_mask, is_neg_inf=is_neg_inf, is_pos_inf=is_pos_inf,
        l_dual=l_dual, u_dual=u_dual, d_row=d_row, d_col=d_col,
        c0=c0, q0=q0, l0_dual=l0_dual, u0_dual=u0_dual,
        q_norm_term=q_norm_term, c_norm_term=c_norm_term,
    )


def triplet_transfer_wins(
    dense_elems: int, nnz: int, dtype, index_bytes: int = 8
) -> bool:
    """Is shipping COO triplets + an on-device scatter cheaper than the
    dense host->device transfer?  Requires a 2x margin."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return nnz * (index_bytes + itemsize) < dense_elems * itemsize // 2


def _vec(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def to_device_arrays(problem, dtype=torch.float32, *, device=None):
    """Host LPProblem -> (ExactDenseOp, c, q, l, u) device tensors.

    Sparse host matrices are densified ON the device from their COO
    triplets; duplicate entries are summed, as the JAX package's
    `.at[].add` does."""
    dev = resolve_device(device)
    K = problem.K
    if hasattr(K, "toarray"):
        coo = K.tocoo()
        m, n = coo.shape
        if triplet_transfer_wins(m * n, coo.nnz, dtype):
            mat = dense_from_coo(coo, dtype, dev)
        else:
            mat = _vec(K.toarray(), dtype, dev)
    else:
        mat = _vec(K, dtype, dev)
    op = ExactDenseOp.build(mat)
    del mat
    return (op, *device_vectors(problem, dtype, dev))


def dense_from_coo(coo, dtype, device) -> torch.Tensor:
    """The dense (m, n) matrix of COO triplets, scattered on `device`
    (duplicates summed, as the JAX package's `.at[].add` does)."""
    mat = torch.zeros(coo.shape, dtype=dtype, device=device)
    idx = (
        torch.as_tensor(coo.row.astype(np.int64), device=device),
        torch.as_tensor(coo.col.astype(np.int64), device=device),
    )
    mat.index_put_(idx, _vec(coo.data, dtype, device), accumulate=True)
    return mat


def device_vectors(problem, dtype, device):
    """(c, q, l, u) of a host LPProblem as device tensors."""
    return tuple(_vec(v, dtype, device)
                 for v in (problem.c, problem.q, problem.l, problem.u))
