"""Operator-layout autotune for matrix_format="auto" (counterpart of
tpdlp/ops/autotune.py).

Time the K x / K'y pair of each candidate layout on the target device and
keep the fastest.  Candidates on a CUDA device (and on the CPU alike):

- dense, the exact dense operator over kernel K1 (csrc/dense_matvec.cu),
  only when the dense matrix fits the memory budget;
- band, over kernel K2 (csrc/band_matvec.cu), when K is band-like and its
  slabs are smaller than the dense matrix and fit the budget;
- blocked (block-ELL), when the layout's size estimate fits the budget and,
  with dense contending, its tiles are filled at least 1.5x as densely as
  the dense matrix;
- sparse (CSR, csrc/csr_matvec.cu), always.

This is the JAX package's accelerator branch with the CSR candidate added:
the JAX package leaves its BCOO operator out on the TPU only because
gathers are slow there, which the H100 does not share.  As there, a matrix
at least `density_threshold` dense goes dense without timing, and no
candidate over the budget is built: a K too large to hold dense, whose
block-ELL estimate is over the budget and which is not band-like, goes to
CSR without building anything else.
"""

from __future__ import annotations

import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.device import resolve_device
from tpdlp_torch.ops.band import BandOp, band_stored_elems
from tpdlp_torch.ops.blocked import BlockEllOp, ell_stored_elems
from tpdlp_torch.ops.exact_dense import ExactDenseOp
from tpdlp_torch.ops.sparse import SparseOp
from tpdlp_torch.problem import dense_from_coo

#: Ceiling on a candidate layout's bytes (the dense matrix's; the band
#: slabs'; the block-ELL tiles').  The solver holds the operator plus a
#: scaled copy plus O(m+n) vectors.  Override with TPDLP_DENSE_BYTES_BUDGET
#: (the JAX package's variable).
_DENSE_BYTES_BUDGET = int(
    os.environ.get("TPDLP_DENSE_BYTES_BUDGET", 4 << 30)
)


def _budget(budget=None) -> int:
    return _DENSE_BYTES_BUDGET if budget is None else budget


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def dense_candidate_allowed(m: int, n: int, dtype, budget=None) -> bool:
    """Would a dense (m, n) matrix of `dtype` fit the autotune budget?"""
    return m * n * _itemsize(dtype) <= _budget(budget)


def _dense_from_coo(coo: sp.coo_matrix, dtype, device):
    """The exact dense operator (kernel K1), built by the port's on-device
    scatter of the COO triplets: the dense array never exists in host
    memory."""
    return ExactDenseOp.build(dense_from_coo(coo, dtype, device))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_op(op, kkt_passes: int = 10) -> float:
    """Marginal seconds per K x / K'y pair of `op`.

    Chained pairs (each pass feeds the next, and a timed chain starts from
    a perturbed y, never from a repeat of the warm-up's inputs), timed at
    two chain lengths: the slope cancels the fixed cost of a chain, which
    would otherwise drown the per-pass difference between candidates for
    small operators.  Each chain ends in a device synchronisation."""
    m, n = op.shape
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    x = torch.randn((n,), generator=g, dtype=torch.float64).to(
        dtype=op.dtype, device=op.device)
    y = torch.randn((m,), generator=g, dtype=torch.float64).to(
        dtype=op.dtype, device=op.device)

    def chain(passes, dy):
        xv, yv = x, y + dy
        for _ in range(passes):
            kx = op.mv(xv)
            kty = op.rmv(yv)
            xv = xv + kty / (1.0 + torch.max(torch.abs(kty)))
            yv = yv + kx / (1.0 + torch.max(torch.abs(kx)))
        return xv, yv

    def timed(passes, dy):
        chain(passes, dy)  # warm-up
        _sync(op.device)
        t0 = time.perf_counter()
        chain(passes, dy + 1.0)  # perturbed: never the warm-up's inputs
        _sync(op.device)
        return time.perf_counter() - t0

    lo, hi = kkt_passes, 6 * kkt_passes
    t_lo = timed(lo, 0.0)
    t_hi = timed(hi, 2.0)
    return max(t_hi - t_lo, 1e-9) / (hi - lo)


def choose_operator(K, dtype=torch.float32, kkt_passes: int = 10,
                    density_threshold: float = 0.25,
                    dense_bytes_budget=None, device=None, timings=None):
    """Return (op, label): the fastest of the candidate layouts (module
    docstring) for K on `device` (CUDA unless the caller names another).

    `timings`: an optional dict that receives each timed candidate's
    seconds per pair by label (empty when no timing was needed)."""
    dev = resolve_device(device)
    coo = K.tocoo() if sp.issparse(K) else sp.coo_matrix(np.asarray(K))
    m, n = coo.shape
    density = coo.nnz / float(max(m * n, 1))
    itemsize = _itemsize(dtype)
    budget = _budget(dense_bytes_budget)
    allow_dense = dense_candidate_allowed(m, n, dtype, budget)

    if allow_dense and density >= density_threshold:
        return _dense_from_coo(coo, dtype, dev), "dense"

    candidates = []
    if allow_dense:
        candidates.append(("dense", _dense_from_coo(coo, dtype, dev)))
    # Band first among the sparse layouts: for banded K its stream has no
    # gather work.  The size estimate (None when K is not band-like) keeps
    # an over-budget slab array from being built.
    band_elems = band_stored_elems(coo)
    if (band_elems is not None and band_elems * itemsize <= budget
            and (not allow_dense or band_elems * itemsize < m * n * itemsize)):
        band = BandOp.from_scipy(coo, dtype, device=dev)
        if band is not None:
            candidates.append(("band", band))
    # Estimate the block-ELL size before building it: the host build
    # allocates the full zero-padded float64 tiles.
    if ell_stored_elems(coo) * itemsize <= budget:
        blocked = BlockEllOp.from_scipy(coo, dtype, device=dev)
        if not allow_dense or blocked.fill_ratio() > density * 1.5:
            candidates.append(("blocked", blocked))
        else:
            del blocked
    candidates.append(("sparse", SparseOp.from_scipy(coo, dtype, device=dev)))

    if len(candidates) == 1:
        label, op = candidates[0]
        return op, label
    timed = []
    for label, op in candidates:
        seconds = _time_op(op, kkt_passes)
        if timings is not None:
            timings[label] = seconds
        timed.append((seconds, label, op))
    _, label, op = min(timed, key=lambda t: t[0])
    return op, label
