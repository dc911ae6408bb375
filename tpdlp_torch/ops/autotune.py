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


#: Timed replays of each captured chain on a CUDA device (after one
#: untimed replay); the median is kept.
GRAPH_REPLAYS = 5


def _chain_inputs(op):
    """The seeded x and y every timing of `op` starts from."""
    m, n = op.shape
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    x = torch.randn((n,), generator=g, dtype=torch.float64).to(
        dtype=op.dtype, device=op.device)
    y = torch.randn((m,), generator=g, dtype=torch.float64).to(
        dtype=op.dtype, device=op.device)
    return x, y


def _chain(op, x, y, passes, dy):
    """`passes` chained K x / K'y pairs: each pass feeds the next."""
    xv, yv = x, y + dy
    for _ in range(passes):
        kx = op.mv(xv)
        kty = op.rmv(yv)
        xv = xv + kty / (1.0 + torch.max(torch.abs(kty)))
        yv = yv + kx / (1.0 + torch.max(torch.abs(kx)))
    return xv, yv


def _time_op_host(op, lo, hi) -> float:
    """The CPU rule: host seconds around each chain, which ends in nothing
    but its own work there."""
    x, y = _chain_inputs(op)

    def timed(passes, dy):
        _chain(op, x, y, passes, dy)  # warm-up
        t0 = time.perf_counter()
        _chain(op, x, y, passes, dy + 1.0)  # perturbed: never the warm-up's
        return time.perf_counter() - t0

    t_lo = timed(lo, 0.0)
    t_hi = timed(hi, 2.0)
    return max(t_hi - t_lo, 1e-9) / (hi - lo)


def _time_op_graphs(op, lo, hi) -> float:
    """The CUDA rule: each chain captured once as a CUDA graph and its
    replays timed by CUDA events, so Python's launches never enter the
    timed window; seconds per pair are the slope of the two medians.

    The eager warm-up chains (with the host rule's inputs) run every
    kernel's one-time set-up (the shared-memory opt-in and the SM-count
    query of csrc/pipeline.cuh, the lazily built K' of ExactDenseOp)
    before capture.  The kernel wrappers count what a capture records; the
    capture itself launches nothing, so that count is taken back and added
    again at every replay (`_kernels.launches` stays the count of kernels
    the card ran).  The graphs and their memory pool are freed before
    this returns."""
    from tpdlp_torch.ops import _kernels

    dev = op.device
    x, y = _chain_inputs(op)
    before = sum(_kernels.launches.values())
    _chain(op, x, y, lo, 0.0)
    _chain(op, x, y, hi, 2.0)
    torch.cuda.synchronize(dev)
    warm = sum(_kernels.launches.values()) - before
    if isinstance(op, (ExactDenseOp, BandOp, SparseOp)) and (
            warm != 2 * (lo + hi)):
        raise RuntimeError(f"autotune warm-up launched {warm} kernels, "
                           f"expected {2 * (lo + hi)}")

    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for passes, dy in ((lo, 1.0), (hi, 3.0)):  # the host rule's inputs
        counted = dict(_kernels.launches)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph, pool=pool):
            _chain(op, x, y, passes, dy)
        recorded = {k: _kernels.launches[k] - counted[k] for k in counted}
        _kernels.launches.update(counted)
        graphs.append((graph, recorded))

    def replay(graph, recorded):
        graph.replay()
        for k, v in recorded.items():
            _kernels.launches[k] += v

    medians = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        for graph, recorded in graphs:
            replay(graph, recorded)  # untimed
            times = []
            for _ in range(GRAPH_REPLAYS):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record(stream)
                replay(graph, recorded)
                t1.record(stream)
                t1.synchronize()
                times.append(t0.elapsed_time(t1) * 1e-3)
            medians.append(sorted(times)[len(times) // 2])
    torch.cuda.synchronize(dev)
    for graph, _ in graphs:
        graph.reset()
    del graphs, graph, pool
    torch.cuda.empty_cache()
    t_lo, t_hi = medians
    return max(t_hi - t_lo, 1e-12) / (hi - lo)


def autotune_launches(op_count: int = 1, kkt_passes: int = 10) -> int:
    """Kernel launches of `op_count` timings on a CUDA device by an
    operator with a kernel: the eager warm-up chains and, per captured
    chain, one untimed and GRAPH_REPLAYS timed replays, two launches a
    pair."""
    lo, hi = kkt_passes, 6 * kkt_passes
    return op_count * 2 * (lo + hi) * (2 + GRAPH_REPLAYS)


def _time_op(op, kkt_passes: int = 10) -> float:
    """Marginal seconds per K x / K'y pair of `op`.

    Chained pairs (each pass feeds the next, and a timed chain starts from
    a perturbed y, never from a repeat of the warm-up's inputs), timed at
    two chain lengths: the slope cancels the fixed cost of a chain, which
    would otherwise drown the per-pass difference between candidates for
    small operators (the JAX rule, tpdlp/ops/autotune.py).  On a CUDA
    device the chains are timed on the card (`_time_op_graphs`); on the
    CPU by the host's clock."""
    lo, hi = kkt_passes, 6 * kkt_passes
    if op.device.type == "cuda":
        return _time_op_graphs(op, lo, hi)
    return _time_op_host(op, lo, hi)


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
