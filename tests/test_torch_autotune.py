"""The port's layout autotune (`tpdlp_torch.ops.autotune`) against the JAX
package's rules: the dense-budget predicate, and every branch of
`choose_operator` with the timing replaced by a fixed table (which
candidates are built, which is returned), then one real timing on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpdlp.ops import autotune as jax_autotune
import tpdlp_torch
from tpdlp_torch.ops import autotune as A
from tpdlp_torch.ops.band import BandOp
from tpdlp_torch.ops.blocked import BlockEllOp
from tpdlp_torch.ops.exact_dense import ExactDenseOp
from tpdlp_torch.ops.sparse import SparseOp

torch.set_num_threads(2)

LABELS = {ExactDenseOp: "dense", BandOp: "band", BlockEllOp: "blocked",
          SparseOp: "sparse"}


@pytest.mark.parametrize("m,n", [(10, 10), (1000, 2000), (46341, 46341),
                                 (65536, 16384), (8000, 20000)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("budget", [None, 1 << 20])
def test_dense_candidate_allowed_equals_jax(m, n, dtype, budget):
    assert A.dense_candidate_allowed(m, n, getattr(torch, dtype), budget) \
        == jax_autotune.dense_candidate_allowed(m, n, getattr(jnp, dtype),
                                                budget)


def test_budget_default_is_the_jax_one():
    assert A._DENSE_BYTES_BUDGET == jax_autotune._DENSE_BYTES_BUDGET


@pytest.fixture
def fake_times(monkeypatch):
    """_time_op replaced: seconds from `table` by layout; the labels of the
    timed candidates land in `timed`, in order."""
    state = {"table": {}, "timed": []}

    def fake(op, kkt_passes=10):
        label = LABELS[type(op)]
        state["timed"].append(label)
        return state["table"].get(label, 1.0)

    monkeypatch.setattr(A, "_time_op", fake)
    return state


def _random_K(m, n, density, seed=0):
    rng = np.random.default_rng(seed)
    K = sp.random(m, n, density=density, random_state=rng, format="coo")
    K.data = rng.standard_normal(K.nnz)
    return K


def _banded_K(n=1024, bandwidth=9, seed=0):
    p = tpdlp_torch.generate_banded_lp(n=n, m_ineq=n // 2, m_eq=n // 4,
                                       bandwidth=bandwidth, seed=seed)
    return p.K


def _choose(K, **kw):
    timings = {}
    op, label = A.choose_operator(K, torch.float64, device="cpu",
                                  timings=timings, **kw)
    assert LABELS[type(op)] == label
    return op, label, timings


def test_density_shortcut_goes_dense_without_timing(fake_times):
    op, label, timings = _choose(_random_K(40, 60, 0.5))
    assert label == "dense" and timings == {} and fake_times["timed"] == []
    np.testing.assert_array_equal(op.mat.numpy(),
                                  _random_K(40, 60, 0.5).toarray())


def test_dense_over_budget_is_not_a_candidate(fake_times):
    K = _random_K(300, 500, 0.02)
    _, label, timings = _choose(K)
    assert set(timings) == {"dense", "sparse"}  # fill too low for blocked
    _, label, timings = _choose(K, dense_bytes_budget=300 * 500 * 8 - 1)
    assert "dense" not in timings


def test_dense_beats_sparse_when_faster(fake_times):
    K = _random_K(300, 500, 0.02)
    fake_times["table"] = {"dense": 0.5, "sparse": 2.0}
    assert _choose(K)[1] == "dense"
    fake_times["table"] = {"dense": 2.0, "sparse": 0.5}
    assert _choose(K)[1] == "sparse"


def test_band_offered_only_for_band_like_K(fake_times):
    banded = _banded_K()
    _, _, timings = _choose(banded)
    assert "band" in timings
    fake_times["table"] = {"band": 0.1}
    op, label, _ = _choose(banded)
    assert label == "band" and op.shape == banded.shape
    # Not band-like: a dense column block every row group touches.
    _, _, timings = _choose(_random_K(300, 4000, 0.05))
    assert "band" not in timings


def _no_dense(monkeypatch):
    """Dense over the budget while the budget still holds the others."""
    monkeypatch.setattr(A, "dense_candidate_allowed", lambda *a, **k: False)


def test_band_not_offered_when_not_smaller_than_dense(fake_times,
                                                      monkeypatch):
    # 256 x 256 with full-width windows: the slabs are K and K' densely.
    K = _random_K(256, 256, 0.2)
    _, _, timings = _choose(K)
    assert "band" not in timings
    # Without a dense contender the band slabs contend.
    _no_dense(monkeypatch)
    _, _, timings = _choose(K)
    assert "band" in timings and "dense" not in timings


def test_blocked_gated_by_fill(fake_times):
    # Column-clustered sparsity: few dense tiles, fill far above density.
    rng = np.random.default_rng(3)
    K = sp.lil_matrix((256, 2048))
    for i in range(256):
        K[i, (i // 8) * 64 % 2048 + rng.integers(0, 64, 6)] = \
            rng.standard_normal(6)
    K = K.tocoo()
    _, _, timings = _choose(K)
    assert "blocked" in timings
    # Scattered sparsity: the padded tiles hold mostly zeros.
    _, _, timings = _choose(_random_K(256, 2048, 0.003))
    assert "blocked" not in timings


def test_blocked_gated_by_size_estimate(fake_times, monkeypatch):
    K = _random_K(256, 2048, 0.003)
    # No dense contender: blocked contends whatever its fill.
    _no_dense(monkeypatch)
    _, _, timings = _choose(K)
    assert "blocked" in timings and "dense" not in timings
    monkeypatch.setattr(A, "_budget", lambda b=None: 1024)
    _, _, timings = _choose(K)
    assert "blocked" not in timings and "dense" not in timings


def test_csr_last_resort_builds_nothing_else(fake_times, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a candidate over the budget was built")

    monkeypatch.setattr(A, "_dense_from_coo", refuse)
    monkeypatch.setattr(BandOp, "from_scipy", refuse)
    monkeypatch.setattr(BlockEllOp, "from_scipy", refuse)
    op, label, timings = _choose(_random_K(300, 4000, 0.01),
                                 dense_bytes_budget=4096)
    assert label == "sparse" and timings == {} and fake_times["timed"] == []
    assert op.nnz == _random_K(300, 4000, 0.01).nnz


def test_real_timing_on_cpu():
    timings = {}
    K = _random_K(200, 300, 0.05)
    op, label = A.choose_operator(K, torch.float64, kkt_passes=2,
                                  device="cpu", timings=timings)
    assert label in ("dense", "band", "blocked", "sparse")
    assert label in timings and label == min(timings, key=timings.get)
    assert all(t > 0 for t in timings.values())
    x = np.random.default_rng(1).standard_normal(300)
    np.testing.assert_allclose(op.mv(torch.as_tensor(x)).numpy(),
                               K.toarray() @ x, rtol=1e-12, atol=1e-12)


def test_time_op_is_a_positive_slope():
    op = SparseOp.from_scipy(_random_K(50, 80, 0.1), torch.float64,
                             device="cpu")
    assert A._time_op(op, kkt_passes=2) > 0
