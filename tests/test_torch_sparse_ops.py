"""The port's sparse layouts against the JAX package's: `SparseOp` (CSR)
and `BlockEllOp` (block-ELL) products, norms and scaling in fp64 on the
CPU to a relative 1e-12 (the two packages sum in different orders), the
block-ELL layout array for array, and the empty-row/column contract.

The JAX `SparseOp` gives -inf as the inf-norm of an empty row or column
(`jax.ops.segment_max`'s identity); the port gives 0, as every other
operator of both packages does.  There the port is held to the JAX
*dense* operator, and one test records the JAX sparse value."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpdlp
from tpdlp.ops.blocked import BlockEllOp as JaxBlockEll
from tpdlp.ops.blocked import ell_stored_elems as jax_ell_stored_elems
from tpdlp.ops.dense import DenseOp as JaxDense
from tpdlp.ops.sparse import SparseOp as JaxSparse
from tpdlp_torch.ops import _kernels as KN
from tpdlp_torch.ops.blocked import BlockEllOp, ell_stored_elems
from tpdlp_torch.ops.sparse import SparseOp

torch.set_num_threads(2)

ORDS = ("inf", 1.0, 2.0, 0.5)


def _np(a):
    return np.asarray(a, dtype=np.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _close(a, b, rtol=1e-12):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=1e-300)


def _random_K(rng, m, n, density, fmt="csr"):
    K = sp.random(m, n, density=density, random_state=rng, format=fmt)
    K.data = rng.standard_normal(K.nnz)
    return K


def _ops(K, layout):
    jax_op = {"sparse": JaxSparse.from_scipy,
              "blocked": JaxBlockEll.from_scipy}[layout](K, jnp.float64)
    port = {"sparse": SparseOp, "blocked": BlockEllOp}[layout].from_scipy(
        K, torch.float64, device="cpu")
    return jax_op, port


LAYOUTS = ["sparse", "blocked"]
SHAPES = [(37, 23, 0.2), (300, 517, 0.02), (8, 128, 1.0)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("m,n,density", SHAPES)
def test_products_match_jax(rng, layout, m, n, density):
    K = _random_K(rng, m, n, density, "coo")
    jop, op = _ops(K, layout)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    X, Y = rng.standard_normal((n, 3)), rng.standard_normal((m, 3))
    _close(op.mv(_t(x)), jop.mv(jnp.asarray(x)))
    _close(op.rmv(_t(y)), jop.rmv(jnp.asarray(y)))
    _close(op.mm(_t(X)), jop.mm(jnp.asarray(X)))
    _close(op.rmm(_t(Y)), jop.rmm(jnp.asarray(Y)))
    assert op.shape == (m, n) and op.dtype == torch.float64


@pytest.mark.parametrize("layout", LAYOUTS)
def test_norms_and_scale_match_jax(rng, layout):
    K = _random_K(rng, 50, 70, 0.1)
    jop, op = _ops(K, layout)
    dense = JaxDense(jnp.asarray(K.toarray()))
    for ord_ in ORDS:
        for ours, theirs, ref in (
                (op.row_abs_norms(ord_), jop.row_abs_norms(ord_),
                 dense.row_abs_norms(ord_)),
                (op.col_abs_norms(ord_), jop.col_abs_norms(ord_),
                 dense.col_abs_norms(ord_))):
            # The JAX SparseOp's -inf on an empty segment is its fault
            # (see the module docstring): there the dense operator rules.
            finite = np.isfinite(_np(theirs))
            _close(_np(ours)[finite], _np(theirs)[finite])
            _close(ours, ref)
    dr, dc = rng.uniform(0.5, 2.0, 50), rng.uniform(0.5, 2.0, 70)
    x, y = rng.standard_normal(70), rng.standard_normal(50)
    js = jop.scale(jnp.asarray(dr), jnp.asarray(dc))
    ps = op.scale(_t(dr), _t(dc))
    _close(ps.mv(_t(x)), js.mv(jnp.asarray(x)))
    _close(ps.rmv(_t(y)), js.rmv(jnp.asarray(y)))
    # scale_ rounds as scale does, and scale leaves the source alone.
    _close(op.mv(_t(x)), jop.mv(jnp.asarray(x)))
    inplace = _ops(K, layout)[1].scale_(_t(dr), _t(dc))
    np.testing.assert_array_equal(_np(inplace.mv(_t(x))), _np(ps.mv(_t(x))))
    np.testing.assert_array_equal(_np(inplace.rmv(_t(y))),
                                  _np(ps.rmv(_t(y))))


def test_sparse_scale_matches_jax_values(rng):
    """The scaled CSR values equal the JAX BCOO values entry for entry
    ((value * d_row) * d_col, the same rounding)."""
    K = _random_K(rng, 40, 30, 0.15)
    K.sort_indices()
    jop, op = _ops(K, "sparse")
    dr, dc = rng.uniform(0.5, 2.0, 40), rng.uniform(0.5, 2.0, 30)
    js = jop.scale(jnp.asarray(dr), jnp.asarray(dc))
    ps = op.scale(_t(dr), _t(dc))
    np.testing.assert_array_equal(_np(ps.mat.values()), _np(js.mat.data))
    np.testing.assert_array_equal(
        _np(ps.mat.to_dense()), _np(js.mat.todense()))
    np.testing.assert_array_equal(
        _np(ps.mat_t.to_dense()), _np(js.mat_t.todense()))


def test_sparse_duplicates_summed(rng):
    """Duplicate triplets are summed once on the host, in fp64."""
    row = np.array([0, 0, 1, 2, 2, 2])
    col = np.array([1, 1, 0, 2, 0, 2])
    val = np.array([1.0, 2.0, -1.0, 0.5, 4.0, 0.25])
    K = sp.coo_matrix((val, (row, col)), shape=(3, 3))
    op = SparseOp.from_scipy(K, torch.float64, device="cpu")
    assert op.nnz == 4
    np.testing.assert_array_equal(_np(op.mat.to_dense()), K.toarray())
    np.testing.assert_array_equal(_np(op.mat_t.to_dense()), K.toarray().T)


@pytest.mark.parametrize("m,n,density", SHAPES + [(1000, 3000, 0.003)])
def test_ell_layout_equals_jax(rng, m, n, density):
    K = _random_K(rng, m, n, density, "coo")
    jop, op = _ops(K, "blocked")
    for a, b in ((op.fwd, jop.fwd), (op.bwd, jop.bwd)):
        np.testing.assert_array_equal(_np(a.tiles), _np(b.tiles))
        np.testing.assert_array_equal(a.col_idx.numpy(), np.asarray(b.col_idx))
        assert a.col_idx.dtype == torch.int32
    assert ell_stored_elems(K) == jax_ell_stored_elems(K)
    assert op.fill_ratio() == pytest.approx(jop.fill_ratio(), rel=1e-15)


def test_blocked_host_build_stays_on_cpu(rng):
    K = _random_K(rng, 20, 30, 0.2)
    op = BlockEllOp.from_scipy(K, torch.float32, host=True)
    assert op.device.type == "cpu" and op.dtype == torch.float32
    assert op.astype(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("m,n,density", [(37, 23, 0.2), (513, 77, 0.05),
                                         (40, 2000, 0.01)])
def test_csr_twin_matches_dense(rng, m, n, density):
    """The kernel's plain twin (the CPU path) against a dense fp64
    product, on matrices with empty rows; the lane-group size is a power
    of two between 2 and 32."""
    K = _random_K(rng, m, n, density)
    K.sort_indices()
    x = rng.standard_normal(n)
    crow = torch.as_tensor(K.indptr.astype(np.int32))
    col = torch.as_tensor(K.indices.astype(np.int32))
    y = KN.csr_matvec(crow, col, _t(K.data), _t(x))
    np.testing.assert_allclose(y.numpy(), K.toarray() @ x, rtol=1e-12,
                               atol=1e-12)
    g = KN.csr_group(m, K.nnz)
    assert g in (2, 4, 8, 16, 32) and g >= min(32, -(-K.nnz // m))


def _empty_segment_problem():
    """An LP with 13 empty rows and 411 empty columns in K."""
    return tpdlp.generate_feasible_lp(n=2000, m_ineq=600, m_eq=200,
                                      density=0.002, seed=0)


def test_empty_rows_and_columns_have_norm_zero():
    p = _empty_segment_problem()
    K = sp.csr_matrix(p.K)
    empty_r = np.diff(K.indptr) == 0
    empty_c = np.diff(K.tocsc().indptr) == 0
    assert empty_r.sum() == 13 and empty_c.sum() == 411
    dense = JaxDense(jnp.asarray(K.toarray()))
    op = SparseOp.from_scipy(K, torch.float64, device="cpu")
    blocked = BlockEllOp.from_scipy(K, torch.float64, device="cpu")
    for ord_ in ORDS:
        for port in (op, blocked):
            r, c = port.row_abs_norms(ord_), port.col_abs_norms(ord_)
            _close(r, dense.row_abs_norms(ord_))
            _close(c, dense.col_abs_norms(ord_))
            assert (r.numpy()[empty_r] == 0).all()
            assert (c.numpy()[empty_c] == 0).all()


def test_jax_sparse_gives_minus_inf_on_empty_segments():
    """The JAX SparseOp's fault, recorded: -inf inf-norms on empty rows
    and columns, which Ruiz scaling turns into NaN factors."""
    K = sp.csr_matrix(_empty_segment_problem().K)
    jop = JaxSparse.from_scipy(K, jnp.float64)
    rows = np.asarray(jop.row_abs_norms("inf"))
    cols = np.asarray(jop.col_abs_norms("inf"))
    assert np.isneginf(rows[np.diff(K.indptr) == 0]).all()
    assert np.isneginf(cols[np.diff(K.tocsc().indptr) == 0]).all()
    with np.errstate(invalid="ignore"):
        assert np.isnan(np.sqrt(rows[np.isneginf(rows)])).all()
