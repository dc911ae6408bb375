"""The port's dense operator and its kernel's plain twin against the JAX
package: the exact matvec (its Pallas kernel in interpret mode, and fp64
numpy), the LinOp contract against JAX's DenseOp, the padded layout,
scale and astype.  The CUDA kernel itself runs only on the card (the
`cuda` tests skip here; chip_smoke.py holds it against the twin there)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpdlp.ops.dense import DenseOp
from tpdlp.ops.pallas_dense import _pad_to_grid, matvec_exact
from tpdlp_torch.ops import _kernels
from tpdlp_torch.ops._kernels import (
    ROW_ALIGN,
    dense_matvec,
    dense_matvec_plain,
)
from tpdlp_torch.ops.exact_dense import ExactDenseOp, pad_rows

torch.set_num_threads(2)


def _tol(n):
    # test_pallas_dense.py's fp32 accumulation scale.
    return 6e-8 * max(4, n) ** 0.5 * 30


@pytest.mark.parametrize(
    "m,n",
    [(27, 51), (2000, 700), (8, 128), (130, 1100), (1, 1), (257, 2049),
     (16, 9000)],
)
def test_plain_matvec_matches_jax_kernel_and_fp64(rng, m, n):
    """The port's fp32 product == the Pallas kernel (interpret mode) and
    fp64 numpy, to fp32 accumulation accuracy, on the padded layout."""
    K = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    op = ExactDenseOp.build(torch.from_numpy(K))
    y = op.mv(torch.from_numpy(x)).numpy()

    Kp = _pad_to_grid(jnp.asarray(K))
    xp = jnp.zeros(Kp.shape[1], jnp.float32).at[:n].set(jnp.asarray(x))
    y_jax = np.asarray(matvec_exact(Kp, xp, interpret=True))[:m]
    ref = K.astype(np.float64) @ x.astype(np.float64)
    assert y.dtype == np.float32 and y.shape == (m,)
    assert np.max(np.abs(y - ref) / (1 + np.abs(ref))) < _tol(n)
    assert np.max(np.abs(y - y_jax) / (1 + np.abs(y_jax))) < 2 * _tol(n)


def test_plain_matvec_row_blocks_equal_one_pass(rng):
    """The CPU twin's row blocks give what a single pass gives."""
    K = torch.from_numpy(rng.standard_normal((300, 1000)))
    x = torch.from_numpy(rng.standard_normal(1000))
    y = dense_matvec_plain(K, x)
    torch.testing.assert_close(y, (K * x).sum(dim=1), rtol=0, atol=0)
    assert y.shape == (300,)


def test_padded_layout(rng):
    """Row strides are multiples of ROW_ALIGN, padding is zero, K' is the
    exact transpose of the stored K, stored_bytes counts the padding."""
    m, n = 37, 53
    K = torch.from_numpy(rng.standard_normal((m, n)))
    op = ExactDenseOp.build(K)
    assert op.fwd.shape == (m, 56) and op.fwd.stride(0) % ROW_ALIGN == 0
    assert torch.all(op.fwd[:, n:] == 0)
    torch.testing.assert_close(op.mat, K, rtol=0, atol=0)
    assert op.bwd.shape == (n, 40) and torch.all(op.bwd[:, m:] == 0)
    torch.testing.assert_close(op.bwd[:, :m], K.T, rtol=0, atol=0)
    assert op.stored_bytes() == (m * 56 + n * 40) * 8
    # An aligned contiguous matrix is used as it is (no copy).
    A = torch.zeros((4, 8))
    assert pad_rows(A) is A


def test_linop_parity_with_jax_dense_op(rng):
    """ExactDenseOp == JAX's DenseOp on every LinOp method (mirrors
    tests/test_pallas_dense.py::test_exact_op_linop_parity)."""
    m, n = 77, 130
    K = rng.standard_normal((m, n)).astype(np.float32)
    op = ExactDenseOp.build(torch.from_numpy(K))
    ref = DenseOp(jnp.asarray(K))
    assert op.shape == (m, n)
    assert op.dtype == torch.float32
    assert op.device.type == "cpu"
    assert not op.has_fast_products
    np.testing.assert_allclose(op.mat.numpy(), K, rtol=0)
    xn = rng.standard_normal(n).astype(np.float32)
    yn = rng.standard_normal(m).astype(np.float32)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    close = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(op.mv(x).numpy(),
                               np.asarray(ref.mv(jnp.asarray(xn))), **close)
    np.testing.assert_allclose(op.rmv(y).numpy(),
                               np.asarray(ref.rmv(jnp.asarray(yn))), **close)
    np.testing.assert_array_equal(op.mv_fast(x).numpy(), op.mv(x).numpy())
    np.testing.assert_array_equal(op.rmv_fast(y).numpy(), op.rmv(y).numpy())
    X = rng.standard_normal((n, 3)).astype(np.float32)
    Y = rng.standard_normal((m, 3)).astype(np.float32)
    np.testing.assert_allclose(op.mm(torch.from_numpy(X)).numpy(),
                               np.asarray(ref.mm(jnp.asarray(X))), **close)
    np.testing.assert_allclose(op.rmm(torch.from_numpy(Y)).numpy(),
                               np.asarray(ref.rmm(jnp.asarray(Y))), **close)
    for ord_ in ("inf", 1.0, 2.0):
        np.testing.assert_allclose(op.row_abs_norms(ord_).numpy(),
                                   np.asarray(ref.row_abs_norms(ord_)),
                                   rtol=1e-4)
        np.testing.assert_allclose(op.col_abs_norms(ord_).numpy(),
                                   np.asarray(ref.col_abs_norms(ord_)),
                                   rtol=1e-4)
    dr = rng.uniform(0.5, 2.0, m).astype(np.float32)
    dc = rng.uniform(0.5, 2.0, n).astype(np.float32)
    s = op.scale(torch.from_numpy(dr), torch.from_numpy(dc))
    rs = ref.scale(jnp.asarray(dr), jnp.asarray(dc))
    np.testing.assert_allclose(s.mv(x).numpy(),
                               np.asarray(rs.mv(jnp.asarray(xn))), **close)
    np.testing.assert_allclose(s.rmv(y).numpy(),
                               np.asarray(rs.rmv(jnp.asarray(yn))), **close)


def test_scale_rounds_like_jax_and_keeps_padding(rng):
    """fp64 scale is bit-identical to DenseOp.scale ((K*d_row)*d_col);
    the padding stays zero and K' is rebuilt from the scaled K."""
    m, n = 19, 31
    K = rng.standard_normal((m, n))
    dr, dc = rng.uniform(0.1, 3, m), rng.uniform(0.1, 3, n)
    op = ExactDenseOp.build(torch.from_numpy(K))
    op.rmv(torch.ones(m, dtype=torch.float64))  # materialise K'
    s = op.scale(torch.from_numpy(dr), torch.from_numpy(dc))
    want = np.asarray(DenseOp(jnp.asarray(K)).scale(jnp.asarray(dr),
                                                    jnp.asarray(dc)).mat)
    np.testing.assert_array_equal(s.mat.numpy(), want)
    assert torch.all(s.fwd[:, n:] == 0)
    np.testing.assert_array_equal(s.bwd[:, :m].numpy(), want.T)
    # The unscaled operator is untouched.
    np.testing.assert_array_equal(op.mat.numpy(), K)


def test_astype_keeps_logical_shape(rng):
    K = torch.from_numpy(rng.standard_normal((10, 7)).astype(np.float32))
    op = ExactDenseOp.build(K)
    o64 = op.astype(torch.float64)
    assert o64.dtype == torch.float64 and o64.shape == (10, 7)
    np.testing.assert_array_equal(o64.mat.numpy(), K.numpy().astype(
        np.float64))
    x = torch.ones(7, dtype=torch.float64)
    np.testing.assert_allclose(o64.mv(x).numpy(),
                               K.numpy().astype(np.float64).sum(1),
                               rtol=1e-12)


def test_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU never takes the plain twin: the
    wrapper launches the kernel or raises (here: no CUDA device)."""
    M = torch.empty((4, 4), device="meta")
    x = torch.empty((4,), device="meta")
    before = _kernels.launches["dense_matvec"]
    with pytest.raises(ValueError, match="CUDA"):
        dense_matvec(M, x)
    assert _kernels.launches["dense_matvec"] == before


def test_build_targets_hopper_and_tracks_sources():
    """nvcc builds sm_90a from the package's sources into a file named by
    their hash, under the ignored build directory."""
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    path = _kernels.library_path()
    assert path.parent == _kernels.BUILD_DIR
    assert path.name.startswith("libtpdlp_torch_")
    replaces = {
        "dense_matvec.cu": "tpdlp/ops/pallas_dense.py::_matvec_kernel",
        "band_matvec.cu": "tpdlp/ops/band.py::_band_kernel",
        # No TPU kernel: the JAX sparse operator's XLA product.
        "csr_matvec.cu": "tpdlp/ops/sparse.py::SparseOp",
    }
    assert set(_kernels.SOURCES) == set(replaces)
    for src in _kernels.SOURCES:
        text = (_kernels.CSRC / src).read_text()
        assert replaces[src] in text


def test_library_path_tracks_headers(tmp_path):
    """Every source and header in csrc names the library: an edited header
    in a copy of csrc gives another library path, so it is rebuilt."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    assert _kernels.library_path(csrc) == _kernels.library_path()
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert _kernels.library_path(csrc) != _kernels.library_path()
