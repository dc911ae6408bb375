"""The band-slab path of the port against the JAX package, in fp64 on the
CPU on the same numpy inputs: the layout (slabs and starts array for
array), the products and norms, scaling, Ruiz, the fp32 kernel arithmetic
against the Pallas kernel in interpret mode, and whole
`solve(matrix_format="band")` runs.

Exact solve parity (same k, n, j, status; x, y, objective to 1e-9) is
asserted under fixed steps; under the adaptive rule the two packages'
summation orders drift apart (tests/test_torch_solve_parity.py), so there
the same status and an objective within 5*tol are asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpdlp
from tpdlp.ops.band import BandOp as JaxBandOp
from tpdlp.ops.band import _band_matvec_pallas
from tpdlp.ops.band import band_stored_elems as jax_band_stored_elems
from tpdlp.scaling.ruiz import ruiz_equilibrate as jax_ruiz
from tpdlp.scaling.ruiz import scale_problem as jax_scale_problem
from tpdlp.solver.power_iteration import (
    spectral_norm_estimate as jax_spectral_norm,
)
from tpdlp.solver.solve import build_device_operator as jax_build_operator
from tests.test_band import _banded
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch import convert
from tpdlp_torch.bench import band_scale
from tpdlp_torch.ops import _kernels
from tpdlp_torch.ops.band import BandOp, band_stored_elems
from tpdlp_torch.scaling.ruiz import ruiz_equilibrate
from tpdlp_torch.solver.solve import build_device_operator

torch.set_num_threads(2)

SHAPES = [(500, 700, 17), (1024, 1024, 72), (300, 260, 5)]
FIXED = dict(scaling="ruiz", adaptive=False, primal_weight_update=True,
             eta_safety=0.99)
MAIN = dict(scaling="ruiz", adaptive=True, primal_weight_update=True)
#: Banded instances (n, m_ineq, m_eq, bandwidth, seed) of the solve tests.
INSTANCES = {"n520": (520, 260, 130, 33, 1), "n768": (768, 384, 192, 33, 4)}


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def jax_b0(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)


def _ours(K, dtype=torch.float64, **kw):
    return BandOp.from_scipy(K, dtype, device="cpu", **kw)


def _rel(a, b):
    a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
    b = np.asarray(b)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b)), initial=0.0))


def _instance(name):
    n, mi, me, bw, seed = INSTANCES[name]
    return tpdlp.generate_banded_lp(n=n, m_ineq=mi, m_eq=me, bandwidth=bw,
                                    seed=seed)


@pytest.mark.parametrize("m,n,half", SHAPES)
def test_layout_equals_jax(m, n, half):
    K = _banded(m, n, half)
    ours = _ours(K)
    ref = JaxBandOp.from_scipy(K, dtype=jnp.float64)
    host = _ours(K, device_build=False)
    for a, b in ((ours.fwd, ref.fwd), (ours.bwd, ref.bwd)):
        np.testing.assert_array_equal(a.starts.numpy(), np.asarray(b.starts))
        assert a.starts.dtype == torch.int32
        np.testing.assert_allclose(a.slabs.numpy(), np.asarray(b.slabs),
                                   rtol=1e-15, atol=0)
        assert (a.m, a.n) == (b.m, b.n)
    for a, b in ((ours.fwd, host.fwd), (ours.bwd, host.bwd)):
        np.testing.assert_array_equal(a.starts.numpy(), b.starts.numpy())
        np.testing.assert_allclose(a.slabs.numpy(), b.slabs.numpy(),
                                   rtol=1e-15, atol=0)
    assert band_stored_elems(K) == jax_band_stored_elems(K)
    assert ours.stored_bytes() == ref.stored_bytes()
    assert ours.fill_ratio() == pytest.approx(ref.fill_ratio(), rel=1e-15)
    assert ours.shape == (m, n) and ours.dtype == torch.float64
    assert ours.device == torch.device("cpu")


def test_duplicate_triplets_are_summed():
    """COO duplicates add up, in both builds, as in the JAX package."""
    K = _banded(300, 340, 9, seed=6)
    dup = sp.coo_matrix((np.concatenate([K.data, K.data[::3]]),
                         (np.concatenate([K.row, K.row[::3]]),
                          np.concatenate([K.col, K.col[::3]]))),
                        shape=K.shape)
    ref = JaxBandOp.from_scipy(dup, dtype=jnp.float64)
    for device_build in (True, False):
        ours = _ours(dup, device_build=device_build)
        assert ours.nnz == dup.nnz
        assert ours.fill_ratio() == pytest.approx(ref.fill_ratio(),
                                                  rel=1e-15)
        for a, b in ((ours.fwd, ref.fwd), (ours.bwd, ref.bwd)):
            np.testing.assert_allclose(a.slabs.numpy(), np.asarray(b.slabs),
                                       rtol=1e-15, atol=0)
    x = np.random.default_rng(0).standard_normal(340)
    np.testing.assert_allclose(ours.mv(torch.tensor(x)).numpy(),
                               dup.tocsr() @ x, rtol=1e-12)


def test_rejects_unstructured():
    rng = np.random.default_rng(2)
    D = sp.random(300, 4000, density=0.05, random_state=rng)
    assert JaxBandOp.from_scipy(D) is None
    assert BandOp.from_scipy(D, device="cpu") is None
    assert band_stored_elems(D) is None is jax_band_stored_elems(D)


@pytest.mark.parametrize("m,n,half", SHAPES)
def test_products_and_norms_equal_jax(m, n, half):
    rng = np.random.default_rng(3)
    K = _banded(m, n, half)
    ours = _ours(K)
    ref = JaxBandOp.from_scipy(K, dtype=jnp.float64)
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    X = rng.standard_normal((n, 4))
    Y = rng.standard_normal((m, 3))
    before = dict(_kernels.launches)
    pairs = [
        (ours.mv(torch.tensor(x)), ref.fwd.matvec_xla(jnp.asarray(x)), K @ x),
        (ours.rmv(torch.tensor(y)), ref.bwd.matvec_xla(jnp.asarray(y)),
         K.T @ y),
        (ours.fwd.matvec_plain(torch.tensor(x)),
         ref.fwd.matvec_xla(jnp.asarray(x)), K @ x),
        (ours.mm(torch.tensor(X)), ref.mm(jnp.asarray(X)), K @ X),
        (ours.rmm(torch.tensor(Y)), ref.rmm(jnp.asarray(Y)), K.T @ Y),
    ]
    for got, want, exact in pairs:
        assert got.shape == np.asarray(exact).shape
        assert _rel(got, want) <= 1e-12
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-10,
                                   atol=1e-12)
    assert _kernels.launches == before  # CPU tensors take the twin
    for ord_ in ("inf", 2.0, 1.0):
        assert _rel(ours.row_abs_norms(ord_), ref.row_abs_norms(ord_)) <= (
            1e-12)
        assert _rel(ours.col_abs_norms(ord_), ref.col_abs_norms(ord_)) <= (
            1e-12)
    np.testing.assert_allclose(ours.row_abs_norms("inf").numpy(),
                               np.abs(K).max(axis=1).toarray().ravel(),
                               rtol=1e-12)
    np.testing.assert_allclose(
        ours.col_abs_norms(2.0).numpy(),
        np.sqrt(np.asarray(K.multiply(K).sum(axis=0)).ravel()), rtol=1e-10)


def test_scale_equals_jax():
    rng = np.random.default_rng(5)
    K = _banded(400, 520, 20)
    dr = rng.uniform(0.5, 2.0, 400)
    dc = rng.uniform(0.5, 2.0, 520)
    ref = JaxBandOp.from_scipy(K, dtype=jnp.float64).scale(
        jnp.asarray(dr), jnp.asarray(dc))
    op = _ours(K)
    out = op.scale(torch.tensor(dr), torch.tensor(dc))
    orig = op.fwd.slabs.clone()
    for a, b in ((out.fwd, ref.fwd), (out.bwd, ref.bwd)):
        np.testing.assert_array_equal(a.slabs.numpy(), np.asarray(b.slabs))
    assert torch.equal(op.fwd.slabs, orig)  # `scale` leaves op as it is
    inplace = op.scale_(torch.tensor(dr), torch.tensor(dc))
    assert inplace is op
    np.testing.assert_array_equal(op.fwd.slabs.numpy(),
                                  out.fwd.slabs.numpy())
    np.testing.assert_array_equal(op.bwd.slabs.numpy(),
                                  out.bwd.slabs.numpy())
    Ks = sp.diags(dr) @ K @ sp.diags(dc)
    x = rng.standard_normal(520)
    y = rng.standard_normal(400)
    np.testing.assert_allclose(op.mv(torch.tensor(x)).numpy(), Ks @ x,
                               rtol=1e-10)
    np.testing.assert_allclose(op.rmv(torch.tensor(y)).numpy(), Ks.T @ y,
                               rtol=1e-10)
    f32 = op.astype(torch.float32)
    assert f32.dtype == torch.float32 and f32.nnz == op.nnz
    assert torch.equal(f32.fwd.starts, op.fwd.starts)


def test_fp32_matches_pallas_interpret():
    """The fp32 arithmetic of the kernel's twin against the TPU kernel run
    in interpret mode (tests/test_band.py's tolerance)."""
    K = _banded(640, 640, 30)
    ref = JaxBandOp.from_scipy(K, dtype=jnp.float32)
    op = _ours(K, torch.float32)
    np.testing.assert_array_equal(op.fwd.slabs.numpy(),
                                  np.asarray(ref.fwd.slabs))
    x = np.random.default_rng(1).standard_normal(640).astype(np.float32)
    xw = ref.fwd._windows(jnp.asarray(x))
    want = np.asarray(_band_matvec_pallas(ref.fwd.slabs, xw,
                                          interpret=True)).ravel()[:640]
    got = op.mv(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), K @ x, rtol=2e-4, atol=1e-4)


def test_ruiz_on_band_equals_jax():
    K = _banded(520, 640, 21, seed=8)
    cur, d_row, d_col = ruiz_equilibrate(_ours(K))
    jcur, jd_row, jd_col = jax_ruiz(JaxBandOp.from_scipy(K,
                                                         dtype=jnp.float64))
    assert _rel(d_row, jd_row) <= 1e-12
    assert _rel(d_col, jd_col) <= 1e-12
    assert _rel(cur.fwd.slabs, jcur.fwd.slabs) <= 1e-12
    assert _rel(cur.bwd.slabs, jcur.bwd.slabs) <= 1e-12


def test_carried_jax_band_problem(jax_b0):
    """A JAX-built, JAX-scaled band problem handed to the port through
    tpdlp_torch.convert: the same products and the same ||K|| estimate."""
    p = _instance("n520")
    jop, *jvecs = jax_build_operator(p, jnp.float64, "band")
    js = jax_scale_problem(jop, *jvecs, method="ruiz")
    op = convert.band_op_from_numpy(
        np.asarray(js[0].fwd.slabs), np.asarray(js[0].fwd.starts),
        np.asarray(js[0].bwd.slabs), np.asarray(js[0].bwd.starts),
        p.m, p.n, device="cpu")
    names = ("c", "q", "l", "u", "d_row", "d_col")
    arrays = dict(zip(names, (np.asarray(v) for v in js[1:])))
    pb = tpdlp_torch.problem.device_problem(
        op, *(torch.tensor(arrays[k]) for k in ("c", "q", "l", "u")),
        p.m_ineq, d_row=torch.tensor(arrays["d_row"]),
        d_col=torch.tensor(arrays["d_col"]),
        c0=torch.tensor(p.c), q0=torch.tensor(p.q), l0=torch.tensor(p.l),
        u0=torch.tensor(p.u))
    d = {f: getattr(pb, f).numpy() for f in (
        "c", "q", "l", "u", "ineq_mask", "is_neg_inf", "is_pos_inf",
        "l_dual", "u_dual", "d_row", "d_col", "c0", "q0", "l0_dual",
        "u0_dual", "q_norm_term", "c_norm_term")}
    d["op"] = op
    carried = convert.problem_from_numpy(d, device="cpu")
    assert carried.op is op and carried.op.dtype == torch.float64
    x = np.random.default_rng(0).standard_normal(p.n)
    assert _rel(carried.op.mv(torch.tensor(x)),
                js[0].mv(jnp.asarray(x))) <= 1e-12
    ours = PI.spectral_norm_estimate(carried.op, 3, 50)
    ref = jax_spectral_norm(js[0], jax.random.PRNGKey(3), 50)
    assert _rel(ours, ref) <= 1e-12


def _both(p, solve_kw=None, **cfg_kw):
    solve_kw = dict(matrix_format="band", **(solve_kw or {}))
    rj = tpdlp.solve(p, tpdlp.SolverConfig(**cfg_kw), dtype=jnp.float64,
                     **solve_kw)
    rt = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**cfg_kw),
                           device="cpu", dtype=torch.float64, **solve_kw)
    return rj, rt


def _exact(ra, rb, tol=1e-9):
    assert ra.status == rb.status
    assert (ra.iterations, ra.restarts, ra.kkt_passes) == (
        rb.iterations, rb.restarts, rb.kkt_passes)
    for f in ("x", "y", "objective"):
        assert _rel(getattr(ra, f), getattr(rb, f)) <= tol, f


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_band_solve_fixed_steps_exact(jax_b0, name):
    rj, rt = _both(_instance(name), tol=1e-4, **FIXED)
    assert rj.status == tpdlp.Status.SOLVED
    _exact(rt, rj)


def test_band_solve_main_path_same_answer(jax_b0):
    tol = 1e-4
    rj, rt = _both(_instance("n768"), tol=tol, **MAIN)
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert abs(rt.objective - rj.objective) <= 5 * tol * (
        1 + abs(rj.objective))


def test_band_against_dense_in_the_port():
    """Same instance, band and dense layouts: the same solve."""
    p = _instance("n520")
    cfg = tpdlp_torch.SolverConfig(tol=1e-4, **FIXED)
    cache = {}
    rb = tpdlp_torch.solve(p, cfg, device="cpu", matrix_format="band",
                           op_cache=cache)
    rd = tpdlp_torch.solve(p, cfg, device="cpu", matrix_format="dense",
                           op_cache=cache)
    assert rb.status == tpdlp_torch.Status.SOLVED
    _exact(rb, rd)
    # The cache keys each layout apart, and a reused band op gives the
    # same solve.
    assert sorted(k[0] for k in cache) == ["band", "dense"]
    again = tpdlp_torch.solve(p, cfg, device="cpu", matrix_format="band",
                              op_cache=cache)
    assert len(cache) == 2
    np.testing.assert_array_equal(again.x, rb.x)


def test_build_device_operator_band():
    p = _instance("n520")
    op, c, q, l, u = build_device_operator(p, torch.float64, "band", "cpu")
    assert isinstance(op, BandOp) and op.shape == p.shape
    np.testing.assert_array_equal(c.numpy(), p.c)
    np.testing.assert_array_equal(u.numpy(), p.u)
    # The other layouts build too; an unknown one is refused.
    from tpdlp_torch.ops.sparse import SparseOp

    sp_op = build_device_operator(p, torch.float64, "sparse", "cpu")[0]
    assert isinstance(sp_op, SparseOp) and sp_op.shape == p.shape
    with pytest.raises(ValueError, match="unknown matrix_format"):
        build_device_operator(p, torch.float64, "coo", "cpu")
    wide = tpdlp_torch.generate_feasible_lp(n=4000, m_ineq=100, m_eq=40,
                                            density=0.05, seed=0)
    with pytest.raises(ValueError, match="band-like"):
        build_device_operator(wide, torch.float64, "band", "cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_banded_lp_identical(seed):
    kw = dict(n=300, m_ineq=120, m_eq=70, bandwidth=21, seed=seed)
    a = tpdlp_torch.generate_banded_lp(**kw)
    b = tpdlp.generate_banded_lp(**kw)
    assert a.name == b.name and a.m_ineq == b.m_ineq
    for f in ("c", "q", "l", "u"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a.K, f), getattr(b.K, f))
    assert a.K.shape == b.K.shape


def test_band_scale_on_cpu(capsys):
    row = band_scale.main(["--n", "520", "--m_ineq", "260", "--m_eq", "130",
                           "--bandwidth", "33", "--seed", "1", "--no-warm",
                           "--device", "cpu"])
    assert row["status"] == "Solved"
    assert row["backend"] == "cpu" and row["device"] == "cpu"
    assert row["band_stored_mb"] > 0 and row["iterations"] > 0
    assert row["nnz"] == int(_instance("n520").K.nnz)
    assert '"instance": "banded-520-260-130-33"' in capsys.readouterr().out


def test_kernel_wrapper_rejects_non_cuda():
    """A tensor on neither the CPU nor CUDA is refused, not computed."""
    slabs = torch.zeros((8, 128, 128), device="meta")
    starts = torch.zeros(8, dtype=torch.int32, device="meta")
    before = dict(_kernels.launches)
    with pytest.raises(ValueError, match="same CUDA device"):
        _kernels.band_matvec(slabs, starts, torch.zeros(100, device="meta"),
                             1000, 100)
    with pytest.raises(ValueError, match="same CUDA device"):
        _kernels.band_matvec(torch.zeros((8, 128, 128)),
                             torch.zeros(8, dtype=torch.int32),
                             torch.zeros(100, device="meta"), 1000, 100)
    assert _kernels.launches == before
