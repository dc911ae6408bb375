"""Iterative refinement of the port (`tpdlp_torch.solver.refine`) against
the JAX package's (`tpdlp.solver.refine`), on the CPU on the same numpy
inputs.

The host pieces (fp64 residuals, the slack, banded-slack and elastic
forms, the active-set polish) are numpy in both packages and must agree to
1e-15.  Whole `solve_refined` runs use fp32 inner solves, whose adaptive
steps do not replay bit for bit across the packages (their products sum in
different orders), so there the same status is asserted and an objective
within 1e-8 relative of the JAX run and of scipy HiGHS
(tests/oracles.py).  The instances are those of tests/test_refine.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import tpdlp
from tpdlp.io import netlib as jax_netlib
from tpdlp.solver import refine as jax_refine
from tests.oracles import solve_oracle
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.ops.band import band_stored_elems
from tpdlp_torch.solver import refine as R

torch.set_num_threads(2)

TOL_HOST = 1e-15
#: Relative objective agreement of whole refined solves.
TOL_OBJ = 1e-8
REFINE = dict(max_kkt=400_000, scaling="ruiz", adaptive=True,
              abs_gap_termination=True)


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def jax_b0(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)


def _K64(p):
    return (p.K.tocsr().astype(np.float64) if sp.issparse(p.K)
            else np.asarray(p.K, dtype=np.float64))


def _data(p):
    return (_K64(p), np.asarray(p.c, float), np.asarray(p.q, float),
            np.asarray(p.l, float), np.asarray(p.u, float), p.m_ineq)


def _free_bounds():
    p = tpdlp.generate_feasible_lp(n=40, m_ineq=28, m_eq=8, seed=3)
    p.u[::3] = np.inf
    p.l[1::5] = -np.inf
    p.l[2] = -np.inf
    p.u[2] = np.inf  # a free variable
    return p


#: name -> (problem factory, tol, extra solve_refined arguments).
INSTANCES = {
    "afiro": (lambda: jax_netlib.load("afiro", mirrors=[]), 1e-10, {}),
    "free-bounds": (_free_bounds, 1e-9, {}),
    "mixed-bounds": (lambda: tpdlp.generate_feasible_lp(
        n=50, m_ineq=30, m_eq=10, seed=0, bounds="mixed"), 1e-9, {}),
    "suboptimal-freeze": (lambda: tpdlp.generate_feasible_lp(
        n=60, m_ineq=35, m_eq=12, seed=11), 1e-10, {}),
    "banded": (lambda: tpdlp.generate_banded_lp(
        n=1024, m_ineq=512, m_eq=256, bandwidth=33, seed=1), 1e-9,
        {"matrix_format": "band"}),
}


def _host_cases():
    rng = np.random.default_rng(0)
    p = tpdlp.generate_feasible_lp(n=50, m_ineq=30, m_eq=10, seed=0,
                                   bounds="mixed")
    yield "mixed-sparse", p, rng.standard_normal(p.n), rng.standard_normal(
        p.m)
    p = _free_bounds()
    p.K = p.K.toarray()
    yield "free-dense", p, rng.standard_normal(p.n), rng.standard_normal(p.m)
    p = tpdlp.generate_feasible_lp(n=30, m_ineq=0, m_eq=12, seed=4)
    yield "equalities-only", p, rng.standard_normal(p.n), \
        rng.standard_normal(p.m)


HOST_CASES = list(_host_cases())


@pytest.mark.parametrize("name,p,x,y", HOST_CASES,
                         ids=[c[0] for c in HOST_CASES])
def test_host_residuals_equal_jax(name, p, x, y):
    a = jax_refine.host_residuals(*_data(p), x, y)
    b = R.host_residuals(*_data(p), x, y)
    for f in ("primal_res", "dual_res", "gap", "prim_obj", "adjusted_dual"):
        va, vb = getattr(a, f), getattr(b, f)
        assert abs(va - vb) <= TOL_HOST * (1 + abs(va)), f
    for f in ("lam", "rp_vec", "rd_vec"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                   rtol=TOL_HOST, atol=TOL_HOST)
    q_n, c_n = float(np.linalg.norm(p.q)), float(np.linalg.norm(p.c))
    for tol in (1e-2, 1e-6):
        for abs_gap in (False, True):
            assert R._terminated(b, q_n, c_n, tol, abs_gap) == \
                jax_refine._terminated(a, q_n, c_n, tol, abs_gap)


def _same_matrix(a, b):
    a = a.toarray() if sp.issparse(a) else np.asarray(a)
    b = b.toarray() if sp.issparse(b) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=TOL_HOST, atol=0)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("m_ineq", [0, 7, 20])
def test_slack_and_elastic_forms_equal_jax(dense, m_ineq):
    p = tpdlp.generate_feasible_lp(n=35, m_ineq=20, m_eq=6, seed=2)
    K = _K64(p)
    if dense:
        K = K.toarray()
    a = jax_refine._slack_form(K, m_ineq)
    b = R._slack_form(K, m_ineq)
    assert sp.issparse(a) == sp.issparse(b)
    _same_matrix(a, b)
    _same_matrix(jax_refine._elastic_form(a), R._elastic_form(b))


@pytest.mark.parametrize("n,m_ineq,m_eq,bw,seed", [
    (2048, 1024, 512, 65, 3), (700, 300, 100, 17, 0), (512, 0, 256, 9, 1)])
def test_slack_form_banded_equals_jax(n, m_ineq, m_eq, bw, seed):
    p = tpdlp.generate_banded_lp(n=n, m_ineq=m_ineq, m_eq=m_eq,
                                 bandwidth=bw, seed=seed)
    K64 = _K64(p)
    a = jax_refine._slack_form_banded(K64, p.m_ineq)
    b = R._slack_form_banded(K64, p.m_ineq)
    if a is None:
        assert b is None
        return
    np.testing.assert_array_equal(b[1], a[1])
    _same_matrix(a[0], b[0])
    assert band_stored_elems(b[0]) is not None


def _refined(p, tol, monkeypatch, op_cache=None, **kw):
    """(JAX run, port run) of solve_refined with the power-iteration draw
    of the JAX package injected into the port; `op_cache` goes to the
    port's run."""
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)
    a = jax_refine.solve_refined(p, tpdlp.SolverConfig(tol=tol, **REFINE),
                                 solve_fn=tpdlp.solve, seed=0, **kw)
    b = R.solve_refined(p, tpdlp_torch.SolverConfig(tol=tol, **REFINE),
                        solve_fn=tpdlp_torch.solve, seed=0, device="cpu",
                        op_cache=op_cache, **kw)
    return a, b


def _assert_certified(p, r, tol):
    """The reference's criteria, recomputed in fp64 on the host."""
    res = R.host_residuals(*_data(p), np.asarray(r.x, float),
                           np.asarray(r.y, float))
    assert res.primal_res <= tol * (1 + float(np.linalg.norm(p.q)))
    assert res.dual_res <= tol * (1 + float(np.linalg.norm(p.c)))
    assert abs(res.gap) <= tol * (
        1 + abs(res.prim_obj) + abs(res.adjusted_dual))


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_solve_refined_matches_jax_and_highs(name, monkeypatch):
    make, tol, kw = INSTANCES[name]
    p = make()
    cache = {}
    a, b = _refined(p, tol, monkeypatch, op_cache=cache, **kw)
    assert a.status == b.status == tpdlp_torch.Status.SOLVED, (
        a.status_string, b.status_string)
    # Every operator in the layout asked for: a banded run keeps "band"
    # for its corrections (the interleaved slack form), end to end.
    assert {k[0] for k in cache} == {kw.get("matrix_format", "dense")}
    if len(b.escalation["stages"]) > 1:  # corrections ran: K_aug cached
        assert any(k[3] == (p.m, p.n + p.m_ineq) for k in cache)
    _assert_certified(p, b, tol)
    assert abs(b.objective - a.objective) <= TOL_OBJ * (1 + abs(
        a.objective))
    o = solve_oracle(p)
    assert o.status == 0
    assert abs(b.objective - o.fun) <= TOL_OBJ * (1 + abs(o.fun))
    esc = b.escalation
    assert esc["route"] == "refine" and esc["stages"][0]["stage"] == "coarse"
    assert all(s["dtype"] == "float32" for s in esc["stages"])
    assert sum(s["j"] for s in esc["stages"]) <= b.kkt_passes
    assert esc["inner_s"] + esc["host_s"] == pytest.approx(esc["wall_s"])


@pytest.mark.parametrize("max_kkt", [500, 900, 5_000, 50_000, 500_000])
def test_refine_kkt_budget_exhaustion_is_honest(max_kkt, monkeypatch):
    """Never overdraw the budget (the JAX test's contract and allowance:
    one in-flight chunk); an unreachable 1e-14 ends at the JAX run's
    status."""
    p = tpdlp.generate_feasible_lp(n=45, m_ineq=30, m_eq=10, seed=0)
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)
    cfg = dict(REFINE, tol=1e-14, max_kkt=max_kkt)
    a = jax_refine.solve_refined(p, tpdlp.SolverConfig(**cfg),
                                 solve_fn=tpdlp.solve, seed=0)
    b = R.solve_refined(p, tpdlp_torch.SolverConfig(**cfg),
                        solve_fn=tpdlp_torch.solve, seed=0, device="cpu")
    assert b.kkt_passes <= max_kkt + 2100
    assert b.status == a.status
    if b.status != tpdlp_torch.Status.SOLVED:
        assert b.status in (tpdlp_torch.Status.KKT_LIMIT,
                            tpdlp_torch.Status.TIME_LIMIT)


def _polish_inputs():
    """A near-optimal incumbent (the JAX 1e-6 refined solve) on the JAX
    polish test's instance."""
    p = tpdlp.generate_feasible_lp(n=60, m_ineq=40, m_eq=12, seed=5)
    K, c, q, l, u, mi = _data(p)
    K = sp.csr_matrix(K)
    r = jax_refine.solve_refined(
        p, tpdlp.SolverConfig(tol=1e-6, max_kkt=200_000, scaling="ruiz",
                              adaptive=True, refine_polish=False),
        solve_fn=tpdlp.solve, seed=0)
    xh, yh = np.asarray(r.x, float), np.asarray(r.y, float)
    return K, c, q, l, u, mi, xh, yh


@pytest.fixture(scope="module")
def polish_inputs():
    return _polish_inputs()


@pytest.mark.parametrize("max_matvecs", [np.inf, 40.0])
def test_polish_equals_jax(polish_inputs, max_matvecs):
    K, c, q, l, u, mi, xh, yh = polish_inputs
    args = (K, c, q, l, u, mi, xh, yh)
    res_a = jax_refine.host_residuals(*args)
    res_b = R.host_residuals(*args)
    kw = dict(eps_rel=1e-5, max_matvecs=max_matvecs)
    qn, cn = float(np.linalg.norm(q)), float(np.linalg.norm(c))
    xa, ya, ca, sa = jax_refine._active_set_polish(
        *args, res_a, qn, cn, 1e-9, **kw)
    xb, yb, cb, sb = R._active_set_polish(*args, res_b, qn, cn, 1e-9, **kw)
    assert cb == ca and sb == sa
    np.testing.assert_allclose(xb, xa, rtol=TOL_HOST, atol=TOL_HOST)
    np.testing.assert_allclose(yb, ya, rtol=TOL_HOST, atol=TOL_HOST)
    if np.isfinite(max_matvecs):
        assert cb <= max_matvecs + 10


def test_polish_charged_kkt_matches_actual_matvecs(polish_inputs,
                                                   monkeypatch):
    """The polish's charge against the KKT budget equals the matvecs it
    actually runs (full-K equivalents counted through every LSMR operand;
    the JAX test's bounds)."""
    K, c, q, l, u, mi, xh, yh = polish_inputs
    res = R.host_residuals(K, c, q, l, u, mi, xh, yh)
    actual = {"mv": 0.0}
    real_lsmr = spla.lsmr

    def counting_lsmr(A, b, **kw):
        def _mv(v):
            actual["mv"] += A.nnz / K.nnz
            return A @ v

        def _rmv(v):
            actual["mv"] += A.nnz / K.nnz
            return A.T @ v

        op = spla.LinearOperator(A.shape, matvec=_mv, rmatvec=_rmv)
        return real_lsmr(op, b, **kw)

    monkeypatch.setattr(spla, "lsmr", counting_lsmr)
    _, _, charged, _ = R._active_set_polish(
        K, c, q, l, u, mi, xh, yh, res, float(np.linalg.norm(q)),
        float(np.linalg.norm(c)), 1e-9, eps_rel=1e-5)
    assert actual["mv"] > 0
    assert actual["mv"] / 4 <= charged <= max(actual["mv"], 1.0) * 2


def test_op_cache_builds_one_operator_across_rounds(monkeypatch):
    """Two operators (stage 1's K and the slack form's K_aug), each built
    once: every correction round rescales the cached K_aug for its own c,
    q, l and u without rebuilding it."""
    solve_mod = importlib.import_module("tpdlp_torch.solver.solve")
    builds = []
    real = solve_mod.build_device_operator

    def counting(problem, dtype, matrix_format="dense", device=None):
        builds.append(problem.K.shape)
        return real(problem, dtype, matrix_format, device)

    monkeypatch.setattr(solve_mod, "build_device_operator", counting)
    # tests/test_refine.py's 1e-12 instance: two correction rounds.
    p = tpdlp.generate_feasible_lp(n=30, m_ineq=20, m_eq=6, seed=7)
    cache = {}
    cfg = tpdlp_torch.SolverConfig(tol=1e-12, refine_polish=False,
                                   **REFINE)
    r = R.solve_refined(p, cfg, solve_fn=tpdlp_torch.solve, seed=0,
                        device="cpu", op_cache=cache)
    assert r.status == tpdlp_torch.Status.SOLVED
    rounds = [s for s in r.escalation["stages"] if s["stage"] != "coarse"]
    assert len(rounds) >= 2
    assert len(cache) == 2 and sorted(builds) == sorted(
        k[3] for k in cache)
    assert {k[1] for k in cache} == {"torch.float32"}


def test_banded_refine_keeps_band_end_to_end():
    """The corrections' operator on a banded LP: the interleaved slack
    form builds as a band operator (kernel K2 on CUDA) whose products are
    those of the permuted slack form K_aug[:, cols]."""
    from tpdlp_torch.ops.band import BandOp

    p = tpdlp_torch.generate_banded_lp(n=1024, m_ineq=512, m_eq=256,
                                       bandwidth=33, seed=1)
    K64 = _K64(p)
    K_perm, cols = R._slack_form_banded(K64, p.m_ineq)
    op = BandOp.from_scipy(K_perm, torch.float64, device="cpu")
    assert op is not None and op.shape == (p.m, p.n + p.m_ineq)
    K_aug = R._slack_form(K64, p.m_ineq).tocsc()
    rng = np.random.default_rng(0)
    x = rng.standard_normal(K_perm.shape[1])
    y = rng.standard_normal(K_perm.shape[0])
    np.testing.assert_allclose(op.mv(torch.as_tensor(x)).numpy(),
                               K_aug[:, cols] @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.rmv(torch.as_tensor(y)).numpy(),
                               K_aug[:, cols].T @ y, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("mode", ["refine", "auto"])
def test_public_solve_reroutes_like_jax(mode, monkeypatch):
    """dtype=None below escalation_tol reroutes through solve_refined once
    the default dtype is fp32, as on CUDA (tests/test_refine.py's
    emulation on the CPU, in both packages)."""
    jax_solve_mod = importlib.import_module("tpdlp.solver.solve")
    solve_mod = importlib.import_module("tpdlp_torch.solver.solve")
    monkeypatch.setattr(jax_solve_mod, "default_dtype", lambda: jnp.float32)
    monkeypatch.setattr(solve_mod, "default_dtype",
                        lambda device: torch.float32)
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)
    p = tpdlp.generate_feasible_lp(n=30, m_ineq=20, m_eq=6, seed=2)
    tol = 1e-9
    cfg = dict(REFINE, tol=tol, escalation_mode=mode)
    a = tpdlp.solve(p, tpdlp.SolverConfig(**cfg))
    b = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**cfg), device="cpu")
    assert a.status == b.status == tpdlp_torch.Status.SOLVED
    assert b.escalation["route"] == "refine"
    assert b.x.dtype == np.float64
    _assert_certified(p, b, tol)
    assert abs(b.objective - a.objective) <= TOL_OBJ * (1 + abs(
        a.objective))
    # An explicit dtype or a warm start is not rerouted.
    r = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**cfg), device="cpu",
                          dtype=torch.float64)
    assert r.escalation is None
