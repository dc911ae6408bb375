"""Presolve of the port (`tpdlp_torch.presolve`: the numpy engine and the
C++ core over the port's own copy of core.cpp) against the JAX package's,
on the CPU on the same numpy inputs.

Both engines of both packages must give the same status, reduction
counts and passes, the same reduced K, c, q, l, u and m_ineq and the same
postsolve data, to rtol 1e-12, on the vendored corpus and on generated LPs
with planted reducible structure (the JAX tests' fixed variables,
singleton rows, proportional duplicate rows, doubleton equations and
emptied columns).  Postsolve and dual postsolve of the same reduced point
must agree to 1e-12, and `solve(presolve=...)` under fixed steps in fp64
must give the JAX k, n, j, status and x to 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpdlp
from tpdlp.bench.suite import build_corpus
from tpdlp.presolve import files as jax_files
from tpdlp.presolve import reductions as jax_red
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.presolve import cpp as port_cpp
from tpdlp_torch.presolve import files as port_files
from tpdlp_torch.presolve import reductions as port_red

torch.set_num_threads(2)

RTOL = 1e-12
FIXED = dict(scaling="ruiz", adaptive=False, primal_weight_update=True,
             eta_safety=0.99)
BACKENDS = ["python", "cpp"]


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


def _planted(seed):
    """A generated LP with the JAX lockstep fuzz's planted structure
    (tests/test_presolve_cpp.py), drawn from `seed`."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 60))
    mi = int(rng.integers(2, 40))
    me = int(rng.integers(1, 20))
    p = tpdlp.generate_feasible_lp(
        n=n, m_ineq=mi, m_eq=me, density=float(rng.uniform(0.05, 0.5)),
        seed=int(rng.integers(0, 10_000)))
    K = p.K.tolil()
    for _ in range(int(rng.integers(0, 4))):
        j = int(rng.integers(0, p.n))
        p.l[j] = p.u[j] = float(rng.uniform(-2, 2))
    if rng.random() < 0.5 and p.n >= 2:
        i = int(rng.integers(0, p.m))
        K.rows[i] = [int(rng.integers(0, p.n))]
        K.data[i] = [float(rng.choice([-1.5, 2.0]))]
    if rng.random() < 0.5 and p.m >= 4:
        i0, i1 = rng.choice(p.m, 2, replace=False)
        lam = float(rng.choice([-2.0, 0.5, 3.0]))
        K.rows[int(i1)] = list(K.rows[int(i0)])
        K.data[int(i1)] = [lam * v for v in K.data[int(i0)]]
        p.q[int(i1)] = lam * p.q[int(i0)] - abs(rng.normal())
    if rng.random() < 0.5 and p.m - mi >= 1 and p.n >= 3:
        i = mi + int(rng.integers(0, p.m - mi))
        j1, j2 = rng.choice(p.n, 2, replace=False)
        K.rows[i] = sorted([int(j1), int(j2)])
        K.data[i] = [float(rng.uniform(0.5, 2)), float(rng.uniform(0.5, 2))]
        p.l[int(j1)] = -50.0
        p.u[int(j1)] = 50.0
    if rng.random() < 0.3:
        j = int(rng.integers(0, p.n))
        for i in range(p.m):
            if j in K.rows[i]:
                idx = K.rows[i].index(j)
                K.rows[i].pop(idx)
                K.data[i].pop(idx)
    p.K = sp.csr_matrix(K)
    p.name = f"planted{seed}"
    return p


def _reducible(seed):
    """tests/test_presolve.py's round-trip LP: two fixed variables, a
    singleton row and a duplicate row planted."""
    p = tpdlp.generate_feasible_lp(n=40, m_ineq=25, m_eq=8, seed=seed)
    p.l[3] = p.u[3] = 1.5
    p.l[7] = p.u[7] = -0.5
    K = p.K.toarray()
    single = np.zeros((1, p.n))
    single[0, 11] = 1.0
    p.K = sp.csr_matrix(np.vstack([single, K[0:1] * 2.0, K]))
    p.q = np.concatenate([[p.l[11] - 1.0], p.q[0:1] * 2.0 - 0.5, p.q])
    p.m_ineq += 2
    p.name = f"reducible{seed}"
    return p


CORPUS = {p.name: p for p in build_corpus()}
PROBLEMS = {**CORPUS, **{f"planted{s}": _planted(s) for s in range(8)},
            **{f"reducible{s}": _reducible(s) for s in range(3)}}


def _same_data(a, b):
    for f in dataclasses.fields(jax_red.PostsolveData):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_allclose(vb, va, rtol=RTOL, atol=0,
                                       err_msg=f.name)
        else:
            assert vb == pytest.approx(va, rel=RTOL), f.name


def _same_presolve(a, b):
    assert int(b.status) == int(a.status)
    assert (b.rows_removed, b.cols_removed, b.passes) == (
        a.rows_removed, a.cols_removed, a.passes)
    _same_data(a.data, b.data)
    assert (a.problem is None) == (b.problem is None)
    if a.problem is not None:
        pa, pb = a.problem, b.problem
        assert pb.m_ineq == pa.m_ineq and pb.K.shape == pa.K.shape
        np.testing.assert_allclose(sp.csr_matrix(pb.K).toarray(),
                                   sp.csr_matrix(pa.K).toarray(),
                                   rtol=RTOL, atol=0)
        for f in ("c", "q", "l", "u"):
            np.testing.assert_allclose(getattr(pb, f), getattr(pa, f),
                                       rtol=RTOL, atol=0, err_msg=f)
        assert pb.obj_offset == pytest.approx(pa.obj_offset, rel=RTOL)
        assert isinstance(pb, tpdlp_torch.LPProblem)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_presolve_equals_jax(name, backend):
    p = PROBLEMS[name]
    _same_presolve(jax_red.presolve(p, backend=backend),
                   port_red.presolve(p, backend=backend))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_postsolve_round_trips_equal_jax(name, backend):
    """The same reduced primal and dual point mapped back by each
    package's postsolve and dual postsolve."""
    p = PROBLEMS[name]
    a = jax_red.presolve(p, backend=backend)
    b = port_red.presolve(p, backend=backend)
    rng = np.random.default_rng(0)
    n_red = a.problem.n if a.problem is not None else 0
    m_red = a.problem.m if a.problem is not None else 0
    if int(a.status) not in (int(tpdlp.Status.RUNNING),
                             int(tpdlp.Status.SOLVED)):
        return  # presolve decided infeasible/unbounded: no point to map
    x_red = rng.standard_normal(n_red)
    y_red = rng.standard_normal(m_red)
    xa = jax_red.postsolve(x_red, a.data)
    xb = port_red.postsolve(x_red, b.data)
    np.testing.assert_allclose(xb, xa, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(port_red.postsolve_dual(y_red, xb, b.data),
                               jax_red.postsolve_dual(y_red, xa, a.data),
                               rtol=RTOL, atol=RTOL)


def test_cpp_core_builds_into_the_build_directory():
    """The port's core is built beside the CUDA kernels (build/tpdlp_torch
    at the checkout's root, ignored by git), named by a hash of its source
    and flags, never next to the source."""
    from tpdlp_torch.ops._kernels import BUILD_DIR

    lib = port_cpp.build()
    assert lib == port_cpp.library_path() and lib.exists()
    assert lib.parent == BUILD_DIR
    assert "-ffp-contract=off" in port_cpp.CXX_FLAGS
    assert not list(port_cpp.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["reducible0", "reducible1", "prod06",
                                  "inv18", "planted2"])
def test_solve_with_presolve_equals_jax(name, backend, monkeypatch):
    """solve(presolve=...) under fixed steps in fp64: the JAX k, n, j and
    status, x and y to 1e-9 (the inner solve on the reduced LP, then
    postsolve)."""
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)
    p = PROBLEMS[name]
    cfg = dict(tol=1e-6, max_kkt=60_000, **FIXED)
    rj = tpdlp.solve(p, tpdlp.SolverConfig(**cfg), dtype=jnp.float64,
                     presolve=backend)
    rt = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**cfg),
                           dtype=torch.float64, device="cpu",
                           presolve=backend)
    assert int(rt.status) == int(rj.status)
    assert (rt.iterations, rt.restarts, rt.kkt_passes) == (
        rj.iterations, rj.restarts, rj.kkt_passes)
    assert rt.x.shape == (p.n,) and rt.y.shape == (p.m,)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rt.y, rj.y, rtol=1e-9, atol=1e-9)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9, abs=1e-9)


def _lp(c, K, q, m_ineq, l, u):
    return tpdlp.LPProblem(c=np.asarray(c, float),
                           K=sp.csr_matrix(np.asarray(K, float)),
                           q=np.asarray(q, float), m_ineq=m_ineq,
                           l=np.asarray(l, float), u=np.asarray(u, float))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["solved", "infeasible", "unbounded"])
def test_presolve_decided_statuses_short_circuit_like_jax(case, backend):
    """A status presolve decides alone comes back at once (no device
    work), with the JAX result's status, x and objective."""
    p = {
        # Every variable fixed: presolve solves it.
        "solved": _lp([1.0, 2.0], [[1.0, 1.0]], [1.0], 1, [1.0, 0.5],
                      [1.0, 0.5]),
        # An empty row with a positive right-hand side (0 >= 1).
        "infeasible": _lp([1.0], [[0.0]], [1.0], 1, [0.0], [10.0]),
        # An empty column with a negative cost and no upper bound.
        "unbounded": _lp([-1.0, 1.0], [[0.0, 1.0]], [0.0], 1, [0.0, 0.0],
                         [np.inf, 5.0]),
    }[case]
    rj = tpdlp.solve(p, tpdlp.SolverConfig(), dtype=jnp.float64,
                     presolve=backend)
    rt = tpdlp_torch.solve(p, device="cpu", presolve=backend)
    assert int(rt.status) == int(rj.status)
    assert rt.iterations == rt.kkt_passes == 0
    np.testing.assert_allclose(rt.x, rj.x, rtol=RTOL)
    assert rt.objective == pytest.approx(rj.objective, rel=RTOL)


def test_presolve_with_warm_start_raises_like_jax():
    p = PROBLEMS["reducible0"]
    with pytest.raises(ValueError, match="presolve \\+ warm start"):
        tpdlp.solve(p, presolve="python", x0=np.zeros(p.n))
    with pytest.raises(ValueError, match="presolve \\+ warm start"):
        tpdlp_torch.solve(p, device="cpu", presolve="python",
                          x0=np.zeros(p.n))
    with pytest.raises(ValueError, match="presolve backend"):
        tpdlp_torch.solve(p, device="cpu", presolve="papilo")


@pytest.mark.parametrize("backend", BACKENDS)
def test_file_level_round_trip_equals_jax(backend, tmp_path):
    """presolve_mps / postsolve_solution / postsolve_dual_solution of both
    packages over the same MPS file."""
    p = _reducible(1)
    orig = tmp_path / "orig.mps"
    tpdlp_torch.write_mps(p, str(orig))
    out = {}
    for pkg, mod in (("jax", jax_files), ("port", port_files)):
        red, tf = tmp_path / f"{pkg}.mps", tmp_path / f"{pkg}.npz"
        stats = mod.presolve_mps(str(orig), str(red), str(tf),
                                 backend=backend)
        out[pkg] = (stats, tpdlp_torch.read_mps(str(red)), str(tf))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0]["status"] == "Reduced"
    ra, rb = out["jax"][1], out["port"][1]
    np.testing.assert_array_equal(sp.csr_matrix(rb.K).toarray(),
                                  sp.csr_matrix(ra.K).toarray())
    rng = np.random.default_rng(1)
    x_red, y_red = rng.standard_normal(rb.n), rng.standard_normal(rb.m)
    xa = jax_files.postsolve_solution(x_red, out["jax"][2])
    xb = port_files.postsolve_solution(x_red, out["port"][2])
    np.testing.assert_allclose(xb, xa, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(
        port_files.postsolve_dual_solution(y_red, xb, out["port"][2]),
        jax_files.postsolve_dual_solution(y_red, xa, out["jax"][2]),
        rtol=RTOL, atol=RTOL)


def test_rounding_crossed_bounds_raise_as_in_jax():
    """Both packages' engines leave l_j > u_j by an ulp on this LP (the
    JAX config fuzz's sample t8, a fault of the reference recorded in
    ROADMAP.md queue 3); both packages' solve(presolve=...) then raise the
    same ValueError on validation of the reduced problem."""
    rng = np.random.default_rng(1234)
    for _ in range(8):  # the fuzz's draws before sample t8
        _fuzz_draw(rng)
    p = _fuzz_draw(rng)
    for backend in ("python", "cpp"):
        a = jax_red.presolve(p, backend=backend)
        b = port_red.presolve(p, backend=backend)
        _same_presolve(a, b)
        assert np.flatnonzero(b.problem.l > b.problem.u).size
        with pytest.raises(ValueError, match="l > u") as jax_err:
            tpdlp.solve(p, tpdlp.SolverConfig(tol=1e-6), dtype=jnp.float64,
                        presolve=backend)
        with pytest.raises(ValueError, match="l > u") as port_err:
            tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(tol=1e-6),
                              device="cpu", presolve=backend)
        assert str(port_err.value) == str(jax_err.value)


def _fuzz_draw(rng):
    """One instance draw of tests/test_config_fuzz.py's battery, with the
    draws of its config that follow (so the next call draws the next
    sample's instance)."""
    banded = rng.random() < 0.3
    if banded:
        p = tpdlp.generate_banded_lp(
            n=int(rng.integers(200, 600)), m_ineq=int(rng.integers(80, 200)),
            m_eq=int(rng.integers(40, 120)),
            bandwidth=int(rng.choice([17, 33])),
            seed=int(rng.integers(0, 1000)))
    else:
        p = tpdlp.generate_feasible_lp(
            n=int(rng.integers(20, 120)), m_ineq=int(rng.integers(10, 70)),
            m_eq=int(rng.integers(3, 30)),
            density=float(rng.uniform(0.1, 0.4)),
            seed=int(rng.integers(0, 1000)))
    halpern = rng.random() < 0.25
    rng.choice(["none", "ruiz", "ruiz+pc"])
    if not halpern:
        rng.random()
    rng.choice(["reference", "linesearch"])
    rng.random(), rng.random(), rng.random()
    rng.choice(["dense", "sparse", "auto"] + (["band"] if banded else []))
    rng.choice(["off", "python", "cpp"])
    return p


@pytest.mark.slow
def test_presolve_lockstep_fuzz_equals_jax():
    """The JAX lockstep fuzz's 25 planted trials (slow there too): both
    engines of the port equal the JAX engines."""
    for seed in range(100, 125):
        p = _planted(seed)
        for backend in BACKENDS:
            _same_presolve(jax_red.presolve(p, backend=backend),
                           port_red.presolve(p, backend=backend))
