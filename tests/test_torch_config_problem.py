"""The port's configuration, status codes, problem containers, generator
and suite against the JAX package's, on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpdlp
from tpdlp.bench.suite import build_suite as jax_build_suite
from tpdlp.config import fast_step_products as jax_fast
from tpdlp.problem import device_problem as jax_device_problem
from tpdlp.problem import to_device_arrays as jax_to_device_arrays
from tpdlp.problem import triplet_transfer_wins as jax_triplet_wins
import tpdlp_torch
from tpdlp_torch.bench.suite import build_suite
from tpdlp_torch.config import fast_step_products
from tpdlp_torch.problem import (
    as_problem,
    device_problem,
    resolve_device,
    to_device_arrays,
    triplet_transfer_wins,
)

torch.set_num_threads(2)


def test_solver_config_fields_and_defaults_equal():
    ours = [(f.name, f.default) for f in
            dataclasses.fields(tpdlp_torch.SolverConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(tpdlp.SolverConfig)]
    assert ours == ref
    assert tpdlp_torch.SolverConfig() == tpdlp_torch.SolverConfig()
    hash(tpdlp_torch.SolverConfig())  # frozen, hashable


@pytest.mark.parametrize("field,value", [
    ("step_scheme", "reflected"), ("adaptive_rule", "armijo"),
    ("scaling", "l2"), ("escalation_scheme", "x"),
    ("escalation_mode", "x"), ("step_products", "tf32"),
    ("loop_mode", "x"),
])
def test_solver_config_checks_equal(field, value):
    with pytest.raises(ValueError) as ref:
        tpdlp.SolverConfig(**{field: value})
    with pytest.raises(ValueError) as ours:
        tpdlp_torch.SolverConfig(**{field: value})
    assert str(ours.value) == str(ref.value)


def test_status_values_and_strings_equal():
    assert [(s.name, int(s)) for s in tpdlp_torch.Status] == [
        (s.name, int(s)) for s in tpdlp.Status]
    for s in tpdlp.Status:
        assert tpdlp_torch.Status(int(s)).describe() == s.describe()


@pytest.mark.parametrize("kw", [
    {}, {"tol": 1e-6}, {"step_products": "fast", "tol": 1e-8},
    {"step_products": "exact"},
])
def test_fast_step_products_equal(kw):
    assert fast_step_products(tpdlp_torch.SolverConfig(**kw)) == jax_fast(
        tpdlp.SolverConfig(**kw))


@pytest.mark.parametrize("seed,bounds", [(0, "box"), (5, "box"),
                                         (11, "mixed")])
def test_generator_equals_jax_byte_for_byte(seed, bounds):
    kw = dict(n=60, m_ineq=25, m_eq=9, density=0.2, seed=seed, bounds=bounds)
    a = tpdlp_torch.generate_feasible_lp(**kw)
    b = tpdlp.generate_feasible_lp(**kw)
    for name in ("c", "q", "l", "u"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.K != b.K).nnz == 0 and a.K.dtype == b.K.dtype
    assert (a.m_ineq, a.name, a.shape) == (b.m_ineq, b.name, b.shape)


def test_suite_equals_jax_suite():
    ours = build_suite(("small", "medium"))
    ref = jax_build_suite(("small", "medium"))
    assert [(p.name, p.shape) for p in ours] == [
        (p.name, p.shape) for p in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.q, b.q)
        assert (a.K != b.K).nnz == 0
    assert [p.name for p in build_suite(("large",),
                                        names=("mittelmann-s",))] == [
        "mittelmann-s"]


@pytest.mark.parametrize("layout", ["dense", "scipy", "scipy_dup"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_to_device_arrays_equal(layout, dtype):
    p = tpdlp.generate_feasible_lp(n=40, m_ineq=15, m_eq=6, density=0.05,
                                   seed=3)
    if layout == "dense":
        p.K = p.K.toarray()
    elif layout == "scipy_dup":
        # Duplicate COO entries are summed, as `.at[].add` does.
        coo = p.K.tocoo()
        p.K = sp.coo_matrix(
            (np.concatenate([coo.data, coo.data[:5] * 0.5]),
             (np.concatenate([coo.row, coo.row[:5]]),
              np.concatenate([coo.col, coo.col[:5]]))),
            shape=coo.shape,
        )
    op, c, q, l, u = to_device_arrays(p, getattr(torch, dtype),
                                      device="cpu")
    jop, jc, jq, jl, ju = jax_to_device_arrays(p, getattr(jnp, dtype))
    np.testing.assert_array_equal(op.mat.numpy(), np.asarray(jop.mat))
    for a, b in ((c, jc), (q, jq), (l, jl), (u, ju)):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("elems,nnz", [(10_000, 10), (10_000, 900),
                                       (100, 90)])
def test_triplet_transfer_wins_equal(elems, nnz):
    for t, j in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        assert triplet_transfer_wins(elems, nnz, t) == jax_triplet_wins(
            elems, nnz, j)


@pytest.mark.parametrize("compat", [True, False])
def test_device_problem_equals_jax(rng, compat):
    m, n, mi = 9, 14, 4
    K = rng.standard_normal((m, n))
    c, q = rng.standard_normal(n), rng.standard_normal(m)
    l = np.where(rng.random(n) < 0.3, -np.inf, -rng.random(n))
    u = np.where(rng.random(n) < 0.3, np.inf, rng.random(n))
    dr, dc = rng.uniform(0.5, 2, m), rng.uniform(0.5, 2, n)
    T = torch.from_numpy
    from tpdlp_torch.ops.exact_dense import ExactDenseOp
    from tpdlp.ops.dense import DenseOp

    ours = device_problem(
        ExactDenseOp.build(T(K)), T(c * dc), T(q * dr), T(l / dc),
        T(u / dc), mi, d_row=T(dr), d_col=T(dc), c0=T(c), q0=T(q), l0=T(l),
        u0=T(u), compat_scaled_norms=compat)
    J = jnp.asarray
    ref = jax_device_problem(
        DenseOp(J(K)), J(c * dc), J(q * dr), J(l / dc), J(u / dc), mi,
        d_row=J(dr), d_col=J(dc), c0=J(c), q0=J(q), l0=J(l), u0=J(u),
        compat_scaled_norms=compat)
    for f in dataclasses.fields(ref):
        if f.name == "op":
            continue
        np.testing.assert_allclose(
            getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name)),
            rtol=1e-15, err_msg=f.name)
    assert (ours.m, ours.n) == (ref.m, ref.n)


def test_validate_and_duck_typing():
    p = tpdlp.generate_feasible_lp(n=10, m_ineq=4, m_eq=2, seed=1)
    ours = as_problem(p)
    assert isinstance(ours, tpdlp_torch.LPProblem)
    assert (ours.name, ours.m_ineq, ours.m_eq) == (p.name, 4, 2)
    bad = dataclasses.replace(p, l=p.u + 1.0)
    with pytest.raises(ValueError) as ref:
        bad.validate()
    with pytest.raises(ValueError) as mine:
        as_problem(bad).validate()
    assert str(mine.value) == str(ref.value)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
