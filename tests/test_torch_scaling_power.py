"""Ruiz / Pock-Chambolle scaling and the power-iteration stepsize against
the JAX package, in fp64 on the same inputs.  The power iteration's start
vector is JAX's `jax.random.normal` draw, injected by replacing the port's
`initial_vector` (torch cannot reproduce those bits)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp
from tpdlp.problem import to_device_arrays as jax_to_device_arrays
from tpdlp.scaling.ruiz import scale_problem as jax_scale_problem
from tpdlp.solver.power_iteration import (
    spectral_norm_estimate as jax_spectral_norm,
)
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.problem import device_problem, to_device_arrays
from tpdlp_torch.scaling.ruiz import scale_problem

JS = importlib.import_module("tpdlp.solver.solve")
TS = importlib.import_module("tpdlp_torch.solver.solve")

torch.set_num_threads(2)

RTOL = 1e-12


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def jax_b0(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)


def _problem(seed=4, bounds="box"):
    return tpdlp.generate_feasible_lp(n=70, m_ineq=30, m_eq=12, density=0.15,
                                      seed=seed, bounds=bounds)


def _close(a, b, name, rtol=RTOL):
    a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
    b = np.asarray(b)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=name)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=name)
    err = np.max(np.abs(a[fin] - b[fin]) / (1 + np.abs(b[fin])),
                 initial=0.0)
    assert err <= rtol, f"{name}: {err}"


@pytest.mark.parametrize("method", ["ruiz", "ruiz+pc"])
@pytest.mark.parametrize("bounds", ["box", "mixed"])
def test_scaling_equals_jax(method, bounds):
    p = _problem(bounds=bounds)
    ours = scale_problem(*to_device_arrays(p, torch.float64, device="cpu"),
                         method=method)
    jop, *jvecs = jax_to_device_arrays(p, jnp.float64)
    ref = jax_scale_problem(jop, *jvecs, method=method)
    _close(ours[0].mat, ref[0].mat, "K_s")
    for name, a, b in zip(("c", "q", "l", "u", "d_row", "d_col"),
                          ours[1:], ref[1:]):
        _close(a, b, name)


def test_scaling_stops_when_converged():
    """An equilibrated K stops Ruiz after its first pass on both sides."""
    p = _problem()
    p.K = np.eye(p.m, p.n)
    ours = scale_problem(*to_device_arrays(p, torch.float64, device="cpu"),
                         method="ruiz", ruiz_iters=20)
    jop, *jvecs = jax_to_device_arrays(p, jnp.float64)
    ref = jax_scale_problem(jop, *jvecs, method="ruiz", ruiz_iters=20)
    _close(ours[5], ref[5], "d_row", rtol=0)
    _close(ours[6], ref[6], "d_col", rtol=0)


def test_scaling_none_is_identity():
    p = _problem()
    op, c, q, l, u = to_device_arrays(p, torch.float64, device="cpu")
    out = scale_problem(op, c, q, l, u, method="none")
    assert out[0] is op and out[1] is c
    assert torch.all(out[5] == 1) and torch.all(out[6] == 1)
    with pytest.raises(ValueError, match="scaling method"):
        scale_problem(op, c, q, l, u, method="l2")


@pytest.mark.parametrize("seed", [0, 3])
def test_power_iteration_equals_jax(jax_b0, seed):
    p = _problem()
    op = to_device_arrays(p, torch.float64, device="cpu")[0]
    jop = jax_to_device_arrays(p, jnp.float64)[0]
    ours = PI.spectral_norm_estimate(op, seed, 100)
    ref = jax_spectral_norm(jop, jax.random.PRNGKey(seed), 100)
    _close(ours, ref, "||K||")


@pytest.mark.parametrize("scaling", ["none", "ruiz", "ruiz+pc"])
def test_eta_omega_equal_jax(jax_b0, scaling):
    p = _problem(bounds="mixed")
    cfg_kw = dict(scaling=scaling, power_iters=50)
    tcfg = tpdlp_torch.SolverConfig(**cfg_kw)
    jcfg = tpdlp.SolverConfig(**cfg_kw)
    op, c, q, l, u = to_device_arrays(p, torch.float64, device="cpu")
    op_s, c_s, q_s, l_s, u_s, dr, dc = scale_problem(op, c, q, l, u,
                                                     method=scaling)
    pb = device_problem(op_s, c_s, q_s, l_s, u_s, p.m_ineq, d_row=dr,
                        d_col=dc, c0=c, q0=q, l0=l, u0=u)
    jop, jc, jq, jl, ju = jax_to_device_arrays(p, jnp.float64)
    jpb = JS._build_device_problem(jop, jc, jq, jl, ju, p.m_ineq, jcfg)
    eta, omega = TS.eta_omega_of(pb, 2, tcfg)
    jeta, jomega = JS.eta_omega_of(jpb, jax.random.PRNGKey(2), jcfg)
    _close(eta, jeta, "eta0")
    _close(omega, jomega, "omega0")
    # A pinned omega overrides the norm rule; NaN keeps it.
    _, om = TS.eta_omega_of(pb, 2, tcfg, om0=torch.tensor(3.0,
                                                          dtype=torch.float64))
    assert float(om) == 3.0
    _, om = TS.eta_omega_of(pb, 2, tcfg,
                            om0=torch.tensor(float("nan"),
                                             dtype=torch.float64))
    _close(om, jomega, "omega0 (NaN override)")


def test_initial_vector_is_seeded():
    a = PI.initial_vector(50, 7, torch.float32, "cpu")
    b = PI.initial_vector(50, 7, torch.float32, "cpu")
    c = PI.initial_vector(50, 8, torch.float32, "cpu")
    assert a.dtype == torch.float32 and a.shape == (50,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.5 < float(a.std()) < 1.5
