"""Whole solves of the per-iteration slice against the JAX package, in fp64
on the CPU with the JAX power-iteration draw injected: infeasible and
unbounded LPs (planted, and the terminal corpus infeas01/unbnd01), a
feasible LP with the certificates on, the Halpern scheme, a restart period
above 256, and the band layout under certificates and Halpern.

Under fixed steps the port must give the JAX status and the same k, n and
j.  Under the main path's adaptive rule the two packages' summation orders
drift apart (tests/test_torch_solve_parity.py), so there the status must be
the same."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp
from tpdlp.bench.suite import INSTANCES_DIR
from tpdlp.io.mps import read_mps as jax_read_mps
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.bench.infeasibility import INSTANCES_DIR as PORT_INSTANCES
from tests.oracles import solve_oracle

torch.set_num_threads(2)

#: tests/test_infeasibility.py's certificate configuration (fixed steps).
CERTS = dict(tol=1e-6, max_kkt=60_000, infeasibility_detect=True,
             infeas_tol=1e-4)
#: The main path's settings with the ray certificates.
MAIN = dict(tol=1e-6, max_kkt=60_000, scaling="ruiz", adaptive=True,
            primal_weight_update=True, infeasibility_detect=True)


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def jax_b0(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)


def _problems(name):
    """(JAX problem, port problem): the same LP, each read or generated by
    its own package."""
    if name in ("infeas01", "unbnd01"):
        return (jax_read_mps(os.path.join(INSTANCES_DIR, f"{name}.mps")),
                tpdlp_torch.read_mps(PORT_INSTANCES / f"{name}.mps"))
    kind, seed = name.rsplit("_s", 1)
    gen = {"infeasible": "generate_infeasible_lp",
           "unbounded": "generate_unbounded_lp"}[kind]
    return (getattr(tpdlp, gen)(seed=int(seed)),
            getattr(tpdlp_torch, gen)(seed=int(seed)))


def _both(pj, pt, matrix_format="dense", **cfg_kw):
    rj = tpdlp.solve(pj, tpdlp.SolverConfig(**cfg_kw), dtype=jnp.float64,
                     matrix_format=matrix_format)
    rt = tpdlp_torch.solve(pt, tpdlp_torch.SolverConfig(**cfg_kw),
                           device="cpu", dtype=torch.float64,
                           matrix_format=matrix_format)
    return rj, rt


def _counters(r):
    return r.status, r.iterations, r.restarts, r.kkt_passes


CERTIFIED = {
    "infeasible_s0": tpdlp.Status.PRIMAL_INFEASIBLE,
    "infeasible_s1": tpdlp.Status.PRIMAL_INFEASIBLE,
    "infeasible_s2": tpdlp.Status.PRIMAL_INFEASIBLE,
    "infeasible_s3": tpdlp.Status.PRIMAL_INFEASIBLE,
    "unbounded_s1": tpdlp.Status.DUAL_INFEASIBLE,
    "infeas01": tpdlp.Status.PRIMAL_INFEASIBLE,
    "unbnd01": tpdlp.Status.DUAL_INFEASIBLE,
}


@pytest.mark.parametrize("name", list(CERTIFIED))
def test_fixed_steps_certify_at_the_jax_k_and_j(jax_b0, name):
    rj, rt = _both(*_problems(name), **CERTS)
    assert rj.status == CERTIFIED[name]
    assert _counters(rt) == _counters(rj)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["infeasible_s0", "infeasible_s1",
                                  "infeasible_s2", "unbounded_s1",
                                  "infeas01", "unbnd01"])
def test_main_path_certifies_like_jax(jax_b0, name):
    """(infeasible_s3 reaches the KKT limit in both packages under these
    settings, and takes tens of seconds here.)"""
    rj, rt = _both(*_problems(name), **MAIN)
    assert rt.status == rj.status == CERTIFIED[name]


def test_no_false_positive_on_feasible(jax_b0):
    """tests/test_infeasibility.py::test_no_false_positive_on_feasible on
    both packages: Solved, at the same k, n and j."""
    kw = dict(n=40, m_ineq=25, m_eq=8, seed=5)
    rj, rt = _both(tpdlp.generate_feasible_lp(**kw),
                   tpdlp_torch.generate_feasible_lp(**kw),
                   **dict(CERTS, scaling="ruiz"))
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert _counters(rt) == _counters(rj)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9)


@pytest.mark.parametrize("seed", [1, 4, 9])
def test_halpern_scheme_like_jax(jax_b0, seed):
    """tests/test_solver_basic.py's Halpern cases: the JAX objective and
    counters, the oracle's objective, and a reported point inside the box
    (the carried z may lie outside it)."""
    kw = dict(n=60, m_ineq=35, m_eq=12, seed=seed)
    pj, pt = (tpdlp.generate_feasible_lp(**kw),
              tpdlp_torch.generate_feasible_lp(**kw))
    rj, rt = _both(pj, pt, tol=1e-7, scaling="ruiz",
                   primal_weight_update=True, step_scheme="halpern")
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert _counters(rt) == _counters(rj)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9)
    assert rt.objective == pytest.approx(solve_oracle(pj).fun, abs=1e-4)
    assert np.all(rt.x >= pt.l - 1e-7) and np.all(rt.x <= pt.u + 1e-7)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-9, atol=1e-9)


def test_halpern_infeasible_certificates(jax_b0):
    rj, rt = _both(tpdlp.generate_infeasible_lp(seed=2),
                   tpdlp_torch.generate_infeasible_lp(seed=2), tol=1e-6,
                   step_scheme="halpern", infeasibility_detect=True)
    assert rj.status == tpdlp.Status.PRIMAL_INFEASIBLE
    assert _counters(rt) == _counters(rj)


def test_restart_period_300_like_jax(jax_b0):
    """Above 256 the JAX package runs the per-iteration loop."""
    kw = dict(n=78, m_ineq=30, m_eq=18, density=0.2, seed=7)
    rj, rt = _both(tpdlp.generate_feasible_lp(**kw),
                   tpdlp_torch.generate_feasible_lp(**kw), tol=1e-6,
                   scaling="ruiz", primal_weight_update=True,
                   restart_period=300)
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert _counters(rt) == _counters(rj)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9)


@pytest.mark.parametrize("extra", [
    dict(infeasibility_detect=True, normalized_certificates=True),
    dict(step_scheme="halpern"),
    dict(step_scheme="halpern", loop_mode="periter"),
])
def test_band_layout_like_jax(jax_b0, extra):
    """matrix_format="band" under the per-iteration loop and Halpern."""
    kw = dict(n=520, m_ineq=260, m_eq=130, bandwidth=33, seed=1)
    rj, rt = _both(tpdlp.generate_banded_lp(**kw),
                   tpdlp_torch.generate_banded_lp(**kw),
                   matrix_format="band", tol=1e-4, scaling="ruiz",
                   primal_weight_update=True, eta_safety=0.99, **extra)
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert _counters(rt) == _counters(rj)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9)
