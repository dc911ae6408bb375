"""The fp64 tail of precision escalation (`escalation_mode="fp64_tail"`,
`tpdlp_torch.solver.solve._solve_escalated`) against the JAX package's,
on the CPU on the same numpy inputs.

The fp32 stage runs adaptive steps, which do not replay bit for bit
across the packages (ROADMAP.md queue 3), so the port's fp32 stage is
handed the JAX stage's result: from identical x0/y0 the fp64 stage
(Halpern with fixed steps, the "auto" scheme) must then give the JAX
k, n, j and status exactly and x, y to 1e-9, and the stages' counters and
histories must be summed as there.  Through the public `solve` (the default
dtype patched to fp32 in both packages, as on CUDA) the whole route must
reach the JAX status, with the objective within 1e-8 relative.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp
from tpdlp.bench.suite import build_suite
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI

torch.set_num_threads(2)

JAX_SOLVE = importlib.import_module("tpdlp.solver.solve")
PORT_SOLVE = importlib.import_module("tpdlp_torch.solver.solve")
_SUITE = {p.name: p for p in build_suite(("small",))}
TAIL = dict(tol=1e-8, scaling="ruiz", adaptive=True,
            primal_weight_update=True, escalation_mode="fp64_tail",
            max_kkt=60_000)
TOL_X = 1e-9


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


def _problems():
    yield "afiro-class", _SUITE["afiro-class"]
    yield "sc50-class", _SUITE["sc50-class"]
    yield "mixed-bounds", tpdlp.generate_feasible_lp(
        n=50, m_ineq=30, m_eq=10, seed=0, bounds="mixed")


PROBLEMS = dict(_problems())


def _jax_escalated(p, cfg, monkeypatch, **kw):
    """The JAX `_solve_escalated` result and its inner solves' results."""
    calls = []
    real = JAX_SOLVE.solve

    def recording(*a, **k):
        r = real(*a, **k)
        calls.append(r)
        return r

    monkeypatch.setattr(JAX_SOLVE, "solve", recording)
    r = JAX_SOLVE._solve_escalated(p, cfg, seed=0, **kw)
    monkeypatch.setattr(JAX_SOLVE, "solve", real)
    return r, calls


def _as_port(r):
    """A JAX SolveResult as the port's."""
    fields = {f.name for f in dataclasses.fields(tpdlp_torch.SolveResult)}
    kw = {f: getattr(r, f) for f in fields if hasattr(r, f)}
    kw["status"] = tpdlp_torch.Status(int(r.status))
    return tpdlp_torch.SolveResult(**kw)


def _port_escalated(p, cfg, s1, monkeypatch, **kw):
    """The port's `_solve_escalated` with its fp32 stage replaced by the
    JAX stage's result `s1` (the fp64 stage runs the port's solve)."""
    real = PORT_SOLVE.solve
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)

    def staged(problem, config, **k):
        if k["dtype"] == torch.float32:
            return _as_port(s1)
        return real(problem, config, **k)

    monkeypatch.setattr(PORT_SOLVE, "solve", staged)
    try:
        return PORT_SOLVE._solve_escalated(p, cfg, seed=0, device="cpu",
                                           **kw)
    finally:
        monkeypatch.setattr(PORT_SOLVE, "solve", real)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b)), initial=0.0))


def _exact(rj, rt):
    assert int(rt.status) == int(rj.status)
    assert (rt.iterations, rt.restarts, rt.kkt_passes) == (
        rj.iterations, rj.restarts, rj.kkt_passes)
    assert _rel(rt.x, rj.x) <= TOL_X
    assert _rel(rt.y, rj.y) <= TOL_X
    assert _rel(rt.objective, rj.objective) <= TOL_X


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_fp64_stage_from_the_same_start_equals_jax(name, monkeypatch):
    p = PROBLEMS[name]
    rj, calls = _jax_escalated(p, tpdlp.SolverConfig(**TAIL), monkeypatch)
    assert len(calls) == 2 and calls[0].status == tpdlp.Status.SOLVED
    rt = _port_escalated(p, tpdlp_torch.SolverConfig(**TAIL), calls[0],
                         monkeypatch)
    _exact(rj, rt)
    fp32, fp64 = rt.escalation["stages"]
    assert rt.escalation["route"] == "fp64_tail"
    assert (fp32["dtype"], fp64["dtype"]) == ("float32", "float64")
    # The fp64 stage's own counters are the JAX fp64 stage's.
    assert (fp64["k"], fp64["n"], fp64["j"]) == (
        calls[1].iterations, calls[1].restarts, calls[1].kkt_passes)


@pytest.mark.parametrize("spare", [0, 150])
def test_exhausted_budget_reports_kkt_limit(spare, monkeypatch):
    """A budget the fp32 stage spends (spare 0), or the fp64 stage runs
    out of (spare 150): KKT_LIMIT with the JAX counters."""
    p = PROBLEMS["sc50-class"]
    _, calls = _jax_escalated(p, tpdlp.SolverConfig(**TAIL), monkeypatch)
    max_kkt = calls[0].kkt_passes + spare
    cfg = dict(TAIL, max_kkt=max_kkt)
    rj, calls = _jax_escalated(p, tpdlp.SolverConfig(**cfg), monkeypatch)
    assert rj.status == tpdlp.Status.KKT_LIMIT
    rt = _port_escalated(p, tpdlp_torch.SolverConfig(**cfg), calls[0],
                         monkeypatch)
    assert rt.status == tpdlp_torch.Status.KKT_LIMIT
    assert len(rt.escalation["stages"]) == (1 if spare == 0 else 2)
    _exact(rj, rt)


def test_counters_and_histories_are_summed(monkeypatch):
    p = PROBLEMS["afiro-class"]
    rj, calls = _jax_escalated(p, tpdlp.SolverConfig(**TAIL), monkeypatch,
                               log_history=True)
    rt = _port_escalated(p, tpdlp_torch.SolverConfig(**TAIL), calls[0],
                         monkeypatch, log_history=True)
    s1, s2 = calls
    fp32, fp64 = rt.escalation["stages"]
    assert rt.iterations == s1.iterations + fp64["k"] == rj.iterations
    assert rt.restarts == s1.restarts + fp64["n"] == rj.restarts
    assert rt.kkt_passes == s1.kkt_passes + fp64["j"] == rj.kkt_passes
    assert len(rt.history) == len(rj.history) == (
        len(s1.history) + len(s2.history))
    assert [h["k"] for h in rt.history] == [h["k"] for h in rj.history]
    assert rt.solve_time >= s1.solve_time


@pytest.mark.parametrize("name", ["afiro-class", "mixed-bounds"])
def test_public_solve_takes_the_fp64_tail_like_jax(name, monkeypatch):
    """dtype=None below escalation_tol with escalation_mode="fp64_tail",
    the default dtype patched to fp32 in both packages: both take the
    tail and reach the same status and objective; under resume the port,
    as the JAX package, does not escalate."""
    monkeypatch.setattr(JAX_SOLVE, "default_dtype", lambda: jnp.float32)
    monkeypatch.setattr(PORT_SOLVE, "default_dtype",
                        lambda device: torch.float32)
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)
    p = PROBLEMS[name]
    rj = tpdlp.solve(p, tpdlp.SolverConfig(**TAIL))
    rt = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**TAIL),
                           device="cpu")
    assert int(rt.status) == int(rj.status)
    assert rt.escalation["route"] == "fp64_tail"
    assert rt.x.dtype == np.float64
    if rj.status == tpdlp.Status.SOLVED:
        assert abs(rt.objective - rj.objective) <= 1e-8 * (
            1 + abs(rj.objective))
    r = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**TAIL),
                          device="cpu", resume=True)
    assert r.escalation is None
