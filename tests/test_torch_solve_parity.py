"""Whole-slice parity: `tpdlp_torch.solve` against `tpdlp.solve` on the
suite's small classes, deg2-class and maros-class, in fp64 on the CPU with
the JAX power-iteration draw injected, and the solve() paths around the
loop (warm start, time limit, KKT budget, the per-iteration slice's
options, presolve, the escalation reroute, unported options).

Exact parity (same k, n, j, status; x, y, objective to 1e-9) is asserted
for fixed steps.  Under the adaptive (Malitsky-Pock) rule the trajectory
amplifies rounding: the two packages sum their products in different
orders (1e-16 apart), and that difference grows about 100x per restart
cycle (afiro-class: 1e-13 after one cycle, 5e-8 after four), until a
restart decision flips.  There both solves must reach the same status and
objective, and test_torch_step_restart.py holds single steps and cycles
of that rule to 1e-12 / 1e-9.
"""

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

_SUITE = {p.name: p for p in build_suite(("small", "medium"))}
#: Fixed steps at 0.99/||K|| (the default safety 0.9 needs ~2.5x more
#: iterations on deg2-class at 1e-6).
FIXED = dict(scaling="ruiz", adaptive=False, primal_weight_update=True,
             eta_safety=0.99)
MAIN = dict(scaling="ruiz", adaptive=True, primal_weight_update=True)


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def jax_b0(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)


def _both(p, dtype="float64", solve_kw=None, **cfg_kw):
    solve_kw = solve_kw or {}
    rj = tpdlp.solve(p, tpdlp.SolverConfig(**cfg_kw),
                     dtype=getattr(jnp, dtype), **solve_kw)
    rt = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**cfg_kw),
                           device="cpu", dtype=getattr(torch, dtype),
                           **solve_kw)
    return rj, rt


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b)), initial=0.0))


def _exact(rj, rt, tol=1e-9):
    assert rt.status == rj.status
    assert (rt.iterations, rt.restarts, rt.kkt_passes) == (
        rj.iterations, rj.restarts, rj.kkt_passes)
    assert _rel(rt.x, rj.x) <= tol
    assert _rel(rt.y, rj.y) <= tol
    assert _rel(rt.objective, rj.objective) <= tol
    for f in ("primal_res", "dual_res", "gap"):
        assert abs(getattr(rt, f) - getattr(rj, f)) <= tol * (
            1 + abs(getattr(rj, f))), f


@pytest.mark.parametrize("name,tol", [
    ("afiro-class", 1e-4), ("afiro-class", 1e-6),
    ("sc50-class", 1e-4), ("sc50-class", 1e-6),
    ("share-class", 1e-4), ("share-class", 1e-6),
    ("deg2-class", 1e-4), ("deg2-class", 1e-6),
    ("maros-class", 1e-4),
])
def test_fp64_parity_exact(jax_b0, name, tol):
    rj, rt = _both(_SUITE[name], tol=tol, **FIXED)
    assert rj.status == tpdlp.Status.SOLVED
    _exact(rj, rt)
    assert rt.x.dtype == np.float64 and rt.x.shape == (_SUITE[name].n,)


@pytest.mark.parametrize("name", ["afiro-class", "sc50-class",
                                  "share-class", "deg2-class"])
def test_fp64_main_path_same_answer(jax_b0, name):
    """The main path's settings (adaptive + primal-weight update): same
    status and objective to the tolerance (see the module docstring)."""
    tol = 1e-4
    rj, rt = _both(_SUITE[name], tol=tol, **MAIN)
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert abs(rt.objective - rj.objective) <= 5 * tol * (
        1 + abs(rj.objective))


@pytest.mark.parametrize("name", ["afiro-class", "sc50-class",
                                  "share-class"])
def test_fp32_same_status_and_objective(name):
    tol = 1e-4
    rj, rt = _both(_SUITE[name], dtype="float32", tol=tol, **MAIN)
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert rt.x.dtype == np.float32
    assert abs(rt.objective - rj.objective) <= 5 * tol * (
        1 + abs(rj.objective))


def test_warm_start_parity(jax_b0):
    p = _SUITE["sc50-class"]
    start = tpdlp.solve(p, tpdlp.SolverConfig(tol=1e-3, **FIXED),
                        dtype=jnp.float64)
    rj, rt = _both(p, tol=1e-6, solve_kw=dict(x0=start.x, y0=start.y),
                   **FIXED)
    _exact(rj, rt)
    cold = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(tol=1e-6, **FIXED),
                             device="cpu")
    assert rt.iterations < cold.iterations


def test_time_limit_path():
    p = _SUITE["afiro-class"]
    rj, rt = _both(p, tol=1e-6, solve_kw=dict(time_used=5.0),
                   time_limit=1.0, **MAIN)
    assert rt.status == rj.status == tpdlp.Status.TIME_LIMIT
    assert (rt.iterations, rt.kkt_passes) == (rj.iterations, rj.kkt_passes)
    assert rt.status_string == "Unsolved (Time limit exceeded)"
    assert rt.solve_time >= 5.0


@pytest.mark.parametrize("tol,max_kkt,status", [
    (1e10, 0, tpdlp.Status.SOLVED),        # final_eval certifies x = 0
    (1e-9, 0, tpdlp.Status.KKT_LIMIT),
    (1e-9, 300, tpdlp.Status.KKT_LIMIT),   # blocked cycles overrun 300
])
def test_kkt_budget_path(jax_b0, tol, max_kkt, status):
    rj, rt = _both(_SUITE["sc50-class"], tol=tol, max_kkt=max_kkt, **FIXED)
    assert rj.status == status
    _exact(rj, rt)


def test_options_parity(jax_b0):
    """omega0 pin, op_cache reuse, history records, and a JAX LPProblem
    passed as it is."""
    p = _SUITE["afiro-class"]
    rj, rt = _both(p, tol=1e-6, solve_kw=dict(omega0=0.5), **FIXED)
    _exact(rj, rt)
    cache = {}
    cfg = tpdlp_torch.SolverConfig(tol=1e-6, **FIXED)
    r1 = tpdlp_torch.solve(p, cfg, device="cpu", op_cache=cache,
                           log_history=True)
    assert len(cache) == 1
    r2 = tpdlp_torch.solve(p, cfg, device="cpu", op_cache=cache)
    assert len(cache) == 1 and r2.iterations == r1.iterations
    np.testing.assert_array_equal(r1.x, r2.x)
    assert r1.history and r1.history[-1]["k"] == r1.iterations
    assert {"k", "j", "restarts", "gap", "eta", "omega", "time"} <= set(
        r1.history[0])


def test_result_surface_equals_jax(jax_b0):
    p = _SUITE["afiro-class"]
    p_max = tpdlp.generate_feasible_lp(n=51, m_ineq=17, m_eq=10,
                                       density=0.3, seed=7)
    p_max.objsense, p_max.obj_offset = "MAX", 2.5
    for prob in (p, p_max):
        rj, rt = _both(prob, tol=1e-4, **FIXED)
        assert rt.objective_original_sense == pytest.approx(
            rj.objective_original_sense, rel=1e-9)
        a, b = rt.csv_row(prob.name), rj.csv_row(prob.name)
        assert set(a) == set(b)
        assert {k: a[k] for k in a if k != "Time (s)"} == {
            k: b[k] for k in b if k != "Time (s)"}


@pytest.mark.parametrize("kw,item", [
    (dict(presolve="python"), 18),
    (dict(presolve="cpp", matrix_format="sparse"), 18),
    (dict(presolve="cpp"), 18),
    (dict(mesh="1x1", matrix_format="band"), 21),
    (dict(mesh="1x1", matrix_format="auto"), 21),
    (dict(mesh="1x1"), 21),
])
def test_unported_options_raise(jax_b0, kw, item):
    """The options of ROADMAP.md items that were once unported run and
    match the JAX package: the same status, k, n and j and the objective
    to 1e-9 under fixed steps in fp64.  Presolve (item 18), and
    solve(mesh=...) (item 21) on a 1x1 mesh of each package, which pads
    the problem as its layout says (band: to 1024 x 1024) and cuts the
    results back (tests/test_torch_shard.py holds the multi-rank
    meshes)."""
    p = _SUITE["afiro-class"]
    if item == 21:
        from tpdlp.shard import make_solver_mesh as jax_mesh
        from tpdlp_torch.shard import make_solver_mesh

        kw = dict(kw)
        del kw["mesh"]
        rj = tpdlp.solve(p, tpdlp.SolverConfig(tol=1e-6, **FIXED),
                         dtype=jnp.float64,
                         mesh=jax_mesh(jax.devices()[:1], (1, 1)), **kw)
        rt = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(tol=1e-6,
                                                           **FIXED),
                               device="cpu", dtype=torch.float64,
                               mesh=make_solver_mesh(), **kw)
        assert rt.x.shape == (p.n,) and rt.y.shape == (p.m,)
    else:
        rj, rt = _both(p, tol=1e-6, solve_kw=kw, **FIXED)
    assert rj.status == tpdlp.Status.SOLVED
    _exact(rj, rt)


@pytest.mark.parametrize("kw", [
    dict(infeasibility_detect=True),
    dict(normalized_certificates=True),
    dict(loop_mode="periter"),
    dict(step_scheme="halpern"),
    dict(restart_period=512),
], ids=["infeasibility_detect", "normalized_certificates", "periter",
        "halpern", "restart_period_512"])
def test_per_iteration_options_match_jax(jax_b0, kw):
    """The options of the per-iteration slice on afiro-class under fixed
    steps: the JAX package's status, k, n and j."""
    rj, rt = _both(_SUITE["afiro-class"], tol=1e-6, **FIXED, **kw)
    assert rj.status == tpdlp.Status.SOLVED
    _exact(rj, rt)


def test_halpern_with_adaptive_raises_like_jax():
    p = _SUITE["afiro-class"]
    kw = dict(step_scheme="halpern", adaptive=True)
    with pytest.raises(ValueError, match="requires adaptive=False"):
        tpdlp.solve(p, tpdlp.SolverConfig(**kw))
    with pytest.raises(ValueError, match="requires adaptive=False"):
        tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**kw), device="cpu")


def test_band_format_rejects_unstructured():
    """matrix_format="band" on a K that is not band-like raises the JAX
    package's ValueError (tests/test_band.py's counterpart)."""
    p = tpdlp.generate_feasible_lp(n=4000, m_ineq=100, m_eq=40,
                                   density=0.05, seed=0)
    with pytest.raises(ValueError, match="band-like"):
        tpdlp.solve(p, tpdlp.SolverConfig(), matrix_format="band")
    with pytest.raises(ValueError, match="band-like"):
        tpdlp_torch.solve(p, device="cpu", matrix_format="band")


def test_escalation_reroute_raises_on_cuda_only(monkeypatch):
    """dtype=None below escalation_tol: on the CPU (fp64) the port solves
    directly, as the JAX package does there; with the default dtype fp32,
    as on CUDA, both packages reroute into iterative refinement and reach
    the same status, with objectives within 1e-8 relative."""
    import importlib

    p = _SUITE["afiro-class"]
    cfg = tpdlp_torch.SolverConfig(tol=1e-8, **FIXED)
    r = tpdlp_torch.solve(p, cfg, device="cpu")
    assert r.status == tpdlp_torch.Status.SOLVED
    assert r.x.dtype == np.float64 and r.escalation is None
    monkeypatch.setattr(importlib.import_module("tpdlp.solver.solve"),
                        "default_dtype", lambda: jnp.float32)
    monkeypatch.setattr(importlib.import_module("tpdlp_torch.solver.solve"),
                        "default_dtype", lambda device: torch.float32)
    rj = tpdlp.solve(p, tpdlp.SolverConfig(tol=1e-8, **FIXED))
    rt = tpdlp_torch.solve(p, cfg, device="cpu")
    assert rj.status == rt.status == tpdlp_torch.Status.SOLVED
    assert rt.escalation["route"] == "refine"
    assert abs(rt.objective - rj.objective) <= 1e-8 * (1 + abs(rj.objective))
    with pytest.raises(ValueError, match="matrix_format"):
        tpdlp_torch.solve(p, device="cpu", matrix_format="coo")
