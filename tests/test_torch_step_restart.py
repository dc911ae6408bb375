"""One step, one restart check, one final evaluation and one chunk of the
port against the JAX package, from the same mid-solve fp64 state: the JAX
state after 100 iterations, carried across with tpdlp_torch.convert."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp
from tpdlp.problem import to_device_arrays as jax_to_device_arrays
import tpdlp_torch
from tpdlp_torch import convert

JS = importlib.import_module("tpdlp.solver.solve")
JL = importlib.import_module("tpdlp.solver.loop")
JStep = importlib.import_module("tpdlp.solver.step")
TL = importlib.import_module("tpdlp_torch.solver.loop")
TStep = importlib.import_module("tpdlp_torch.solver.step")

torch.set_num_threads(2)

RTOL = 1e-12
BASE = dict(tol=1e-4, scaling="ruiz", primal_weight_update=True)
CONFIGS = {
    "adaptive": dict(BASE, adaptive=True),
    "linesearch": dict(BASE, adaptive=True, adaptive_rule="linesearch"),
    "fixed": dict(BASE, adaptive=False),
}


@functools.lru_cache(maxsize=None)
def _jax_mid_state(name):
    """(JAX problem, JAX state after 100 per-iteration steps, config)."""
    cfg = tpdlp.SolverConfig(**CONFIGS[name])
    p = tpdlp.generate_feasible_lp(n=60, m_ineq=30, m_eq=12, seed=11)
    op, c, q, l, u = jax_to_device_arrays(p, jnp.float64)
    mask = jnp.asarray(np.arange(p.m) < p.m_ineq)
    pb, st = JS._prepare(op, c, q, l, u, mask, jax.random.PRNGKey(0),
                         jnp.asarray(np.nan), cfg)
    body = JL.make_body(pb, cfg)
    st = jax.jit(lambda s: jax.lax.fori_loop(0, 100, lambda i, s: body(s),
                                             s))(st)
    return pb, st, cfg


def _to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name != "op"}


def _carried(name):
    """Both sides at the same state: (jpb, jst, jcfg, pb, st, cfg)."""
    jpb, jst, jcfg = _jax_mid_state(name)
    d = _to_numpy(jpb)
    d["op"] = np.asarray(jpb.op.mat)
    pb = convert.problem_from_numpy(d, device="cpu")
    st = convert.state_from_numpy(_to_numpy(jst), device="cpu")
    return jpb, jst, jcfg, pb, st, tpdlp_torch.SolverConfig(**CONFIGS[name])


def _close(a, b, name, rtol=RTOL):
    a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
    b = np.asarray(b)
    if b.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=name)
        return
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), name)
    fin = np.isfinite(b)
    err = np.max(np.abs(a[fin] - b[fin]) / (1 + np.abs(b[fin])),
                 initial=0.0)
    assert err <= rtol, f"{name}: {err}"


def _same_state(st, jst, rtol=RTOL):
    for f in dataclasses.fields(jst):
        _close(getattr(st, f.name), getattr(jst, f.name), f.name, rtol)


def test_carried_state_is_mid_cycle():
    _, jst, _, _, st, _ = _carried("adaptive")
    assert int(jst.k) == 100 and int(jst.t) % 40 != 0
    assert st.k.dtype == torch.int32 and st.x.dtype == torch.float64
    _same_state(st, jst, rtol=0)
    back = convert.state_to_numpy(st)
    for k, v in _to_numpy(jst).items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("name", ["adaptive", "linesearch"])
def test_adaptive_step_equals_jax(name):
    jpb, jst, jcfg, pb, st, cfg = _carried(name)
    ref = JStep.adaptive_step(jpb, jcfg, jst.x, jst.y, jst.kx, jst.kty,
                              jst.eta, jst.omega, jst.k + 1)
    ours = TStep.adaptive_step(pb, cfg, st.x, st.y, st.kx, st.kty, st.eta,
                               st.omega, st.k + 1)
    for field, a, b in zip(ref._fields, ours, ref):
        _close(a, b, field)


def test_linesearch_backtracks_like_jax():
    """A too-large incoming eta forces retries; trials (j_inc) match."""
    jpb, jst, jcfg, pb, st, cfg = _carried("linesearch")
    big = 50.0
    ref = JStep.adaptive_step(jpb, jcfg, jst.x, jst.y, jst.kx, jst.kty,
                              jst.eta * big, jst.omega, jst.k + 1)
    ours = TStep.adaptive_step(pb, cfg, st.x, st.y, st.kx, st.kty,
                               st.eta * big, st.omega, st.k + 1)
    assert int(ref.j_inc) > 1
    for field, a, b in zip(ref._fields, ours, ref):
        _close(a, b, field)


def test_fixed_step_equals_jax():
    jpb, jst, jcfg, pb, st, cfg = _carried("fixed")
    ref = JStep.fixed_step(jpb, jcfg, jst.x, jst.y, jst.kx, jst.kty,
                           jst.eta, jst.omega)
    ours = TStep.fixed_step(pb, cfg, st.x, st.y, st.kx, st.kty, st.eta,
                            st.omega)
    for field, a, b in zip(ref._fields, ours, ref):
        _close(a, b, field)


def test_live_iteration_equals_jax():
    jpb, jst, jcfg, pb, st, cfg = _carried("adaptive")
    ref = JL.make_live(jpb, jcfg, include_restart=False)(jst)
    ours = TL.make_live(pb, cfg)(st)
    _same_state(ours, ref)


@pytest.mark.parametrize("kkt_first,t", [
    (0.0, None),     # no criterion fires: no restart
    (1e10, None),    # sufficient decay: restart
    (0.0, 40),       # artificial (t >= 0.36 k): restart
])
@pytest.mark.parametrize("name", ["adaptive", "fixed"])
def test_restart_check_equals_jax(name, kkt_first, t):
    jpb, jst, jcfg, pb, st, cfg = _carried(name)
    jst = jst.replace(kkt_first=jnp.asarray(kkt_first, jnp.float64))
    st = st.replace(kkt_first=torch.tensor(kkt_first, dtype=torch.float64))
    if t is not None:
        jst = jst.replace(t=jnp.int32(t))
        st = st.replace(t=torch.tensor(t, dtype=torch.int32))
    ref = JL._restart_check(jpb, jcfg, jst)
    ours = TL._restart_check(pb, cfg, st)
    restarted = int(ref.n_restarts) == int(jst.n_restarts) + 1
    assert restarted == (kkt_first > 0 or t is not None)
    _same_state(ours, ref)


def test_restart_check_flags_divergence_like_jax():
    jpb, jst, jcfg, pb, st, cfg = _carried("fixed")
    jst = jst.replace(x_sum=jst.x_sum.at[0].set(jnp.nan))
    xs = st.x_sum.clone()
    xs[0] = float("nan")
    st = st.replace(x_sum=xs)
    ref = JL._restart_check(jpb, jcfg, jst)
    ours = TL._restart_check(pb, cfg, st)
    assert int(ref.status) == int(tpdlp.Status.NUMERICAL_ERROR)
    _same_state(ours, ref)


@pytest.mark.parametrize("tol", [1e-12, 1e3])
def test_final_eval_equals_jax(tol):
    jpb, jst, jcfg, pb, st, cfg = _carried("adaptive")
    ref = JL.final_eval(jst, jpb, jcfg.replace(tol=tol))
    ours = TL.final_eval(st, pb, cfg.replace(tol=tol))
    want = tpdlp.Status.SOLVED if tol > 1 else tpdlp.Status.KKT_LIMIT
    assert int(ref.status) == int(ours.status) == int(want)
    _same_state(ours, ref)


@pytest.mark.parametrize("name,extra,rtol", [
    ("fixed", 400, 1e-10),     # a few cycles: the fixed-step map is stable
    ("adaptive", 30, 1e-9),    # alignment + one cycle
])
def test_chunk_from_mid_cycle_equals_jax(name, extra, rtol):
    """The unaligned pre-loop brings the state to a cycle boundary, then
    blocked cycles run to the budget; counters identical."""
    jpb, jst, jcfg, pb, st, cfg = _carried(name)
    budget = int(jst.j) + extra
    ref = JL.run_chunk(jst, jpb, jnp.int32(budget), jcfg, aligned=False)
    ours = TL.run_chunk(st, pb, budget, cfg, aligned=False)
    assert int(ref.t) % jcfg.restart_period == 0 and int(ref.j) >= budget
    _same_state(ours, ref, rtol)


def test_unported_loops_raise():
    _, _, _, pb, st, cfg = _carried("fixed")
    for kw in (dict(loop_mode="periter"), dict(infeasibility_detect=True),
               dict(restart_period=300)):
        with pytest.raises(NotImplementedError, match="item 11"):
            TL.run_chunk(st, pb, 10**6, cfg.replace(**kw))
    with pytest.raises(NotImplementedError, match="item 11"):
        TL.run_chunk(st, pb, 10**6, cfg.replace(step_scheme="halpern"))
