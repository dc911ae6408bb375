"""The port's per-iteration loop, certificates and Halpern scheme against the
JAX package's, from the same mid-solve fp64 states: the JAX state after a
few hundred per-iteration steps (certificate slots filled), carried across
with tpdlp_torch.convert.  One certificate-on iteration, one Halpern
iteration and restart check to 1e-12; per-iteration chunks that stop
mid-cycle, on the budget or on a certificate, to 1e-9 with identical
counters; and the port's blocked and per-iteration loops against each
other."""

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
from tests.test_torch_step_restart import _same_state, _to_numpy

JS = importlib.import_module("tpdlp.solver.solve")
JL = importlib.import_module("tpdlp.solver.loop")
TL = importlib.import_module("tpdlp_torch.solver.loop")

torch.set_num_threads(2)

RTOL = 1e-12
BASE = dict(tol=1e-4, scaling="ruiz", primal_weight_update=True)
CERTS = dict(infeasibility_detect=True, normalized_certificates=True)


def _feasible():
    return tpdlp.generate_feasible_lp(n=60, m_ineq=30, m_eq=12, seed=11)


def _infeasible():
    return tpdlp.generate_infeasible_lp(seed=0)


#: name -> (config, problem, per-iteration steps before the carried state).
CASES = {
    "certs_fixed": (dict(BASE, adaptive=False, **CERTS), _feasible, 100),
    "certs_adaptive": (dict(BASE, adaptive=True, **CERTS), _feasible, 100),
    "halpern": (dict(BASE, adaptive=False, step_scheme="halpern"),
                _feasible, 100),
    "halpern_certs": (dict(BASE, adaptive=False, step_scheme="halpern",
                           **CERTS), _feasible, 100),
    "periter": (dict(BASE, adaptive=False, loop_mode="periter"), _feasible,
                100),
    # The JAX loop certifies this one at k = 1207, mid-cycle.
    "infeasible": (dict(tol=1e-6, infeasibility_detect=True), _infeasible,
                   1190),
}


@functools.lru_cache(maxsize=None)
def _jax_state(name):
    kw, problem, iters = CASES[name]
    cfg = tpdlp.SolverConfig(**kw)
    p = problem()
    op, c, q, l, u = jax_to_device_arrays(p, jnp.float64)
    mask = jnp.asarray(np.arange(p.m) < p.m_ineq)
    pb, st = JS._prepare(op, c, q, l, u, mask, jax.random.PRNGKey(0),
                         jnp.asarray(np.nan), cfg)
    body = JL.make_body(pb, cfg)
    st = jax.jit(lambda s: jax.lax.fori_loop(0, iters, lambda i, s: body(s),
                                             s))(st)
    return pb, st, cfg


def _carried(name):
    """Both sides at the same state: (jpb, jst, jcfg, pb, st, cfg)."""
    jpb, jst, jcfg = _jax_state(name)
    d = _to_numpy(jpb)
    d["op"] = np.asarray(jpb.op.mat)
    pb = convert.problem_from_numpy(d, device="cpu")
    st = convert.state_from_numpy(_to_numpy(jst), device="cpu")
    return jpb, jst, jcfg, pb, st, tpdlp_torch.SolverConfig(**CASES[name][0])


def _counters(st):
    return tuple(int(getattr(st, f)) for f in ("k", "t", "j", "n_restarts",
                                               "status"))


@pytest.mark.parametrize("name", ["certs_fixed", "certs_adaptive",
                                  "halpern", "halpern_certs"])
def test_one_iteration_equals_jax(name):
    jpb, jst, jcfg, pb, st, cfg = _carried(name)
    assert int(jst.t) % jcfg.restart_period != 0
    if cfg.normalized_certificates:
        # The carried certificate slots are live, not the zeros of a fresh
        # state.
        for f in ("lam_prev", "x_norm_prev", "y_norm_prev", "x_plain_sum",
                  "kty_plain_sum"):
            assert np.abs(np.asarray(getattr(jst, f))).max() > 0, f
    ref = JL.make_live(jpb, jcfg, include_restart=False)(jst)
    ours = TL.make_live(pb, cfg)(st)
    assert _counters(ours) == _counters(ref)
    _same_state(ours, ref)


@pytest.mark.parametrize("kkt_first,fp_res,t", [
    (0.0, 1.0, None),     # no baseline, t below the artificial share
    (1.0, 0.1, None),     # sufficient decay of the fixed-point residual
    (1.0, 0.9, None),     # no criterion fires
    (0.0, 1.0, 40),       # artificial (t >= 0.36 k)
])
def test_restart_check_halpern_equals_jax(kkt_first, fp_res, t):
    jpb, jst, jcfg, pb, st, cfg = _carried("halpern")
    jst = jst.replace(kkt_first=jnp.asarray(kkt_first, jnp.float64),
                      fp_res=jnp.asarray(fp_res, jnp.float64))
    st = st.replace(kkt_first=torch.tensor(kkt_first, dtype=torch.float64),
                    fp_res=torch.tensor(fp_res, dtype=torch.float64))
    if t is not None:
        jst = jst.replace(t=jnp.int32(t))
        st = st.replace(t=torch.tensor(t, dtype=torch.int32))
    ref = JL._restart_check_halpern(jpb, jcfg, jst)
    ours = TL._restart_check_halpern(pb, cfg, st)
    restarted = int(ref.n_restarts) == int(jst.n_restarts) + 1
    assert restarted == (fp_res <= 0.2 * kkt_first or t is not None)
    _same_state(ours, ref)


def test_restart_check_halpern_flags_divergence_like_jax():
    jpb, jst, jcfg, pb, st, cfg = _carried("halpern")
    jst = jst.replace(x_sum=jst.x_sum.at[0].set(jnp.nan))
    xs = st.x_sum.clone()
    xs[0] = float("nan")
    ours = TL._restart_check_halpern(pb, cfg, st.replace(x_sum=xs))
    ref = JL._restart_check_halpern(jpb, jcfg, jst)
    assert int(ref.status) == int(tpdlp.Status.NUMERICAL_ERROR)
    _same_state(ours, ref)


@pytest.mark.parametrize("name", ["certs_fixed", "certs_adaptive",
                                  "halpern_certs", "periter"])
def test_chunk_ending_mid_cycle_and_the_next_equal_jax(name):
    """A per-iteration chunk whose budget ends mid-cycle stops exactly at
    it; the chunk after it enters mid-cycle and crosses restart checks."""
    jpb, jst, jcfg, pb, st, cfg = _carried(name)
    budget = int(jst.j) + 17
    for extra in (0, 150):
        budget += extra
        jst = JL.run_chunk(jst, jpb, jnp.int32(budget), jcfg)
        st = TL.run_chunk(st, pb, budget, cfg)
        assert int(jst.j) >= budget
        assert _counters(st) == _counters(jst)
        _same_state(st, jst, rtol=1e-9)
        if extra == 0:
            assert int(jst.t) % jcfg.restart_period != 0
    assert int(jst.n_restarts) > 0


def test_certificate_fires_mid_cycle_like_jax():
    """The planted-infeasible LP certifies at k = 1207 (1207 % 40 = 7):
    the chunk stops there with the JAX state, and the rest of the cycle
    runs masked (issued, not counted in k)."""
    jpb, jst, jcfg, pb, st, cfg = _carried("infeasible")
    k0 = int(st.k)
    budget = int(jst.j) + 1000
    jst = JL.run_chunk(jst, jpb, jnp.int32(budget), jcfg)
    TL.reset_launched()
    st = TL.run_chunk(st, pb, budget, cfg)
    assert int(jst.status) == int(tpdlp.Status.PRIMAL_INFEASIBLE)
    assert int(jst.k) == 1207
    assert _counters(st) == _counters(jst)
    _same_state(st, jst, rtol=1e-9)
    # Issued: the iterations to the end of the cycle the certificate fired
    # in, and one restart check per cycle boundary reached.
    T = cfg.restart_period
    issued = -(-int(st.k) // T) * T - k0
    counts = {k: TL.launched[k] for k in ("iterations", "restart_checks")}
    assert counts == {"iterations": issued,
                      "restart_checks": -(-int(st.k) // T) - k0 // T}


def test_blocked_entry_mid_cycle_uses_the_masked_block():
    """The blocked runner's alignment block from a mid-cycle state equals
    the JAX blocked runner's per-iteration pre-loop."""
    jpb, jst, jcfg, pb, st, cfg = _carried("halpern")
    budget = int(jst.j) + 200
    ref = JL.run_chunk(jst, jpb, jnp.int32(budget), jcfg, aligned=False)
    ours = TL.run_chunk(st, pb, budget, cfg, aligned=False)
    assert int(ref.t) % jcfg.restart_period == 0
    assert _counters(ours) == _counters(ref)
    _same_state(ours, ref, rtol=1e-9)


@pytest.mark.parametrize(
    "kw",
    [
        dict(adaptive=True, primal_weight_update=True),
        dict(adaptive=False),
        dict(adaptive=False, step_scheme="halpern"),
        dict(adaptive=True, adaptive_rule="linesearch"),
    ],
)
def test_blocked_matches_periter_exactly(kw):
    """tests/test_blocked_loop.py's test on the port: blocked and
    per-iteration give identical counters and the same solution."""
    p = tpdlp_torch.generate_feasible_lp(n=60, m_ineq=30, m_eq=12, seed=11)
    base = dict(tol=1e-6, scaling="ruiz", max_kkt=30_000)
    rb = tpdlp_torch.solve(
        p, tpdlp_torch.SolverConfig(**base, loop_mode="blocked", **kw),
        seed=3, device="cpu")
    rp = tpdlp_torch.solve(
        p, tpdlp_torch.SolverConfig(**base, loop_mode="periter", **kw),
        seed=3, device="cpu")
    assert rb.status == rp.status == tpdlp_torch.Status.SOLVED
    assert rb.iterations == rp.iterations
    assert rb.kkt_passes == rp.kkt_passes
    assert rb.restarts == rp.restarts
    np.testing.assert_allclose(rb.x, rp.x, rtol=1e-6, atol=1e-8)
    assert rb.objective == pytest.approx(rp.objective, rel=1e-9)


def test_certificates_change_no_value():
    """Certificates on a feasible solve: the same k, n and x as the blocked
    solve, and one KKT pass per iteration from k = 2 on."""
    p = tpdlp_torch.generate_feasible_lp(n=60, m_ineq=30, m_eq=12, seed=11)
    base = dict(tol=1e-6, scaling="ruiz", adaptive=True,
                primal_weight_update=True)
    rb = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**base), device="cpu")
    rc = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**base, **CERTS),
                           device="cpu")
    assert rb.status == rc.status == tpdlp_torch.Status.SOLVED
    assert (rc.iterations, rc.restarts) == (rb.iterations, rb.restarts)
    assert rc.kkt_passes == rb.kkt_passes + rb.iterations - 1
    np.testing.assert_array_equal(rc.x, rb.x)
    np.testing.assert_array_equal(rc.y, rb.y)


@pytest.mark.parametrize("name", ["certs_adaptive", "halpern"])
def test_final_eval_equals_jax(name):
    """final_eval's Halpern branch evaluates the *_prev point."""
    jpb, jst, jcfg, pb, st, cfg = _carried(name)
    for tol in (1e-12, 1e3):
        ref = JL.final_eval(jst, jpb, jcfg.replace(tol=tol))
        ours = TL.final_eval(st, pb, cfg.replace(tol=tol))
        _same_state(ours, ref)
