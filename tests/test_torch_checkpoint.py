"""Checkpoint/resume of the port (`tpdlp_torch.solver.checkpoint` and
`solve(checkpoint_path=..., resume=...)`) against the JAX package's, in
fp64 on the CPU with the JAX power-iteration draw injected.

The npz files share field names and defaults, so a state the JAX package
saves mid-solve loads in the port; resumed there under fixed steps, the
solve ends with the k, n, j, status and x (to 1e-9) of an uninterrupted
JAX solve, in blocked and in per-iteration mode, and from a state saved
mid-cycle."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp
from tpdlp.bench.suite import build_suite
from tpdlp.solver import checkpoint as jax_ckpt
from tpdlp.solver.state import PDHGState as JaxState
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.problem import device_problem, to_device_arrays
from tpdlp_torch.solver import checkpoint as C
from tpdlp_torch.solver.state import PDHGState, init_state

torch.set_num_threads(2)

FIXED = dict(scaling="ruiz", adaptive=False, primal_weight_update=True,
             eta_safety=0.99, tol=1e-6)
(_P,) = build_suite(("small",))[1:2]  # sc50-class


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def jax_b0(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)


def _state(seed=0):
    p = tpdlp_torch.generate_feasible_lp(n=20, m_ineq=10, m_eq=4, seed=52)
    op, c, q, l, u = to_device_arrays(p, torch.float64, device="cpu")
    pb = device_problem(op, c, q, l, u, p.m_ineq)
    st = init_state(pb, torch.tensor(0.1, dtype=torch.float64),
                    torch.tensor(1.0, dtype=torch.float64))
    g = torch.Generator().manual_seed(seed)
    return st.replace(
        x=torch.randn(20, generator=g, dtype=torch.float64),
        k=torch.tensor(123, dtype=torch.int32),
        status=torch.tensor(3, dtype=torch.int32),
        eta=torch.tensor(0.25, dtype=torch.float64))


def test_state_fields_are_the_jax_ones():
    assert [f.name for f in dataclasses.fields(PDHGState)] == [
        f.name for f in dataclasses.fields(JaxState)]


def test_save_load_round_trip(tmp_path):
    st = _state()
    C.save_state(st, tmp_path / "st")
    back = C.load_state(tmp_path / "st")
    for f in dataclasses.fields(PDHGState):
        a, b = getattr(st, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name
    f32 = C.load_state(str(tmp_path / "st.npz"), dtype=torch.float32)
    assert f32.x.dtype == torch.float32 and f32.k.dtype == torch.int32


def test_port_checkpoint_loads_in_jax(tmp_path):
    st = _state()
    C.save_state(st, tmp_path / "st")
    js = jax_ckpt.load_state(str(tmp_path / "st"))
    for f in dataclasses.fields(PDHGState):
        np.testing.assert_array_equal(np.asarray(getattr(js, f.name)),
                                      getattr(st, f.name).numpy(), f.name)


def test_missing_fields_take_the_jax_defaults(tmp_path):
    st = _state()
    C.save_state(st, tmp_path / "st")
    z = dict(np.load(tmp_path / "st.npz"))
    for name in ("x_plain_sum", "y_plain_sum", "kx_plain_sum",
                 "kty_plain_sum", "omega_init", "kx_restart",
                 "kty_restart", "fp_res"):
        del z[name]
    np.savez(tmp_path / "old.npz", **z)
    back = C.load_state(tmp_path / "old")
    assert torch.equal(back.omega_init, st.omega)
    assert back.kx_plain_sum.shape == st.y.shape
    assert float(back.x_plain_sum.abs().sum()) == 0.0
    del z["x"]
    np.savez(tmp_path / "bad.npz", **z)
    with pytest.raises(KeyError, match="'x'"):
        C.load_state(tmp_path / "bad")


def _jax_solve(cfg_kw, **kw):
    return tpdlp.solve(_P, tpdlp.SolverConfig(**cfg_kw), dtype=jnp.float64,
                       **kw)


def _port_solve(cfg_kw, **kw):
    return tpdlp_torch.solve(_P, tpdlp_torch.SolverConfig(**cfg_kw),
                             device="cpu", dtype=torch.float64, **kw)


def _same_run(rt, rj):
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert (rt.iterations, rt.restarts, rt.kkt_passes) == (
        rj.iterations, rj.restarts, rj.kkt_passes)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("saved_in,resumed_in,budget", [
    ("auto", "auto", 400),          # blocked, at a cycle boundary
    ("periter", "periter", 430),    # per-iteration, mid-cycle
    ("periter", "auto", 430),       # mid-cycle state, blocked resume
], ids=["blocked", "periter", "midcycle-blocked"])
def test_jax_checkpoint_resumed_by_port(jax_b0, tmp_path, saved_in,
                                        resumed_in, budget):
    ckpt = str(tmp_path / "state")
    short = _jax_solve(dict(FIXED, loop_mode=saved_in, max_kkt=budget,
                            chunk_kkt_init=100, chunk_kkt_max=200),
                       checkpoint_path=ckpt)
    assert short.status == tpdlp.Status.KKT_LIMIT
    saved = jax_ckpt.load_state(ckpt)
    assert int(saved.j) == budget if saved_in == "periter" else (
        int(saved.j) >= budget)
    full = dict(FIXED, loop_mode=resumed_in, max_kkt=60_000)
    rt = _port_solve(full, checkpoint_path=ckpt, resume=True)
    _same_run(rt, _jax_solve(full))
    assert rt.iterations > short.iterations


def test_port_checkpoint_resume_equals_uninterrupted(jax_b0, tmp_path):
    """Interrupted and resumed in the port, bit for bit the uninterrupted
    port solve; the checkpoint after the last chunk holds the result."""
    ckpt = tmp_path / "state"
    short = _port_solve(dict(FIXED, max_kkt=400), checkpoint_path=ckpt)
    assert short.status == tpdlp.Status.KKT_LIMIT
    rt = _port_solve(dict(FIXED, max_kkt=60_000), checkpoint_path=ckpt,
                     resume=True)
    ref = _port_solve(dict(FIXED, max_kkt=60_000))
    assert (rt.status, rt.iterations, rt.restarts, rt.kkt_passes) == (
        ref.status, ref.iterations, ref.restarts, ref.kkt_passes)
    np.testing.assert_array_equal(rt.x, ref.x)
    last = C.load_state(ckpt)
    assert int(last.k) == rt.iterations and int(last.status) == int(
        tpdlp.Status.SOLVED)


def test_resume_without_a_checkpoint_starts_fresh(jax_b0, tmp_path):
    rt = _port_solve(dict(FIXED, max_kkt=60_000),
                     checkpoint_path=tmp_path / "none", resume=True)
    _same_run(rt, _jax_solve(dict(FIXED, max_kkt=60_000)))
    assert (tmp_path / "none.npz").exists()


def test_timer_records_and_prints(capsys):
    """tpdlp_torch.timer.Timer: the JAX Timer's surface, plus a device
    to synchronise (the CPU needs none)."""
    from tpdlp.timer import Timer as JaxTimer
    from tpdlp_torch.timer import Timer

    with Timer("solve") as t:
        sum(range(1000))
    assert t.elapsed > 0
    assert capsys.readouterr().out.startswith("solve: ")
    with Timer("quiet", quiet=True, device=torch.zeros(1)) as q:
        pass
    assert q.elapsed >= 0 and capsys.readouterr().out == ""
    assert q.device == torch.device("cpu")
    jax_params = list(inspect.signature(JaxTimer).parameters)
    assert list(inspect.signature(Timer).parameters)[:2] == jax_params


def test_profile_trace_writes_a_trace(tmp_path):
    from tpdlp_torch.timer import profile_trace

    p = tpdlp_torch.generate_feasible_lp(n=12, m_ineq=5, m_eq=2, seed=0)
    with profile_trace(tmp_path / "trace"):
        r = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(tol=1e-4),
                              device="cpu")
    assert r.status == tpdlp.Status.SOLVED
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
