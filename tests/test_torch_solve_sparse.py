"""Whole solves through the sparse and auto layouts against the JAX
package, in fp64 on the CPU with the JAX power-iteration draw injected.

Under fixed steps (adaptive=False, eta_safety=0.99) the port's
matrix_format="sparse" gives the JAX matrix_format="sparse" status, k, n
and j, and x, y and the objective to 1e-9, on the suite's small and medium
classes and, with the certificates on, on the terminal corpus.  On an LP
with empty rows and columns the JAX sparse operator's -inf norms stop its
Ruiz-scaled solve (Numerical error); there the port's sparse path is held
to the JAX dense path.  Under the adaptive rule the two packages' summation
orders drift apart (tests/test_torch_solve_parity.py): same status, and
the objective within 5*tol."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp
from tpdlp.bench.suite import INSTANCES_DIR, build_suite
from tpdlp.io.mps import read_mps as jax_read_mps
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.bench.suite import INSTANCES_DIR as PORT_INSTANCES
from tpdlp_torch.ops import autotune as A
from tpdlp_torch.ops.exact_dense import ExactDenseOp
from tpdlp_torch.ops.sparse import SparseOp

torch.set_num_threads(2)

_SUITE = {p.name: p for p in build_suite(("small", "medium"))}
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


def _jax(p, fmt="sparse", **cfg_kw):
    return tpdlp.solve(p, tpdlp.SolverConfig(**cfg_kw), dtype=jnp.float64,
                       matrix_format=fmt)


def _port(p, fmt="sparse", **cfg_kw):
    return tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**cfg_kw),
                             device="cpu", dtype=torch.float64,
                             matrix_format=fmt)


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


@pytest.mark.parametrize("name", list(_SUITE))
def test_sparse_fixed_steps_match_jax(jax_b0, name):
    p = _SUITE[name]
    rj, rt = _jax(p, tol=1e-4, **FIXED), _port(p, tol=1e-4, **FIXED)
    assert rj.status == tpdlp.Status.SOLVED
    _exact(rj, rt)


@pytest.mark.parametrize("name", ["afiro-class", "share-class"])
def test_sparse_fixed_steps_match_jax_tight(jax_b0, name):
    p = _SUITE[name]
    rj, rt = _jax(p, tol=1e-6, **FIXED), _port(p, tol=1e-6, **FIXED)
    assert rj.status == tpdlp.Status.SOLVED
    _exact(rj, rt)


@pytest.mark.parametrize("name,status", [
    ("infeas01", tpdlp.Status.PRIMAL_INFEASIBLE),
    ("unbnd01", tpdlp.Status.DUAL_INFEASIBLE),
])
def test_sparse_certificates_match_jax(jax_b0, name, status):
    pj = jax_read_mps(os.path.join(INSTANCES_DIR, f"{name}.mps"))
    pt = tpdlp_torch.read_mps(os.path.join(PORT_INSTANCES, f"{name}.mps"))
    kw = dict(tol=1e-6, max_kkt=60_000, infeasibility_detect=True,
              infeas_tol=1e-4)
    rj, rt = _jax(pj, **kw), _port(pt, **kw)
    assert rj.status == status
    _exact(rj, rt)


@pytest.mark.parametrize("name", ["sc50-class", "deg2-class"])
def test_sparse_adaptive_same_answer(jax_b0, name):
    p, tol = _SUITE[name], 1e-4
    rj, rt = _jax(p, tol=tol, **MAIN), _port(p, tol=tol, **MAIN)
    assert rt.status == rj.status == tpdlp.Status.SOLVED
    assert abs(rt.objective - rj.objective) <= 5 * tol * (
        1 + abs(rj.objective))


@pytest.fixture
def pinned(monkeypatch):
    """choose_operator's timing replaced, so that `label` wins: returns a
    setter."""
    state = {}

    def fake(op, kkt_passes=10):
        kind = {ExactDenseOp: "dense", SparseOp: "sparse"}.get(type(op))
        return 0.0 if kind == state["label"] else 1.0

    monkeypatch.setattr(A, "_time_op", fake)
    return state


@pytest.mark.parametrize("label", ["sparse", "dense"])
def test_auto_matches_the_layout_it_picked(jax_b0, pinned, label):
    """"auto" with its label pinned gives that layout's run bit for bit;
    pinned to CSR it gives the JAX "auto" (BCOO on the CPU) run."""
    pinned["label"] = label
    p = _SUITE["deg2-class"]
    ra = _port(p, "auto", tol=1e-4, **FIXED)
    rl = _port(p, label, tol=1e-4, **FIXED)
    assert (ra.status, ra.iterations, ra.restarts, ra.kkt_passes) == (
        rl.status, rl.iterations, rl.restarts, rl.kkt_passes)
    np.testing.assert_array_equal(ra.x, rl.x)
    if label == "sparse":
        _exact(_jax(p, "auto", tol=1e-4, **FIXED), ra)


def test_empty_segments_solve_like_jax_dense(jax_b0):
    """Empty rows and columns: the JAX sparse path stops at k = 40 with a
    Numerical error (its -inf norms); the port's sparse path gives the JAX
    dense path's run."""
    p = tpdlp.generate_feasible_lp(n=2000, m_ineq=600, m_eq=200,
                                   density=0.002, seed=0)
    rs = _jax(p, "sparse", tol=1e-4, **FIXED)
    assert rs.status == tpdlp.Status.NUMERICAL_ERROR and rs.iterations == 40
    rd = _jax(p, "dense", tol=1e-4, **FIXED)
    assert rd.status == tpdlp.Status.SOLVED
    _exact(rd, _port(p, "sparse", tol=1e-4, **FIXED))


def test_op_cache_reuses_the_sparse_operator(jax_b0):
    p = _SUITE["sc50-class"]
    cache = {}
    cfg = tpdlp_torch.SolverConfig(tol=1e-6, **FIXED)
    r1 = tpdlp_torch.solve(p, cfg, device="cpu", matrix_format="sparse",
                           op_cache=cache)
    (key,) = cache
    assert key[0] == "sparse" and isinstance(cache[key], SparseOp)
    before = cache[key].mat.values().clone()
    r2 = tpdlp_torch.solve(p, cfg, device="cpu", matrix_format="sparse",
                           op_cache=cache)
    assert len(cache) == 1 and r2.iterations == r1.iterations
    np.testing.assert_array_equal(r1.x, r2.x)
    # Scaling works on a copy: the cached operator is the unscaled K.
    assert torch.equal(cache[key].mat.values(), before)
