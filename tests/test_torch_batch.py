"""Scenario-batched solves of the port (`tpdlp_torch.solve_batch`) on the
CPU: twins of every case of tests/test_batch.py (the oracle, ragged
shapes, single-solve trajectories, certificates, both restart schedules,
compaction, Halpern, the shared-K layouts, the distinct band stack and its
"auto" rule), parity with `tpdlp.solve_batch`, and the batched kernels'
twins against the single ones.

Tolerances:
- against scipy's HiGHS (tests/oracles.py), as test_batch.py: objectives
  to 1e-3 (5e-3 for the band fleet), at solver tol 1e-6;
- parity with the JAX package in fp64 under fixed steps, as
  test_torch_solve_parity.py: each element's status, k, n and j exactly,
  x, y and the objective to 1e-9 (the two packages sum in different
  orders, 1e-16 apart), with the JAX power-iteration draws injected
  (PRNGKey(seed) for a shared K, its B-way split for a stack);
- under the adaptive rule, which amplifies those differences (ROADMAP.md
  queue 3): the same status and the objective within 5 * tol;
- compaction and the batched twins: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp.batch import solve_batch as jax_solve_batch
from tpdlp_torch import SolverConfig, Status, generate_feasible_lp
from tpdlp_torch.batch import solve_batch
from tpdlp_torch.batch import stacked as ST
from tpdlp_torch.batch import vmapped as V
from tpdlp_torch.io.generator import (
    generate_banded_lp,
    generate_infeasible_lp,
)
from tpdlp_torch.ops import _kernels as K
from tpdlp_torch.scaling.ruiz import ruiz_equilibrate
from tests.oracles import solve_oracle

torch.set_num_threads(2)

FIXED = dict(scaling="ruiz", adaptive=False, primal_weight_update=True,
             eta_safety=0.99, tol=1e-6, max_kkt=60_000)


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


def _jax_elements(n, seed, batch, dtype, device):
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    b0 = np.stack([np.array(jax.random.normal(k, (n,), dtype=jnp.float64))
                   for k in keys])
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)
    monkeypatch.setattr(V, "element_vectors", _jax_elements)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b)), initial=0.0))


def _perturbed_fleet(base, B, seed=0, perturb_q=True):
    rng = np.random.default_rng(seed)
    fleet = []
    for _ in range(B):
        kw = {"c": base.c * (1 + 0.1 * rng.standard_normal(base.n))}
        if perturb_q:
            kw["q"] = base.q + 0.05 * rng.standard_normal(base.m)
        fleet.append(dataclasses.replace(base, **kw))
    return fleet


def _oracle_close(problems, results, tol=1e-3):
    for p, r in zip(problems, results):
        o = solve_oracle(p)
        assert o.status == 0
        assert r.status == Status.SOLVED, (p.name, r.status_string)
        np.testing.assert_allclose(r.objective, o.fun, rtol=tol, atol=tol)
        assert r.x.shape == (p.n,) and r.y.shape == (p.m,)


# ---------------------------------------------------------------------------
# Twins of tests/test_batch.py
# ---------------------------------------------------------------------------


def test_batch_same_shape_matches_oracle():
    problems = [generate_feasible_lp(n=30, m_ineq=18, m_eq=6, seed=s)
                for s in range(4)]
    cfg = SolverConfig(tol=1e-6, max_kkt=60_000, scaling="ruiz")
    _oracle_close(problems, solve_batch(problems, cfg, device="cpu"))


def test_batch_ragged_shapes():
    problems = [
        generate_feasible_lp(n=20, m_ineq=12, m_eq=4, seed=1),
        generate_feasible_lp(n=35, m_ineq=20, m_eq=8, seed=2),
        generate_feasible_lp(n=28, m_ineq=0, m_eq=10, seed=3),
    ]
    cfg = SolverConfig(tol=1e-6, max_kkt=60_000, scaling="ruiz")
    _oracle_close(problems, solve_batch(problems, cfg, device="cpu"))


@pytest.mark.parametrize("sync", ["element", "global"])
def test_batch_matches_single_solve(sync):
    """Both schedules reach the single solves' objectives to 1e-6;
    "element" keeps their trajectories exactly (k, n, j)."""
    problems = [generate_feasible_lp(n=25, m_ineq=15, m_eq=5, seed=s)
                for s in (7, 8)]
    cfg = SolverConfig(tol=1e-6, max_kkt=60_000)
    batch = solve_batch(problems, cfg, device="cpu", restart_sync=sync)
    for p, rb in zip(problems, batch):
        rs = tpdlp_torch.solve(p, cfg, device="cpu")
        assert rb.status == rs.status == Status.SOLVED
        np.testing.assert_allclose(rb.objective, rs.objective, rtol=1e-6)
        if sync == "element":
            assert (rb.iterations, rb.restarts, rb.kkt_passes) == (
                rs.iterations, rs.restarts, rs.kkt_passes)


def test_batch_mixed_feasible_infeasible():
    problems = [generate_feasible_lp(n=30, m_ineq=15, m_eq=5, seed=1),
                generate_infeasible_lp(seed=3)]
    cfg = SolverConfig(tol=1e-6, max_kkt=60_000, infeasibility_detect=True,
                       infeas_tol=1e-4)
    results = solve_batch(problems, cfg, device="cpu")
    assert results[0].status == Status.SOLVED
    assert results[1].status == Status.PRIMAL_INFEASIBLE


def test_batch_global_restart_sync():
    problems = [generate_feasible_lp(n=30, m_ineq=18, m_eq=6, seed=s)
                for s in range(4)]
    cfg = SolverConfig(tol=1e-6, max_kkt=60_000, scaling="ruiz")
    exact = solve_batch(problems, cfg, device="cpu", restart_sync="element")
    fast = solve_batch(problems, cfg, device="cpu", restart_sync="global")
    for p, re_, rf in zip(problems, exact, fast):
        assert rf.status == Status.SOLVED, (p.name, rf.status_string)
        np.testing.assert_allclose(rf.objective, re_.objective, rtol=1e-4)
    with pytest.raises(ValueError, match="restart_sync"):
        solve_batch(problems, cfg, device="cpu", restart_sync="bogus")


def _straggler_fleet():
    """Tiny easy instances and harder ones: the easy half finishes first,
    so compaction fires mid-solve."""
    return [generate_feasible_lp(n=12, m_ineq=7, m_eq=2, seed=s)
            for s in range(6)] + [
        generate_feasible_lp(n=40, m_ineq=25, m_eq=8, seed=s)
        for s in range(4)]


def _force_compaction(monkeypatch):
    monkeypatch.setattr(V, "_MIN_COMPACT", 2)
    monkeypatch.setattr(V, "_COMPACT_MIN_CHUNK_WALL", 0.0)


def test_batch_compaction_preserves_results(monkeypatch):
    _force_compaction(monkeypatch)
    problems = _straggler_fleet()
    cfg = SolverConfig(tol=1e-6, max_kkt=80_000, scaling="ruiz",
                       chunk_kkt_init=64, chunk_kkt_max=256)
    _oracle_close(problems, solve_batch(problems, cfg, device="cpu",
                                        restart_sync="global"))


@pytest.mark.parametrize("sync", ["element", "global"])
@pytest.mark.parametrize("fmt,shared", [("dense", False), ("dense", True),
                                        ("band", False)])
def test_compaction_is_bit_identical(monkeypatch, sync, fmt, shared):
    """Compaction forced at every chunk boundary changes no element's
    result: the same status, k, n, j and the same x, y and objective bits
    as the uncompacted fleet (every product and reduction of an element
    is independent of the batch it runs in)."""
    if fmt == "band":
        problems = [generate_banded_lp(n=256, m_ineq=128, m_eq=64,
                                       bandwidth=9, seed=s)
                    for s in (1, 2, 3)] + [
            generate_banded_lp(n=192, m_ineq=96, m_eq=48, bandwidth=7,
                               seed=4)]
    elif shared:
        base = generate_feasible_lp(n=40, m_ineq=25, m_eq=8, seed=3,
                                    density=0.3)
        problems = _perturbed_fleet(base, 6)
    else:
        problems = _straggler_fleet()
    cfg = SolverConfig(tol=1e-6, max_kkt=80_000, scaling="ruiz",
                       adaptive=True, primal_weight_update=True,
                       chunk_kkt_init=64, chunk_kkt_max=256)
    kw = dict(device="cpu", restart_sync=sync, matrix_format=fmt,
              shared_operator=shared)
    plain = solve_batch(problems, cfg, compact=False, **kw)
    _force_compaction(monkeypatch)
    calls = []
    take = V._take_state
    monkeypatch.setattr(V, "_take_state",
                        lambda st, sel: calls.append(1) or take(st, sel))
    packed = solve_batch(problems, cfg, compact=True, **kw)
    assert calls, "compaction never fired"
    for a, b in zip(plain, packed):
        assert a.status == b.status
        assert (a.iterations, a.restarts, a.kkt_passes) == (
            b.iterations, b.restarts, b.kkt_passes)
        assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)
        assert a.objective == b.objective


def test_batch_halpern_scheme():
    problems = [generate_feasible_lp(n=25, m_ineq=15, m_eq=5, seed=s)
                for s in range(3)]
    cfg = SolverConfig(tol=1e-6, scaling="ruiz", step_scheme="halpern")
    for sync in ("element", "global"):
        _oracle_close(problems, solve_batch(problems, cfg, device="cpu",
                                            restart_sync=sync))
    with pytest.raises(ValueError, match="adaptive=False"):
        solve_batch(problems, cfg.replace(adaptive=True), device="cpu")


def test_batch_shared_operator_matches_dense_and_oracle():
    """Perturbed fleet (same K): the shared-operator path gives the same
    trajectories as the per-element dense stack (one operator, the same
    scaling diagonals)."""
    base = generate_feasible_lp(n=40, m_ineq=25, m_eq=8, seed=3,
                                density=0.3)
    fleet = _perturbed_fleet(base, 5)
    cfg = SolverConfig(tol=1e-6, max_kkt=100_000, scaling="ruiz")
    rs = solve_batch(fleet, cfg, device="cpu", shared_operator="auto")
    rd = solve_batch(fleet, cfg, device="cpu", shared_operator=False)
    _oracle_close(fleet, rs)
    for a, b in zip(rs, rd):
        np.testing.assert_allclose(a.objective, b.objective, rtol=1e-9)
        assert a.iterations == b.iterations


@pytest.mark.parametrize("fmt", ["sparse", "auto"])
def test_batch_shared_operator_sparse_layouts(fmt):
    base = generate_feasible_lp(n=48, m_ineq=30, m_eq=10, seed=4,
                                density=0.25)
    fleet = _perturbed_fleet(base, 4, seed=1)
    cfg = SolverConfig(tol=1e-6, max_kkt=100_000, scaling="ruiz")
    _oracle_close(fleet, solve_batch(fleet, cfg, device="cpu",
                                     matrix_format=fmt))


@pytest.mark.parametrize("sync", ["element", "global"])
def test_batch_shared_operator_band_fleet(sync):
    base = generate_banded_lp(n=256, m_ineq=128, m_eq=64, bandwidth=9,
                              seed=7)
    fleet = _perturbed_fleet(base, 4, seed=2, perturb_q=False)
    cfg = SolverConfig(tol=1e-6, max_kkt=100_000, scaling="ruiz")
    _oracle_close(fleet, solve_batch(fleet, cfg, device="cpu",
                                     matrix_format="band",
                                     restart_sync=sync), tol=5e-3)


def test_batch_shared_operator_validation():
    problems = [generate_feasible_lp(n=20, m_ineq=12, m_eq=4, seed=s)
                for s in range(2)]
    with pytest.raises(ValueError, match="constraint"):
        solve_batch(problems, SolverConfig(tol=1e-4), device="cpu",
                    shared_operator=True)
    with pytest.raises(ValueError, match="distinct-K"):
        solve_batch(problems, SolverConfig(tol=1e-4), device="cpu",
                    matrix_format="sparse")
    with pytest.raises(ValueError, match="shared_operator"):
        solve_batch(problems, SolverConfig(tol=1e-4), device="cpu",
                    shared_operator="yes")


def test_batch_distinct_band_fleet_matches_single_solves():
    problems = [generate_banded_lp(n=256, m_ineq=128, m_eq=64, bandwidth=9,
                                   seed=s) for s in (1, 2, 3)]
    cfg = SolverConfig(tol=1e-6, max_kkt=100_000, scaling="ruiz")
    batch = solve_batch(problems, cfg, device="cpu", matrix_format="band",
                        shared_operator=False)
    _oracle_close(problems, batch)
    for p, rb in zip(problems, batch):
        rs = tpdlp_torch.solve(p, cfg, device="cpu", matrix_format="band")
        np.testing.assert_allclose(rb.objective, rs.objective, rtol=1e-5)


def test_batch_distinct_band_fleet_ragged_shapes():
    problems = [
        generate_banded_lp(n=256, m_ineq=128, m_eq=64, bandwidth=9, seed=4),
        generate_banded_lp(n=192, m_ineq=96, m_eq=48, bandwidth=7, seed=5),
    ]
    cfg = SolverConfig(tol=1e-6, max_kkt=100_000, scaling="ruiz")
    _oracle_close(problems, solve_batch(problems, cfg, device="cpu",
                                        matrix_format="band",
                                        shared_operator=False))


def test_batch_distinct_auto_picks_band(monkeypatch):
    calls = []
    real = V.band_stack_op
    monkeypatch.setattr(V, "band_stack_op",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    problems = [generate_banded_lp(n=2048, m_ineq=1024, m_eq=512,
                                   bandwidth=33, seed=s) for s in (6, 7)]
    cfg = SolverConfig(tol=1e-6, max_kkt=400, scaling="ruiz")
    rs = solve_batch(problems, cfg, device="cpu", matrix_format="auto",
                     shared_operator=False)
    assert calls, "auto did not route through the band stack"
    assert all(r.status in (Status.SOLVED, Status.KKT_LIMIT) for r in rs)


def test_batch_distinct_auto_falls_back_to_dense(monkeypatch):
    calls = []
    real = V.band_stack_op
    monkeypatch.setattr(V, "band_stack_op",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    problems = [generate_feasible_lp(n=2600, m_ineq=10, m_eq=4, seed=s,
                                     density=0.5) for s in (3, 4)]
    cfg = SolverConfig(tol=1e-4, max_kkt=60_000, scaling="ruiz")
    rs = solve_batch(problems, cfg, device="cpu", matrix_format="auto",
                     shared_operator=False)
    assert not calls
    _oracle_close(problems, rs)


def test_batch_distinct_band_rejects_unbanded():
    problems = [generate_feasible_lp(n=2600, m_ineq=40, m_eq=8, seed=s,
                                     density=0.5) for s in (1, 2)]
    with pytest.raises(ValueError, match="band-like"):
        solve_batch(problems, SolverConfig(tol=1e-4), device="cpu",
                    matrix_format="band", shared_operator=False)


def test_batch_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    problems = [generate_feasible_lp(n=20, m_ineq=12, m_eq=4, seed=0)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_batch(problems)


# ---------------------------------------------------------------------------
# Parity with tpdlp.solve_batch
# ---------------------------------------------------------------------------


def _fleets():
    base = generate_feasible_lp(n=40, m_ineq=25, m_eq=8, seed=3, density=0.3)
    return {
        "shared-dense": (_perturbed_fleet(base, 4), {}),
        "distinct-dense": ([
            generate_feasible_lp(n=20, m_ineq=12, m_eq=4, seed=1),
            generate_feasible_lp(n=35, m_ineq=20, m_eq=8, seed=2),
            generate_feasible_lp(n=28, m_ineq=0, m_eq=10, seed=3),
        ], {}),
        "distinct-band": ([
            generate_banded_lp(n=256, m_ineq=128, m_eq=64, bandwidth=9,
                               seed=1),
            generate_banded_lp(n=192, m_ineq=96, m_eq=48, bandwidth=7,
                               seed=5),
        ], dict(matrix_format="band", shared_operator=False)),
        "certificates": ([
            generate_feasible_lp(n=30, m_ineq=15, m_eq=5, seed=1),
            generate_infeasible_lp(seed=3),
        ], {}),
    }


def _both_batch(problems, dtype="float64", **kw):
    cfg_kw = kw.pop("cfg")
    rj = jax_solve_batch(problems, tpdlp.SolverConfig(**cfg_kw),
                         dtype=getattr(jnp, dtype), **kw)
    rt = solve_batch(problems, SolverConfig(**cfg_kw), device="cpu",
                     dtype=getattr(torch, dtype), **kw)
    return rj, rt


@pytest.mark.parametrize("sync", ["element", "global"])
@pytest.mark.parametrize("fleet", ["shared-dense", "distinct-dense",
                                   "distinct-band", "certificates"])
def test_batch_parity_with_jax_fixed_steps(jax_draws, fleet, sync):
    problems, kw = _fleets()[fleet]
    cfg = dict(FIXED)
    if fleet == "certificates":
        cfg.update(infeasibility_detect=True, normalized_certificates=True,
                   infeas_tol=1e-4)
    rj, rt = _both_batch(problems, cfg=cfg, restart_sync=sync, **kw)
    for a, b in zip(rj, rt):
        assert int(b.status) == int(a.status)
        assert (b.iterations, b.restarts, b.kkt_passes) == (
            a.iterations, a.restarts, a.kkt_passes)
        assert _rel(b.x, a.x) <= 1e-9
        assert _rel(b.y, a.y) <= 1e-9
        assert _rel(b.objective, a.objective) <= 1e-9
    if fleet == "certificates":
        assert rt[1].status == Status.PRIMAL_INFEASIBLE


def test_batch_parity_with_jax_halpern(jax_draws):
    problems = [generate_feasible_lp(n=25, m_ineq=15, m_eq=5, seed=s)
                for s in range(3)]
    cfg = dict(FIXED, step_scheme="halpern")
    rj, rt = _both_batch(problems, cfg=cfg, restart_sync="global")
    for a, b in zip(rj, rt):
        assert int(b.status) == int(a.status) == int(Status.SOLVED)
        assert (b.iterations, b.restarts, b.kkt_passes) == (
            a.iterations, a.restarts, a.kkt_passes)
        assert _rel(b.x, a.x) <= 1e-9


@pytest.mark.parametrize("rule", ["reference", "linesearch"])
def test_batch_parity_with_jax_adaptive(jax_draws, rule):
    """The adaptive rule: the same status, the objective within 5 * tol;
    under the line search each element retries on its own (j counts its
    trials)."""
    base = generate_feasible_lp(n=40, m_ineq=25, m_eq=8, seed=3, density=0.3)
    problems = _perturbed_fleet(base, 4)
    cfg = dict(scaling="ruiz", adaptive=True, primal_weight_update=True,
               tol=1e-4, max_kkt=60_000, adaptive_rule=rule)
    rj, rt = _both_batch(problems, cfg=cfg, restart_sync="global")
    if rule == "linesearch":
        assert all(r.kkt_passes >= r.iterations for r in rt)
    for a, b in zip(rj, rt):
        assert int(b.status) == int(a.status) == int(Status.SOLVED)
        assert abs(b.objective - a.objective) <= 5e-4 * (1 + abs(a.objective))


def test_band_stack_layout_matches_jax():
    """The common slab layout array for array: windows widened to the
    batch's WB, starts clipped, slab content shifted by whole lanes."""
    from tpdlp.batch.vmapped import _band_stack

    problems = [
        generate_banded_lp(n=256, m_ineq=128, m_eq=64, bandwidth=9, seed=4),
        generate_banded_lp(n=192, m_ineq=96, m_eq=48, bandwidth=31, seed=5),
    ]
    m_max = max(p.m for p in problems)
    n_max = max(p.n for p in problems)
    want = _band_stack(problems, jnp.float64, np.float64, m_max, n_max)
    got = ST.band_stack(problems, torch.float64, m_max, n_max)
    for (ws, wst), (gs, gst) in zip(want, got):
        assert np.array_equal(np.asarray(ws), gs)
        assert np.array_equal(np.asarray(wst), gst)


# ---------------------------------------------------------------------------
# The batched twins, element by element the single twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["dense-shared", "dense-stack",
                                  "band-shared", "band-stack", "csr"])
def test_batched_twins_equal_single_twins(case, dtype):
    g = torch.Generator().manual_seed(5)
    B = 6
    if case.startswith("dense"):
        m, n = 37, 53
        M = torch.randn((B, m, n) if case == "dense-stack" else (m, n),
                        generator=g, dtype=dtype)
        X = torch.randn((B, n), generator=g, dtype=dtype)
        Y = K.dense_matvec_batch(M, X)
        single = [K.dense_matvec_plain(M[b] if M.dim() == 3 else M, X[b])
                  for b in range(B)]
    elif case.startswith("band"):
        m, n, WB = 700, 300, 256
        stack = case == "band-stack"
        lead = (B, 8) if stack else (8,)
        slabs = torch.randn(lead + (128, WB), generator=g, dtype=dtype)
        starts = (torch.randint(0, 2, lead, generator=g) * 128).to(
            torch.int32)
        X = torch.randn((B, n), generator=g, dtype=dtype)
        Y = K.band_matvec_batch(slabs, starts, X, m, n)
        single = [K.band_matvec_plain(slabs[b] if stack else slabs,
                                      starts[b] if stack else starts,
                                      X[b], m, n) for b in range(B)]
    else:
        import scipy.sparse as sp

        A = sp.random(90, 70, density=0.1, random_state=3, format="csr")
        crow = torch.as_tensor(A.indptr.astype(np.int32))
        col = torch.as_tensor(A.indices.astype(np.int32))
        val = torch.as_tensor(A.data, dtype=dtype)
        X = torch.randn((B, 70), generator=g, dtype=dtype)
        Y = K.csr_matvec_batch(crow, col, val, X)
        single = [K.csr_matvec_plain(crow, col, val, X[b]) for b in range(B)]
    assert torch.equal(Y, torch.stack(single))


def test_stacked_ruiz_stops_each_element_at_its_own_convergence():
    """A converged element's factors are exactly 1: its matrix and
    diagonals stay as they were while the others keep scaling, as each
    element of the JAX package's vmapped Ruiz loop does."""
    easy = generate_feasible_lp(n=30, m_ineq=10, m_eq=5, seed=2)
    easy = dataclasses.replace(easy, K=np.ones((15, 30)))
    hard = generate_feasible_lp(n=30, m_ineq=10, m_eq=5, seed=3)
    op = ST.StackedDenseOp.from_problems([easy, hard], 15, 30,
                                         torch.float64, "cpu")
    _, d_row, d_col = ruiz_equilibrate(op, 20, 1e-6)
    one_row, one_col = ruiz_equilibrate(
        ST.StackedDenseOp.from_problems([easy], 15, 30, torch.float64,
                                        "cpu"), 20, 1e-6)[1:]
    assert torch.equal(d_row[:1], one_row) and torch.equal(d_col[:1],
                                                           one_col)
