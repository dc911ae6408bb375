"""The port's fishnet warm start (`tpdlp_torch.fishnet`) on the CPU: its
pieces and the whole search against `tpdlp.fishnet` on the same inputs in
fp64, and twins of tests/test_fishnet.py.

Tolerances: the round schedule exactly; one round's PDHG steps and the
batched gap to 1e-12 (the two packages sum their matrix products in
different orders, 1e-16 apart, over a few steps); `spectral_cast` with the
JAX package's random draws injected returns the JAX point to 1e-9 (the
ranking of the population is the same, the point carries the rounding of
8 rounds of 32 steps); a warm solve's objective within 1e-4 of the cold
one, as test_fishnet.py.
"""

import csv
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpdlp.fishnet as JF
import tpdlp_torch
import tpdlp_torch.fishnet as F
from tpdlp.problem import to_device_arrays as jax_arrays
from tpdlp_torch import SolverConfig, Status, generate_feasible_lp, solve
from tpdlp_torch.io.writer import write_mps
from tpdlp_torch.ops.sparse import SparseOp
from tpdlp_torch.problem import to_device_arrays

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b)), initial=0.0))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's three draws replaced by the JAX package's for seed 0:
    PRNGKey(seed) split into the radius, points and breeding keys."""
    def keys(seed):
        return jax.random.split(jax.random.PRNGKey(seed), 3)

    def t(a, dtype, device):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    monkeypatch.setattr(F, "radius_start", lambda n, seed, dt, dev: t(
        jax.random.normal(keys(seed)[0], (n,), dtype=jnp.float64), dt, dev))
    monkeypatch.setattr(F, "initial_points", lambda n, j, seed, dt, dev: t(
        jax.random.normal(keys(seed)[1], (n, j), dtype=jnp.float64), dt,
        dev))
    monkeypatch.setattr(
        F, "breed_weights", lambda keep, n_new, seed, r, dt, dev: t(
            jax.random.uniform(jax.random.fold_in(keys(seed)[2], r),
                               (keep, n_new), dtype=jnp.float64), dt, dev))


@pytest.mark.parametrize("j,s", [(32, 2), (64, 2), (32, 4), (27, 3), (1, 2)])
def test_round_schedule_matches_jax(j, s):
    assert F._round_schedule(j, s) == JF._round_schedule(j, s)


def test_round_schedule_matches_reference_dynamics():
    assert F._round_schedule(32, 2) == [
        (32, 16, False), (16, 8, True), (16, 8, False), (8, 4, True),
        (8, 4, False), (4, 2, True), (4, 2, False), (2, 1, False),
    ]


def _pieces(seed=4):
    """One LP with free, lower-only and boxed variables as both packages'
    dense operators, and a random (n, 16) / (m, 16) population."""
    p = generate_feasible_lp(n=30, m_ineq=18, m_eq=6, seed=seed,
                             bounds="mixed")
    opj, cj, qj, lj, uj = jax_arrays(p, jnp.float64)
    opt, ct, qt, lt, ut = to_device_arrays(p, torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((p.n, 16))
    pts_y = rng.standard_normal((p.m, 16))
    return p, (opj, cj, qj, lj, uj), (opt, ct, qt, lt, ut), pts, pts_y


def test_pdhg_steps_match_jax():
    p, (opj, cj, qj, lj, uj), (opt, ct, qt, lt, ut), pts, pts_y = _pieces()
    mask_j = jnp.arange(p.m) < p.m_ineq
    mask_t = torch.arange(p.m) < p.m_ineq
    xj, yj = JF._pdhg_steps(opj, jnp.asarray(pts), jnp.asarray(pts_y), cj,
                            qj, lj, uj, mask_j, 0.3, 1.7, 5)
    xt, yt = F._pdhg_steps(opt, torch.as_tensor(pts),
                           torch.as_tensor(pts_y), ct, qt, lt, ut, mask_t,
                           0.3, 1.7, 5)
    assert _rel(xt, xj) <= 1e-12 and _rel(yt, yj) <= 1e-12


def test_batched_gap_matches_jax():
    p, (opj, cj, qj, lj, uj), (opt, ct, qt, lt, ut), pts, pts_y = _pieces(5)

    nj, pj = jnp.isneginf(lj), jnp.isposinf(uj)
    nt, pt = torch.isneginf(lt), torch.isposinf(ut)
    gj = JF._batched_gap(opj, jnp.asarray(pts), jnp.asarray(pts_y), cj, qj,
                         jnp.where(nj, 0.0, lj), jnp.where(pj, 0.0, uj),
                         nj, pj)
    gt = F._batched_gap(opt, torch.as_tensor(pts), torch.as_tensor(pts_y),
                        ct, qt, torch.where(nt, 0.0, lt),
                        torch.where(pt, 0.0, ut), nt, pt)
    assert _rel(gt, gj) <= 1e-12


@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_spectral_cast_matches_jax(jax_draws, k, layout):
    p = generate_feasible_lp(n=30, m_ineq=20, m_eq=5, seed=21)
    opj, cj, qj, lj, uj = jax_arrays(p, jnp.float64)
    xj, yj = JF.spectral_cast(opj, cj, qj, lj, uj, p.m_ineq, k=k, seed=0)
    op, c, q, l, u = to_device_arrays(p, torch.float64, device="cpu")
    if layout == "sparse":
        op = SparseOp.from_scipy(p.K, torch.float64, device="cpu")
    xt, yt = F.spectral_cast(op, c, q, l, u, p.m_ineq, k=k, seed=0)
    assert _rel(xt, xj) <= 1e-9 and _rel(yt, yj) <= 1e-9


def test_draws_are_seeded():
    a = F.initial_points(7, 4, 3, torch.float64, "cpu")
    assert torch.equal(a, F.initial_points(7, 4, 3, torch.float64, "cpu"))
    assert not torch.equal(a, F.initial_points(7, 4, 4, torch.float64,
                                               "cpu"))
    w = F.breed_weights(3, 5, 0, 1, torch.float64, "cpu")
    assert bool(((w >= 0) & (w < 1)).all())
    assert not torch.equal(w, F.breed_weights(3, 5, 0, 2, torch.float64,
                                              "cpu"))


# ---------------------------------------------------------------------------
# Twins of tests/test_fishnet.py
# ---------------------------------------------------------------------------


def test_spectral_cast_returns_finite_point():
    p = generate_feasible_lp(n=30, m_ineq=20, m_eq=5, seed=21)
    op, c, q, l, u = to_device_arrays(p, torch.float64, device="cpu")
    x0, y0 = F.spectral_cast(op, c, q, l, u, p.m_ineq, k=8, seed=0)
    assert x0.shape == (p.n,) and y0.shape == (p.m,)
    assert bool(torch.isfinite(x0).all()) and bool(torch.isfinite(y0).all())


def test_warm_start_solves():
    p = generate_feasible_lp(n=40, m_ineq=25, m_eq=8, seed=22)
    op, c, q, l, u = to_device_arrays(p, torch.float64, device="cpu")
    x0, y0 = F.spectral_cast(op, c, q, l, u, p.m_ineq, k=16, seed=0)
    cfg = SolverConfig(tol=1e-6, max_kkt=60_000)
    r_warm = solve(p, cfg, device="cpu", x0=x0.numpy(), y0=y0.numpy())
    r_cold = solve(p, cfg, device="cpu")
    assert r_warm.status == Status.SOLVED
    np.testing.assert_allclose(r_warm.objective, r_cold.objective, rtol=1e-4)


def test_cli_fishnet_sparse_does_not_densify(tmp_path, monkeypatch):
    """--fishnet --matrix_format sparse builds the solve's layout for the
    search: the dense staging helper is never called, and the sweep still
    solves from the fishnet warm start."""
    import tpdlp_torch.cli.main as cli
    import tpdlp_torch.problem as problem_mod

    p = generate_feasible_lp(n=30, m_ineq=20, m_eq=5, seed=3, density=0.2)
    write_mps(p, str(tmp_path / "inst.mps"))

    def boom(*a, **k):
        raise AssertionError("fishnet densified: to_device_arrays called")

    monkeypatch.setattr(problem_mod, "to_device_arrays", boom)
    monkeypatch.setattr(importlib.import_module("tpdlp_torch.solver.solve"),
                        "to_device_arrays", boom)
    out = tmp_path / "out"
    assert cli.main([
        "--instance_path", str(tmp_path), "--output_path", str(out),
        "--tolerance", "1e-6", "--fishnet", "--matrix_format", "sparse",
        "--device", "cpu",
    ]) == 0
    with open(out / "solver_results.csv") as f:
        rows = list(csv.DictReader(f))
    assert rows and all(r["Status"] == "Solved" for r in rows)


def test_cli_fishnet_refuses_presolve(tmp_path):
    import tpdlp_torch.cli.main as cli

    with pytest.raises(SystemExit, match="--fishnet cannot be combined"):
        cli.main(["--instance_path", str(tmp_path), "--fishnet",
                  "--presolve", "python", "--device", "cpu"])


def test_fishnet_value_bench_smoke():
    from tpdlp_torch.bench import fishnet_value

    rows = fishnet_value.main(["--classes", "small", "--tol", "1e-4",
                               "--device", "cpu"])
    assert len(rows) == 3
    for r in rows:
        assert r["cold_status"] == "Solved"
        assert r["warm_status"] == "Solved"
        assert r["delta_k"] == r["cold_k"] - r["warm_k"]


def test_fishnet_start_maps_back_to_the_original_frame():
    """fishnet_start hands the solve a point in the original frame: x0 =
    d_col x0_s, y0 = d_row y0_s of the search on the scaled problem."""
    from tpdlp_torch.scaling.ruiz import scale_problem

    p = generate_feasible_lp(n=30, m_ineq=20, m_eq=5, seed=9)
    x0, y0 = F.fishnet_start(p, torch.float64, torch.device("cpu"),
                             scaling="ruiz", seed=1)
    op, c, q, l, u = to_device_arrays(p, torch.float64, device="cpu")
    op_s, c_s, q_s, l_s, u_s, d_row, d_col = scale_problem(
        op, c, q, l, u, method="ruiz")
    xs, ys = F.spectral_cast(op_s, c_s, q_s, l_s, u_s, p.m_ineq, k=32,
                             seed=1)
    assert np.array_equal(x0, (d_col * xs).numpy())
    assert np.array_equal(y0, (d_row * ys).numpy())
    assert tpdlp_torch.solve(p, SolverConfig(tol=1e-6, scaling="ruiz"),
                             device="cpu", x0=x0, y0=y0).status == (
        Status.SOLVED)
