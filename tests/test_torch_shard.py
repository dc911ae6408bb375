"""Sharded solves: the port over gloo ranks against the JAX package's
sharded solves on conftest's virtual CPU mesh.

The port's side runs once per test session: four spawned processes, joined
by a gloo process group on the CPU, import the port and never JAX
(tests/torch_shard_ranks.py), and run every case in one group, on meshes
(2, 2), (1, 4) and (4, 1) over the same four ranks.  Under xdist the first
worker that needs them runs the ranks and the others read its results (a
file lock in the session's shared temporary directory).  The JAX side runs
here, on `make_solver_mesh(jax.devices()[:4], shape)`.

- Layouts: each rank's shard equals the JAX shard on the matching device
  (`addressable_shards`), array for array, for the dense 2D blocks, the
  band slabs and the block-ELL tiles.  `padded_sizes*`
  and `pad_vectors` equal JAX's on a grid of sizes and meshes.
- fp64, fixed steps: the JAX sharded solve's status and k, n, j exactly,
  x and y to 1e-9; the port's unsharded solve to the same; every rank the
  same bits; one all_reduce per product.  Both start from the JAX
  package's power-iteration draw at the padded n.
- Adaptive steps, Ruiz, the primal-weight update and the ray
  certificates: the same status and the objective within 5 * tol
  (ROADMAP's standard for the adaptive rule), an infeasible LP certified.
- A checkpoint written under a mesh (rank 0) and resumed: the
  uninterrupted run's k, n, j and x.
"""

import fcntl
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpdlp
import tpdlp.shard.mesh as JM
from tpdlp.ops.band import BandOp as JBandOp
from tpdlp.ops.blocked import BlockEllOp as JBlockEllOp
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.shard import mesh as TM
from tpdlp_torch.shard import run_ranks
from torch_shard_ranks import run_cases

torch.set_num_threads(2)

SHAPES = [(2, 2), (1, 4), (4, 1)]
FIXED = dict(scaling="ruiz", adaptive=False, primal_weight_update=True,
             eta_safety=0.99)
MAIN = dict(scaling="ruiz", adaptive=True, primal_weight_update=True,
            infeasibility_detect=True)
TOL = 1e-4
PAD = {"dense": TM.padded_sizes, "band": TM.padded_sizes_band,
       "sparse": TM.padded_sizes_sparse}


def _problems(pkg):
    """The instances, from either package's generators (byte-identical):
    non-divisible sizes, so that every layout pads."""
    return {
        "feasible": pkg.generate_feasible_lp(n=53, m_ineq=29, m_eq=10,
                                             seed=11),
        "features": pkg.generate_feasible_lp(n=40, m_ineq=30, m_eq=6,
                                             seed=13),
        "banded": pkg.generate_banded_lp(n=300, m_ineq=150, m_eq=70,
                                         bandwidth=17, seed=9),
        "infeasible": pkg.generate_infeasible_lp(n=40, m_eq=10,
                                                 density=0.4, seed=0),
    }


def _padded_coo(K, m_pad, n_pad):
    coo = sp.coo_matrix(K)
    return sp.coo_matrix((coo.data, (coo.row, coo.col)), shape=(m_pad, n_pad))


def _layout_cases():
    problems = _problems(tpdlp_torch)
    out = {}
    for shape in SHAPES:
        mesh = TM.Mesh(shape)
        for fmt in ("dense", "band", "sparse"):
            p = problems["banded" if fmt == "band" else "feasible"]
            m_pad, n_pad = PAD[fmt](p.m, p.n, mesh)
            out[f"{fmt}-{shape[0]}x{shape[1]}"] = {
                "kind": "layout", "shape": shape, "format": fmt,
                "K": _padded_coo(p.K, m_pad, n_pad)}
    return out


def _b0(n_pad):
    """The JAX package's power-iteration start at the padded n (fp64)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n_pad,),
                                      dtype=jnp.float64))


#: id -> (problem, layout, shape, settings): the solve cases.
SOLVES = {
    "fixed-dense-2x2": ("feasible", "dense", (2, 2), FIXED),
    "fixed-dense-1x4": ("feasible", "dense", (1, 4), FIXED),
    "fixed-dense-4x1": ("feasible", "dense", (4, 1), FIXED),
    "fixed-sparse-2x2": ("feasible", "sparse", (2, 2), FIXED),
    "fixed-band-1x4": ("banded", "band", (1, 4), FIXED),
    "fixed-auto-4x1": ("feasible", "auto", (4, 1), FIXED),
    "main-dense-2x2": ("features", "dense", (2, 2), MAIN),
    "main-sparse-4x1": ("features", "sparse", (4, 1), MAIN),
    "main-band-2x2": ("banded", "band", (2, 2), MAIN),
    "main-infeasible-1x4": ("infeasible", "dense", (1, 4),
                            dict(MAIN, normalized_certificates=True)),
}
#: The resumed case: fixed-dense-2x2 stopped at this budget, then resumed.
RESUME_KKT = 200


def _solve_cases(ckpt_dir):
    problems = _problems(tpdlp_torch)
    out = {}
    for cid, (pname, fmt, shape, settings) in SOLVES.items():
        p = problems[pname]
        layout = "dense" if fmt == "auto" else fmt
        _, n_pad = PAD[layout](p.m, p.n, TM.Mesh(shape))
        out[cid] = {"kind": "solve", "shape": shape, "problem": p,
                    "cfg": dict(tol=TOL, **settings),
                    "solve": {"matrix_format": fmt, "dtype": torch.float64},
                    "b0": _b0(n_pad)}
    resumed = dict(out["fixed-dense-2x2"])
    resumed["solve"] = dict(resumed["solve"],
                            checkpoint_path=str(ckpt_dir / "fixed.npz"))
    resumed["resume_from"] = RESUME_KKT
    out["resumed-dense-2x2"] = resumed
    return out


def _run_ranks(ckpt_dir):
    cases = {**_layout_cases(), **_solve_cases(ckpt_dir)}
    per_rank = run_ranks(run_cases, 4, backend="gloo", device="cpu",
                         shape=(2, 2), args=(list(cases.values()),),
                         timeout=900)
    return {cid: [r[i] for r in per_rank] for i, cid in enumerate(cases)}


@pytest.fixture(scope="session")
def port_runs(tmp_path_factory, request):
    """{case id: [rank 0's result, ..., rank 3's]}, computed once per
    session (once across xdist workers)."""
    worker = getattr(request.config, "workerinput", None)
    if worker is None:
        return _run_ranks(tmp_path_factory.mktemp("ckpt"))
    shared = tmp_path_factory.getbasetemp().parent
    path = shared / "torch_shard_runs.pkl"
    with open(shared / "torch_shard_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            ckpt = shared / "torch_shard_ckpt"
            ckpt.mkdir(exist_ok=True)
            path.write_bytes(pickle.dumps(_run_ranks(ckpt)))
        return pickle.loads(path.read_bytes())


def _jax_mesh(shape):
    return tpdlp.shard.make_solver_mesh(jax.devices()[:4], shape)


def _by_device(arr, mesh):
    """The JAX array's shard on each of the mesh's devices, in rank
    order (device i of the flat mesh <-> rank i)."""
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [shards[d] for d in mesh.devices.reshape(-1)]


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cid", list(_layout_cases()))
def test_layout_shards_equal_jax(port_runs, cid):
    case = _layout_cases()[cid]
    fmt, mesh = case["format"], _jax_mesh(case["shape"])
    K = case["K"]
    if fmt == "dense":
        mat_s, _, _, _ = JM.problem_shardings(mesh)
        want = [{"mat": b, "mat_t": b.T} for b in _by_device(
            jax.device_put(K.toarray(), mat_s), mesh)]
    elif fmt == "band":
        op = JM.shard_band(JBandOp.from_scipy(K, jnp.float64, host=True),
                           mesh)
        parts = {f"{d}_{a}": _by_device(getattr(getattr(op, d), a), mesh)
                 for d in ("fwd", "bwd") for a in ("slabs", "starts")}
        want = [{k: v[i] for k, v in parts.items()} for i in range(4)]
    else:
        op = JM.shard_block_ell(
            JBlockEllOp.from_scipy(K, jnp.float64, host=True), mesh)
        parts = {f"{d}_{a}": _by_device(getattr(getattr(op, d), a), mesh)
                 for d in ("fwd", "bwd") for a in ("tiles", "col_idx")}
        want = [{k: v[i] for k, v in parts.items()} for i in range(4)]
    for rank, got in enumerate(port_runs[cid]):
        assert set(got["arrays"]) == set(want[rank])
        for k, v in want[rank].items():
            np.testing.assert_array_equal(got["arrays"][k], v,
                                          err_msg=f"{cid} rank {rank} {k}")


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4), (4, 1), (2, 4),
                                   (1, 8), (8, 1)])
def test_padded_sizes_and_vectors_equal_jax(shape):
    jmesh = tpdlp.shard.make_solver_mesh(
        jax.devices()[:shape[0] * shape[1]], shape)
    tmesh = TM.Mesh(shape)
    for m in (1, 7, 128, 129, 1000):
        for n in (1, 9, 256, 257, 3001):
            for name in ("padded_sizes", "padded_sizes_band",
                         "padded_sizes_sparse"):
                assert getattr(TM, name)(m, n, tmesh) == getattr(JM, name)(
                    m, n, jmesh), (name, m, n, shape)
    rng = np.random.default_rng(0)
    m, n = 29, 41
    m_pad, n_pad = TM.padded_sizes_sparse(m, n, tmesh)
    vecs = (rng.normal(size=n), rng.normal(size=m),
            np.where(rng.random(n) < 0.3, -np.inf, -rng.random(n)),
            np.where(rng.random(n) < 0.3, np.inf, rng.random(n)),
            np.arange(m) < 17)
    for a, b in zip(TM.pad_vectors(*vecs, m_pad, n_pad),
                    JM.pad_vectors(*vecs, m_pad, n_pad)):
        np.testing.assert_array_equal(a, b)
    K = rng.normal(size=(m, n))
    for a, b in zip(TM.pad_problem_arrays(K, *vecs, m_pad, n_pad),
                    JM.pad_problem_arrays(K, *vecs, m_pad, n_pad)):
        np.testing.assert_array_equal(a, b)


def test_mesh_without_a_process_group():
    """One process: a 1x1 mesh whose collectives are the identity; any
    other shape says how to launch."""
    mesh = TM.make_solver_mesh()
    assert mesh.shape == (1, 1) and mesh.size == 1 and mesh.group is None
    t = torch.ones(3)
    assert mesh.all_reduce(t) is t and mesh.counts["product"] == 0
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=4"):
        TM.make_solver_mesh((2, 2))
    with pytest.raises(ValueError, match="backend"):
        TM.init_distributed("mpi")
    # A device problem holds its whole operator on one device: not this
    # design's route, which builds each rank's shard on the host.
    with pytest.raises(ValueError, match=r"solve\(problem, cfg, mesh=mesh\)"):
        TM.shard_device_problem(None, mesh)


def test_rank_devices_follow_the_backend_they_are_given(monkeypatch):
    """gloo: CPU ranks, or ranks sharing the cards; NCCL: a card for each
    rank, refused where there are fewer cards than ranks or none."""
    from tpdlp_torch.shard.launch import rank_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_devices(4, "cpu", "gloo") == "cpu"
    assert rank_devices(3, "cuda:0", "gloo") == ["cuda:0", "cuda:1",
                                                 "cuda:0"]
    assert rank_devices(2, "cuda:0", "nccl") == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="4 NCCL ranks need 4 cards"):
        rank_devices(4, "cuda:0", "nccl")
    with pytest.raises(ValueError, match="NCCL needs CUDA ranks"):
        rank_devices(1, "cpu", "nccl")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        rank_devices(1, "cpu", "mpi")


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _jax_solve(cid):
    pname, fmt, shape, settings = SOLVES[cid]
    p = _problems(tpdlp)[pname]
    return tpdlp.solve(p, tpdlp.SolverConfig(tol=TOL, **settings),
                       mesh=_jax_mesh(shape), matrix_format=fmt,
                       dtype=jnp.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b)), initial=0.0))


def _same_on_every_rank(runs):
    r0 = runs[0]
    for r in runs[1:]:
        assert (r["status"], r["k"], r["n"], r["j"]) == (
            r0["status"], r0["k"], r0["n"], r0["j"])
        np.testing.assert_array_equal(r["x"], r0["x"])
        np.testing.assert_array_equal(r["y"], r0["y"])
    return r0


def _one_all_reduce_per_product(r):
    # Two products per iteration and restart check, the power
    # iteration's 2 * 100 + 1 and init_state's 2: every one reduced once.
    assert r["counts"]["product"] > 2 * r["k"]
    assert r["counts"]["norm"] > 0 and r["counts"]["broadcast"] == 0


@pytest.mark.parametrize("cid", [c for c in SOLVES if c.startswith("fixed")])
def test_fixed_steps_match_jax_and_unsharded(port_runs, monkeypatch, cid):
    rt = _same_on_every_rank(port_runs[cid])
    rj = _jax_solve(cid)
    assert rj.status == tpdlp.Status.SOLVED
    assert rt["status"] == int(rj.status)
    assert (rt["k"], rt["n"], rt["j"]) == (rj.iterations, rj.restarts,
                                           rj.kkt_passes)
    assert rt["x"].shape == (rj.x.shape[0],) and len(rt["y"]) == len(rj.y)
    assert _rel(rt["x"], rj.x) <= 1e-9 and _rel(rt["y"], rj.y) <= 1e-9
    assert _rel(rt["objective"], rj.objective) <= 1e-9
    _one_all_reduce_per_product(rt)

    pname, fmt, shape, settings = SOLVES[cid]
    p = _problems(tpdlp_torch)[pname]
    layout = "dense" if fmt == "auto" else fmt
    b0 = _b0(PAD[layout](p.m, p.n, TM.Mesh(shape))[1])
    monkeypatch.setattr(PI, "initial_vector",
                        lambda n, seed, dtype, device: torch.as_tensor(
                            b0[:n], dtype=dtype, device=device))
    single = tpdlp_torch.solve(
        p, tpdlp_torch.SolverConfig(tol=TOL, **settings), device="cpu",
        dtype=torch.float64)
    assert (rt["k"], rt["n"], rt["j"]) == (single.iterations,
                                           single.restarts,
                                           single.kkt_passes)
    assert _rel(rt["x"], single.x) <= 1e-9
    assert _rel(rt["y"], single.y) <= 1e-9


@pytest.mark.parametrize("cid", [c for c in SOLVES if c.startswith("main")])
def test_adaptive_with_certificates_matches_jax(port_runs, cid):
    rt = _same_on_every_rank(port_runs[cid])
    rj = _jax_solve(cid)
    assert rt["status"] == int(rj.status)
    if rj.status == tpdlp.Status.SOLVED:
        assert abs(rt["objective"] - rj.objective) <= 5 * TOL * (
            1 + abs(rj.objective))
    else:
        assert "infeasible" in cid
        assert rj.status == tpdlp.Status.PRIMAL_INFEASIBLE


def test_checkpoint_under_a_mesh_resumes_to_the_same_run(port_runs):
    """Rank 0 writes the checkpoint at a budget; every rank resumes from
    rank 0's state: the uninterrupted run's counters and point."""
    full = _same_on_every_rank(port_runs["fixed-dense-2x2"])
    resumed = _same_on_every_rank(port_runs["resumed-dense-2x2"])
    assert resumed["k"] > 0 and full["j"] > RESUME_KKT
    assert (resumed["status"], resumed["k"], resumed["n"], resumed["j"]) == (
        full["status"], full["k"], full["n"], full["j"])
    assert _rel(resumed["x"], full["x"]) <= 1e-12
    assert resumed["counts"]["broadcast"] > 0


def test_refinement_forwards_the_mesh(monkeypatch):
    """dtype=None below escalation_tol, with fp32 as the default dtype (as
    on CUDA), routes to iterative refinement, whose inner solves all run
    on the mesh the solve was given; on a 1x1 mesh the result is the
    unsharded refinement's."""
    import importlib

    S = importlib.import_module("tpdlp_torch.solver.solve")
    monkeypatch.setattr(S, "default_dtype", lambda device: torch.float32)
    p = _problems(tpdlp_torch)["features"]
    cfg = tpdlp_torch.SolverConfig(tol=1e-8, **FIXED)
    plain = tpdlp_torch.solve(p, cfg, device="cpu")
    meshes = []
    real = S.solve

    def spy(*a, **kw):
        meshes.append(kw.get("mesh"))
        return real(*a, **kw)

    monkeypatch.setattr(S, "solve", spy)
    mesh = TM.make_solver_mesh()
    r = tpdlp_torch.solve(p, cfg, device="cpu", mesh=mesh)
    assert r.escalation["route"] == plain.escalation["route"] == "refine"
    assert len(meshes) == len(r.escalation["stages"]) >= 1
    assert all(m is mesh for m in meshes)
    assert r.status == plain.status == tpdlp_torch.Status.SOLVED
    assert (r.iterations, r.kkt_passes) == (plain.iterations,
                                            plain.kkt_passes)
    assert abs(r.objective - plain.objective) <= 1e-8 * (
        1 + abs(plain.objective))
