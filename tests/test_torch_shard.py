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
- Vectors: after `prepare`, each rank's slice of every state field and
  problem vector equals the JAX `shard_state` / `shard_device_problem`
  shard on the matching device, and after a chunk of fixed steps the JAX
  state's values at the rank's span; every scalar holds the same bits on
  every rank, in 2D the x slice on a column's ranks and the y slice on a
  row's; each rank holds x/C + y/R bytes of vectors (2D) or the whole / N
  (flat); the collectives by purpose follow the formula of
  `_expected_counts`.
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
import importlib
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
from tpdlp.ops.dense import DenseOp as JDenseOp
from tpdlp.solver.loop import run_chunk as jax_run_chunk
import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.ops.exact_dense import ExactDenseOp
from tpdlp_torch.scaling.ruiz import ruiz_equilibrate
from tpdlp_torch.shard import mesh as TM
from tpdlp_torch.shard import run_ranks
from torch_shard_ranks import run_cases

torch.set_num_threads(2)

#: tpdlp.solver.solve, the module (the package exports the function).
JS = importlib.import_module("tpdlp.solver.solve")

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


#: The placed cases: prepare, then a chunk of this many KKT passes (0:
#: prepare alone) of fixed steps, on every layout and mesh.
PLACED_BUDGETS = (0, 120)


def _placed_id(fmt, shape, budget):
    return f"placed-{fmt}-{shape[0]}x{shape[1]}-{budget}"


def _placed_case(fmt):
    return "banded" if fmt == "band" else "feasible"


def _placed_cases():
    problems = _problems(tpdlp_torch)
    out = {}
    for shape in SHAPES:
        for fmt in ("dense", "band", "sparse"):
            p = problems[_placed_case(fmt)]
            _, n_pad = PAD[fmt](p.m, p.n, TM.Mesh(shape))
            for budget in PLACED_BUDGETS:
                out[_placed_id(fmt, shape, budget)] = {
                    "kind": "placed", "shape": shape, "problem": p,
                    "format": fmt, "cfg": dict(tol=TOL, **FIXED),
                    "budget": budget, "b0": _b0(n_pad)}
    return out


def _run_ranks(ckpt_dir):
    cases = {**_layout_cases(), **_placed_cases(),
             **_solve_cases(ckpt_dir)}
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
# Vectors: the JAX placement on every rank
# ---------------------------------------------------------------------------

_PLACED = [(fmt, shape) for shape in SHAPES
           for fmt in ("dense", "band", "sparse")]


def _jax_placed(fmt, shape, budget):
    """The JAX package's sharded (pb, state) of the placed case: its
    solve's mesh branch (padding, the layout's sharded operator, the
    vectors placed), `_prepare`, `shard_device_problem` and `shard_state`,
    then `run_chunk` to `budget` KKT passes."""
    p = _problems(tpdlp)[_placed_case(fmt)]
    mesh = _jax_mesh(shape)
    m_pad, n_pad = PAD[fmt](p.m, p.n, TM.Mesh(shape))
    K = _padded_coo(p.K, m_pad, n_pad)
    if fmt == "dense":
        mat_s, yvec_s, xvec_s, _ = JM.problem_shardings(mesh)
        op = JDenseOp(jax.device_put(K.toarray(), mat_s))
    else:
        _, yvec_s, _ = JM.flat_shardings(mesh)
        xvec_s = yvec_s
        op = (JM.shard_band(JBandOp.from_scipy(K, jnp.float64, host=True),
                            mesh) if fmt == "band" else
              JM.shard_block_ell(JBlockEllOp.from_scipy(K, jnp.float64,
                                                        host=True), mesh))
    c, q, l, u, mask = JM.pad_vectors(p.c, p.q, p.l, p.u,
                                      np.arange(p.m) < p.m_ineq, m_pad,
                                      n_pad)
    put = jax.device_put
    cfg = tpdlp.SolverConfig(tol=TOL, **FIXED)
    pb, st = JS._prepare(op, put(c, xvec_s), put(q, yvec_s),
                         put(l, xvec_s), put(u, xvec_s), jnp.asarray(mask),
                         jax.random.PRNGKey(0), jnp.asarray(np.nan), cfg)
    pb = JM.shard_device_problem(pb, mesh)
    st = JM.shard_state(st, mesh, layout="2d" if fmt == "dense" else "flat")
    if budget:
        st = jax_run_chunk(st, pb, jnp.int32(budget), cfg, aligned=True)
    arrays = {f"st.{k}": v for k, v in vars(st).items()}
    arrays.update({f"pb.{k}": v for k, v in vars(pb).items() if k != "op"})
    return mesh, arrays


def _same(got, want, what, rel=1e-12):
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got.shape == want.shape, what
        assert _rel(got, want) <= rel, (what, _rel(got, want))


@pytest.mark.parametrize("fmt,shape", _PLACED)
def test_prepared_slices_equal_jax_shards(port_runs, fmt, shape):
    """After `prepare`, each rank's slice of every state field and problem
    vector is the JAX shard on the matching device (fp64; floats to
    1e-12, the power iteration's and ||c||/||q||'s sums differ in order
    only)."""
    mesh, want = _jax_placed(fmt, shape, 0)
    runs = port_runs[_placed_id(fmt, shape, 0)]
    for name, arr in want.items():
        shards = _by_device(arr, mesh)
        for rank, r in enumerate(runs):
            _same(r["arrays"][name], shards[rank],
                  f"{fmt} {shape} rank {rank} {name}")


@pytest.mark.parametrize("fmt,shape", _PLACED)
def test_slices_after_a_chunk_equal_jax(port_runs, fmt, shape):
    """After a chunk of 120 KKT passes of fixed steps (three restart
    checks), each rank's slices are the JAX sharded state's values at the
    rank's spans: counters exactly, floats to 1e-9."""
    budget = PLACED_BUDGETS[1]
    _, want = _jax_placed(fmt, shape, budget)
    for rank, r in enumerate(port_runs[_placed_id(fmt, shape, budget)]):
        (x0, x1), (y0, y1) = r["spans"]
        assert r["issued"]["restart_checks"] >= 3
        for name, arr in want.items():
            whole = np.asarray(arr)
            if whole.ndim:
                n_x = len(np.asarray(want["st.x"]))
                whole = whole[x0:x1] if len(whole) == n_x else whole[y0:y1]
            _same(r["arrays"][name], whole,
                  f"{fmt} {shape} rank {rank} {name}", rel=1e-9)


@pytest.mark.parametrize("fmt,shape", _PLACED)
@pytest.mark.parametrize("budget", PLACED_BUDGETS)
def test_replicas_hold_the_same_bits(port_runs, fmt, shape, budget):
    """Every scalar of the state holds the same bits on every rank; in 2D
    the R ranks of a column hold the same x slice bits and the C ranks of
    a row the same y slice bits."""
    runs = port_runs[_placed_id(fmt, shape, budget)]
    R, C = shape
    for name, v in runs[0]["arrays"].items():
        if v.ndim == 0:
            for r in runs[1:]:
                assert r["arrays"][name].tobytes() == v.tobytes(), name
    if fmt != "dense":
        return
    for rank, r in enumerate(runs):
        same_col = runs[rank % C]  # row 0 of this rank's column
        same_row = runs[(rank // C) * C]  # column 0 of this rank's row
        for name, v in r["arrays"].items():
            if v.ndim == 0:
                continue
            twin = same_col if len(v) == len(r["arrays"]["st.x"]) else (
                same_row)
            assert v.tobytes() == twin["arrays"][name].tobytes(), (rank,
                                                                 name)


@pytest.mark.parametrize("fmt,shape", _PLACED)
@pytest.mark.parametrize("budget", PLACED_BUDGETS)
def test_each_rank_holds_its_share_of_the_vectors(port_runs, fmt, shape,
                                                  budget):
    """Vector bytes on a rank (each tensor once, however many fields hold
    it): x/C + y/R in 2D, the whole / N in flat, where x and y are the
    bytes the same vectors take whole."""
    R, C = shape
    parts = (C, R) if fmt == "dense" else (R * C, R * C)
    for r in port_runs[_placed_id(fmt, shape, budget)]:
        b = r["bytes"]
        assert (b["x_parts"], b["y_parts"]) == parts
        assert b["x"] * parts[0] == b["x_whole"] > 0
        assert b["y"] * parts[1] == b["y_whole"] > 0


@pytest.mark.parametrize("fmt,shape", _PLACED)
def test_collectives_follow_the_formula(port_runs, monkeypatch, fmt, shape):
    """Prepare and a chunk: the collectives by purpose on every rank are
    `_expected_counts`'s."""
    budget = PLACED_BUDGETS[1]
    passes = _ruiz_passes(_placed_case(fmt), fmt, shape, monkeypatch)
    for r in port_runs[_placed_id(fmt, shape, budget)]:
        want = _expected_counts(r, FIXED, passes, extract=False)
        assert {k: r["counts"][k] for k in want} == want


@pytest.mark.parametrize("cid", [c for c in SOLVES
                                 if not c.startswith("resumed")])
def test_solve_collectives_follow_the_formula(port_runs, monkeypatch, cid):
    """Whole solves, blocked and per-iteration with certificates: the
    collectives by purpose are `_expected_counts`'s on every rank, with
    one scalar check a chunk and one agreement before each chunk but the
    first, plus the resume's and the first budget check's."""
    pname, fmt, shape, settings = SOLVES[cid]
    layout = "dense" if fmt == "auto" else fmt
    passes = _ruiz_passes(pname, layout, shape, monkeypatch)
    for r in port_runs[cid]:
        solved_at_check = r["status"] != int(tpdlp.Status.KKT_LIMIT)
        want = _expected_counts(r, settings, passes, solved_at_check)
        assert {k: r["counts"][k] for k in want} == want
        assert r["counts"]["clock"] == r["counts"]["check"] + 1 >= 2


@pytest.mark.parametrize("cid", list(SOLVES) + ["resumed-dense-2x2"])
def test_solves_hold_their_share_of_the_vectors(port_runs, cid):
    """At the end of every sharded solve (resumed, certified and infeasible
    ones included) each rank holds its slices only: x/C + y/R bytes of
    vectors in 2D, the whole / N in flat."""
    for r in port_runs[cid]:
        held = r["held"]
        assert held["x_parts"] * held["y_parts"] > 1
        assert held["x"] * held["x_parts"] == held["x_whole"] > 0
        assert held["y"] * held["y_parts"] == held["y_whole"] > 0


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


def _ruiz_passes(pname, fmt, shape, monkeypatch):
    """The Ruiz passes of the problem's padded K: the unsharded pass count
    (inf-norms and diagonal products are exact, so every layout and mesh
    stops at the same pass)."""
    p = _problems(tpdlp_torch)[pname]
    m_pad, n_pad = PAD[fmt](p.m, p.n, TM.Mesh(shape))
    calls = []
    real = ExactDenseOp.row_abs_norms
    monkeypatch.setattr(ExactDenseOp, "row_abs_norms",
                        lambda self, ord: calls.append(ord) or real(self,
                                                                    ord))
    op = ExactDenseOp.build(torch.as_tensor(
        _padded_coo(p.K, m_pad, n_pad).toarray()))
    ruiz_equilibrate(op, 20, 1e-6)
    monkeypatch.undo()
    return len(calls)


def _expected_counts(r, cfg, passes, solved_at_check=True, extract=True):
    """The collectives a rank issues, by purpose, for a fresh solve or a
    prepare-and-chunk (`extract` False) that neither times out, warm
    starts nor resumes:
    - product: one per product, 2 per issued iteration and restart check
      plus the power iteration's 2 * power_iters + 1 and init_state's 2;
    - norm: 3 per Ruiz pass (2D: the row and column norms over the
      subgroups and the stop test; flat: two gathers of the factors and
      the stop test);
    - reduce: 2 per restart check (the candidates' residuals, then the new
      weight with the termination test), 2 per issued iteration with
      certificates (the rays' norms, then their tests), power_iters + 1
      for the power iteration, 1 for ||c||, ||q||, 1 for the termination
      norms, 1 for the objective, 1 for `final_eval` when the budget ran
      out;
    - gather: 1, the result; broadcast: 0."""
    it, checks = r["issued"]["iterations"], r["issued"]["restart_checks"]
    certify = cfg.get("infeasibility_detect") or cfg.get(
        "normalized_certificates")
    reduce = (2 * checks + 100 + 1 + 2 + (2 * it if certify else 0)
              + (1 if extract else 0) + (0 if solved_at_check else 1))
    return {"product": 2 * (it + checks) + 2 * 100 + 3, "norm": 3 * passes,
            "reduce": reduce, "gather": 1 if extract else 0,
            "broadcast": 0}


def _one_collective_per_product(r):
    # Two products per issued iteration and restart check, the power
    # iteration's 2 * 100 + 1 and init_state's 2: every one reduced or
    # gathered once, and each a kernel launch where the layout has one.
    products = 2 * (r["issued"]["iterations"]
                    + r["issued"]["restart_checks"]) + 203
    assert r["counts"]["product"] == products
    assert set(v for k, v in r["launches"].items() if v) <= {products}
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
    _one_collective_per_product(rt)

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
