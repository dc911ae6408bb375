"""The rank side of tests/test_torch_shard.py: what each gloo rank runs.

This module imports the port and never JAX (the ranks are spawned
processes that import it by name).  `run_cases` takes a list of cases and
returns one result per case; the test process compares them with the JAX
package's sharded solves on its virtual CPU mesh.
"""

from __future__ import annotations

import dataclasses

import torch

import tpdlp_torch
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch.ops import _kernels
from tpdlp_torch.shard import make_solver_mesh
from tpdlp_torch.shard.mesh import PROBLEM_X, PROBLEM_Y, vector_bytes
from tpdlp_torch.shard.ops import band_shard, dense_shard, ell_shard
from tpdlp_torch.solver import loop as L
from tpdlp_torch.solver.solve import prepare


def _arrays(op) -> dict:
    """This rank's shard as numpy arrays, by the JAX layout's names."""
    if hasattr(op, "local"):  # ShardedDenseOp
        return {"mat": op.local.mat.numpy(),
                "mat_t": op.local.bwd[:, :op.local.m].numpy()}
    if hasattr(op.fwd, "slabs"):
        return {"fwd_slabs": op.fwd.slabs.numpy(),
                "fwd_starts": op.fwd.starts.numpy(),
                "bwd_slabs": op.bwd.slabs.numpy(),
                "bwd_starts": op.bwd.starts.numpy()}
    return {"fwd_tiles": op.fwd.tiles.numpy(),
            "fwd_col_idx": op.fwd.col_idx.numpy(),
            "bwd_tiles": op.bwd.tiles.numpy(),
            "bwd_col_idx": op.bwd.col_idx.numpy()}


_BUILD = {"dense": dense_shard, "band": band_shard, "sparse": ell_shard}


def _layout(mesh, case):
    return {"arrays": _arrays(_BUILD[case["format"]](
        case["K"], mesh, torch.float64, "cpu"))}


def _with_b0(fn):
    """fn(mesh, device, case) with the power iteration's start replaced by
    the JAX package's (case["b0"], drawn at the padded n), where given."""
    def run(mesh, device, case):
        b0 = case.get("b0")
        saved = PI.initial_vector
        if b0 is not None:
            PI.initial_vector = lambda n, seed, dtype, device: (
                torch.as_tensor(b0[:n], dtype=dtype, device=device))
        try:
            return fn(mesh, device, case)
        finally:
            PI.initial_vector = saved
    return run


@_with_b0
def _placed(mesh, device, case):
    """`prepare` and a chunk of `case["budget"]` KKT passes: this rank's
    slices of every state field and problem vector, its vector bytes and
    the collectives by purpose."""
    cfg = tpdlp_torch.SolverConfig(**case["cfg"])
    mesh.reset_counts()
    L.reset_launched()
    pb, st = prepare(case["problem"], cfg, dtype=torch.float64,
                     device=device, mesh=mesh,
                     matrix_format=case["format"])
    st = L.run_chunk(st, pb, case["budget"], cfg, aligned=True)
    arrays = {f"st.{f.name}": getattr(st, f.name).numpy()
              for f in dataclasses.fields(st)}
    arrays.update({f"pb.{name}": getattr(pb, name).numpy()
                   for name in PROBLEM_X + PROBLEM_Y
                   + ("q_norm_term", "c_norm_term")})
    return {"arrays": arrays, "bytes": vector_bytes(pb.op.pl, st, pb),
            "counts": dict(mesh.counts), "issued": dict(L.launched),
            "spans": (pb.op.pl.x_span, pb.op.pl.y_span)}


@_with_b0
def _solve(mesh, device, case):
    """A whole solve (after a stopped and checkpointed one, for a resumed
    case): its result, collectives, kernel launches and issued work."""
    cfg = tpdlp_torch.SolverConfig(**case["cfg"])
    kw = dict(case.get("solve", {}))
    if "resume_from" in case:
        # Stop at a budget with a checkpoint, then resume from it.
        part = cfg.replace(max_kkt=case["resume_from"])
        tpdlp_torch.solve(case["problem"], part, device=device,
                          mesh=mesh, **kw)
        kw["resume"] = True
    mesh.reset_counts()
    _kernels.reset_launches()
    L.reset_launched()
    r = tpdlp_torch.solve(case["problem"], cfg, device=device,
                          mesh=mesh, **kw)
    return {"status": int(r.status), "k": r.iterations, "n": r.restarts,
            "j": r.kkt_passes, "x": r.x, "y": r.y, "objective": r.objective,
            "primal_res": r.primal_res, "dual_res": r.dual_res,
            "gap": r.gap, "counts": dict(mesh.counts),
            "launches": dict(_kernels.launches),
            "issued": dict(L.launched), "held": dict(mesh.held)}


def run_cases(world_mesh, device, cases):
    """Each case on the mesh of its shape (made once, over all ranks)."""
    meshes = {tuple(world_mesh.shape): world_mesh}
    out = []
    for case in cases:
        shape = tuple(case["shape"])
        if shape not in meshes:
            meshes[shape] = make_solver_mesh(shape)
        mesh = meshes[shape]
        run = {"layout": _layout, "placed": _placed,
               "solve": _solve}[case["kind"]]
        out.append(run(mesh, case) if case["kind"] == "layout"
                   else run(mesh, device, case))
    return out
