"""Sharded solves over torch.distributed (counterpart of tpdlp/shard/mesh.py).

The JAX package places arrays on a ("row", "col") device mesh and lets
GSPMD insert the collectives.  Torch has no such compiler, so the port does
the communication by hand, inside the operators, and keeps the JAX
package's operator layouts and padded sizes exactly:

- dense: a 2D block partition over ("row", "col"); rank (r, c) holds
  K[r-th row block, c-th column block] (`padded_sizes`);
- band: flat 1D strips of 128-row groups over all ranks
  (`padded_sizes_band`);
- block-ELL ("sparse"): flat 1D strips of 8-row strips over all ranks
  (`padded_sizes_sparse`).

Every vector is replicated: each rank holds the whole (padded) x, y and
state.  A product runs the layout's kernel on the rank's shard, writes the
partial into a zero-filled buffer of full length and sums that buffer over
the group with ONE `all_reduce` (tpdlp_torch/shard/ops.py).  In 2D a row
block sums its C partials; in a flat layout every entry has exactly one
nonzero contribution, so the sum is an exact all-gather.  Every norm, dot
and host read of the solver then sees the same bits on every rank, and all
ranks take the same restart and termination decisions: the solver body
(solver/loop.py, step.py, residuals.py, infeasibility.py, reduce.py) is
the single-device one, as in the JAX package.  What this costs: the
vector work is not divided among the ranks.  The host's wall clock is the
one thing that differs between ranks, so a time-limit decision is agreed
on by a MAX over the group (`Mesh.agree`).

Padding keeps the maths exact: padded K rows and columns are zero; padded
q entries are 0 and marked as inequalities (their residual min(0, 0)
vanishes); padded variables are fixed at l = u = 0 (`pad_vectors`).  The
solve cuts its results back to (n,) and (m,).

The collectives are `all_reduce` and `broadcast` only, which gloo runs on
CPU and CUDA tensors and NCCL on CUDA tensors.  The backend is the
caller's explicit choice (`init_distributed`): "nccl" when each rank owns
a GPU, "gloo" for CPU ranks (or for several ranks that share one card,
with gloo staging the CUDA tensors through the host).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

#: The backends `init_distributed` takes.
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class Mesh:
    """A ("row", "col") mesh of R x C ranks.

    `group` is the process group the ranks share (None: one process and no
    process group, where every collective is the identity).  This rank sits
    at (`row`, `col`) = divmod(rank, C).  Every collective runs over the
    whole group: a product reduces a full-length vector, so no row or
    column subgroup is needed.  `counts` counts the
    collectives this rank issued, by purpose ("product": one per operator
    product, "norm": the scaling's row and column norms, "clock": a
    time-limit agreement, "broadcast")."""

    shape: tuple
    rank: int = 0
    group: Optional[object] = None
    counts: dict = dataclasses.field(default_factory=lambda: {
        "product": 0, "norm": 0, "clock": 0, "broadcast": 0})

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def row(self) -> int:
        return self.rank // self.shape[1]

    @property
    def col(self) -> int:
        return self.rank % self.shape[1]

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   kind: str = "product") -> torch.Tensor:
        """Sum (op="sum") or maximum (op="max") of `t` over the group, in
        place; returns `t`."""
        if self.group is not None:
            import torch.distributed as dist

            red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
            dist.all_reduce(t, op=red, group=self.group)
            self.counts[kind] += 1
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank, in place; returns `t`."""
        if self.group is not None:
            import torch.distributed as dist

            dist.broadcast(t, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
            self.counts["broadcast"] += 1
        return t

    def agree(self, flag: bool, device) -> bool:
        """True on every rank when `flag` holds on any rank."""
        if self.group is None:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        return bool(self.all_reduce(t, "max", "clock").item() > 0)


def default_shape(n: int) -> tuple:
    """As square as possible (balances the two products' traffic)."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return (r, n // r)


def launch_hint(shape) -> str:
    r, c = shape
    return (f"a {r}x{c} mesh needs {r * c} processes: launch with "
            f"`torchrun --nproc_per_node={r * c} -m tpdlp_torch.cli.main "
            f"--mesh {r}x{c} ...`, or call init_distributed(backend, "
            f"init_method=..., world_size={r * c}, rank=...) in each")


def make_solver_mesh(shape=None, group=None) -> Mesh:
    """A ("row", "col") mesh over the ranks of `group` (default: every
    process of the initialised process group; with none, the one calling
    process, a 1x1 mesh).

    Default shape: as square as possible."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        shape = (1, 1) if shape is None else tuple(shape)
        if shape != (1, 1):
            raise ValueError(
                "make_solver_mesh: no process group is initialised; "
                + launch_hint(shape))
        return Mesh(shape)
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    shape = default_shape(world) if shape is None else tuple(shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"make_solver_mesh: shape {shape} does not hold "
                         f"the group's {world} ranks; " + launch_hint(shape))
    return Mesh(shape, dist.get_rank(group), group)


def init_distributed(backend: str, shape=None, **kwargs) -> Mesh:
    """Join the process group and return the solver mesh over all of it.

    `backend`: "nccl" when each rank owns a GPU (set its device first, or
    pass `device_id`), "gloo" for CPU ranks or ranks that share a card.
    `kwargs` go to `torch.distributed.init_process_group`
    (init_method="tcp://localhost:<port>", world_size, rank, timeout; with
    none, the environment torchrun sets)."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"init_distributed: backend {backend!r}, "
                         f"expected one of {BACKENDS}")
    dist.init_process_group(backend=backend, **kwargs)
    return make_solver_mesh(shape)


def clock_spent(elapsed: float, limit: float, mesh, device) -> bool:
    """Have `elapsed` seconds reached `limit`?  Under a mesh, agreed by
    every rank (true when it holds on any), so that all of them stop at
    the same chunk."""
    spent = elapsed >= limit
    return spent if mesh is None else mesh.agree(spent, device)


# ---------------------------------------------------------------------------
# Padded sizes and padding (numpy; copies of the JAX module's helpers)
# ---------------------------------------------------------------------------


def _pad_to(v, size, fill=0.0):
    pad = size - v.shape[0]
    if pad == 0:
        return v
    return np.concatenate([np.asarray(v), np.full((pad,), fill, v.dtype)])


def padded_sizes(m: int, n: int, mesh: Mesh) -> tuple[int, int]:
    """Row/col sizes padded to mesh-divisible multiples (the dense 2D
    layout)."""
    r, c = mesh.shape
    return (-(-m // r)) * r, (-(-n // c)) * c


def padded_sizes_sparse(m: int, n: int, mesh: Mesh) -> tuple[int, int]:
    """Padded sizes for the sharded block-ELL layout: both dimensions pad
    to a multiple of L = lcm(128, 8 * lcm(8, N)), so the 8-row strip count
    of K and of K' divides the rank count N and 8, and each dimension is a
    whole number of 128-column blocks."""
    N = mesh.size
    L = math.lcm(128, 8 * math.lcm(8, N))
    return (-(-m // L)) * L, (-(-n // L)) * L


def padded_sizes_band(m: int, n: int, mesh: Mesh) -> tuple[int, int]:
    """Padded sizes for the sharded band layout: multiples of
    128 * lcm(8, N), so each direction's 128-row group count divides the
    rank count N (and the layout's group padding to 8)."""
    N = mesh.size
    L = 128 * math.lcm(8, N)
    return (-(-m // L)) * L, (-(-n // L)) * L


def pad_vectors(c, q, l, u, ineq_mask, m_pad: int, n_pad: int):
    """Exactness-preserving zero-padding of the problem vectors: q zero;
    padded rows marked as inequalities (their residual min(0, 0) vanishes);
    padded variables fixed at 0 (l = u = 0)."""
    c_p = _pad_to(c, n_pad)
    q_p = _pad_to(q, m_pad)
    l_p = _pad_to(l, n_pad)
    u_p = _pad_to(u, n_pad)
    mask_p = np.concatenate(
        [np.asarray(ineq_mask), np.ones(m_pad - len(q), dtype=bool)]
    )
    return c_p, q_p, l_p, u_p, mask_p


def pad_problem_arrays(K, c, q, l, u, ineq_mask, m_pad: int, n_pad: int):
    """pad_vectors plus the zero-padded dense K."""
    m, n = K.shape
    K_p = np.zeros((m_pad, n_pad), dtype=K.dtype)
    K_p[:m, :n] = K
    c_p, q_p, l_p, u_p, mask_p = pad_vectors(
        c, q, l, u, ineq_mask, m_pad, n_pad
    )
    return K_p, c_p, q_p, l_p, u_p, mask_p


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def shard_device_problem(pb, mesh: Mesh):
    """Not this design's route: a DeviceProblem already holds its whole
    operator on one device, and no device may stage the whole operator.
    Each rank builds its own shard on the host instead: `solve(problem,
    cfg, mesh=mesh)`, or `solver.solve.prepare(problem, cfg, mesh=mesh)`
    for the (DeviceProblem, state) pair.  Raises ValueError saying so."""
    raise ValueError(
        "shard_device_problem: under a mesh each rank builds its shard on "
        "the host from the LPProblem; call solve(problem, cfg, mesh=mesh) "
        "or tpdlp_torch.solver.solve.prepare(problem, cfg, mesh=mesh)")


def shard_state(st, mesh: Mesh):
    """The replicated placement of a PDHGState: rank 0's state on every
    rank, field by field (a state resumed from a checkpoint or carried in
    from elsewhere then holds the same bits on every rank).  The other
    ranks' `st` gives only the shapes and dtypes: each field arrives in a
    fresh buffer, since fields of a state may share storage."""
    return dataclasses.replace(st, **{
        f.name: mesh.broadcast(v if mesh.rank == 0 else torch.empty_like(v))
        for f in dataclasses.fields(st)
        for v in (getattr(st, f.name),)})
