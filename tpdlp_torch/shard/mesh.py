"""Sharded solves over torch.distributed (counterpart of tpdlp/shard/mesh.py).

The JAX package places arrays on a ("row", "col") device mesh and lets
GSPMD insert the collectives.  Torch has no such compiler, so the port does
the communication by hand, inside the operators and the reductions, and
keeps the JAX package's operator layouts, padded sizes and vector
placements exactly:

- dense: a 2D block partition over ("row", "col"); rank (r, c) holds
  K[r-th row block, c-th column block] (`padded_sizes`), the c-th slice of
  every x-space vector (n/C entries, the same on the R ranks of column c:
  the JAX P("col")) and the r-th slice of every y-space vector (m/R
  entries, the same on the C ranks of row r: P("row"));
- band: flat 1D strips of 128-row groups over all ranks
  (`padded_sizes_band`); rank i holds the y strip its K strip produces and
  the x strip its K' strip produces (P(("row", "col")) for both spaces);
- block-ELL ("sparse"): flat 1D strips of 8-row strips over all ranks
  (`padded_sizes_sparse`), vectors as for band.

`Placement` says which slice of each space this rank holds; scalars are
replicated.  A product takes this rank's slice and returns this rank's
slice with ONE collective (tpdlp_torch/shard/ops.py): in 2D the block's
partial K x_c is summed over row r's C ranks (K'y_r over column c's R
ranks) by an `all_reduce` over the row (column) subgroup; in a flat layout
the gathered side is `all_gather`ed from every rank's strip and the strip's
product is local.  A reduction over a space (`Placement.reduce`, reached
through `solver/reduce.py::reduce` with the operator's `red`) computes
this rank's partials, all_gathers them over the whole group and reduces,
in rank order, the partials of one replica of each slice (row 0's ranks
for x, column 0's for y in 2D; every rank in flat), so that every rank
reads the same bits and takes the same restart and termination decisions.
Several reductions that need no result of one another share one
collective, and the step's dots ride on the products' collectives
(solver/step.py).  The host's wall clock is the one thing that differs
between ranks, so a time-limit decision is agreed on by a MAX over the
group (`Mesh.agree`); after every chunk `check_replicated` holds every
scalar of the state to the same bits on every rank and raises where they
differ, before a diverged decision could leave the ranks issuing different
collectives.  A full-length vector exists on a rank's device only as the
gathered side of a flat product (or of a flat strip's scaling factors), in
the solve's result and in a checkpoint write (`gather_state`); a resume
cuts rank 0's state into each rank's slices (`shard_state`).

Padding keeps the maths exact: padded K rows and columns are zero; padded
q entries are 0 and marked as inequalities (their residual min(0, 0)
vanishes); padded variables are fixed at l = u = 0 (`pad_vectors`).  The
solve cuts its results back to (n,) and (m,).

The collectives are `all_reduce`, `all_gather` and `broadcast`, which gloo
runs on CPU and CUDA tensors and NCCL on CUDA tensors; every rank creates
the mesh's row and column subgroups (`dist.new_group`) in one fixed order.
The backend is the caller's explicit choice (`init_distributed`): "nccl"
when each rank owns a GPU, "gloo" for CPU ranks (or for several ranks that
share one card, with gloo staging the CUDA tensors through the host).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

#: The backends `init_distributed` takes.
BACKENDS = ("nccl", "gloo")


#: The purposes `Mesh.counts` counts collectives by: "product" (one per
#: operator product), "norm" (the scaling's row and column norms and a flat
#: layout's gathered scaling factors), "reduce" (the solver's dots, norms
#: and tests over a space), "gather" (full vectors for the result or a
#: checkpoint), "clock" (a time-limit agreement), "check" (the scalars'
#: agreement after a chunk) and "broadcast".
KINDS = ("product", "norm", "reduce", "gather", "clock", "check",
         "broadcast")


@dataclasses.dataclass
class Mesh:
    """A ("row", "col") mesh of R x C ranks.

    `group` is the process group the ranks share (None: one process and no
    process group, where every collective is the identity).  This rank sits
    at (`row`, `col`) = divmod(rank, C); `row_group` holds the C ranks of
    its row and `col_group` the R ranks of its column (both None without a
    process group).  `counts` counts the collectives this rank issued, by
    purpose (`KINDS`); `held` is the last sharded solve's `vector_bytes`
    on this rank, taken of its final state and problem."""

    shape: tuple
    rank: int = 0
    group: Optional[object] = None
    row_group: Optional[object] = None
    col_group: Optional[object] = None
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    held: dict = dataclasses.field(default_factory=dict)

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

    def _group(self, over: str):
        return {"all": self.group, "row": self.row_group,
                "col": self.col_group}[over]

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   kind: str = "product", over: str = "all") -> torch.Tensor:
        """Sum (op="sum") or maximum (op="max") of `t` over the whole group
        (over="all"), this rank's row ("row") or its column ("col"), in
        place; returns `t`."""
        if self.group is not None:
            import torch.distributed as dist

            red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
            dist.all_reduce(t, op=red, group=self._group(over))
            self.counts[kind] += 1
        return t

    def all_gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """(N, *t.shape): every rank's `t`, in rank order, over the whole
        group (t[None] without a process group)."""
        if self.group is None:
            return t[None]
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        self.counts[kind] += 1
        return torch.stack(parts)

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
    R, C = shape
    ranks = [dist.get_global_rank(group, i) for i in range(world)]
    # Every process of the job creates every subgroup, in one order (rows,
    # then columns), as `new_group` requires.
    rows = [dist.new_group([ranks[r * C + c] for c in range(C)])
            for r in range(R)]
    cols = [dist.new_group([ranks[r * C + c] for r in range(R)])
            for c in range(C)]
    rank = dist.get_rank(group)
    return Mesh(shape, rank, group, rows[rank // C], cols[rank % C])


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
# Placement (counterparts of problem_shardings, flat_shardings, _X_FIELDS,
# _Y_FIELDS and shard_state)
# ---------------------------------------------------------------------------

#: State fields in x-space (length n, on "col" in 2D) and y-space (length
#: m, on "row"); every other field is a replicated scalar.  The JAX
#: package's sets.
_X_FIELDS = frozenset({
    "x", "kty", "x_prev", "kty_prev", "lam_prev", "x_norm_prev",
    "x_plain_sum", "kty_plain_sum", "x_sum", "x_restart", "kty_restart",
})
_Y_FIELDS = frozenset({
    "y", "kx", "y_prev", "kx_prev", "y_norm_prev", "y_plain_sum",
    "kx_plain_sum", "y_sum", "y_restart", "kx_restart",
})
#: DeviceProblem vectors by space (problem.py), for accounting.
PROBLEM_X = ("c", "l", "u", "is_neg_inf", "is_pos_inf", "l_dual", "u_dual",
             "d_col", "c0", "l0_dual", "u0_dual")
PROBLEM_Y = ("q", "ineq_mask", "d_row", "q0")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Which slice of each vector space this rank holds, for the mesh
    layout of a padded (m, n) operator: `flat` False is the dense 2D
    layout (x on "col", y on "row"), True band and block-ELL (both spaces
    in strips over all ranks)."""

    mesh: Mesh
    flat: bool
    m: int
    n: int

    @property
    def x_span(self) -> tuple[int, int]:
        parts, i = ((self.mesh.size, self.mesh.rank) if self.flat
                    else (self.mesh.shape[1], self.mesh.col))
        per = self.n // parts
        return i * per, (i + 1) * per

    @property
    def y_span(self) -> tuple[int, int]:
        parts, i = ((self.mesh.size, self.mesh.rank) if self.flat
                    else (self.mesh.shape[0], self.mesh.row))
        per = self.m // parts
        return i * per, (i + 1) * per

    @property
    def x_ranks(self) -> list:
        """The ranks that hold one copy of each x slice, in slice order:
        row 0's in 2D, every rank in flat."""
        R, C = self.mesh.shape
        return list(range(R * C)) if self.flat else list(range(C))

    @property
    def y_ranks(self) -> list:
        """The ranks that hold one copy of each y slice: column 0's in 2D,
        every rank in flat."""
        R, C = self.mesh.shape
        return list(range(R * C)) if self.flat else [r * C
                                                     for r in range(R)]

    @property
    def red(self):
        """The reducer of the solver body (solver/reduce.py): this
        placement, or None on one rank, whose slices are the whole vectors
        (its reductions are then the unsharded solve's exact calls)."""
        return self if self.mesh.size > 1 else None

    @property
    def payload(self) -> dict:
        """Entries this rank sends in each product's collective (the
        step's dot partials aside): in 2D its partial of y_r (K x, over
        its row) and of x_c (K'y, over its column); in flat its x strip
        (gathered for K x) and its y strip (for K'y)."""
        (x0, x1), (y0, y1) = self.x_span, self.y_span
        return ({"K x": x1 - x0, "K'y": y1 - y0} if self.flat
                else {"K x": y1 - y0, "K'y": x1 - x0})

    def cut_x(self, v):
        x0, x1 = self.x_span
        return v[x0:x1]

    def cut_y(self, v):
        y0, y1 = self.y_span
        return v[y0:y1]

    def reduce(self, reqs, kind: str = "reduce") -> list:
        """The values of `reqs` ((op, space, *tensors), op "dot", "norm",
        "all" or "max", space "x" or "y") over the whole vectors: each
        rank's partials, one all_gather over the group, and the partials
        of one replica of each slice reduced in rank order."""
        reqs = list(reqs)
        dtype = next((t.dtype for _, _, *ts in reqs for t in ts
                      if t.is_floating_point()), torch.float64)
        parts = []
        for op, _, *ts in reqs:
            if op == "dot":
                parts.append(torch.dot(ts[0], ts[1]))
            elif op == "norm":
                parts.append(torch.dot(ts[0], ts[0]))
            elif op == "all":  # the count of false entries
                parts.append((~ts[0]).sum().to(dtype))
            elif op == "max":
                parts.append(torch.amax(ts[0]))
            else:
                raise ValueError(f"unknown reduction {op!r}")
        G = self.mesh.all_gather(torch.stack(parts).to(dtype), kind)
        rows = {"x": G[self.x_ranks], "y": G[self.y_ranks]}
        sums = {k: v.sum(0) for k, v in rows.items()}
        maxs = ({k: v.amax(0) for k, v in rows.items()}
                if any(op == "max" for op, *_ in reqs) else None)
        out = []
        for i, (op, space, *_) in enumerate(reqs):
            if op == "dot":
                out.append(sums[space][i])
            elif op == "norm":
                out.append(torch.sqrt(sums[space][i]))
            elif op == "all":
                out.append(sums[space][i] == 0)
            else:
                out.append(maxs[space][i])
        return out

    def gather(self, *vecs):
        """The whole vectors of (space, slice) pairs, on every rank, by one
        all_gather: for results and checkpoints only."""
        lens = [v.shape[0] for _, v in vecs]
        G = self.mesh.all_gather(torch.cat([v for _, v in vecs]), "gather")
        out, at = [], 0
        for (space, _), ln in zip(vecs, lens):
            ranks = self.x_ranks if space == "x" else self.y_ranks
            out.append(G[ranks, at:at + ln].reshape(-1))
            at += ln
        return out


def placement(mesh: Mesh, layout: str, m: int, n: int) -> Placement:
    """The placement of the vectors of a solve in `layout` ("dense": 2D,
    "band" or "sparse": flat) over the padded (m, n) operator (the
    counterpart of `problem_shardings` and `flat_shardings`)."""
    return Placement(mesh, layout != "dense", m, n)


def _space(name: str):
    return "x" if name in _X_FIELDS else "y" if name in _Y_FIELDS else None


def _fields(st):
    out = [(f.name, getattr(st, f.name)) for f in dataclasses.fields(st)]
    for name, v in out:
        if (v.dim() > 0) != (_space(name) is not None):
            raise ValueError(f"state field {name!r} of shape {tuple(v.shape)}"
                             " does not match the space field sets")
    return out


def gather_state(st, pl: Placement):
    """The whole (padded) state on every rank, from each rank's slices, by
    one all_gather (a checkpoint write)."""
    vecs = [(n, v) for n, v in _fields(st) if v.dim()]
    full = pl.gather(*((_space(n), v) for n, v in vecs))
    return dataclasses.replace(st, **{n: v for (n, _), v in zip(vecs,
                                                                 full)})


def shard_state(st, pl: Placement):
    """Rank 0's whole (padded) state cut into this rank's slices, on every
    rank (the counterpart of the JAX `shard_state`): rank 0's `st` is the
    whole state, the other ranks' `st` (this rank's slices) gives only the
    dtypes and the device.  Floating fields and counters each travel in
    one broadcast."""
    fields = _fields(st)
    full_len = {"x": pl.n, "y": pl.m, None: 1}
    floats = [(n, v) for n, v in fields if v.is_floating_point()]
    ints = [(n, v) for n, v in fields if not v.is_floating_point()]
    like = floats[0][1]
    size = sum(full_len[_space(n)] for n, _ in floats)
    if pl.mesh.rank == 0:
        buf_f = torch.cat([v.reshape(-1) for _, v in floats])
        buf_i = torch.stack([v.to(torch.int32) for _, v in ints])
        if buf_f.numel() != size:
            raise ValueError("shard_state: the state's vectors are not of "
                             f"this layout's padded sizes ({pl.n}, {pl.m})")
    else:
        buf_f = like.new_empty(size)
        buf_i = torch.empty(len(ints), dtype=torch.int32, device=like.device)
    pl.mesh.broadcast(buf_f)
    pl.mesh.broadcast(buf_i)
    out, at = {}, 0
    for name, v in floats:
        space = _space(name)
        ln = full_len[space]
        part = buf_f[at:at + ln]
        at += ln
        out[name] = (part.reshape(()) if space is None else
                     (pl.cut_x(part) if space == "x" else pl.cut_y(part))
                     ).clone()
    for i, (name, _) in enumerate(ints):
        out[name] = buf_i[i].clone()
    return dataclasses.replace(st, **out)


def check_replicated(st, mesh: Mesh) -> None:
    """Raise where a scalar of the state differs between ranks in any bit
    (one all_gather): a rank-local value would otherwise lead the ranks to
    different restart or termination decisions and different
    collectives."""
    if mesh.group is None or mesh.size == 1:
        return
    scalars = [(n, v) for n, v in _fields(st) if not v.dim()]
    bits = torch.stack([v.to(torch.float64).view(torch.int64)
                        if v.is_floating_point() else v.to(torch.int64)
                        for _, v in scalars])
    G = mesh.all_gather(bits, "check")
    differ = (G != G[0]).any(0)
    if bool(differ.any()):
        names = [n for (n, _), d in zip(scalars, differ.tolist()) if d]
        raise RuntimeError(f"sharded solve: rank {mesh.rank} sees scalar "
                           f"state fields {names} differ between ranks")


def vector_bytes(pl: Placement, *objs) -> dict:
    """The vectors among the fields of `objs` (a state, a DeviceProblem),
    each tensor's data counted once however many fields hold it: {"x",
    "y": bytes held here, by space; "x_whole", "y_whole": the bytes the
    same vectors take whole (padded); "x_parts", "y_parts": the number of
    slices of each space}.  A vector held as its slice has x = x_whole /
    x_parts (y likewise)."""
    seen = set()
    out = dict.fromkeys(("x", "y", "x_whole", "y_whole"), 0)
    for obj in objs:
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            space = ("x" if f.name in _X_FIELDS or f.name in PROBLEM_X
                     else "y" if f.name in _Y_FIELDS or f.name in PROBLEM_Y
                     else None)
            key = (v.data_ptr(), v.numel()) if space else None
            if space is None or key in seen:
                continue
            seen.add(key)
            out[space] += v.numel() * v.element_size()
            out[space + "_whole"] += ((pl.n if space == "x" else pl.m)
                                      * v.element_size())
    R, C = pl.mesh.shape
    out["x_parts"] = pl.mesh.size if pl.flat else C
    out["y_parts"] = pl.mesh.size if pl.flat else R
    return out


def shard_device_problem(pb, mesh: Mesh):
    """Not this design's route: a DeviceProblem already holds its whole
    operator on one device, and no device may stage the whole operator.
    Each rank builds its own shard and its slices on the host instead:
    `solve(problem, cfg, mesh=mesh)`, or `solver.solve.prepare(problem,
    cfg, mesh=mesh)` for the (DeviceProblem, state) pair.  Raises
    ValueError saying so."""
    raise ValueError(
        "shard_device_problem: under a mesh each rank builds its shard on "
        "the host from the LPProblem; call solve(problem, cfg, mesh=mesh) "
        "or tpdlp_torch.solver.solve.prepare(problem, cfg, mesh=mesh)")
