"""Reductions that serve one solve, a fleet (tpdlp_torch/batch) and a
sharded solve (tpdlp_torch/shard).

A single solve's vectors are 1-D and its scalars 0-d; a fleet's vectors are
(B, n) and its per-element scalars (B, 1), so that every elementwise
expression of the solver broadcasts unchanged.  `dot`, `norm` and `all_`
keep the single solve's exact call for a 1-D argument (its bits stay those
of the solve before fleets existed) and reduce the last axis of a batch,
keeping it as a (B, 1) column.

Under a mesh a vector is this rank's slice of its space, so a reduction
must know the space ("x" or "y") to sum the right ranks' partials.  The
solver names it in a request (op, space, *tensors), op "dot", "norm",
"all" or "max", and hands requests that need no result of one another to
`reduce` together, with the operator's reducer `red` (`pb.red`,
`op.red`): None on one device, where each request is the exact call
above, in order; a `shard.mesh.Placement` under a mesh, where the batch
costs one collective.  `staged` runs several computations that each need
a few rounds of reductions side by side, one `reduce` a round.
"""

from __future__ import annotations

import torch


def dot(a, b):
    """a'b: `torch.dot` for vectors; each row's sum of a*b for a batch."""
    if a.dim() == 1:
        return torch.dot(a, b)
    return (a * b).sum(dim=-1, keepdim=True)


def norm(v):
    """The 2-norm of a vector, or of each row of a batch."""
    if v.dim() == 1:
        return torch.linalg.vector_norm(v)
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def all_(v):
    """All of a bool vector, or of each row of a batch."""
    if v.dim() == 1:
        return torch.all(v)
    return v.all(dim=-1, keepdim=True)


def amax(v):
    """The largest entry of a vector (kept as a (1,) column), or of each
    row of a batch."""
    return torch.amax(v, dim=-1, keepdim=True)


_LOCAL = {"dot": dot, "norm": norm, "all": all_, "max": amax}


def reduce(red, *reqs, kind: str = "reduce") -> list:
    """The value of each request (op, space, *tensors) over the whole
    vectors: the exact local call when `red` is None, else `red.reduce`
    (one collective for all of them, counted under `kind`)."""
    if red is None:
        return [_LOCAL[op](*ts) for op, _space, *ts in reqs]
    return red.reduce(reqs, kind)


def staged(red, *gens) -> list:
    """Run generators side by side: each yields a list of requests and is
    sent their values, until it returns.  A round's requests from every
    generator still running go to one `reduce`.  Returns each generator's
    return value."""
    out = [None] * len(gens)
    pending = {}
    for i, g in enumerate(gens):
        try:
            pending[i] = next(g)
        except StopIteration as stop:
            out[i] = stop.value
    while pending:
        order = list(pending)
        vals = reduce(red, *(r for i in order for r in pending[i]))
        at, nxt = 0, {}
        for i in order:
            ln = len(pending[i])
            try:
                nxt[i] = gens[i].send(vals[at:at + ln])
            except StopIteration as stop:
                out[i] = stop.value
            at += ln
        pending = nxt
    return out
