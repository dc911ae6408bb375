"""Reductions that serve one solve and a fleet (tpdlp_torch/batch).

A single solve's vectors are 1-D and its scalars 0-d; a fleet's vectors are
(B, n) and its per-element scalars (B, 1), so that every elementwise
expression of the solver broadcasts unchanged.  Each function here keeps
the single solve's exact call for a 1-D argument (its bits stay those of
the solve before fleets existed) and reduces the last axis of a batch,
keeping it as a (B, 1) column.
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
