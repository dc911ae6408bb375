"""Spectral-norm estimation by power iteration on K'K (counterpart of
tpdlp/solver/power_iteration.py).

The starting vector comes from `initial_vector`, a seeded torch.Generator
draw.  It cannot reproduce the JAX package's `jax.random.normal` bits, so
the parity tests replace this one function with the JAX draw.  Under a
mesh the draw is still of the padded n, as the JAX package's is, on the
host, and each rank keeps its slice; the norms reduce over their spaces
(solver/reduce.py), one collective each.
"""

from __future__ import annotations

import torch

from tpdlp_torch.solver.reduce import reduce


def initial_vector(n: int, seed: int, dtype, device) -> torch.Tensor:
    """Standard-normal b0 of length n from a CPU generator seeded `seed`
    (the same vector on every device), moved to `device`."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    b0 = torch.randn((n,), generator=g, dtype=torch.float64)
    return b0.to(dtype=dtype, device=device)


def spectral_norm_estimate(op, seed: int, num_iters: int = 100,
                           start=None):
    """||K||_2 estimate: num_iters power iterations of b <- K'(K b), from
    `initial_vector(n, seed)` or, where given, the vector `start` (this
    rank's slice under a mesh)."""
    n = op.shape[1]
    if start is not None:
        b = start
    elif op.red is None:
        b = initial_vector(n, seed, op.dtype, op.device)
    else:
        b = op.pl.cut_x(initial_vector(n, seed, op.dtype, "cpu")).to(
            op.device)
    for _ in range(num_iters):
        b = op.rmv(op.mv(b))
        b = b / _norm(op.red, "x", b)
    return _norm(op.red, "y", op.mv(b))


def _norm(red, space, v):
    """||v||: the whole-tensor norm the JAX package takes on one device
    (a vector's 2-norm), reduced over `space` under a mesh."""
    if red is None:
        return torch.linalg.vector_norm(v)
    return reduce(red, ("norm", space, v))[0]
