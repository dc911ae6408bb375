"""Spectral-norm estimation by power iteration on K'K (counterpart of
tpdlp/solver/power_iteration.py).

The starting vector comes from `initial_vector`, a seeded torch.Generator
draw.  It cannot reproduce the JAX package's `jax.random.normal` bits, so
the parity tests replace this one function with the JAX draw.
"""

from __future__ import annotations

import torch


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
    `initial_vector(n, seed)` or, where given, the (n,) vector `start`."""
    n = op.shape[1]
    b = initial_vector(n, seed, op.dtype, op.device) if start is None else (
        start)
    for _ in range(num_iters):
        b = op.rmv(op.mv(b))
        b = b / torch.linalg.vector_norm(b)
    return torch.linalg.vector_norm(op.mv(b))
