"""A DOTmark-style optimal transport LP (Schrieber, Schuhmacher &
Gottschlich, "DOTmark - A Benchmark for Discrete Optimal Transport", IEEE
Access 2017, class WhiteNoise) at a CPU's size, as a generator file: the
tests copy it into a copy of the benchmark's `generators/`, the way a new
kind of LP is added.  numpy and scipy only.

Two r x r images of uniform random intensities, each scaled to one unit of
mass a pixel (N = r * r pixels, N units), and the plan x (N * N columns,
x[i * N + j] from pixel i of the first to pixel j of the second):

    minimize c'x  s.t.  sum_j x_ij = a_i,  sum_i x_ij = b_j,  x >= 0

with c the squared Euclidean distance of the pixels on the grid.  K's
2 * N * N nonzeros are all 1.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from benchmark.generators.feasible_lp import LP


def build(instance: dict, seed: int) -> LP:
    """The transport LP of `instance["resolution"]` from `seed`."""
    r = int(instance["resolution"])
    N = r * r
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(size=(2, N))
    a, b = a * (N / a.sum()), b * (N / b.sum())
    row, col = np.divmod(np.arange(N), r)
    cost = ((row[:, None] - row[None, :]) ** 2
            + (col[:, None] - col[None, :]) ** 2).astype(np.float64)
    j = np.arange(N * N)
    K = sp.csr_matrix((np.ones(2 * N * N),
                       (np.concatenate([j // N, N + j % N]),
                        np.concatenate([j, j]))), shape=(2 * N, N * N))
    return LP(c=cost.ravel(), K=K, q=np.concatenate([a, b]), m_ineq=0,
              l=np.zeros(N * N), u=np.full(N * N, np.inf),
              name=f"dotmark_whitenoise_{r}x{r}_s{seed}")
