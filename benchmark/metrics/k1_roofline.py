"""k1_roofline (%; kernels, ops/exact_dense.py and csrc/dense_matvec.cu):
the traced single-vector K1 launches' share of their bound.

One product y = M x of a dense rows x cols matrix reads M and x once and
writes y once: (rows cols + cols + rows) item bytes, against 2 rows cols
flops; K and K' cost the same.
"""

from benchmark.peaks import roofline_percent

KERNELS = ("dense_matvec_kernel",)


def product_cost(rows, cols, item):
    """(bytes, flops) of one product."""
    return (rows * cols + cols + rows) * item, 2 * rows * cols


def read(run):
    return roofline_percent(run.trace, KERNELS,
                            product_cost(run.m, run.n, run.item), run.item)
