"""csr_roofline (%; kernels, ops/sparse.py and csrc/csr_matvec.cu): the
traced CSR launches' share of their bound.

One product y = K x of a CSR matrix of `rows` rows, `cols` columns and
`nnz` nonzeros reads each value and column index once, the row offsets
once and x once, and writes y once: nnz (item + 4) + (rows + 1) 4 +
cols item + rows item bytes, against 2 nnz flops.  The solver stores K
and K' and alternates K x and K'y, so a launch is counted at the mean of
the two (rows and cols swapped).
"""

from benchmark.peaks import roofline_percent

KERNELS = ("csr_matvec_ring_kernel", "csr_matvec_direct_kernel")


def product_cost(rows, cols, nnz, item):
    """(bytes, flops) of one product."""
    return (nnz * (item + 4) + (rows + 1) * 4 + (cols + rows) * item,
            2 * nnz)


def read(run):
    k = product_cost(run.m, run.n, run.nnz, run.item)
    kt = product_cost(run.n, run.m, run.nnz, run.item)
    mean = ((k[0] + kt[0]) / 2, (k[1] + kt[1]) / 2)
    return roofline_percent(run.trace, KERNELS, mean, run.item)
