"""k1_batch_roofline (%; kernels, the shared-K batch axis of
csrc/dense_matvec.cu): the traced shared-K batch launches' share of their
bound.

One product Y = M X' of a dense rows x cols matrix shared by a batch of
B right-hand sides reads M once and X once and writes Y once:
(rows cols + B (cols + rows)) item bytes, against 2 rows cols B flops; K
and K' cost the same.  B is the traffic's batch: after a fleet compacts,
its launches carry fewer right-hand sides, so their X and Y bytes are
counted high by at most B (rows + cols) item, under 0.3% of M's at
mittelmann-l's size.
"""

from benchmark.peaks import roofline_percent

KERNELS = ("dense_matvec_shared_kernel",)


def product_cost(rows, cols, batch, item):
    """(bytes, flops) of one product."""
    return ((rows * cols + batch * (cols + rows)) * item,
            2 * rows * cols * batch)


def read(run):
    if run.batch == 1:
        return None
    return roofline_percent(run.trace, KERNELS,
                            product_cost(run.m, run.n, run.batch, run.item),
                            run.item)
