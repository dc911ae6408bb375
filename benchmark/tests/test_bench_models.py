"""The byte and flop models of the roofline metrics against hand counts,
and the share they give from a trace."""

from benchmark import peaks, spec
from benchmark.trace import TraceData, union_length

csr = spec.metric("csr_roofline")
k1 = spec.metric("k1_roofline")
k1b = spec.metric("k1_batch_roofline")


def test_dense_product_hand_count():
    # 3 x 5 fp32: 15 matrix + 5 x + 3 y floats; 2 * 15 flops.
    assert k1.product_cost(3, 5, 4) == (4 * (15 + 5 + 3), 30)
    # mittelmann-l's K: 640 MB and 112 KB of vectors.
    b, f = k1.product_cost(8000, 20000, 4)
    assert b == 640_112_000 and f == 320_000_000


def test_csr_product_hand_count():
    # 4 x 6 with 7 nonzeros, fp32: 7 values + 7 indices + 5 offsets
    # (4 bytes each), x of 6 and y of 4 floats.
    assert csr.product_cost(4, 6, 7, 4) == (7 * 8 + 5 * 4 + 10 * 4, 14)
    assert csr.product_cost(4, 6, 7, 8) == (7 * 12 + 5 * 4 + 10 * 8, 14)


def test_shared_k_batch_product_hand_count():
    # 3 x 5 fp32 shared by 4 right-hand sides: the matrix once, X 4 x 5,
    # Y 4 x 3.
    assert k1b.product_cost(3, 5, 4, 4) == (4 * (15 + 20 + 12), 120)


def test_bound_and_share_from_a_trace():
    nbytes, flops = k1.product_cost(8000, 20000, 4)
    bound = peaks.bound_s(nbytes, flops, 4)
    assert bound == nbytes / 3.35e12
    # Two launches of twice their bound: 50%.
    us = 2 * bound * 1e6
    trace = TraceData(device=[("void dense_matvec_kernel<float>(...)", 0.0,
                               us),
                              ("void dense_matvec_kernel<float>(...)", us,
                               2 * us),
                              ("void dense_matvec_shared_kernel<float>", 0,
                               1.0)],
                      host=[], window=(0.0, 4 * us))
    share = peaks.roofline_percent(trace, k1.KERNELS, (nbytes, flops), 4)
    assert abs(share - 50.0) < 1e-9
    assert peaks.roofline_percent(trace, ("csr_matvec_ring_kernel",),
                                  (1, 1), 4) is None
    assert peaks.roofline_percent(None, k1.KERNELS, (1, 1), 4) is None


def test_trace_busy_share_and_idle_labels():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    host = sorted([("aten::mul", 0.0, 10.0), ("aten::item", 10.0, 30.0),
                   ("cudaLaunchKernel", 12.0, 14.0)], key=lambda r: r[1])
    trace = TraceData(device=[("k", 0.0, 4.0), ("k", 2.0, 10.0),
                              ("k", 20.0, 25.0)],
                      host=host, window=(0.0, 30.0))
    assert trace.busy_us == 15.0 and trace.window_us == 30.0
    # Idle 10-20 (host in aten::item) and 25-30 (aten::item too).
    assert trace.idle_by_host_op() == [["aten::item", 15e-6]]
    assert trace.top_device_ops() == [["k", 17e-6]]
