"""The shared-K kernel's plan (`tpdlp_torch/ops/_kernels.py::shared_plan`),
a pure function the wrapper calls before each launch of
`csrc/dense_matvec.cu::dense_matvec_shared_kernel`: its tiles, walked the
way the kernel walks them, cover every (element, row) output exactly once,
fit a block's shared memory and keep what the kernel's launcher checks.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from tpdlp_torch.ops._kernels import (
    _LONG_CLUSTER,
    _LONG_MIN_REREAD,
    _LONG_OUTPUTS,
    _WHOLE_ROW_BYTES,
    _WHOLE_TILE_SMEM,
    shared_plan,
)

H100_SMS = 132
#: A block's shared memory on Hopper (kMaxSmem in csrc/dense_matvec.cu).
SMEM_LIMIT = 227 * 1024
#: The cluster route's walk as csrc/dense_matvec.cu spells it (kLongWarps,
#: kLaneRows, kLongSegs, kLongStages): a block's warps, a lane's tile rows
#: (x 8 elements), segments of 512 bytes a stage, stages of its ring.
LONG_WARPS, LANE_ROWS, LONG_SEGS, LONG_STAGES = 8, 12, 2, 7

# (rows, cols, batch, item): the fleets' K and K' (afiro-class x 10,000 and
# ragged 37, deg2-class x 64 fp32 and fp64, mittelmann-s x 8, mittelmann-l
# x 64 and ragged 37), rows longer than a stage, cols % 4 of 1, 2 and 3,
# B = 1, B and rows off the tiles, one column, no column.
SHAPES = [
    (27, 51, 10_000, 4), (51, 27, 10_000, 4), (27, 51, 37, 4),
    (51, 27, 37, 4), (27, 51, 1, 4), (444, 757, 64, 4), (757, 444, 64, 4),
    (444, 757, 64, 8), (757, 444, 64, 8), (2000, 5000, 8, 4),
    (5000, 2000, 8, 4), (300, 2500, 5, 4), (300, 1300, 5, 8),
    (300, 2500, 1, 4), (37, 1025, 9, 4), (33, 1, 7, 4), (33, 2, 7, 4),
    (33, 3, 7, 4), (33, 5, 7, 8), (2001, 5003, 3, 4), (3, 70001, 2, 4),
    (1, 1, 1, 8), (5, 0, 3, 4), (8000, 20000, 64, 4), (20000, 8000, 64, 4),
    (20000, 8000, 37, 4),
]


def _row_bytes(cols, item):
    return -(-cols // 4) * 4 * item


def _reread(rows, cols, batch):
    """The bytes of an fp32 K that the chunked route reads after its first
    pass (8 elements a pass)."""
    return (-(-batch // 8) - 1) * rows * _row_bytes(cols, 4)


def _traffic(rows, cols, batch, item, plan):
    """(K bytes, X bytes) a launch by `plan` brings from L2 into the SMs:
    every element block reads K's rows (cols rounded up to 4) once, every
    row block X's rows once, in either regime."""
    return (rows * _row_bytes(cols, item) * plan.elem_blocks,
            batch * cols * item * plan.row_blocks)


def _covered(plan, rows, cols, batch, item):
    """How often each (element, row) is written: the kernel's walk of
    blocks, warps, lane groups and units, in numpy."""
    count = np.zeros((batch, rows), dtype=np.int64)
    if plan.cluster > 1:
        # A tile a cluster, element blocks fastest; block q writes
        # elements [q EB / 4, (q + 1) EB / 4) of it, every row.
        o = np.arange(_LONG_OUTPUTS // plan.cluster)
        for tile in range(plan.row_blocks * plan.elem_blocks):
            r0 = tile // plan.elem_blocks * plan.RB
            e0 = tile % plan.elem_blocks * plan.EB
            nr, ne = min(plan.RB, rows - r0), min(plan.EB, batch - e0)
            assert nr > 0 and ne > 0, "a tile with nothing to do"
            for q in range(plan.cluster):
                e = q * (plan.EB // plan.cluster) + o // plan.RB
                r = o % plan.RB
                keep = (r < nr) & (e < ne)
                np.add.at(count, (e0 + e[keep], r0 + r[keep]), 1)
        return count
    whole = _row_bytes(cols, item) <= plan.chunk
    groups = 32 // plan.G
    o = np.arange(16)
    for blk in range(plan.row_blocks * plan.elem_blocks):
        r0 = blk % plan.row_blocks * plan.RB
        e0 = blk // plan.row_blocks * plan.EB
        nr, ne = min(plan.RB, rows - r0), min(plan.EB, batch - e0)
        assert nr > 0 and ne > 0, "a block with nothing to do"
        if whole:
            nue = -(-ne // 4)
            units = -(-nr // 4) * nue
            mine = [u0 + g for warp in range(8)
                    for u0 in range(warp * groups, units, 8 * groups)
                    for g in range(groups) if u0 + g < units]
            assert sorted(mine) == list(range(units))
            cells = [(u // nue, u % nue) for u in mine]
        else:
            ues = plan.EB // 4
            cells = [(w // ues, w % ues) for w in range(8)]
        for ur, ue in cells:
            r = ur * 4 + o // 4
            e = ue * 4 + o % 4
            keep = (r < nr) & (e < ne)
            np.add.at(count, (e0 + e[keep], r0 + r[keep]), 1)
    return count


@pytest.mark.parametrize("rows,cols,batch,item", SHAPES)
def test_shared_plan_covers_every_output_once(rows, cols, batch, item):
    plan = shared_plan(rows, cols, batch, item, H100_SMS)
    assert np.array_equal(_covered(plan, rows, cols, batch, item),
                          np.ones((batch, rows), dtype=np.int64))


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("rows,cols,batch,item", SHAPES)
def test_shared_plan_keeps_the_kernels_limits(rows, cols, batch, item, sms):
    """What launch_shared (launch_shared_long on the cluster route)
    checks before it launches, and two blocks an SM for whole rows."""
    plan = shared_plan(rows, cols, batch, item, sms)
    row_bytes = _row_bytes(cols, item)
    nlive = -(-cols // (16 // item))
    assert plan.row_blocks == -(-rows // plan.RB)
    assert plan.elem_blocks == -(-batch // plan.EB)
    if plan.cluster > 1:
        # fp32 rows longer than a stage where the chunked route would read
        # K again for _LONG_MIN_REREAD bytes, tiles of 3072 outputs and 32
        # or 64 elements (32 at a batch of at most 32); the rest is the
        # launcher's own.
        assert row_bytes > _WHOLE_ROW_BYTES and item == 4
        assert _reread(rows, cols, batch) >= _LONG_MIN_REREAD
        assert plan.cluster == _LONG_CLUSTER
        assert plan.EB in (32, 64) and plan.RB * plan.EB == _LONG_OUTPUTS
        assert plan.EB == 64 or batch <= 32
        assert (plan.G, plan.chunk, plan.stages, plan.smem) == (0, 0, 0, 0)
        return
    assert plan.G in (4, 8, 16, 32)
    assert plan.G == 32 or nlive <= plan.G
    assert plan.RB > 0 and plan.EB > 0
    assert plan.RB % 4 == 0 and plan.EB % 4 == 0
    assert plan.smem == plan.stages * (plan.RB + plan.EB) * min(
        row_bytes, plan.chunk)
    assert plan.smem <= SMEM_LIMIT
    if row_bytes <= _WHOLE_ROW_BYTES:
        assert plan.chunk >= row_bytes and plan.stages == 1
        assert plan.smem <= _WHOLE_TILE_SMEM
        # The K part of a tile at most half its memory.
        assert plan.RB * max(row_bytes, 16) <= _WHOLE_TILE_SMEM // 2 or (
            plan.RB == 4)
    else:
        assert plan.G == 32 and plan.stages == 2 and plan.cluster == 1
        assert plan.chunk % (16 * 32) == 0 and plan.chunk < row_bytes
        assert (plan.RB // 4) * (plan.EB // 4) == 8
        assert item == 8 or _reread(rows, cols, batch) < _LONG_MIN_REREAD


def test_shared_plan_spreads_the_fleets_over_the_card():
    """afiro-class x 10,000 and deg2-class x 64 give every SM of an H100
    a block, in element and row blocks of one size (the last excepted);
    mittelmann-s x 8 reads its K once (one element block) over at least
    as many blocks as SMs less a few."""
    for rows, cols, batch, item in ((27, 51, 10_000, 4), (51, 27, 10_000, 4),
                                    (444, 757, 64, 4), (757, 444, 64, 4),
                                    (444, 757, 64, 8), (757, 444, 64, 8)):
        plan = shared_plan(rows, cols, batch, item, H100_SMS)
        assert plan.row_blocks * plan.elem_blocks >= H100_SMS
        assert rows - (plan.row_blocks - 1) * plan.RB > 0
        assert batch - (plan.elem_blocks - 1) * plan.EB > 0
    for rows, cols in ((2000, 5000), (5000, 2000)):
        plan = shared_plan(rows, cols, 8, 4, H100_SMS)
        assert plan.elem_blocks == 1
        assert plan.row_blocks >= H100_SMS - 8


@pytest.mark.parametrize("rows,cols,batch,item", [
    (27, 51, 10_000, 4), (51, 27, 10_000, 4), (444, 757, 64, 4),
    (757, 444, 64, 4), (757, 444, 64, 8)])
def test_shared_plan_fills_the_warps_of_a_block(rows, cols, batch, item):
    """The fleets' whole-row tiles keep the warps' lane groups busy: the
    units of a block fill at least 80% of the passes they take (8 warps
    of 32 / G units a pass)."""
    plan = shared_plan(rows, cols, batch, item, H100_SMS)
    units = (plan.RB // 4) * (plan.EB // 4)
    slots = 8 * (32 // plan.G)
    assert units / (-(-units // slots) * slots) >= 0.8


@pytest.mark.parametrize("rows,cols,batch", [
    (8000, 20000, 64), (20000, 8000, 64), (20000, 8000, 37),
    (8000, 20000, 16), (2000, 5000, 33), (2000, 5000, 24)])
def test_shared_plan_long_rows_read_k_once(rows, cols, batch):
    """fp32 rows longer than a stage at a batch of 9 to 64, where the
    chunked route would read K again for 60 MB or more, take the cluster
    route: one element block, so each byte of K enters the SMs
    once a launch, and X at most EB / RB of K's bytes with its rows
    rounded up to whole tiles (the budget of shared_plan's docstring); at
    mittelmann-l x 64 at most 1.5 GB in all, against the chunked tiles'
    7.68 GB."""
    plan = shared_plan(rows, cols, batch, 4, H100_SMS)
    k_bytes = rows * _row_bytes(cols, 4)
    k_in, x_in = _traffic(rows, cols, batch, 4, plan)
    assert plan.cluster == _LONG_CLUSTER and plan.elem_blocks == 1
    assert k_in == k_bytes
    assert x_in <= plan.EB * plan.row_blocks * _row_bytes(cols, 4)
    if (rows, cols, batch) in ((8000, 20000, 64), (20000, 8000, 64)):
        assert k_in + x_in <= 1.5e9
        old = shared_plan(rows, cols, 8, 4, H100_SMS)._replace(
            row_blocks=-(-rows // 16), elem_blocks=8)
        assert sum(_traffic(rows, cols, batch, 4, old)) > 7.6e9


def _cluster_partials(EB):
    """The cluster route's partials' buffer, walked as the kernel walks
    it: (the flat index each lane's (chain, element, row) partial is
    stored at, with its bank, a warp's store at a time; the index each
    output's partial L is read from)."""
    RB = _LONG_OUTPUTS // EB
    WE = EB // 32
    Pe, Pc = RB + 1, EB * (RB + 1) + 1
    stores = {}
    banks = []
    for warp in range(LONG_WARPS):
        wr, we = warp // WE, warp % WE
        for i in range(LANE_ROWS):
            for e in range(8):
                step = []
                for lane in range(32):
                    c, g = lane % 8, lane // 8
                    el = we * 32 + g * 8 + e
                    r = wr * LANE_ROWS + i
                    at = c * Pc + el * Pe + r
                    step.append(at % 32)
                    for q in range(_LONG_CLUSTER):
                        key = (q, 8 * q + c, el, r)
                        assert key not in stores
                        stores[key] = (q, at)
                banks.append(step)
    reads = {}
    for q in range(_LONG_CLUSTER):
        for o in range(_LONG_OUTPUTS // _LONG_CLUSTER):
            el, r = q * (EB // _LONG_CLUSTER) + o // RB, o % RB
            for L in range(32):
                reads[(L, el, r)] = (L // 8, (L % 8) * Pc + el * Pe + r)
    return RB, Pc, stores, banks, reads


@pytest.mark.parametrize("EB", [32, 64])
def test_cluster_route_partials_meet_in_one_tree(EB):
    """Every output of a tile reads its 32 partials, chain L from the
    block (L // 8) and the slot where that block's lane of chain L
    stored it, once each; a warp's 32 stores hit 32 banks; the buffer
    fits the ring it overwrites, which fits a block."""
    assert _LONG_OUTPUTS == LONG_WARPS * 32 * LANE_ROWS
    RB, Pc, stores, banks, reads = _cluster_partials(EB)
    assert len(reads) == 32 * RB * EB
    for (L, el, r), where in reads.items():
        assert stores[(L // 8, L, el, r)] == where
    assert len({w for w in reads.values()}) == len(reads)
    assert all(len(set(step)) == 32 for step in banks)
    plan = shared_plan(8000, 20000, 64 if EB == 64 else 32, 4, H100_SMS)
    assert (plan.RB, plan.EB) == (RB, EB)
    ring = LONG_STAGES * (RB + EB) * LONG_SEGS * 512 // _LONG_CLUSTER
    assert 8 * Pc * 4 <= ring <= SMEM_LIMIT


@pytest.mark.parametrize("cols", [1025, 1299, 5003, 8000, 20000])
def test_cluster_route_walks_each_chain_in_order(cols):
    """Lane c of cluster block q takes, stage after stage and segment
    after segment, the vectors 32 s + 8 q + c that it computes with: for
    each chain L the single launch's vectors L, L + 32, ... in order,
    the partial vector (cols % 4) last and on chain nvec % 32."""
    nvec, tail = cols // 4, cols % 4
    nlive = nvec + (1 if tail else 0)
    stages = -(-nlive // (32 * LONG_SEGS))
    for q in range(_LONG_CLUSTER):
        for c in range(8):
            walk = [(k * LONG_SEGS + sg) * 32 + 8 * q + c
                    for k in range(stages) for sg in range(LONG_SEGS)]
            walk = [v for v in walk if v < nlive]
            L = 8 * q + c
            assert walk == list(range(L, nlive, 32))
            if tail and walk and walk[-1] == nvec:
                assert L == nvec % 32


#: The long-row routes' cold times on an H100 (chip_smoke.py's
#: shared_routes, ms): (rows, cols, batch, the faster route's cluster).
#: mittelmann-s (40 MB) x 9 and 16 is faster chunked (0.0308 / 0.0328
#: against 0.0404), x 24 on the cluster route (0.0410 against 0.0482);
#: mittelmann-l (640 MB) x 8 chunked (0.2255 against 0.3479), x 9 on the
#: cluster route (0.3492 against 0.4337).
FASTER_ROUTE = [
    (2000, 5000, 8, 1), (2000, 5000, 9, 1), (2000, 5000, 16, 1),
    (5000, 2000, 16, 1), (2000, 5000, 24, 4), (5000, 2000, 32, 4),
    (8000, 20000, 8, 1), (8000, 20000, 9, 4), (20000, 8000, 9, 4),
    (20000, 8000, 64, 4)]


@pytest.mark.parametrize("rows,cols,batch,cluster", FASTER_ROUTE)
def test_shared_plan_takes_the_faster_long_route(rows, cols, batch,
                                                 cluster):
    """At the batches timed on the card the plan takes the route that was
    faster there, and the 96 x 32 tile up to a batch of 32 (at mittelmann-l
    x 9-32 0.349-0.363 ms against 0.670-0.691 for 48 x 64)."""
    plan = shared_plan(rows, cols, batch, 4, H100_SMS)
    assert plan.cluster == cluster
    if cluster > 1:
        assert plan.EB == (32 if batch <= 32 else 64)
