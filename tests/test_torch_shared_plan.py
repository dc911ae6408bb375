"""The shared-K kernel's plan (`tpdlp_torch/ops/_kernels.py::shared_plan`),
a pure function the wrapper calls before each launch of
`csrc/dense_matvec.cu::dense_matvec_shared_kernel`: its tiles, walked the
way the kernel walks them, cover every (element, row) output exactly once,
fit a block's shared memory and keep what the kernel's launcher checks.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from tpdlp_torch.ops._kernels import (
    _WHOLE_ROW_BYTES,
    _WHOLE_TILE_SMEM,
    shared_plan,
)

H100_SMS = 132
#: A block's shared memory on Hopper (kMaxSmem in csrc/dense_matvec.cu).
SMEM_LIMIT = 227 * 1024

# (rows, cols, batch, item): the fleets' K and K' (afiro-class x 10,000 and
# ragged 37, deg2-class x 64 fp32 and fp64, mittelmann-s x 8), rows longer
# than a stage, cols % 4 of 1, 2 and 3, B = 1, B and rows off the tiles,
# one column, no column.
SHAPES = [
    (27, 51, 10_000, 4), (51, 27, 10_000, 4), (27, 51, 37, 4),
    (51, 27, 37, 4), (27, 51, 1, 4), (444, 757, 64, 4), (757, 444, 64, 4),
    (444, 757, 64, 8), (757, 444, 64, 8), (2000, 5000, 8, 4),
    (5000, 2000, 8, 4), (300, 2500, 5, 4), (300, 1300, 5, 8),
    (300, 2500, 1, 4), (37, 1025, 9, 4), (33, 1, 7, 4), (33, 2, 7, 4),
    (33, 3, 7, 4), (33, 5, 7, 8), (2001, 5003, 3, 4), (3, 70001, 2, 4),
    (1, 1, 1, 8), (5, 0, 3, 4),
]


def _row_bytes(cols, item):
    return -(-cols // 4) * 4 * item


def _covered(plan, rows, cols, batch, item):
    """How often each (element, row) is written: the kernel's walk of
    blocks, warps, lane groups and units, in numpy."""
    whole = _row_bytes(cols, item) <= plan.chunk
    groups = 32 // plan.G
    count = np.zeros((batch, rows), dtype=np.int64)
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
    """What launch_shared checks before it launches, and two blocks an SM
    for whole rows."""
    plan = shared_plan(rows, cols, batch, item, sms)
    row_bytes = _row_bytes(cols, item)
    nlive = -(-cols // (16 // item))
    assert plan.G in (4, 8, 16, 32)
    assert plan.G == 32 or nlive <= plan.G
    assert plan.RB > 0 and plan.EB > 0
    assert plan.RB % 4 == 0 and plan.EB % 4 == 0
    assert plan.row_blocks == -(-rows // plan.RB)
    assert plan.elem_blocks == -(-batch // plan.EB)
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
        assert plan.G == 32 and plan.stages == 2
        assert plan.chunk % (16 * 32) == 0 and plan.chunk < row_bytes
        assert (plan.RB // 4) * (plan.EB // 4) == 8


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
