"""The stack kernel's plan (`tpdlp_torch/ops/_kernels.py::stack_plan`, for
`csrc/dense_matvec.cu::dense_matvec_stack_kernel`), a pure function the
wrapper calls before each launch.  Walked the way the kernel walks it, it
covers every output exactly once, fits a block's shared memory, keeps what
the launcher checks and fills the card.  The kernel itself runs only on
the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from tpdlp_torch.ops._kernels import (
    _STACK_CHUNK_BYTES,
    _STACK_MAX_SLOTS,
    _STACK_WHOLE_SMEM,
    _WHOLE_ROW_BYTES,
    stack_plan,
)

H100_SMS = 132
#: A block's shared memory on Hopper (kMaxSmem in csrc/dense_matvec.cu),
#: an SM's, and what each block reserves beside its dynamic part (the
#: system's 1 KB and the stack kernel's static barriers).
SMEM_LIMIT = 227 * 1024
SM_SMEM = 228 * 1024
BLOCK_EXTRA = 1024 + 8 * (2 * _STACK_MAX_SLOTS + 1)

# (rows, cols, batch, item): the distinct fleet's K and K' (16 deg2-shaped
# LPs) in fp32 and fp64 (fp64 K's rows stream in parts), B = 1 and 64,
# mittelmann-s's rows (5000 columns) and other rows longer than a stage,
# cols % 4 of 1, 2 and 3, a huge batch of short rows, rows off every tile,
# one column, no column.
SHAPES = [
    (444, 757, 16, 4), (757, 444, 16, 4), (444, 757, 16, 8),
    (757, 444, 16, 8), (444, 757, 1, 4), (444, 757, 64, 4),
    (757, 444, 64, 8), (2000, 5000, 8, 4), (2000, 5000, 1, 8),
    (300, 5000, 3, 4), (33, 1299, 5, 4), (17, 1025, 2, 4), (9, 5000, 1, 4),
    (33, 101, 7, 4), (33, 102, 7, 8), (33, 103, 7, 4), (27, 51, 10_000, 4),
    (10_000, 3, 1, 4), (3, 70_001, 2, 4), (1, 1, 1, 8), (5, 0, 3, 4),
]


def _row_bytes(cols, item):
    return -(-cols // 4) * 4 * item


def _stack_covered(plan, rows, cols, batch, item):
    """How often each (element, row) is written: the stack kernel's walk
    of blocks, stages of 8 rows and warps, in numpy."""
    count = np.zeros((batch, rows), dtype=np.int64)
    for blk in range(plan.row_blocks * batch):
        b, r0 = blk // plan.row_blocks, blk % plan.row_blocks * plan.RB
        nr = min(plan.RB, rows - r0)
        assert nr > 0, "a block with nothing to do"
        for g in range(-(-nr // 8)):
            for warp in range(8):
                if g * 8 + warp < nr:
                    count[b, r0 + g * 8 + warp] += 1
    return count


def _launch_smem(plan, cols, item):
    """The dynamic shared memory launch_stack computes from the plan."""
    row_bytes = _row_bytes(cols, item)
    whole = row_bytes <= plan.chunk
    stride = min(row_bytes, plan.chunk)
    return (stride if whole else 0) + plan.slots * (8 + (0 if whole else 1)
                                                    ) * stride


@pytest.mark.parametrize("rows,cols,batch,item", SHAPES)
def test_stack_plan_covers_every_output_once(rows, cols, batch, item):
    plan = stack_plan(rows, cols, batch, item, H100_SMS)
    assert np.array_equal(_stack_covered(plan, rows, cols, batch, item),
                          np.ones((batch, rows), dtype=np.int64))


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("rows,cols,batch,item", SHAPES)
def test_stack_plan_keeps_the_kernels_limits(rows, cols, batch, item, sms):
    """What launch_stack checks before it launches, its shared memory the
    plan's, and at least two blocks an SM."""
    plan = stack_plan(rows, cols, batch, item, sms)
    row_bytes = _row_bytes(cols, item)
    assert plan.RB > 0 and plan.row_blocks == -(-rows // plan.RB)
    assert plan.chunk > 0 and plan.chunk % 16 == 0
    assert 1 <= plan.slots <= _STACK_MAX_SLOTS
    assert plan.smem == _launch_smem(plan, cols, item)
    assert plan.smem <= SMEM_LIMIT
    assert 2 * (plan.smem + BLOCK_EXTRA) <= SM_SMEM
    # The last tile is ragged at most: no tile is empty.
    assert rows - (plan.row_blocks - 1) * plan.RB > 0
    if row_bytes <= _WHOLE_ROW_BYTES:
        assert plan.chunk >= row_bytes
        groups = -(-plan.RB // 8)
        assert plan.slots <= groups
        assert plan.slots >= min(groups, 2)
        if plan.slots > 2:
            assert plan.smem <= _STACK_WHOLE_SMEM
    else:
        # Parts of a multiple of 32 vectors (lane L keeps partial L), whole
        # groups of 8 rows a tile but the last.
        assert plan.chunk == _STACK_CHUNK_BYTES
        assert plan.chunk % (16 * 32) == 0 and plan.chunk < row_bytes
        assert plan.RB % 8 == 0 or plan.row_blocks == 1


@pytest.mark.parametrize("rows,cols,item", [
    (444, 757, 4), (757, 444, 4), (757, 444, 8)])
def test_stack_plan_fills_the_card_in_one_wave(rows, cols, item):
    """The distinct fleet's whole-row stacks: near four blocks an SM, no
    more than one wave; in fp32 four blocks fit an SM with every stage of
    a tile in flight at once (fp64 K' rings two stages)."""
    plan = stack_plan(rows, cols, 16, item, H100_SMS)
    blocks = plan.row_blocks * 16
    assert 3.5 * H100_SMS <= blocks <= 4 * H100_SMS
    if item == 4:
        assert plan.slots == -(-plan.RB // 8)
        assert 4 * (plan.smem + BLOCK_EXTRA) <= SM_SMEM
    else:
        assert plan.slots == 2


@pytest.mark.parametrize("rows,cols,batch,item", [
    (444, 757, 16, 8), (2000, 5000, 8, 4), (2000, 5000, 1, 8)])
def test_stack_plan_streams_long_rows_two_blocks_an_sm(rows, cols, batch,
                                                       item):
    """Rows longer than a stage: a ring of stages per block, two blocks an
    SM, at least a wave of them."""
    plan = stack_plan(rows, cols, batch, item, H100_SMS)
    assert plan.slots == 3
    assert 2 * (plan.smem + BLOCK_EXTRA) <= SM_SMEM
    assert plan.row_blocks * batch >= 1.5 * H100_SMS


def test_stack_plan_is_a_function_of_its_arguments():
    assert stack_plan(444, 757, 16, 4, 132) == stack_plan(444, 757, 16, 4,
                                                          132)
    assert stack_plan(444, 757, 16, 4, 132).RB < stack_plan(
        444, 757, 16, 4, 16).RB

