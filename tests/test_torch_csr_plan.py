"""The CSR kernel's route and partition (`tpdlp_torch/ops/_kernels.py::
csr_plan`, `csr_ring_plan`, `csr_chunks`, `csr_block_segments`), the CPU
twin of what `csrc/csr_matvec.cu` computes before it sums: the ring only
where every block of a wave streams several stages, every row in exactly
one chunk and one block's segment, chunks on row boundaries and a function
of the row offsets alone, and an index-level emulation of the kernel's ring
(one producer, eight consumer warps, stages of 1024 nonzeros, three slots)
under random interleavings, which shows that each lane sums exactly the
nonzeros of the one-pass walk in the same order, that no stage is read
after its slot was refilled, and that the ring never deadlocks.  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import random

import numpy as np
import pytest

from tpdlp_torch.ops._kernels import (
    _CSR_WARPS,
    csr_block_segments,
    csr_chunks,
    csr_group,
    csr_plan,
    csr_ring_plan,
)

H100_SMS = 132
#: A block's shared memory on Hopper.
SMEM_LIMIT = 227 * 1024


def _crow(lens):
    return np.concatenate([[0], np.cumsum(np.asarray(lens, dtype=np.int64))])


def _matrices():
    """Row lengths: uniform short rows, banded-like rows of 53-105, empty
    rows among short ones, a power law with rows longer than a stage and
    than the ring, one row, rows that straddle stage edges, no nonzero."""
    rng = np.random.default_rng(0)
    power = np.minimum((rng.pareto(1.2, 700) * 8).astype(np.int64), 6000)
    power[[5, 300]] = [4100, 1025]
    empties = rng.integers(0, 4, 3000)
    empties[rng.random(3000) < 0.4] = 0
    return {
        "short": rng.integers(1, 12, 2500),
        "banded": rng.integers(53, 106, 900),
        "empty rows": empties,
        "power law": power,
        "one row": np.array([3000]),
        "stage edges": np.full(40, 1023),
        "no nonzero": np.zeros(37, dtype=np.int64),
    }


MATRICES = _matrices()


@pytest.mark.parametrize("name", list(MATRICES))
def test_chunks_cover_every_row_once_on_row_boundaries(name):
    crow = _crow(MATRICES[name])
    rows, nnz = len(crow) - 1, int(crow[-1])
    plan = csr_ring_plan(rows, nnz, 4, 1, H100_SMS)
    chunks = csr_chunks(crow, plan.chunk_rows)
    seen = np.zeros(rows, dtype=np.int64)
    prev_end = 0
    for r0, r1, n0, n1 in chunks:
        assert r0 == prev_end and r1 > r0
        assert (n0, n1) == (crow[r0], crow[r1])
        seen[r0:r1] += 1
        prev_end = r1
    assert prev_end == rows and np.all(seen == 1)
    # Row offsets alone fix the chunks: the same rows and lengths in
    # another array give the same chunks, whatever the card.
    for sms in (1, 78, 132):
        other = csr_ring_plan(rows, nnz, 4, 1, sms)
        assert csr_chunks(list(crow), other.chunk_rows) == chunks


def test_zero_rows_have_no_chunk():
    assert csr_chunks(np.zeros(1, dtype=np.int64), 16) == []


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("batch,item", [(1, 4), (1, 8), (3, 4), (8, 8),
                                        (37, 4)])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_block_segments_cover_every_output_once(name, batch, item, sms):
    crow = _crow(MATRICES[name])
    rows, nnz = len(crow) - 1, int(crow[-1])
    plan = csr_ring_plan(rows, nnz, item, batch, sms)
    assert plan.path == "ring"
    assert plan.G == csr_group(rows, nnz)
    assert plan.chunks == len(csr_chunks(crow, plan.chunk_rows))
    assert 1 <= plan.grid <= plan.chunks * plan.tiles
    assert plan.smem <= SMEM_LIMIT
    count = np.zeros((plan.tiles, rows), dtype=np.int64)
    for b in range(plan.grid):
        segs = csr_block_segments(plan, rows, b)
        assert segs, "a block with nothing to do"
        for t, r0, r1 in segs:
            assert r0 % plan.chunk_rows == 0 and r0 < r1 <= rows
            count[t, r0:r1] += 1
    assert np.all(count == 1)


def test_plan_is_the_launchers_rule():
    """Four blocks an SM and four rows a lane group for one vector, two
    blocks an SM and one row for the batch axis, never more blocks than
    (tile, chunk) items; banded 100k and sparse-1M fill one wave."""
    p = csr_ring_plan(100_000, 10_497_244, 4, 1, H100_SMS)
    assert (p.G, p.R, p.chunk_rows, p.grid, p.tile) == (
        32, 4, 32, 4 * H100_SMS, 1)
    p = csr_ring_plan(1_000_000, 10_000_000, 4, 1, H100_SMS)
    assert (p.G, p.chunk_rows, p.grid) == (16, 64, 4 * H100_SMS)
    p = csr_ring_plan(20_000, 320_000, 4, 8, H100_SMS)
    assert (p.tile, p.tiles, p.R, p.grid) == (8, 1, 1, 2 * H100_SMS)
    assert csr_ring_plan(27, 200, 8, 10_000, H100_SMS).grid == 2 * H100_SMS
    assert csr_ring_plan(3, 7, 4, 1, H100_SMS).grid == 1
    assert csr_ring_plan(300, 9000, 8, 1, H100_SMS).smem == (
        3 * (1024 * 12 + 32))


@pytest.mark.parametrize("rows,nnz,item,batch,route", [
    (100_000, 10_497_244, 4, 1, "ring"),      # banded 100k K and K'
    (400_000, 10_000_000, 4, 1, "ring"),      # sparse-1M K
    (1_000_000, 10_000_000, 4, 1, "ring"),    # sparse-1M K'
    (100_000, 10_497_244, 8, 1, "ring"),      # banded 100k in fp64
    (8000, 320_000, 4, 1, "direct"),          # mittelmann-l K
    (20_000, 320_000, 8, 1, "direct"),        # mittelmann-l K' fp64
    (8000, 320_000, 4, 8, "direct"),          # mittelmann-l x 8
    (100_000, 10_497_244, 4, 8, "ring"),      # banded 100k x 8
    (27, 200, 4, 10_000, "direct"),           # afiro-class x 10,000
    (800, 3200, 4, 1, "direct"),              # the empty-segment LP
    (3, 0, 4, 1, "direct"),                   # no nonzero
])
def test_ring_only_where_every_block_streams_stages(rows, nnz, item, batch,
                                                    route):
    plan = csr_plan(rows, nnz, item, batch, H100_SMS)
    assert plan.path == route
    ring = csr_ring_plan(rows, nnz, item, batch, H100_SMS)
    per_sm = 4 if ring.tile == 1 else 2
    assert (nnz * ring.tiles >= 4 * 1024 * per_sm * H100_SMS) == (
        route == "ring")
    assert plan.G == ring.G == csr_group(rows, nnz)
    if route == "direct":  # one row a lane group: a block 256 / G pairs
        assert plan.grid == -(-rows * batch * plan.G // 256)
        assert plan.smem == 0
    else:
        assert plan == ring
    # A card of fewer SMs streams more a block: never a smaller route.
    assert csr_plan(rows, nnz, item, batch, 66).path in (
        (route,) if route == "ring" else ("ring", "direct"))


# ---------------------------------------------------------------------------
# The ring, emulated: the kernel's producer and consumer warps as
# generators of the actions they take, run in a random interleaving.
# ---------------------------------------------------------------------------


def _producer(crow, segs, stage_nnz):
    g = 0
    for _t, r0, r1 in segs:
        n0, n1 = int(crow[r0]), int(crow[r1])
        for s in range(-(-(n1 - n0) // stage_nnz)):
            yield ("fill", g, n0 + s * stage_nnz,
                   min(n0 + (s + 1) * stage_nnz, n1))
            g += 1


def _consumer(crow, segs, stage_nnz, warp, G, R, walked):
    """Consumer warp `warp` as the kernel runs it: batches of R slabs of
    32 / G rows, lane group gi owning row gi of each slab; each lane's
    nonzeros go to walked[(tile, row, lane)] in the order it sums them."""
    P = 32 // G
    base = 0
    for t, r0, r1 in segs:
        n0, n1 = int(crow[r0]), int(crow[r1])
        nst = -(-(n1 - n0) // stage_nnz)
        rel = base
        for rb in range(r0 + warp * R * P, r1, _CSR_WARPS * R * P):
            rows = [[rb + r * P + gi for r in range(R)] for gi in range(P)]
            beg = [[int(crow[min(row, r1)]) for row in g] for g in rows]
            end = [[int(crow[row + 1]) if row < r1 else b
                    for row, b in zip(g, bg)] for g, bg in zip(rows, beg)]
            bb, be = beg[0][0], end[-1][-1]
            if be <= bb:
                continue
            ks = base + (bb - n0) // stage_nnz
            ke = base + (be - 1 - n0) // stage_nnz
            while rel < ks:
                yield ("wait", rel)
                yield ("arrive", rel)
                rel += 1
            cur = {(gi, r, ln): beg[gi][r] + ln for gi in range(P)
                   for r in range(R) for ln in range(G)}
            for g in range(ks, ke + 1):
                yield ("wait", g)
                lo = n0 + (g - base) * stage_nnz
                for (gi, r, ln), k in cur.items():
                    lim = min(end[gi][r], lo + stage_nnz)
                    taken = []
                    while k < lim:
                        taken.append(k)
                        k += G
                    cur[(gi, r, ln)] = k
                    if taken:
                        yield ("read", g, taken)
                        walked.setdefault((t, rows[gi][r], ln),
                                          []).extend(taken)
                if g < ke:
                    yield ("arrive", g)
            rel = ke
        while rel < base + nst:
            yield ("wait", rel)
            yield ("arrive", rel)
            rel += 1
        base += nst


def _run_ring(crow, segs, plan, seed):
    """Run one block's producer and consumers in a random order under the
    mbarrier rules; returns each lane's walked nonzeros."""
    S, W = plan.stages, _CSR_WARPS
    slot_stage = [None] * S        # the stage a slot holds
    slot_span = [None] * S
    landed = set()                 # stages in their slots, landed
    filled = []
    arrivals = {}                  # stage -> consumer arrivals
    walked = {}
    actors = [("producer", _producer(crow, segs, plan.stage_nnz))]
    actors += [(f"warp {w}", _consumer(crow, segs, plan.stage_nnz, w,
                                       plan.G, plan.R, walked))
               for w in range(W)]
    pending = {name: next(gen, None) for name, gen in actors}
    gens = dict(actors)
    rng = random.Random(seed)
    while any(a is not None for a in pending.values()):
        ready = []
        for name, act in pending.items():
            if act is None:
                continue
            kind, g = act[0], act[1]
            if kind == "fill":
                ok = g < S or arrivals.get(g - S, 0) == W
            elif kind == "wait":
                ok = g in landed
            else:
                ok = True
            if ok:
                ready.append(name)
        assert ready, f"deadlock: {pending}"
        name = rng.choice(ready)
        act = pending[name]
        kind, g = act[0], act[1]
        slot = g % S
        if kind == "fill":
            assert g < S or slot_stage[slot] == g - S
            slot_stage[slot], slot_span[slot] = g, act[2:]
            landed.add(g)
            landed.discard(g - S)
            filled.append(g)
        elif kind == "wait":
            assert slot_stage[slot] == g
        elif kind == "arrive":
            assert slot_stage[slot] == g, "released a stage it never saw"
            arrivals[g] = arrivals.get(g, 0) + 1
            assert arrivals[g] <= W, "a slot's arrivals ran a round ahead"
        elif kind == "read":
            lo, hi = slot_span[slot]
            assert slot_stage[slot] == g, "read a refilled slot"
            assert all(lo <= k < hi for k in act[2])
        pending[name] = next(gens[name], None)
    assert all(arrivals.get(g, 0) == W for g in filled)
    return walked


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("batch,sms", [(1, 1), (1, 3), (10, 2), (1, 132)])
def test_ring_walk_is_the_one_pass_walk(name, batch, sms):
    crow = _crow(MATRICES[name])
    rows, nnz = len(crow) - 1, int(crow[-1])
    plan = csr_ring_plan(rows, nnz, 4, batch, sms)
    walked = {}
    for b in range(plan.grid):
        segs = csr_block_segments(plan, rows, b)
        walked.update(_run_ring(crow, segs, plan, seed=b))
    want = {}
    for t in range(plan.tiles):
        for r in range(rows):
            for ln in range(plan.G):
                ks = list(range(int(crow[r]) + ln, int(crow[r + 1]), plan.G))
                if ks:
                    want[(t, r, ln)] = ks
    assert walked == want


def test_loader_binds_only_entry_points_the_sources_define(monkeypatch):
    """`_kernels._load` binds every C entry point by name; each must be one
    that csrc/*.cu defines (a misspelt name only fails on the card, at the
    first product)."""
    import re

    from tpdlp_torch.ops import _kernels

    defined = set()
    for path in _kernels.CSRC.glob("*.cu"):
        defined |= set(re.findall(r"^(?:int|const char\*) (tpdlp_\w+)\(",
                                  path.read_text(), flags=re.M))
    bound = []

    class FakeLib:
        def __getattr__(self, name):
            if name not in defined:
                raise AttributeError(f"undefined symbol: {name}")
            bound.append(name)
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "build", lambda: "fake.so")
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: FakeLib())
    _kernels._load()
    assert {"tpdlp_csr_matvec_ring_f32", "tpdlp_csr_matvec_ring_batch_f64",
            "tpdlp_csr_matvec_f32", "tpdlp_csr_matvec_batch_f64"} <= set(bound)
    # Every route's entry is bound for both dtypes, single and batch.
    for infix in _kernels._CSR_ENTRY.values():
        for t in ("f32", "f64"):
            assert f"tpdlp_csr_matvec{infix}_{t}" in bound
            assert f"tpdlp_csr_matvec{infix}_batch_{t}" in bound
