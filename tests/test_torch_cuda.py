"""The port's CUDA kernels on the card, against their plain PyTorch twins,
and the paths that need the card to mean anything: the autotune timed on
the device, the escalated 1e-8 solves.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode; the CPU tests hold the twins against the JAX package).
"""

import numpy as np
import pytest
import torch

import tpdlp_torch
from tpdlp_torch.bench.suite import build_suite
from tpdlp_torch.ops import _kernels
from tpdlp_torch.ops._kernels import (
    band_matvec,
    band_matvec_plain,
    dense_matvec,
    dense_matvec_plain,
)
from tpdlp_torch.ops.band import BandOp
from tpdlp_torch.ops.exact_dense import ExactDenseOp, pad_rows

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _tol(n, dtype):
    # tests/test_pallas_dense.py's accumulation scale, per dtype.
    eps = 6e-8 if dtype == torch.float32 else 1.2e-16
    return eps * max(4, n) ** 0.5 * 30


def _check_dense(M, x):
    """One launch per call, the twin's values within tolerance, and
    bit-identical repeats."""
    before = _kernels.launches["dense_matvec"]
    y = dense_matvec(M, x)
    assert _kernels.launches["dense_matvec"] == before + 1
    ref = dense_matvec_plain(M, x)
    assert y.shape == (M.shape[0],) and y.dtype == M.dtype
    assert bool(torch.isfinite(y).all())
    rel = float(((y - ref).abs() / (1 + ref.abs())).max())
    assert rel < _tol(M.shape[1], M.dtype), rel
    assert torch.equal(y, dense_matvec(M, x))
    assert _kernels.launches["dense_matvec"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(card, dtype):
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    # The path's shapes, and the edges of the kernel's tiles: rows past a
    # tile with cols % 4 != 0 (2001 x 5003), a row longer than any stage
    # (3 x 70001), short rows several to a warp (20000 x 8).
    for m, n in [(27, 51), (1, 1), (257, 2049), (16, 9000), (2000, 5000),
                 (5000, 2000), (2001, 5003), (3, 70001), (20000, 8)]:
        M = pad_rows(torch.randn((m, n), generator=gen, dtype=dtype,
                                 device=card))[:, :n]
        _check_dense(M, torch.randn((n,), generator=gen, dtype=dtype,
                                    device=card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_never_reads_padding_on_card(card, dtype):
    """NaN in the row stride's padding and past the end of x: the kernel
    may copy a row up to its stride but uses no value at or past cols."""
    gen = torch.Generator(device=card)
    gen.manual_seed(6)
    for m, n, ld in [(37, 5003, 5012), (2000, 1, 8), (9, 4097, 4104)]:
        full = torch.full((m, ld), float("nan"), dtype=dtype, device=card)
        full[:, :n] = torch.randn((m, n), generator=gen, dtype=dtype,
                                  device=card)
        xbuf = torch.full((n + 8,), float("nan"), dtype=dtype, device=card)
        xbuf[:n] = torch.randn((n,), generator=gen, dtype=dtype, device=card)
        _check_dense(full[:, :n], xbuf[:n])


def test_kernel_rejects_what_it_does_not_take(card):
    M = torch.zeros((8, 6), device=card)  # row stride 6: not a multiple of 4
    x = torch.zeros((6,), device=card)
    before = _kernels.launches["dense_matvec"]
    with pytest.raises(ValueError, match="stride"):
        dense_matvec(M, x)
    with pytest.raises(TypeError):
        dense_matvec(torch.zeros((8, 8), dtype=torch.float16, device=card),
                     torch.zeros((8,), dtype=torch.float16, device=card))
    with pytest.raises(ValueError, match="same CUDA device"):
        dense_matvec(torch.zeros((8, 8), device=card), torch.zeros(8))
    assert _kernels.launches["dense_matvec"] == before


def test_operator_products_run_the_kernel(card):
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    K = torch.randn((37, 53), generator=gen, device=card)
    op = ExactDenseOp.build(K)
    before = _kernels.launches["dense_matvec"]
    y = op.mv(torch.ones(53, device=card))
    kty = op.rmv(torch.ones(37, device=card))
    assert _kernels.launches["dense_matvec"] == before + 2
    torch.testing.assert_close(y, K.sum(1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kty, K.sum(0), rtol=1e-5, atol=1e-5)


def test_solve_on_card_agrees_with_cpu(card):
    """A small solve in fp64 on the card (kernel) and on the CPU (twin):
    same status, objective to 1e-9 (the two sum in different orders)."""
    (p,) = build_suite(("small",), names=("sc50-class",))
    cfg = tpdlp_torch.SolverConfig(tol=1e-6, scaling="ruiz", adaptive=False,
                                   primal_weight_update=True)
    before = _kernels.launches["dense_matvec"]
    rg = tpdlp_torch.solve(p, cfg, dtype=torch.float64)
    assert _kernels.launches["dense_matvec"] > before
    rc = tpdlp_torch.solve(p, cfg, dtype=torch.float64, device="cpu")
    assert rg.status == rc.status == tpdlp_torch.Status.SOLVED
    assert abs(rg.objective - rc.objective) <= 1e-9 * (1 + abs(rc.objective))


def _random_band(m, n, WB, dtype, gen, device):
    """Random slabs (ngroups, 128, WB) and 128-aligned starts with the band
    layout's invariants (ngroups a multiple of 8, start + WB <= n_pad)."""
    ngroups = -(-(-(-m // 128)) // 8) * 8
    n_pad = -(-n // 128) * 128
    starts = torch.randint(0, (n_pad - WB) // 128 + 1, (ngroups,),
                           generator=gen, device=device) * 128
    slabs = torch.randn((ngroups, 128, WB), generator=gen, dtype=dtype,
                        device=device)
    return slabs, starts.to(torch.int32)


def _check_band(slabs, starts, x, m, n):
    before = _kernels.launches["band_matvec"]
    y = band_matvec(slabs, starts, x, m, n)
    assert _kernels.launches["band_matvec"] == before + 1
    ref = band_matvec_plain(slabs, starts, x, m, n)
    assert y.shape == (m,) and y.dtype == slabs.dtype
    assert bool(torch.isfinite(y).all())
    rel = float(((y - ref).abs() / (1 + ref.abs())).max())
    assert rel < _tol(slabs.shape[2], slabs.dtype), rel
    assert torch.equal(y, band_matvec(slabs, starts, x, m, n))
    assert _kernels.launches["band_matvec"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_kernel_matches_plain_on_card(card, dtype):
    gen = torch.Generator(device=card)
    gen.manual_seed(2)
    # (100000, 100000, 384) has 782 row groups, several for each block of
    # the persistent grid; (20003, 3001, 2048) holds the widest rows.
    for m, n, WB in [(1, 1, 128), (300, 260, 384), (5001, 777, 128),
                     (20003, 3001, 2048), (100000, 100000, 384)]:
        slabs, starts = _random_band(m, n, WB, dtype, gen, card)
        _check_band(slabs, starts, torch.randn((n,), generator=gen,
                                               dtype=dtype, device=card),
                    m, n)


def test_band_kernel_rejects_what_it_does_not_take(card):
    slabs = torch.zeros((8, 128, 128), device=card)
    starts = torch.zeros(8, dtype=torch.int32, device=card)
    x = torch.zeros(100, device=card)
    before = _kernels.launches["band_matvec"]
    with pytest.raises(TypeError, match="int32"):
        band_matvec(slabs, starts.long(), x, 1000, 100)
    with pytest.raises(TypeError):
        band_matvec(slabs.double(), starts, x, 1000, 100)
    with pytest.raises(ValueError, match="window"):
        band_matvec(torch.zeros((8, 128, 126), device=card), starts, x, 1000,
                    100)
    with pytest.raises(ValueError, match="row groups"):
        band_matvec(slabs, starts, x, 1025, 100)
    with pytest.raises(ValueError, match="same CUDA device"):
        band_matvec(slabs, starts, torch.zeros(100), 1000, 100)
    with pytest.raises(ValueError, match="contiguous"):
        band_matvec(slabs.transpose(1, 2).contiguous().transpose(1, 2),
                    starts, x, 1000, 100)
    assert _kernels.launches["band_matvec"] == before


def test_band_operator_products_run_the_kernel(card):
    p = tpdlp_torch.generate_banded_lp(n=700, m_ineq=300, m_eq=200,
                                       bandwidth=33, seed=3)
    op = BandOp.from_scipy(p.K, torch.float64)
    assert op.device.type == "cuda"
    before = dict(_kernels.launches)
    y = op.mv(torch.ones(700, dtype=torch.float64, device=card))
    kty = op.rmv(torch.ones(500, dtype=torch.float64, device=card))
    assert _kernels.launches["band_matvec"] == before["band_matvec"] + 2
    assert _kernels.launches["dense_matvec"] == before["dense_matvec"]
    K = torch.as_tensor(p.K.toarray(), device=card)
    torch.testing.assert_close(y, K.sum(1), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(kty, K.sum(0), rtol=1e-12, atol=1e-12)


def test_band_solve_on_card_agrees_with_cpu(card):
    """A small band solve in fp64 on the card (kernel) and on the CPU
    (twin): same status, objective to 1e-9."""
    p = tpdlp_torch.generate_banded_lp(n=768, m_ineq=384, m_eq=192,
                                       bandwidth=33, seed=4)
    cfg = tpdlp_torch.SolverConfig(tol=1e-6, scaling="ruiz", adaptive=False,
                                   primal_weight_update=True)
    before = _kernels.launches["band_matvec"]
    rg = tpdlp_torch.solve(p, cfg, dtype=torch.float64,
                           matrix_format="band")
    assert _kernels.launches["band_matvec"] > before
    rc = tpdlp_torch.solve(p, cfg, dtype=torch.float64, device="cpu",
                           matrix_format="band")
    assert rg.status == rc.status == tpdlp_torch.Status.SOLVED
    assert abs(rg.objective - rc.objective) <= 1e-9 * (1 + abs(rc.objective))


@pytest.mark.parametrize("m,n,WB,dtype", [
    (1000, 3001, 384, torch.float32),     # m % 128 != 0, n % 4 != 0
    (20003, 4099, 2048, torch.float64),   # the widest row: one per stage
    (3001, 2053, 128, torch.float32),     # the narrowest window
])
def test_band_kernel_edges_on_card(card, m, n, WB, dtype):
    """Slab rows at or past m hold NaN and are never read; the last group's
    window runs past n, where x's buffer holds NaN (x counts as zero)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    slabs, starts = _random_band(m, n, WB, dtype, gen, card)
    n_pad = -(-n // 128) * 128
    starts[-(-m // 128) - 1] = n_pad - WB
    slabs.view(-1, WB)[m:] = float("nan")
    xbuf = torch.full((n + 16,), float("nan"), dtype=dtype, device=card)
    xbuf[:n] = torch.randn((n,), generator=gen, dtype=dtype, device=card)
    _check_band(slabs, starts, xbuf[:n], m, n)


def test_dense_solve_on_card_replays_bit_for_bit(card):
    """mittelmann-s in fp32 on the card twice: the kernels' fixed reduction
    order gives the same k and a bit-identical objective."""
    (p,) = build_suite(("large",), names=("mittelmann-s",))
    cfg = tpdlp_torch.SolverConfig(tol=1e-4, scaling="ruiz", adaptive=True,
                                   primal_weight_update=True)
    runs = [tpdlp_torch.solve(p, cfg, dtype=torch.float32, seed=0)
            for _ in range(2)]
    assert runs[0].status == tpdlp_torch.Status.SOLVED
    assert runs[0].iterations == runs[1].iterations
    assert runs[0].objective == runs[1].objective
    assert np.array_equal(runs[0].x, runs[1].x)
    assert np.array_equal(runs[0].y, runs[1].y)


def _banded_8192():
    return tpdlp_torch.generate_banded_lp(n=8192, m_ineq=4096, m_eq=2048,
                                          bandwidth=65, seed=2)


@pytest.mark.parametrize("fmt", ["dense", "band"])
def test_certificates_and_periter_on_card(card, fmt):
    """fp32 on the card, the main path's settings: the certificate-on solve
    replays bit for bit, and it and the per-iteration solve give the blocked
    solve's k, n, x and y bits; the certificates add one KKT pass per
    iteration from k = 2 on (j = j_blocked + k - 1)."""
    if fmt == "dense":
        (p,) = build_suite(("medium",), names=("maros-class",))
    else:
        p = _banded_8192()
    base = dict(tol=1e-4, scaling="ruiz", adaptive=True,
                primal_weight_update=True)

    def run(**extra):
        return tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**base, **extra),
                                 dtype=torch.float32, seed=0,
                                 matrix_format=fmt)

    rb = run()
    certs = [run(infeasibility_detect=True, normalized_certificates=True)
             for _ in range(2)]
    rp = run(loop_mode="periter")
    assert rb.status == tpdlp_torch.Status.SOLVED
    for r in (*certs, rp):
        assert r.status == rb.status
        assert (r.iterations, r.restarts) == (rb.iterations, rb.restarts)
        assert r.objective == rb.objective
        assert np.array_equal(r.x, rb.x) and np.array_equal(r.y, rb.y)
    assert rp.kkt_passes == rb.kkt_passes
    assert certs[0].kkt_passes == certs[1].kkt_passes == (
        rb.kkt_passes + rb.iterations - 1)


def test_certificates_fire_on_card(card):
    """The planted rows of the battery the JAX package certifies: an
    unbounded LP in fp32 and an infeasible one in fp64, through K1."""
    cfg = tpdlp_torch.SolverConfig(
        tol=1e-6, scaling="ruiz", adaptive=True, primal_weight_update=True,
        infeasibility_detect=True, normalized_certificates=True)
    before = _kernels.launches["dense_matvec"]
    ru = tpdlp_torch.solve(tpdlp_torch.generate_unbounded_lp(seed=0), cfg,
                           dtype=torch.float32)
    ri = tpdlp_torch.solve(tpdlp_torch.generate_infeasible_lp(seed=0), cfg,
                           dtype=torch.float64)
    assert _kernels.launches["dense_matvec"] > before
    assert ru.status == tpdlp_torch.Status.DUAL_INFEASIBLE
    assert ri.status == tpdlp_torch.Status.PRIMAL_INFEASIBLE


# ---------------------------------------------------------------------------
# The sparse layouts: CSR (csr_matvec) and block-ELL on the card
# ---------------------------------------------------------------------------

def _random_sparse(m, n, density, seed):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    K = sp.random(m, n, density=density, random_state=rng, format="csr")
    K.data = rng.standard_normal(K.nnz)
    return K


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_kernel_matches_plain_on_card(card, dtype):
    """Every lane-group size (rows of 1 to 200 nonzeros on average), empty
    rows included: the twin's values within tolerance, one launch a call,
    bit-identical repeats."""
    for m, n, density in [(37, 23, 0.2), (1, 1, 1.0), (5000, 40, 0.02),
                          (3000, 2000, 0.004), (500, 4000, 0.01),
                          (200, 20000, 0.01), (7, 50000, 0.004)]:
        K = _random_sparse(m, n, density, seed=m)
        crow = torch.as_tensor(K.indptr.astype(np.int32), device=card)
        col = torch.as_tensor(K.indices.astype(np.int32), device=card)
        val = torch.as_tensor(K.data, dtype=dtype, device=card)
        x = torch.randn(n, dtype=dtype, device=card)
        before = _kernels.launches["csr_matvec"]
        y = _kernels.csr_matvec(crow, col, val, x)
        assert _kernels.launches["csr_matvec"] == before + 1
        ref = _kernels.csr_matvec_plain(crow, col, val, x)
        rel = float(((y - ref).abs() / (1 + ref.abs())).max())
        assert rel < _tol(max(1, K.nnz // max(m, 1)), dtype), (m, n, rel)
        assert torch.equal(y, _kernels.csr_matvec(crow, col, val, x))


def _csr_on_card(K, dtype, card):
    return (torch.as_tensor(K.indptr.astype(np.int32), device=card),
            torch.as_tensor(K.indices.astype(np.int32), device=card),
            torch.as_tensor(K.data, dtype=dtype, device=card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_kernel_keeps_its_bits_on_ragged_rows_on_card(card, dtype):
    """The CSR kernel gives the same bits launch after launch, within the
    plain twin's tolerance: rows of some 10 nonzeros (sparse-1M's K'),
    mostly empty rows, one row of 1000 nonzeros beside rows of 1; and on
    the batch axis element b is bit for bit a single launch."""
    import scipy.sparse as sp

    gen = torch.Generator(device=card)
    gen.manual_seed(17)
    rng = np.random.default_rng(17)
    lens = np.ones(2003, dtype=np.int64)
    lens[1001] = 1000
    indptr = np.concatenate([[0], np.cumsum(lens)])
    spike = sp.csr_matrix((rng.standard_normal(indptr[-1]),
                           rng.integers(0, 5000, indptr[-1]), indptr),
                          shape=(2003, 5000))
    mats = [_random_sparse(100_003, 50_000, 2e-4, seed=1),
            _random_sparse(5001, 40, 0.02, seed=2), spike]
    for K in mats:
        crow, col, val = _csr_on_card(K, dtype, card)
        m, n = K.shape
        x = torch.randn((n,), generator=gen, dtype=dtype, device=card)
        y = _kernels.csr_matvec(crow, col, val, x)
        ref = _kernels.csr_matvec_plain(crow, col, val, x)
        rel = float(((y - ref).abs() / (1 + ref.abs())).max())
        assert rel < _tol(int(np.diff(K.indptr).max()), dtype), (m, rel)
        assert torch.equal(_bits(_kernels.csr_matvec(crow, col, val, x)),
                           _bits(y))
    K = _random_sparse(20_000, 8000, 1e-3, seed=3)
    crow, col, val = _csr_on_card(K, dtype, card)
    X = torch.randn((64, 8000), generator=gen, dtype=dtype, device=card)
    _per_element(lambda X: _kernels.csr_matvec_batch(crow, col, val, X),
                 lambda x: _kernels.csr_matvec(crow, col, val, x), X,
                 "csr_matvec",
                 lambda X: _kernels.csr_matvec_batch_plain(crow, col, val, X))


def _csr_from_lengths(lens, cols, seed):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    K = sp.csr_matrix((rng.standard_normal(indptr[-1]),
                       rng.integers(0, cols, indptr[-1]), indptr),
                      shape=(len(lens), cols))
    K.sort_indices()
    return K


def _ring_sized(K, batch, card):
    """K, which csr_plan sends the direct route at `batch` right-hand
    sides, stacked on itself until it goes through the ring (a wave of
    blocks streams several stages each) at one; the copies keep K's mean
    row length, so G, and with it every row's order, stays K's."""
    import scipy.sparse as sp

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert _kernels.csr_plan(K.shape[0], K.nnz, 8, batch,
                             sms).path == "direct"
    copies = 2
    while _kernels.csr_plan(K.shape[0] * copies, K.nnz * copies, 8, 1,
                            sms).path != "ring":
        copies *= 2
    big = sp.vstack([K] * copies, format="csr")
    assert _kernels.csr_group(big.shape[0], big.nnz) == _kernels.csr_group(
        K.shape[0], K.nnz)
    return big, copies


def _ring_cases():
    """Row lengths the ring must walk across stages: banded rows of 53-105
    nonzeros, power-law rows up to 9000 (longer than a stage and than the
    ring), rows of 1023 that straddle every stage edge, chunks ending on
    empty rows."""
    import scipy.sparse as sp

    rng = np.random.default_rng(29)
    n = 30_000
    band_lens = rng.integers(53, 106, 4000)
    banded = sp.csr_matrix(
        (rng.standard_normal(band_lens.sum()),
         np.concatenate([np.clip(r * 7 - 50 + np.arange(k), 0, n - 1)
                         for r, k in enumerate(band_lens)]),
         np.concatenate([[0], np.cumsum(band_lens)])), shape=(4000, n))
    banded.sum_duplicates()
    power = np.minimum((rng.pareto(1.2, 3000) * 8).astype(np.int64), 9000)
    power[[7, 1500]] = [9000, 4100]
    holes = rng.integers(0, 40, 5000)
    holes[rng.random(5000) < 0.5] = 0
    return n, [banded, _csr_from_lengths(power, n, 1),
               _csr_from_lengths(np.full(300, 1023), n, 2),
               _csr_from_lengths(holes, n, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_ring_matches_plain_and_repeats_on_card(card, dtype):
    """The ring route of csrc/csr_matvec.cu on _ring_cases stacked to the
    ring's size: the twin's values within tolerance, bit-identical
    repeats, values and column indices from views that start off a
    16-byte boundary giving the same bits, and every copy's rows the bits
    of the direct route's launch on the one matrix."""
    gen = torch.Generator(device=card)
    gen.manual_seed(29)
    n, mats = _ring_cases()
    for K in mats:
        big, copies = _ring_sized(K, 1, card)
        x = torch.randn((n,), generator=gen, dtype=dtype, device=card)
        crow, col, val = _csr_on_card(big, dtype, card)
        before = _kernels.launches["csr_matvec"]
        y = _kernels.csr_matvec(crow, col, val, x)
        assert _kernels.launches["csr_matvec"] == before + 1
        ref = _kernels.csr_matvec_plain(crow, col, val, x)
        rel = float(((y - ref).abs() / (1 + ref.abs())).max())
        assert rel < _tol(int(np.diff(K.indptr).max()), dtype), rel
        assert torch.equal(_bits(_kernels.csr_matvec(crow, col, val, x)),
                           _bits(y))
        for shift in (1, 3):
            vb = torch.zeros(val.numel() + 4, dtype=dtype, device=card)
            cb = torch.zeros(col.numel() + 4, dtype=torch.int32,
                             device=card)
            v, c = vb[shift:shift + val.numel()], cb[shift:shift + col.numel()]
            v.copy_(val)
            c.copy_(col)
            assert torch.equal(_bits(_kernels.csr_matvec(crow, c, v, x)),
                               _bits(y))
        small = _kernels.csr_matvec(*_csr_on_card(K, dtype, card), x)
        assert torch.equal(_bits(y).view(copies, -1),
                           _bits(small).expand(copies, -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_ring_batch_equals_single_launches_on_card(card, dtype):
    """The batch axis on the ring: power-law rows across stages, stacked to
    the ring's size, at B = 8 (one tile) and 19 (a ragged tile), each
    element bit for bit its single launch, and every copy's rows the bits
    of the direct route's batch on the one matrix."""
    rng = np.random.default_rng(31)
    power = np.minimum((rng.pareto(1.2, 2000) * 8).astype(np.int64), 5000)
    power[3] = 5000
    K = _csr_from_lengths(power, 7000, 4)
    big, copies = _ring_sized(K, 19, card)
    crow, col, val = _csr_on_card(big, dtype, card)
    small = _csr_on_card(K, dtype, card)
    gen = torch.Generator(device=card)
    gen.manual_seed(31)
    for B in (8, 19):
        X = torch.randn((B, 7000), generator=gen, dtype=dtype, device=card)
        _per_element(
            lambda X: _kernels.csr_matvec_batch(crow, col, val, X),
            lambda x: _kernels.csr_matvec(crow, col, val, x), X,
            "csr_matvec",
            lambda X: _kernels.csr_matvec_batch_plain(crow, col, val, X))
        Y = _kernels.csr_matvec_batch(crow, col, val, X)
        Ys = _kernels.csr_matvec_batch(*small, X)
        assert torch.equal(_bits(Y).view(B, copies, -1),
                           _bits(Ys)[:, None, :].expand(B, copies, -1))


def test_csr_kernel_rejects_what_it_does_not_take(card):
    crow = torch.tensor([0, 1], dtype=torch.int32, device=card)
    col = torch.tensor([0], dtype=torch.int32, device=card)
    val = torch.ones(1, device=card)
    before = _kernels.launches["csr_matvec"]
    with pytest.raises(TypeError, match="int32"):
        _kernels.csr_matvec(crow.long(), col, val, torch.ones(1, device=card))
    with pytest.raises(TypeError, match="float32 or float64"):
        _kernels.csr_matvec(crow, col, val.half(),
                            torch.ones(1, device=card).half())
    with pytest.raises(ValueError, match="same CUDA device"):
        _kernels.csr_matvec(crow, col, val, torch.ones(1))
    assert _kernels.launches["csr_matvec"] == before


@pytest.mark.parametrize("layout", ["sparse", "blocked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sparse_layouts_on_card_match_cpu_fp64(card, layout, dtype):
    """Products, norms and scaling on the card against the operator's own
    fp64 result on the CPU; two identical products and norms on the card
    are bit-identical (no atomics in the sums)."""
    from tpdlp_torch.ops.blocked import BlockEllOp
    from tpdlp_torch.ops.sparse import SparseOp

    cls = {"sparse": SparseOp, "blocked": BlockEllOp}[layout]
    K = _random_sparse(700, 1300, 0.01, seed=5)
    K[3, :] = 0.0  # an empty row
    K.eliminate_zeros()
    op = cls.from_scipy(K, dtype, device=card)
    ref = cls.from_scipy(K, torch.float64, device="cpu")
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal(1300), rng.standard_normal(700)
    dr, dc = rng.uniform(0.5, 2, 700), rng.uniform(0.5, 2, 1300)

    def on(v):
        return torch.as_tensor(v, dtype=dtype, device=card)

    def cpu(v):
        return torch.as_tensor(v, dtype=torch.float64)

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    before = _kernels.launches["csr_matvec"]
    for got, want in (
            (op.mv(on(x)), ref.mv(cpu(x))),
            (op.rmv(on(y)), ref.rmv(cpu(y))),
            (op.row_abs_norms("inf"), ref.row_abs_norms("inf")),
            (op.col_abs_norms(2.0), ref.col_abs_norms(2.0)),
            (op.scale(on(dr), on(dc)).mv(on(x)),
             ref.scale(cpu(dr), cpu(dc)).mv(cpu(x)))):
        np.testing.assert_allclose(got.cpu().double().numpy(), want.numpy(),
                                   rtol=tol, atol=tol)
    launched = _kernels.launches["csr_matvec"] - before
    assert launched == (3 if layout == "sparse" else 0)
    assert float(op.row_abs_norms("inf")[3]) == 0.0
    for f in (lambda: op.mv(on(x)), lambda: op.rmv(on(y)),
              lambda: op.row_abs_norms("inf"),
              lambda: op.col_abs_norms(1.0)):
        assert torch.equal(f(), f())


def test_sparse_and_auto_solves_on_card(card):
    """mittelmann-s in fp32 through "sparse" twice (bit-identical, the
    kernel's launches only) and through "auto": Solved, objectives within
    the tolerance of the dense path's."""
    (p,) = build_suite(("large",), names=("mittelmann-s",))
    cfg = tpdlp_torch.SolverConfig(tol=1e-4, scaling="ruiz", adaptive=True,
                                   primal_weight_update=True)
    _kernels.reset_launches()
    runs = [tpdlp_torch.solve(p, cfg, dtype=torch.float32, seed=0,
                              matrix_format="sparse") for _ in range(2)]
    assert _kernels.launches["csr_matvec"] > 0
    assert _kernels.launches["dense_matvec"] == 0
    assert runs[0].status == tpdlp_torch.Status.SOLVED
    assert (runs[0].iterations, runs[0].objective) == (
        runs[1].iterations, runs[1].objective)
    assert np.array_equal(runs[0].x, runs[1].x)
    dense = tpdlp_torch.solve(p, cfg, dtype=torch.float32, seed=0)
    auto = tpdlp_torch.solve(p, cfg, dtype=torch.float32, seed=0,
                             matrix_format="auto")
    for r in (dense, auto):
        assert r.status == tpdlp_torch.Status.SOLVED
        assert abs(r.objective - runs[0].objective) <= 5e-4 * (
            1 + abs(r.objective))


def test_auto_picks_one_layout_on_banded_100k(card):
    """The autotune times its candidates on the card (captured chains,
    CUDA events): on the banded 100k instance three calls choose the same
    layout."""
    from tpdlp_torch.ops.autotune import choose_operator

    p = tpdlp_torch.generate_banded_lp(n=100_000, m_ineq=75_000,
                                       m_eq=25_000, bandwidth=105, seed=0)
    labels, seen = [], []
    for _ in range(3):
        timings = {}
        op, label = choose_operator(p.K, torch.float32, device=card,
                                    timings=timings)
        assert {"band", "sparse"} <= set(timings)
        assert label == min(timings, key=timings.get)
        labels.append(label)
        seen.append(timings)
        del op
    assert len(set(labels)) == 1, (labels, seen)


def test_captured_autotune_chain_launches_equal_the_formula(card):
    """A timing by captured chains counts each replay as the graph's
    launches, and the capture itself as none: autotune_launches per timed
    operator with a kernel; the graphs' pool is freed afterwards."""
    from tpdlp_torch.ops import autotune as A
    from tpdlp_torch.ops.sparse import SparseOp

    rng = np.random.default_rng(0)
    M = rng.standard_normal((300, 500)) * (rng.random((300, 500)) < 0.05)
    for op, kernel in ((ExactDenseOp.build(torch.as_tensor(
            M, dtype=torch.float32, device=card)), "dense_matvec"),
            (SparseOp.from_scipy(M, torch.float32, device=card),
             "csr_matvec")):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        seconds = A._time_op(op, kkt_passes=10)
        assert seconds > 0
        assert _kernels.launches[kernel] == A.autotune_launches(1, 10)
        assert sum(_kernels.launches.values()) == _kernels.launches[kernel]


def test_refine_1e8_on_card_is_certified(card):
    """dtype=None at tol 1e-8 on CUDA runs iterative refinement (fp32
    device solves) and returns a point whose fp64 host residuals meet the
    criteria."""
    from tpdlp_torch.solver.refine import host_residuals

    p = tpdlp_torch.generate_feasible_lp(n=60, m_ineq=35, m_eq=12, seed=11)
    tol = 1e-8
    r = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(
        tol=tol, scaling="ruiz", adaptive=True, primal_weight_update=True,
        max_kkt=400_000))
    assert r.status == tpdlp_torch.Status.SOLVED, r.status_string
    assert r.escalation["route"] == "refine"
    assert all(s["dtype"] == "float32" for s in r.escalation["stages"])
    assert sum(s["launches"]["dense_matvec"]
               for s in r.escalation["stages"]) > 0
    K = p.K.tocsr().astype(np.float64)
    res = host_residuals(K, p.c, p.q, p.l, p.u, p.m_ineq,
                         np.asarray(r.x, float), np.asarray(r.y, float))
    assert res.primal_res <= tol * (1 + np.linalg.norm(p.q))
    assert res.dual_res <= tol * (1 + np.linalg.norm(p.c))
    assert res.gap <= tol * (1 + abs(res.prim_obj) + abs(res.adjusted_dual))


def test_fp64_tail_on_card_runs_both_dtypes(card):
    """escalation_mode="fp64_tail" on CUDA: an fp32 stage, then an fp64
    stage on K1's fp64 variant."""
    p = tpdlp_torch.generate_feasible_lp(n=60, m_ineq=35, m_eq=12, seed=11)
    r = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(
        tol=1e-8, scaling="ruiz", adaptive=True, primal_weight_update=True,
        max_kkt=400_000, escalation_mode="fp64_tail"))
    stages = r.escalation["stages"]
    assert [s["dtype"] for s in stages] == ["float32", "float64"]
    assert all(s["launches"]["dense_matvec"] > 0 for s in stages)
    assert r.status == tpdlp_torch.Status.SOLVED, r.status_string


# ---------------------------------------------------------------------------
# The kernels' batch axis (tpdlp_torch/batch): one launch for a fleet, each
# element bit for bit a single launch on it.
# ---------------------------------------------------------------------------


def _per_element(fn_batch, fn_single, X, name, twin):
    """One batched launch: one count, bit-identical repeats, the twin's
    values within tolerance, and element b equal to a single launch on b."""
    before = _kernels.launches[name + "_batch"]
    Y = fn_batch(X)
    assert _kernels.launches[name + "_batch"] == before + 1
    assert torch.equal(Y, fn_batch(X))
    assert bool(torch.isfinite(Y).all())
    ref = twin(X)
    rel = float(((Y - ref).abs() / (1 + ref.abs())).max())
    assert rel < _tol(X.shape[1], X.dtype), rel
    # A single launch takes a 16-byte-aligned x: each element's own copy.
    singles = torch.stack([fn_single(X[b].clone())
                           for b in range(X.shape[0])])
    assert torch.equal(_bits(Y), _bits(singles))


def _bits(t):
    """The tensor's bits, so that -0.0 and +0.0 (or NaN payloads) count as
    different."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_batch_kernel_equals_single_launches_on_card(card, dtype):
    """A shared K at B = 1, a ragged B = 37 and the 10,000-element afiro
    batch; a stack of distinct K with the padded row stride; K' too."""
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    (p,) = build_suite(("small",), names=("afiro-class",))
    afiro = ExactDenseOp.build(torch.as_tensor(p.K.toarray(), dtype=dtype,
                                               device=card))
    for op, B in ((afiro, 1), (afiro, 37), (afiro, 10_000)):
        for M in (op.mat, op.bwd[:, : op.m]):
            X = torch.randn((B, M.shape[1]), generator=gen, dtype=dtype,
                            device=card)
            _per_element(lambda X: _kernels.dense_matvec_batch(M, X),
                         lambda x: dense_matvec(M, x), X, "dense_matvec",
                         lambda X: _kernels.dense_matvec_batch_plain(M, X))
    for B, m, n in ((1, 444, 757), (5, 444, 757), (3, 2001, 5003)):
        S = pad_rows(torch.randn((B * m, n), generator=gen, dtype=dtype,
                                 device=card)).view(B, m, -1)[:, :, :n]
        X = torch.randn((B, n), generator=gen, dtype=dtype, device=card)
        before = _kernels.launches["dense_matvec_batch"]
        Y = _kernels.dense_matvec_batch(S, X)
        assert _kernels.launches["dense_matvec_batch"] == before + 1
        assert torch.equal(Y, torch.stack([dense_matvec(S[b], X[b].clone())
                                           for b in range(B)]))
        ref = _kernels.dense_matvec_batch_plain(S, X)
        assert float(((Y - ref).abs() / (1 + ref.abs())).max()) < _tol(
            n, dtype)


def _nan_padded(rows, cols, gen, dtype, card):
    """A (rows, cols) view of a matrix whose row stride (cols rounded up to
    4, plus 4) holds NaN past cols: the kernel may copy it, never use it."""
    ld = -(-cols // 4) * 4 + 4
    full = torch.full((rows, ld), float("nan"), dtype=dtype, device=card)
    full[:, :cols] = torch.randn((rows, cols), generator=gen, dtype=dtype,
                                 device=card)
    return full[:, :cols]


@pytest.mark.parametrize("case", ["deg2", "long", "tails", "ragged",
                                  "zero-row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shared_batch_kernel_equals_single_launches_on_card(card, dtype,
                                                            case):
    """The shared-K kernel (stride_m == 0) in both of its regimes: deg2's K
    and K' (whole rows, and fp64 K's rows streamed in chunks), rows longer
    than a stage (300 x 2500, 300 x 1300), cols % 4 of 1, 2 and 3 in whole
    and streamed rows (X also a view at a row stride of cols + 5), B = 1
    and B and rows off the plan's tiles, NaN in K's row padding, and a K
    row of zeros against x of both signs (the sign of a zero sum is the
    single launch's).  Every element bit for bit a single launch, one
    launch a call."""
    gen = torch.Generator(device=card)
    gen.manual_seed(15)
    mats = []
    if case == "deg2":
        (p,) = build_suite(("medium",), names=("deg2-class",))
        op = ExactDenseOp.build(torch.as_tensor(p.K.toarray(), dtype=dtype,
                                                device=card))
        mats = [(M, B) for M in (op.mat, op.bwd[:, : op.m])
                for B in (1, 5, 64)]
    elif case == "long":
        mats = [(_nan_padded(300, n, gen, dtype, card), B)
                for n in (2500, 1300) for B in (1, 3, 8, 9)]
    elif case == "tails":
        mats = [(_nan_padded(33, n, gen, dtype, card), 7)
                for n in (101, 102, 103, 1297, 1298, 1299)]
    elif case == "ragged":
        mats = [(_nan_padded(m, 60, gen, dtype, card), B)
                for m in (1, 5, 301, 2001) for B in (1, 13)]
    else:
        M = _nan_padded(37, 51, gen, dtype, card)
        M[[0, 2, 17, 36]] = 0.0
        mats = [(M, 37), (_nan_padded(40, 1500, gen, dtype, card), 9)]
        mats[1][0][[1, 39]] = 0.0
    for M, B in mats:
        X = torch.randn((B, M.shape[1]), generator=gen, dtype=dtype,
                        device=card)
        _per_element(lambda X: _kernels.dense_matvec_batch(M, X),
                     lambda x: dense_matvec(M, x), X, "dense_matvec",
                     lambda X: _kernels.dense_matvec_batch_plain(M, X))
        if case == "tails":
            # X a view whose row stride (cols + 5) is no multiple of 4.
            Xs = torch.randn((B, M.shape[1] + 5), generator=gen,
                             dtype=dtype, device=card)[:, : M.shape[1]]
            _per_element(lambda X: _kernels.dense_matvec_batch(M, X),
                         lambda x: dense_matvec(M, x), Xs, "dense_matvec",
                         lambda X: _kernels.dense_matvec_batch_plain(M, X))
        if case == "zero-row":
            Y = _kernels.dense_matvec_batch(M, X)
            zero = (M == 0).all(dim=1)
            assert torch.equal(_bits(Y[:, zero]),
                               _bits(torch.zeros_like(Y[:, zero])))


#: The shared-K kernel at mittelmann-l's K (8000 x 20000) and K', fp32, on
#: the cluster route at B = 64 and a ragged 37, the chunked route at B = 1;
#: a long-row fp64 K (the chunked route at any batch); X a view at an odd
#: row stride and one an element into its buffer (loaded by element); the
#: last vector partial by 1, 2 (at mittelmann-s's size x 24 and 33, on
#: the cluster route) and 3 (odd-stride) elements.
CLUSTER_CASES = {
    "K-64": (8000, 20000, 64, torch.float32, "plain"),
    "Kt-64": (20000, 8000, 64, torch.float32, "plain"),
    "K-37": (8000, 20000, 37, torch.float32, "plain"),
    "Kt-37": (20000, 8000, 37, torch.float32, "plain"),
    "K-1": (8000, 20000, 1, torch.float32, "plain"),
    "Kt-1": (20000, 8000, 1, torch.float32, "plain"),
    "fp64-64": (2000, 5003, 64, torch.float64, "plain"),
    "odd-stride": (2001, 5003, 64, torch.float32, "stride"),
    "offset": (8000, 20000, 16, torch.float32, "offset"),
    "tail-1": (2000, 5001, 24, torch.float32, "plain"),
    "tail-2": (2000, 5002, 33, torch.float32, "stride"),
}


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_shared_batch_cluster_route_equals_single_launches_on_card(card,
                                                                   case):
    """The shared-K kernel where the plan takes the cluster route (fp32
    rows longer than 4 KB, where the chunked route would read K again for
    _LONG_MIN_REREAD bytes or more) and beside it: every element
    bit for bit a single launch, repeats bit-identical, each element
    within tolerance of the plain twin, one launch a call, and the route
    counter moved by one exactly where the plan's cluster route runs.  K
    holds NaN in its row padding."""
    rows, cols, B, dtype, xkind = CLUSTER_CASES[case]
    gen = torch.Generator(device=card)
    gen.manual_seed(17)
    M = _nan_padded(rows, cols, gen, dtype, card)
    if xkind == "stride":
        X = torch.randn((B, cols + 5), generator=gen, dtype=dtype,
                        device=card)[:, :cols]
    elif xkind == "offset":
        X = torch.randn((B * cols + 1,), generator=gen, dtype=dtype,
                        device=card)[1:].view(B, cols)
        assert X.data_ptr() % 16
    else:
        X = torch.randn((B, cols), generator=gen, dtype=dtype, device=card)
    plan = _kernels.shared_plan(rows, cols, B, M.element_size(),
                                _kernels._sm_count(card))
    assert (plan.cluster > 1) == (dtype == torch.float32 and B > 8)
    before = dict(_kernels.launches)
    Y = _kernels.dense_matvec_batch(M, X)
    moved = {k: v - before[k] for k, v in _kernels.launches.items()
             if v != before[k]}
    assert moved == ({"dense_matvec_batch": 1, "dense_matvec_shared_long": 1}
                     if plan.cluster > 1 else {"dense_matvec_batch": 1})
    assert torch.equal(_bits(Y), _bits(_kernels.dense_matvec_batch(M, X)))
    assert bool(torch.isfinite(Y).all())
    for b in range(B):
        ref = _kernels.dense_matvec_batch_plain(M, X[b:b + 1])
        rel = float(((Y[b:b + 1] - ref).abs() / (1 + ref.abs())).max())
        assert rel < _tol(cols, dtype), (b, rel)
    singles = torch.stack([dense_matvec(M, X[b].clone()) for b in range(B)])
    assert torch.equal(_bits(Y), _bits(singles))


def _nan_padded_stack(B, rows, cols, gen, dtype, card):
    """A (B, rows, cols) view of a stack whose row stride (cols rounded up
    to 4, plus 4) holds NaN past cols, its matrices at one stride."""
    ld = -(-cols // 4) * 4 + 4
    full = torch.full((B, rows, ld), float("nan"), dtype=dtype, device=card)
    full[:, :, :cols] = torch.randn((B, rows, cols), generator=gen,
                                    dtype=dtype, device=card)
    return full[:, :, :cols]


@pytest.mark.parametrize("case", ["deg2", "long", "tails", "views"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stack_batch_kernel_equals_single_launches_on_card(card, dtype,
                                                           case):
    """The stack kernel (stride_m != 0) by each regime of its plan: the
    distinct fleet's 444 x 757 and 757 x 444 (cols % 4 = 1; fp64 757's
    rows stream in parts) at B = 1, 16 and 64; rows longer than 4 KB
    (mittelmann-s's 5000 columns, 1299, 1025) with ragged tiles; cols % 4
    of 1, 2 and 3 and a single column; X a view at a row stride of cols + 5
    and one that starts an element into its buffer, neither padded.  Every
    element bit for bit a single launch, one launch a call, NaN in the row
    padding never used."""
    gen = torch.Generator(device=card)
    gen.manual_seed(16)
    if case == "deg2":
        stacks = [(B, m, n) for m, n in ((444, 757), (757, 444))
                  for B in (1, 16, 64)]
    elif case == "long":
        stacks = [(3, 300, 5000), (5, 33, 1299), (2, 17, 1025), (1, 9, 5000)]
    elif case == "tails":
        stacks = [(7, 33, n) for n in (1, 101, 102, 103)]
    else:
        stacks = [(5, 61, 757), (3, 20, 1299)]
    for B, m, n in stacks:
        S = _nan_padded_stack(B, m, n, gen, dtype, card)
        if case == "views":
            Xs = [torch.randn((B, n + 5), generator=gen, dtype=dtype,
                              device=card)[:, :n],
                  torch.randn((B * n + 1,), generator=gen, dtype=dtype,
                              device=card)[1:].view(B, n)]
            assert Xs[1].data_ptr() % 16
        else:
            Xs = [torch.randn((B, n), generator=gen, dtype=dtype,
                              device=card)]
        for X in Xs:
            before = _kernels.launches["dense_matvec_batch"]
            Y = _kernels.dense_matvec_batch(S, X)
            assert _kernels.launches["dense_matvec_batch"] == before + 1
            assert torch.equal(_bits(Y), _bits(_kernels.dense_matvec_batch(
                S, X)))
            assert bool(torch.isfinite(Y).all())
            ref = _kernels.dense_matvec_batch_plain(S, X)
            rel = float(((Y - ref).abs() / (1 + ref.abs())).max())
            assert rel < _tol(n, dtype), (B, m, n, rel)
            singles = torch.stack([dense_matvec(S[b], X[b].clone())
                                   for b in range(B)])
            assert torch.equal(_bits(Y), _bits(singles)), (B, m, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_batch_kernel_equals_single_launches_on_card(card, dtype):
    """A shared band K at B = 1 and 7, and a stack whose windows (WB = 256)
    run past its n = 100 columns (n_pad = 128 < WB): each element's window
    past n must read zeros, not the next element's x, and the last
    element's, not the NaN behind the buffer."""
    gen = torch.Generator(device=card)
    gen.manual_seed(12)
    p = tpdlp_torch.generate_banded_lp(n=2048, m_ineq=1024, m_eq=512,
                                       bandwidth=33, seed=1)
    op = BandOp.from_scipy(p.K, dtype, device=card)
    for mat in (op.fwd, op.bwd):
        for B in (1, 7):
            X = torch.randn((B, mat.n), generator=gen, dtype=dtype,
                            device=card)
            _per_element(
                lambda X: _kernels.band_matvec_batch(
                    mat.slabs, mat.starts, X, mat.m, mat.n),
                lambda x: band_matvec(mat.slabs, mat.starts, x, mat.m,
                                      mat.n),
                X, "band_matvec",
                lambda X: _kernels.band_matvec_batch_plain(
                    mat.slabs, mat.starts, X, mat.m, mat.n))
    B, m, n, WB = 6, 300, 100, 256
    slabs = torch.randn((B, 8, 128, WB), generator=gen, dtype=dtype,
                        device=card)
    starts = torch.zeros((B, 8), dtype=torch.int32, device=card)
    buf = torch.full((B * n + 2 * WB,), float("nan"), dtype=dtype,
                     device=card)
    buf[: B * n] = torch.randn((B * n,), generator=gen, dtype=dtype,
                               device=card)
    X = buf[: B * n].view(B, n)
    Y = _kernels.band_matvec_batch(slabs, starts, X, m, n)
    assert bool(torch.isfinite(Y).all())
    ref = _kernels.band_matvec_batch_plain(slabs, starts, X, m, n)
    assert float(((Y - ref).abs() / (1 + ref.abs())).max()) < _tol(WB, dtype)
    assert torch.equal(Y, torch.stack([
        band_matvec(slabs[b], starts[b], X[b], m, n) for b in range(B)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batch_kernels_take_an_offset_view_of_x_on_card(card, dtype):
    """X a view that starts one element into its buffer, its rows a
    multiple of ROW_ALIGN long (so no padding copy is made): K1's vector
    loads (a stack), the shared-K kernel's and K2's bulk copies of x still
    see 16-byte-aligned rows, and the result is that of an aligned copy,
    bit for bit."""
    gen = torch.Generator(device=card)
    gen.manual_seed(14)
    p = tpdlp_torch.generate_banded_lp(n=2048, m_ineq=1024, m_eq=512,
                                       bandwidth=33, seed=1)
    band = BandOp.from_scipy(p.K, dtype, device=card).fwd
    B, m, n = 3, 200, 256
    S = pad_rows(torch.randn((B * m, n), generator=gen, dtype=dtype,
                             device=card)).view(B, m, -1)[:, :, :n]
    for cols, fn in (
            (n, lambda X: _kernels.dense_matvec_batch(S, X)),
            (n, lambda X: _kernels.dense_matvec_batch(S[0], X)),
            (band.n, lambda X: _kernels.band_matvec_batch(
                band.slabs, band.starts, X, band.m, band.n))):
        assert cols % _kernels.ROW_ALIGN == 0
        buf = torch.randn((B * cols + 1,), generator=gen, dtype=dtype,
                          device=card)
        X = buf[1:].view(B, cols)
        assert X.data_ptr() % 16
        Y = fn(X)
        torch.cuda.synchronize()
        assert torch.equal(Y, fn(X.clone()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_batch_kernel_equals_single_launches_on_card(card, dtype):
    """A shared CSR K (empty rows included) at B = 1, 33 and 10,000."""
    gen = torch.Generator(device=card)
    gen.manual_seed(13)
    for m, n, density, B in ((300, 200, 0.05, 1), (300, 200, 0.05, 33),
                             (27, 51, 0.3, 10_000), (5000, 40, 0.02, 3)):
        K = _random_sparse(m, n, density, seed=m)
        crow = torch.as_tensor(K.indptr.astype(np.int32), device=card)
        col = torch.as_tensor(K.indices.astype(np.int32), device=card)
        val = torch.as_tensor(K.data, dtype=dtype, device=card)
        X = torch.randn((B, n), generator=gen, dtype=dtype, device=card)
        _per_element(
            lambda X: _kernels.csr_matvec_batch(crow, col, val, X),
            lambda x: _kernels.csr_matvec(crow, col, val, x), X,
            "csr_matvec",
            lambda X: _kernels.csr_matvec_batch_plain(crow, col, val, X))


def test_element_fleet_on_card_matches_single_solves(card):
    """A shared-K fleet in fp64 with fixed steps, restart_sync="element":
    each element's status, k, n and j are those of a single solve of the
    same LP on the card, and the fleet's products all went through K1's
    batch axis."""
    from tpdlp_torch.bench.fleet import perturbed_fleet

    (p,) = build_suite(("small",), names=("sc50-class",))
    fleet = perturbed_fleet(p, 5)
    cfg = tpdlp_torch.SolverConfig(tol=1e-6, scaling="ruiz", adaptive=False,
                                   primal_weight_update=True)
    _kernels.reset_launches()
    rs = tpdlp_torch.solve_batch(fleet, cfg, dtype=torch.float64)
    assert _kernels.launches["dense_matvec_batch"] > 0
    for q, r in zip(fleet, rs):
        s = tpdlp_torch.solve(q, cfg, dtype=torch.float64)
        assert r.status == s.status == tpdlp_torch.Status.SOLVED
        assert (r.iterations, r.restarts, r.kkt_passes) == (
            s.iterations, s.restarts, s.kkt_passes)
        assert abs(r.objective - s.objective) <= 1e-9 * (1 + abs(s.objective))


def _rank_partials(op_of, x, y, shape):
    """Each rank's products of a (R, C) mesh whose ranks share this
    process (no process group: a collective is the identity), on its
    slices of the whole x and y (each its own tensor, as in a solve): a 2D
    block's partial K x_c and K'y_r, a flat strip's kernels on the whole
    vectors; with the placement and the kernel launches of each."""
    from tpdlp_torch.shard.mesh import Mesh

    out = []
    for rank in range(shape[0] * shape[1]):
        op = op_of(Mesh(shape, rank))
        before = dict(_kernels.launches)
        if op.pl.flat:
            kx, kty = op.fwd.matvec(x), op.bwd.matvec(y)
        else:
            kx = op.mv(op.pl.cut_x(x).clone())
            kty = op.rmv(op.pl.cut_y(y).clone())
        out.append((op.pl, kx, kty,
                    {k: v - before[k] for k, v in _kernels.launches.items()
                     if v != before[k]}))
    return out


@pytest.mark.parametrize("fmt", ["dense", "band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_operators_on_card_sum_to_the_products(card, fmt, dtype):
    """The sharded layouts' kernels on the card: each 2D block's partial
    K x_c (K'y_r), summed over its row's (column's) ranks, is the whole
    operator's product at the rank's y (x) slice (K1 on each block); each
    flat strip's K2 on the whole vector is the product at its strip; one
    launch of the layout's kernel per product and rank."""
    import scipy.sparse as sp

    from tpdlp_torch.shard import mesh as TM
    from tpdlp_torch.shard.ops import band_shard, dense_shard

    if fmt == "dense":
        p = tpdlp_torch.generate_feasible_lp(n=53, m_ineq=29, m_eq=10,
                                             seed=11)
        shape, pad, build, kernel = (2, 2), TM.padded_sizes, dense_shard, (
            "dense_matvec")
    else:
        p = tpdlp_torch.generate_banded_lp(n=3000, m_ineq=1500, m_eq=700,
                                           bandwidth=33, seed=9)
        shape, pad, build, kernel = (1, 4), TM.padded_sizes_band, (
            band_shard), "band_matvec"
    m_pad, n_pad = pad(p.m, p.n, TM.Mesh(shape))
    coo = sp.coo_matrix(p.K)
    K = sp.coo_matrix((coo.data, (coo.row, coo.col)), shape=(m_pad, n_pad))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n_pad, generator=g, dtype=torch.float64)
    y = torch.randn(m_pad, generator=g, dtype=torch.float64)
    parts = _rank_partials(lambda mesh: build(K, mesh, dtype, card),
                           x.to(dtype=dtype, device=card),
                           y.to(dtype=dtype, device=card), shape)
    kx = torch.zeros(m_pad, dtype=torch.float64)
    kty = torch.zeros(n_pad, dtype=torch.float64)
    for pl, px, py, _ in parts:
        (x0, x1), (y0, y1) = pl.x_span, pl.y_span
        # Flat: each strip once; 2D: each row's C partials of K x, each
        # column's R partials of K'y.
        kx[y0:y1] += px.cpu().double()
        kty[x0:x1] += py.cpu().double()
    Kd = torch.as_tensor(K.toarray())
    for got, want in ((kx, Kd @ x), (kty, Kd.T @ y)):
        rel = float(((got - want).abs() / (1 + want.abs())).max())
        assert rel < _tol(max(m_pad, n_pad), dtype), rel
    assert all(launched == {kernel: 2} for _, _, _, launched in parts)


def test_sharded_solves_on_card_over_gloo_and_nccl(card):
    """Two gloo ranks sharing the card as a 1x2 and as a 2x1 mesh (NCCL
    refuses two ranks on one card) and one NCCL rank: dense and band
    solves in fp32 on partitioned vectors reach the unsharded card solve's
    status, the objective within 5 * tol; every rank launches its layout's
    kernel once per product collective and holds only its slices of the
    vectors (tests/torch_shard_ranks.py is each rank's side)."""
    from torch_shard_ranks import run_cases
    from tpdlp_torch.shard import run_ranks

    tol = 1e-4
    cfg = dict(tol=tol, scaling="ruiz", adaptive=True,
               primal_weight_update=True)
    problems = {
        "dense": tpdlp_torch.generate_feasible_lp(n=757, m_ineq=280,
                                                  m_eq=164, density=0.05,
                                                  seed=1),
        "band": tpdlp_torch.generate_banded_lp(n=3000, m_ineq=1500,
                                               m_eq=700, bandwidth=33,
                                               seed=9),
    }
    kernel = {"dense": "dense_matvec", "band": "band_matvec"}

    def cases(shape):
        return [{"kind": "solve", "shape": shape, "problem": p, "cfg": cfg,
                 "solve": {"matrix_format": fmt, "dtype": torch.float32}}
                for fmt, p in problems.items()]

    runs = {
        "gloo 1x2": run_ranks(run_cases, 2, backend="gloo",
                              device=str(card), shape=(1, 2),
                              args=(cases((1, 2)),), timeout=600),
        "gloo 2x1": run_ranks(run_cases, 2, backend="gloo",
                              device=str(card), shape=(2, 1),
                              args=(cases((2, 1)),), timeout=600),
        "nccl 1x1": run_ranks(run_cases, 1, backend="nccl",
                              device=[str(card)], shape=(1, 1),
                              args=(cases((1, 1)),), timeout=600),
    }
    for i, (fmt, p) in enumerate(problems.items()):
        single = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(**cfg),
                                   dtype=torch.float32, device=card,
                                   matrix_format=fmt)
        assert single.status == tpdlp_torch.Status.SOLVED
        for mesh, per_rank in runs.items():
            for r in (rank[i] for rank in per_rank):
                assert r["status"] == int(single.status), (mesh, fmt)
                assert abs(r["objective"] - single.objective) <= 5 * tol * (
                    1 + abs(single.objective)), (mesh, fmt)
                assert r["launches"][kernel[fmt]] == r["counts"]["product"]
                assert r["counts"]["product"] > 2 * r["k"]
                held = r["held"]
                assert held["x"] * held["x_parts"] == held["x_whole"]
                assert held["y"] * held["y_parts"] == held["y_whole"]