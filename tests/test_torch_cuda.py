"""The port's CUDA kernels on the card, against their plain PyTorch twins.

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
