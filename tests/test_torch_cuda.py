"""The port's CUDA kernels on the card, against their plain PyTorch twins.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode; the CPU tests hold the twins against the JAX package).
"""

import pytest
import torch

import tpdlp_torch
from tpdlp_torch.bench.suite import build_suite
from tpdlp_torch.ops import _kernels
from tpdlp_torch.ops._kernels import dense_matvec, dense_matvec_plain
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(card, dtype):
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    for m, n in [(27, 51), (1, 1), (257, 2049), (16, 9000), (2000, 5000),
                 (5000, 2000)]:
        M = pad_rows(torch.randn((m, n), generator=gen, dtype=dtype,
                                 device=card))[:, :n]
        x = torch.randn((n,), generator=gen, dtype=dtype, device=card)
        before = _kernels.launches["dense_matvec"]
        y = dense_matvec(M, x)
        assert _kernels.launches["dense_matvec"] == before + 1
        ref = dense_matvec_plain(M, x)
        assert y.shape == (m,) and y.dtype == dtype
        assert float(((y - ref).abs() / (1 + ref.abs())).max()) < _tol(n,
                                                                       dtype)
        assert torch.equal(y, dense_matvec(M, x))  # bit-identical repeats


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
