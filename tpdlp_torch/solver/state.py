"""PDHG loop state (counterpart of tpdlp/solver/state.py).

One dataclass of device tensors.  Beyond the reference's state it carries
the products K x and K'y of the current and previous iterate, so that the
adaptive stepsize denominator and the restart KKT errors are vector work
instead of extra products: one K x and one K'y per iteration.  It holds all
of the JAX state's fields, the certificate and Halpern slots included, so
that later slices and checkpoints need no reshuffle.  Counters and the
status are int32 0-d tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from tpdlp_torch.config import Status


@dataclasses.dataclass
class PDHGState:
    # Current iterate and its operator products.
    x: torch.Tensor  # (n,)
    y: torch.Tensor  # (m,)
    kx: torch.Tensor  # (m,)  K x
    kty: torch.Tensor  # (n,)  K'y
    # Previous iterate (necessary restart criterion, certificate diffs).
    x_prev: torch.Tensor
    y_prev: torch.Tensor
    kx_prev: torch.Tensor
    kty_prev: torch.Tensor
    # Certificate slots (infeasibility detection; later slice).
    lam_prev: torch.Tensor  # (n,)
    x_norm_prev: torch.Tensor  # (n,)
    y_norm_prev: torch.Tensor  # (m,)
    x_plain_sum: torch.Tensor  # (n,)
    y_plain_sum: torch.Tensor  # (m,)
    kx_plain_sum: torch.Tensor  # (m,)
    kty_plain_sum: torch.Tensor  # (n,)
    # eta-weighted running averages.
    x_sum: torch.Tensor
    y_sum: torch.Tensor
    eta_sum: torch.Tensor  # scalar
    # Last restart point (primal-weight update; the Halpern anchor) and its
    # products, kept equal to K @ x_restart / K' @ y_restart.
    x_restart: torch.Tensor
    y_restart: torch.Tensor
    kx_restart: torch.Tensor
    kty_restart: torch.Tensor
    # Step sizes.
    eta: torch.Tensor  # scalar — stepsize for the next step
    omega: torch.Tensor  # scalar — primal weight
    omega_init: torch.Tensor  # scalar — anchor of the omega clamp
    # Restart metric at the current restart cycle's start.
    kkt_first: torch.Tensor  # scalar
    # Fixed-point residual (Halpern scheme only; 0 in vanilla).
    fp_res: torch.Tensor  # scalar
    # Counters (int32): total iters, inner iters, restarts, KKT passes.
    k: torch.Tensor
    t: torch.Tensor
    n_restarts: torch.Tensor
    j: torch.Tensor
    status: torch.Tensor  # int32 Status code
    # Reporting (updated at restart boundaries).
    prim_obj: torch.Tensor
    adjusted_dual: torch.Tensor
    primal_res: torch.Tensor
    dual_res: torch.Tensor
    gap: torch.Tensor

    def replace(self, **kw) -> "PDHGState":
        return dataclasses.replace(self, **kw)


def init_state(pb, eta0, omega0, x0=None, y0=None) -> PDHGState:
    """Initial state (reference init: primal_dual_hybrid_gradient.py:31-51)."""
    n, m = pb.n, pb.m
    dtype, dev = pb.c.dtype, pb.c.device

    def zeros(size=()):
        return torch.zeros(size, dtype=dtype, device=dev)

    def counter(v=0):
        return torch.full((), v, dtype=torch.int32, device=dev)

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev).clone()

    x = zeros((n,)) if x0 is None else x0.to(dtype)
    y = zeros((m,)) if y0 is None else y0.to(dtype)
    kx = pb.op.mv(x)
    kty = pb.op.rmv(y)
    return PDHGState(
        x=x, y=y, kx=kx, kty=kty,
        x_prev=x, y_prev=y, kx_prev=kx, kty_prev=kty,
        lam_prev=zeros((n,)),
        x_norm_prev=zeros((n,)),
        y_norm_prev=zeros((m,)),
        x_plain_sum=zeros((n,)),
        y_plain_sum=zeros((m,)),
        kx_plain_sum=zeros((m,)),
        kty_plain_sum=zeros((n,)),
        x_sum=zeros((n,)),
        y_sum=zeros((m,)),
        eta_sum=zeros(),
        x_restart=x, y_restart=y, kx_restart=kx, kty_restart=kty,
        eta=scalar(eta0),
        omega=scalar(omega0),
        omega_init=scalar(omega0),
        # kkt_first starts at 0: the artificial criterion always fires the
        # first restart.
        kkt_first=zeros(),
        fp_res=zeros(),
        k=counter(), t=counter(), n_restarts=counter(), j=counter(),
        status=counter(int(Status.RUNNING)),
        prim_obj=zeros(), adjusted_dual=zeros(), primal_res=zeros(),
        dual_res=zeros(), gap=zeros(),
    )
