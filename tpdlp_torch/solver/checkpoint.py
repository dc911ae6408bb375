"""Checkpoint/resume of the solver state (counterpart of
tpdlp/solver/checkpoint.py).

The loop's whole state (iterates, operator products, averages, step sizes,
counters, status) is one dataclass of tensors, so a checkpoint is one npz
file with a field per state slot, under the JAX package's names and with
its defaults for fields an older file lacks: a checkpoint written by either
package loads in the other.  `solve(checkpoint_path=..., resume=True)`
saves after every chunk and resumes from the newest save.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpdlp_torch.solver.state import PDHGState

_FIELDS = [f.name for f in dataclasses.fields(PDHGState)]


def npz_path(path) -> str:
    """The file `save_state(..., path)` writes: `path`, ".npz" appended
    when missing."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(state: PDHGState, path) -> None:
    """Write the solver state to an .npz file (`path`, ".npz" appended
    when missing).  The floating fields move to the host as one tensor and
    the integer fields as another."""
    tensors = [getattr(state, name) for name in _FIELDS]
    floats = [t for t in tensors if t.is_floating_point()]
    ints = [t for t in tensors if not t.is_floating_point()]
    flat_f = torch.cat([t.reshape(-1) for t in floats]).cpu().numpy()
    flat_i = torch.stack(ints).cpu().numpy()
    arrays, fi, ii = {}, 0, 0
    for name, t in zip(_FIELDS, tensors):
        if t.is_floating_point():
            arrays[name] = flat_f[fi:fi + t.numel()].reshape(t.shape)
            fi += t.numel()
        else:
            arrays[name] = flat_i[ii]
            ii += 1
    np.savez(path, **arrays)


def load_state(path, dtype=None, device="cpu") -> PDHGState:
    """Restore a solver state saved by `save_state` (of this package or
    the JAX one) onto `device`.

    `dtype` optionally recasts the floating-point fields (e.g. resuming an
    fp32 solve in fp64)."""
    z = np.load(npz_path(path))
    # State fields added after a checkpoint was written default to zeros of
    # the matching space (x-like fields share x's shape, y-like y's).
    defaults = {
        "x_plain_sum": lambda: np.zeros_like(z["x"]),
        "y_plain_sum": lambda: np.zeros_like(z["y"]),
        "kx_plain_sum": lambda: np.zeros_like(z["y"]),
        "kty_plain_sum": lambda: np.zeros_like(z["x"]),
        "omega_init": lambda: np.asarray(z["omega"]),
        # Anchor operator products: placeholders only; solve() recomputes
        # them from the operator right after a resume.
        "kx_restart": lambda: np.zeros_like(z["kx"]),
        "kty_restart": lambda: np.zeros_like(z["kty"]),
        "fp_res": lambda: np.zeros_like(z["eta"]),
    }
    kwargs = {}
    for name in _FIELDS:
        if name in z.files:
            a = z[name]
        elif name in defaults:
            a = defaults[name]()
        else:
            raise KeyError(
                f"checkpoint {path} lacks state field {name!r} and no "
                "default is known; re-solve from scratch"
            )
        t = torch.as_tensor(np.array(a), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        kwargs[name] = t
    return PDHGState(**kwargs)
