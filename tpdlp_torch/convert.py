"""Carry problems and states across from the JAX package, and back.

Both sides meet as dicts of numpy arrays keyed by the dataclass field
names: a JAX `DeviceProblem` or `PDHGState` fetched with `jax.device_get`
field by field, with the problem's operator under "op": its logical (m, n)
matrix (`ExactDenseOp.mat` or `DenseOp.mat`), or an operator of this
package (a JAX `BandOp` carried across by `band_op_from_numpy`).  This
module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpdlp_torch.ops.band import BandMat, BandOp
from tpdlp_torch.ops.base import LinOp
from tpdlp_torch.ops.exact_dense import ExactDenseOp
from tpdlp_torch.device import resolve_device
from tpdlp_torch.problem import DeviceProblem
from tpdlp_torch.solver.state import PDHGState


def _dtype_of(v) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.asarray(v).dtype)).dtype


def _tensor(v, dtype, dev):
    a = np.array(v)  # a writable copy (fetched arrays may be read-only)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=dev)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=dev)
    return torch.as_tensor(a, dtype=dtype, device=dev)


def problem_from_numpy(d: dict, device=None, dtype=None) -> DeviceProblem:
    """DeviceProblem from a dict of numpy arrays; `dtype` defaults to that
    of d["c"]."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = _dtype_of(d["c"])
    op = d["op"]
    if not isinstance(op, LinOp):
        op = ExactDenseOp.build(_tensor(op, dtype, dev))
    kw = {
        f.name: _tensor(d[f.name], dtype, dev)
        for f in dataclasses.fields(DeviceProblem) if f.name != "op"
    }
    return DeviceProblem(op=op, **kw)


def band_op_from_numpy(fwd_slabs, fwd_starts, bwd_slabs, bwd_starts, m: int,
                       n: int, device=None, dtype=None) -> BandOp:
    """BandOp from the numpy arrays of a JAX `BandOp` (fwd.slabs,
    fwd.starts, bwd.slabs, bwd.starts) of an (m, n) K; `dtype` defaults to
    that of fwd_slabs."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = _dtype_of(fwd_slabs)
    return BandOp(
        BandMat(_tensor(fwd_slabs, dtype, dev), _tensor(fwd_starts, dtype,
                                                         dev), m, n),
        BandMat(_tensor(bwd_slabs, dtype, dev), _tensor(bwd_starts, dtype,
                                                         dev), n, m),
    )


def state_from_numpy(d: dict, device=None, dtype=None) -> PDHGState:
    """PDHGState from a dict of numpy arrays (counters become int32)."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = _dtype_of(d["x"])
    return PDHGState(**{
        f.name: _tensor(d[f.name], dtype, dev)
        for f in dataclasses.fields(PDHGState)
    })


def state_to_numpy(st: PDHGState) -> dict:
    """Dict of numpy arrays from a PDHGState (one copy per field)."""
    return {
        f.name: getattr(st, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(PDHGState)
    }
