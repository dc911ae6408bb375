"""Carry problems and states across from the JAX package, and back.

Both sides meet as dicts of numpy arrays keyed by the dataclass field
names: a JAX `DeviceProblem` or `PDHGState` fetched with `jax.device_get`
field by field, with the problem's operator given as its logical (m, n)
matrix (`ExactDenseOp.mat` or `DenseOp.mat`) under "op".  This module
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpdlp_torch.ops.exact_dense import ExactDenseOp
from tpdlp_torch.problem import DeviceProblem, resolve_device
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
    op = ExactDenseOp.build(_tensor(d["op"], dtype, dev))
    kw = {
        f.name: _tensor(d[f.name], dtype, dev)
        for f in dataclasses.fields(DeviceProblem) if f.name != "op"
    }
    return DeviceProblem(op=op, **kw)


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
