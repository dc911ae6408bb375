"""Presolve and postsolve on the host (counterpart of tpdlp/presolve)."""

from tpdlp_torch.presolve.files import (
    postsolve_dual_solution,
    postsolve_solution,
    presolve_mps,
)
from tpdlp_torch.presolve.reductions import (
    PostsolveData,
    postsolve,
    postsolve_dual,
    presolve,
)

__all__ = [
    "presolve",
    "postsolve",
    "postsolve_dual",
    "PostsolveData",
    "presolve_mps",
    "postsolve_solution",
    "postsolve_dual_solution",
]
