"""tpdlp_torch — the restarted-PDHG LP solver of `tpdlp`, ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package `tpdlp` is the reference; this package never imports it
(nor JAX).  Same standard form (K = [G; A], q = [h; b], the first `m_ineq`
rows inequalities), same `SolverConfig`, `Status` codes and KKT-pass ledger.
Entry points run on CUDA unless the caller passes device="cpu".  The K
products run hand-written CUDA kernels, built with nvcc at first use:
csrc/dense_matvec.cu for matrix_format="dense", csrc/band_matvec.cu for
matrix_format="band".  Importing the package changes no global
torch state.
"""

from tpdlp_torch.config import SolverConfig, Status
from tpdlp_torch.io.generator import (
    generate_banded_lp,
    generate_feasible_lp,
    generate_infeasible_lp,
    generate_unbounded_lp,
)
from tpdlp_torch.io.mps import mps_to_standard_form, read_mps
from tpdlp_torch.problem import LPProblem
from tpdlp_torch.solver.solve import SolveResult, solve

__all__ = [
    "SolverConfig",
    "Status",
    "LPProblem",
    "solve",
    "SolveResult",
    "read_mps",
    "mps_to_standard_form",
    "generate_feasible_lp",
    "generate_banded_lp",
    "generate_infeasible_lp",
    "generate_unbounded_lp",
]
