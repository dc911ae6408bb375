"""tpdlp_torch — the restarted-PDHG LP solver of `tpdlp`, ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package `tpdlp` is the reference; this package never imports it
(nor JAX).  Same standard form (K = [G; A], q = [h; b], the first `m_ineq`
rows inequalities), same `SolverConfig`, `Status` codes and KKT-pass ledger.
Entry points run on CUDA unless the caller passes device="cpu".  The dense
matrix products run a hand-written CUDA kernel (csrc/dense_matvec.cu),
built with nvcc at first use.  Importing the package changes no global
torch state.
"""

from tpdlp_torch.config import SolverConfig, Status
from tpdlp_torch.io.generator import generate_feasible_lp
from tpdlp_torch.problem import LPProblem
from tpdlp_torch.solver.solve import SolveResult, solve

__all__ = [
    "SolverConfig",
    "Status",
    "LPProblem",
    "solve",
    "SolveResult",
    "generate_feasible_lp",
]
