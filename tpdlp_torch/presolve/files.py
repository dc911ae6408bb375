"""File-level presolve round trip (counterpart of tpdlp/presolve/files.py).

`presolve_mps(input_file, output_file, transformation_file)` reads an MPS
file, presolves it, writes the reduced MPS (`io/writer.py`) and the
transformation record (the `PostsolveData` npz);
`postsolve_solution(reduced_solution, transformation_file)` maps a reduced
primal solution back to the original variables, and
`postsolve_dual_solution` a reduced dual solution back to the original
rows.
"""

from __future__ import annotations

import numpy as np

from tpdlp_torch.config import Status
from tpdlp_torch.io.mps import read_mps
from tpdlp_torch.io.writer import write_mps
from tpdlp_torch.presolve.reductions import (
    PostsolveData,
    postsolve,
    postsolve_dual,
    presolve,
)


def presolve_mps(
    input_file: str,
    output_file: str,
    transformation_file: str,
    *,
    backend: str = "python",
    max_passes: int = 25,
) -> dict:
    """Presolve an MPS file; write the reduced MPS + transformation record.

    Returns a stats dict: status string, rows/cols removed, passes.  When
    presolve fully decides the instance (solved/infeasible/unbounded) no
    reduced MPS is written; the transformation record is always written so
    `postsolve_solution` can reconstruct the full solution (an empty reduced
    solution is valid input in the fully-reduced case).
    """
    problem = read_mps(input_file)
    res = presolve(problem, backend=backend, max_passes=max_passes)
    res.data.save(transformation_file)
    if res.status == Status.RUNNING:
        write_mps(res.problem, output_file)
    return {
        "status": res.status.describe()
        if res.status != Status.RUNNING
        else "Reduced",
        "rows_removed": res.rows_removed,
        "cols_removed": res.cols_removed,
        "passes": res.passes,
        "reduced_rows": res.problem.m if res.problem is not None else 0,
        "reduced_cols": res.problem.n if res.problem is not None else 0,
    }


def postsolve_solution(
    reduced_solution, transformation_file: str
) -> np.ndarray:
    """Map a reduced-space primal solution back to the original variables
    ."""
    data = PostsolveData.load(transformation_file)
    return postsolve(np.asarray(reduced_solution, dtype=np.float64), data)


def postsolve_dual_solution(
    reduced_dual, full_primal, transformation_file: str
) -> np.ndarray:
    """Map a reduced-space DUAL solution back to the original rows.

    Beyond the reference wrapper (which is primal-only): needs the
    postsolved full primal point (from `postsolve_solution`) because
    bound-transfer recovery is conditioned on bound activity."""
    data = PostsolveData.load(transformation_file)
    return postsolve_dual(
        np.asarray(reduced_dual, dtype=np.float64),
        np.asarray(full_primal, dtype=np.float64),
        data,
    )
