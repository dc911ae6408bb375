"""The system under test, `tpdlp_torch`, as the benchmark drives it.  The
only module of the benchmark that imports the program: the rest takes
from it the answers, the counters and the kernel names alone.

Counters: `tpdlp_torch.ops._kernels.launches` (kernel launches by wrapper)
and `tpdlp_torch.solver.loop.launched` (iterations issued and restart
checks, masked ones included).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import tpdlp_torch
from tpdlp_torch.ops import _kernels
from tpdlp_torch.solver import loop

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class Answer:
    """What the program returned for one LP."""

    status: str
    x: np.ndarray
    y: np.ndarray
    objective: float
    iterations: int
    kkt_passes: int
    restarts: int


class Program:
    """Solves a request's LPs as a configuration and a traffic mix say:
    `tpdlp_torch.solve` for one LP, `tpdlp_torch.solve_batch` (its
    defaults: element restarts, compaction, a shared operator when K is
    shared) for a fleet.  No operator cache and no warm start."""

    def __init__(self, config: dict, traffic: dict, device):
        fields = dict(config["solver"])
        fields.update(traffic.get("solver", {}))
        self.cfg = tpdlp_torch.SolverConfig(**fields)
        self.matrix_format = config["matrix_format"]
        self.dtype = DTYPES[config["dtype"]]
        self.entry = traffic["entry"]
        self.device = device
        if self.entry not in ("solve", "solve_batch"):
            raise ValueError(f"unknown entry {self.entry!r}")

    def run(self, lps: list, seed: int) -> list:
        if self.entry == "solve":
            results = [tpdlp_torch.solve(
                lp, self.cfg, dtype=self.dtype, device=self.device,
                seed=seed, matrix_format=self.matrix_format) for lp in lps]
        else:
            results = tpdlp_torch.solve_batch(
                lps, self.cfg, dtype=self.dtype, seed=seed,
                matrix_format=self.matrix_format, device=self.device)
        return [Answer(r.status_string, r.x, r.y, float(r.objective),
                       int(r.iterations), int(r.kkt_passes), int(r.restarts))
                for r in results]


def counters() -> dict:
    """The program's counters now, by name."""
    out = {f"launches.{k}": v for k, v in _kernels.launches.items()}
    out.update({f"loop.{k}": v for k, v in loop.launched.items()})
    return out
