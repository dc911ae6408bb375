"""The one request generator: a closed loop of LP requests over one
generated LP, as a traffic file describes it.

A traffic file holds:

    entry     "solve" (one LP a request) or "solve_batch" (a fleet)
    batch     LPs a request (1 for "solve")
    cost_rel  relative size of the normal cost perturbation
    solver    SolverConfig fields set on top of the configuration's
    why       why the mix exists

Every LP of request i is the generated LP with c * (1 + cost_rel * N(0,
1)), drawn from the run's seed and i (the perturbation of
`tpdlp_torch/bench/fleet.py::perturbed_fleet`); request -1 is the
warm-up's, which no request of the window repeats.  Each request hands the
program new problem objects over the same K.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Keeps the traffic's random stream apart from the generator's, which
#: takes the bare seed.
STREAM = 1


class Traffic:
    def __init__(self, spec: dict, lp, seed: int):
        self.entry = spec["entry"]
        self.batch = int(spec["batch"])
        if self.entry == "solve" and self.batch != 1:
            raise ValueError("a 'solve' request holds one LP")
        if self.batch < 1:
            raise ValueError(f"batch {self.batch} must be positive")
        self.lp = lp
        self.seed = seed
        self.rel = float(spec["cost_rel"])
        self._last = (None, None)  # (index, costs): the latest request's

    def costs(self, index: int) -> np.ndarray:
        """The (batch, n) costs of request `index` (-1: the warm-up)."""
        if self._last[0] != index:
            rng = np.random.default_rng([self.seed, STREAM, index + 1])
            noise = rng.standard_normal((self.batch, self.lp.c.shape[0]))
            self._last = (index, self.lp.c * (1.0 + self.rel * noise))
        return self._last[1]

    def cost(self, index: int, b: int) -> np.ndarray:
        """The c of LP b of request `index` (-1: the warm-up)."""
        return self.costs(index)[b]

    def request(self, index: int) -> list:
        """The LPs of request `index` (-1: the warm-up), new objects over
        the generated K."""
        return [dataclasses.replace(self.lp, c=c,
                                    name=f"{self.lp.name}#r{index}b{b}")
                for b, c in enumerate(self.costs(index))]
