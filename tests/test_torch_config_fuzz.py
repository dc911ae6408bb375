"""The JAX package's randomized config-interaction battery
(tests/test_config_fuzz.py) over the port: the same 25 seeded samples of
scaling x step scheme x adaptive rule x termination mode x operator format
x presolve backend, solved by `tpdlp_torch.solve(device="cpu")`, and the
same claims checked (no exception; Solved means the relative criteria
hold on the original problem with 2x slack, the duals are KKT-consistent
and the objective tracks scipy HiGHS; KKT_LIMIT is an honest outcome).
Sample t8 is the reference's known failure (ROADMAP.md queue 3): presolve
leaves a bound pair crossed by an ulp and the JAX solve raises
ValueError, so the JAX battery fails there; the twin holds the port to
the same ValueError and goes on.  Slow, as the JAX battery is."""

import numpy as np
import pytest
import torch

import tpdlp_torch
from tpdlp_torch import (
    SolverConfig, Status, generate_banded_lp, generate_feasible_lp,
)
from tests.oracles import dual_violation, solve_oracle

torch.set_num_threads(2)

#: The sample on which the JAX battery raises (presolve's crossed bounds).
REFERENCE_FAILURE = 8


@pytest.mark.slow
def test_config_fuzz_claims_are_honest_on_the_port():
    rng = np.random.default_rng(1234)
    tol = 1e-6
    n_solved = 0
    for t in range(25):
        banded = rng.random() < 0.3
        if banded:
            p = generate_banded_lp(
                n=int(rng.integers(200, 600)),
                m_ineq=int(rng.integers(80, 200)),
                m_eq=int(rng.integers(40, 120)),
                bandwidth=int(rng.choice([17, 33])),
                seed=int(rng.integers(0, 1000)),
            )
        else:
            p = generate_feasible_lp(
                n=int(rng.integers(20, 120)),
                m_ineq=int(rng.integers(10, 70)),
                m_eq=int(rng.integers(3, 30)),
                density=float(rng.uniform(0.1, 0.4)),
                seed=int(rng.integers(0, 1000)),
            )
        halpern = rng.random() < 0.25
        cfg = SolverConfig(
            tol=tol,
            max_kkt=120_000,
            scaling=str(rng.choice(["none", "ruiz", "ruiz+pc"])),
            adaptive=False if halpern else bool(rng.random() < 0.7),
            adaptive_rule=str(rng.choice(["reference", "linesearch"])),
            step_scheme="halpern" if halpern else "vanilla",
            primal_weight_update=bool(rng.random() < 0.7),
            abs_gap_termination=bool(rng.random() < 0.5),
            infeasibility_detect=bool(rng.random() < 0.5),
        )
        fmt = str(rng.choice(
            ["dense", "sparse", "auto"] + (["band"] if banded else [])
        ))
        presolve = str(rng.choice(["off", "python", "cpp"]))
        desc = (f"t{t} {'band' if banded else 'rand'} m={p.m} n={p.n} "
                f"sc={cfg.scaling} hs={halpern} fmt={fmt} ps={presolve}")

        if t == REFERENCE_FAILURE:
            with pytest.raises(ValueError, match="l > u"):
                tpdlp_torch.solve(p, cfg, device="cpu", matrix_format=fmt,
                                  presolve=presolve)
            continue
        r = tpdlp_torch.solve(p, cfg, device="cpu", matrix_format=fmt,
                              presolve=presolve)
        assert r.status in (Status.SOLVED, Status.KKT_LIMIT), (
            desc, r.status_string)
        if r.status != Status.SOLVED:
            continue
        n_solved += 1
        q_norm = float(np.linalg.norm(p.q))
        c_norm = float(np.linalg.norm(p.c))
        assert r.primal_res <= 2 * tol * (1 + q_norm), (desc, r.primal_res)
        assert r.dual_res <= 2 * tol * (1 + c_norm), (desc, r.dual_res)
        assert dual_violation(p, r.x, r.y) < 1e-3, desc
        o = solve_oracle(p)
        gap_bound = tol * (1 + abs(r.objective) + abs(o.fun)) * 100
        assert abs(r.objective - o.fun) <= max(1e-4, gap_bound), (
            desc, r.objective, o.fun)
    assert n_solved >= 20, n_solved
