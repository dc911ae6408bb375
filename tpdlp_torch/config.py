"""Solver configuration and status codes (counterpart of tpdlp/config.py).

The fields, their defaults, their checks and the status codes and strings
are those of the JAX package, so a configuration means the same thing in
both.  Fields that only steer the TPU backend (`step_products`,
`host_speculation`, `eager_fetch_max`) are accepted and validated; on the
H100 they change nothing (an fp32 product is exact, so there is no fast
product path).  Options this port does not run yet raise
`NotImplementedError` in `solve`, naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import enum


class Status(enum.IntEnum):
    """Solver status codes (an int32 tensor on the device)."""

    RUNNING = 0
    SOLVED = 1
    KKT_LIMIT = 2
    TIME_LIMIT = 3
    DUAL_INFEASIBLE = 4
    PRIMAL_INFEASIBLE = 5
    NUMERICAL_ERROR = 6

    def describe(self) -> str:
        return _STATUS_STRINGS[self]


# Reference status strings (CSV/report parity with the JAX package).
_STATUS_STRINGS = {
    Status.RUNNING: "Running",
    Status.SOLVED: "Solved",
    Status.KKT_LIMIT: "Unsolved (KKT passes limit exceeded)",
    Status.TIME_LIMIT: "Unsolved (Time limit exceeded)",
    Status.DUAL_INFEASIBLE: "DUAL_INFEASIBLE",
    Status.PRIMAL_INFEASIBLE: "PRIMAL_INFEASIBLE",
    Status.NUMERICAL_ERROR: "Unsolved (Numerical error)",
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for the restarted-PDHG solver.

    See tpdlp/config.py for the full rationale of each field."""

    # Termination.
    tol: float = 1e-4
    #: Use |gap| instead of the signed gap in the gap criterion.
    abs_gap_termination: bool = False

    # Work / time budgets.
    max_kkt: int = 100_000
    time_limit: float = 3600.0

    # Restart scheme.
    restart_period: int = 40
    beta_sufficient: float = 0.2
    beta_necessary: float = 0.8
    beta_artificial: float = 0.36

    #: "vanilla" (restarted PDHG) or "halpern" (reflected PDHG with Halpern
    #: anchoring; fixed steps only).
    step_scheme: str = "vanilla"

    # Step sizes.
    adaptive: bool = False
    #: "reference": take the step, update eta by the Malitsky-Pock bound.
    #: "linesearch": retry the step with the reduced eta until accepted.
    adaptive_rule: str = "reference"
    max_backtracks: int = 20
    adaptive_shrink_exponent: float = -0.3
    adaptive_grow_exponent: float = -0.6

    # Primal-weight (omega) update.
    primal_weight_update: bool = False
    theta_smooth: float = 0.5
    #: Clamp omega to [omega0/omega_clamp, omega0*omega_clamp]; 0 disables.
    omega_clamp: float = 1e2

    # Infeasibility certificates (they force the per-iteration loop).
    infeasibility_detect: bool = False
    infeas_tol: float = 1e-4
    normalized_certificates: bool = False
    normalized_tol_conv: float = 1e-4
    normalized_tol_nonzero: float = 1e-3

    # Precision escalation below the fp32 floor (not ported yet).
    precision_escalation: bool = True
    escalation_tol: float = 1e-6
    escalation_scheme: str = "auto"
    escalation_mode: str = "auto"
    refine_round_factor: float = 1e-3
    refine_round_kkt: int = 0
    refine_max_rounds: int = 10
    refine_clip: float = 100.0
    refine_zoom: float = 1e6
    refine_dual_cap: float = 100.0
    refine_polish: bool = True

    #: PDHG-step operator products: "auto" | "exact" | "fast".  Validated;
    #: every operator of this port has exact products only.
    step_products: str = "auto"

    #: "blocked" (restart_period steps, then the restart check), "periter"
    #: (every iteration gated) or "auto" (blocked whenever legal).
    loop_mode: str = "auto"

    # Initialisation.
    eta_safety: float = 0.9
    power_iters: int = 100
    theta: float = 1.0  # extrapolation

    # Scaling: "none" | "ruiz" | "ruiz+pc" (Ruiz then Pock-Chambolle).
    scaling: str = "none"
    ruiz_iters: int = 20
    ruiz_eps: float = 1e-6
    pock_chambolle_alpha: float = 1.0

    #: Termination norms ||q||, ||c|| from the scaled data (the reference's
    #: behaviour) or, when False, from the unscaled data.
    compat_scaled_norms: bool = True

    # Host chunking: KKT passes per chunk between wall-clock checks.
    chunk_kkt_init: int = 2000
    chunk_kkt_max: int = 8000
    #: TPU dispatch options of the JAX package; accepted, no effect here.
    host_speculation: bool = True
    eager_fetch_max: int = 32768

    verbose: bool = False

    def __post_init__(self):
        _check = {
            "step_scheme": ("vanilla", "halpern"),
            "adaptive_rule": ("reference", "linesearch"),
            "scaling": ("none", "ruiz", "ruiz+pc"),
            "escalation_scheme": ("auto", "inherit"),
            "escalation_mode": ("auto", "refine", "fp64_tail"),
            "step_products": ("auto", "exact", "fast"),
            "loop_mode": ("auto", "blocked", "periter"),
        }
        for field, allowed in _check.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"unknown {field}: {v!r} (expected one of {allowed})"
                )

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


def fast_step_products(cfg: SolverConfig) -> bool:
    """Resolve cfg.step_products: True -> steps use op.mv_fast/rmv_fast."""
    if cfg.step_products == "fast":
        return True
    if cfg.step_products == "exact":
        return False
    return cfg.tol >= 1e-4
