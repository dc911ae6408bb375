"""Scenario-batched solves (counterpart of tpdlp/batch)."""

from tpdlp_torch.batch.vmapped import solve_batch

__all__ = ["solve_batch"]
