"""The device an entry point runs on (below the ops and problem layers)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpdlp_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def describe(dev: torch.device) -> dict:
    """The device's name and, for a CUDA card, its power limit as
    `nvidia-smi --query-gpu=name,power.limit` reports it (None where
    nvidia-smi does not answer): what a benchmark artifact records beside
    its numbers."""
    if dev.type != "cuda":
        return {"device": str(dev), "power_limit": None}
    import subprocess

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0:
            limit = out.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"device": torch.cuda.get_device_name(index), "power_limit": limit}
