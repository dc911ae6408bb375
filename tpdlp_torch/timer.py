"""Wall-clock timer and profiler trace (counterpart of tpdlp/timer.py)."""

from __future__ import annotations

import contextlib as _contextlib
import os
import time

import torch


class Timer:
    """with Timer("label"): ...  -> prints elapsed seconds on exit.

    `Timer("x", quiet=True)` only records `.elapsed`.  CUDA work is
    asynchronous: with `device` a CUDA device (or a tensor on one), the
    timer synchronises that device on entry and on exit, so the elapsed
    time covers the device work the enclosed region queued.
    """

    def __init__(self, label: str = "Elapsed time", quiet: bool = False,
                 device=None):
        self.label = label
        self.quiet = quiet
        self.elapsed = 0.0
        if isinstance(device, torch.Tensor):
            device = device.device
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self.start
        if not self.quiet:
            print(f"{self.label}: {self.elapsed:.6f} seconds")
        return False


@_contextlib.contextmanager
def profile_trace(log_dir):
    """Capture a torch.profiler trace of the enclosed region into
    `log_dir` (a Chrome trace, `trace.json`; open it in Perfetto or
    chrome://tracing): CPU activity, and CUDA activity where a CUDA device
    exists.

        with tpdlp_torch.timer.profile_trace("/tmp/tpdlp-trace"):
            tpdlp_torch.solve(problem, cfg)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
