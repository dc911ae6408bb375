"""Wall-clock timer and profiler trace (counterpart of tpdlp/timer.py), and
the port's spans and counters.

`launched` is the port's one counter registry (`solver/loop.py` exports it
under the same name).  `span(name)` times a block of a solve on the host's
clock into it, and, while a torch profiler records, also opens a
function-scope profiler record `tpdlp.<name>`, so that the profiler's host
timeline names each phase beside CUPTI's device records.  A function-scope
record is not mirrored onto the device timeline as a user-scope
`record_function` range is, and costs nothing when no profiler runs.
"""

from __future__ import annotations

import contextlib as _contextlib
import os
import threading
import time

import torch

try:
    from torch._C._profiler import _RecordFunctionFast as _Record
except ImportError:  # a torch without it: the spans count, unrecorded
    _Record = None

_profiling = torch._C._autograd._profiler_enabled

#: The port's counters, summed over every solve of the process since
#: `solver.loop.reset_launched()`:
#: - "iterations", "restart_checks": iterations and restart checks the
#:   runners issued to the device, masked ones included (each issues its K
#:   products whether or not it counts in k); like `ops._kernels.launches`,
#:   for launch accounting;
#: - "selects": the `torch.where` calls of `solver.loop._select`, one a
#:   state field that the selected state replaces;
#: - "<name>_ns" and "<name>_n" for each `span` name: its host wall in
#:   `time.perf_counter_ns` nanoseconds, and how often it ran;
#: - "check_dev_ns": the restart checks' device time between CUDA events
#:   (CUDA only).
launched = {"iterations": 0, "restart_checks": 0, "selects": 0}

#: Per thread: the span `until_read` left open, and the (key, start, end)
#: CUDA event pairs that the next host read settles.
_local = threading.local()


def _add(key: str, value: int) -> None:
    launched[key] = launched.get(key, 0) + value


def _state():
    if not hasattr(_local, "open"):
        _local.open, _local.timed = None, []
    return _local


class span:
    """`with span("steps"): ...` adds the block's host wall to
    `launched["steps_ns"]` and 1 to `launched["steps_n"]`.

    With `device` a CUDA device, two CUDA events on its current stream
    also bracket the device work the block issues; the first host read
    after it (`host_read`), which has waited for that work, adds their
    elapsed time to `launched["<name>_dev_ns"]`, so no synchronisation is
    added.  `.ns` holds the last wall."""

    __slots__ = ("name", "ns", "_t0", "_rec", "_events", "_stream")

    def __init__(self, name: str, device=None):
        self.name = name
        self.ns = 0
        self._rec = self._events = None
        if device is not None and device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        if _Record is not None and _profiling():
            self._rec = _Record("tpdlp." + self.name)
            self._rec.__enter__()
        if self._events is not None:
            self._events[0].record(self._stream)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._close(True)
        return False

    def _close(self, count: bool) -> None:
        self.ns = time.perf_counter_ns() - self._t0
        if self._events is not None:
            self._events[1].record(self._stream)
            if count:
                _state().timed.append((self.name + "_dev_ns",
                                       *self._events))
        if self._rec is not None:
            self._rec.__exit__(None, None, None)
            self._rec = None
        if count:
            _add(self.name + "_ns", self.ns)
            _add(self.name + "_n", 1)


class host_read(span):
    """The span "read" around one device-to-host copy, which waits for the
    device.  On exit it settles the device time of the spans timed by CUDA
    events that the read waited for, then closes the span that
    `until_read` left open."""

    __slots__ = ()

    def __init__(self):
        super().__init__("read")

    def __exit__(self, *exc):
        self._close(True)
        st = _state()
        left = []
        for key, start, end in st.timed:
            if end.query():
                _add(key, round(start.elapsed_time(end) * 1e6))
            else:  # another device's work: settled by a later read
                left.append((key, start, end))
        st.timed = left
        end_pending()
        return False


def until_read(name: str) -> None:
    """Open the span `name` until the end of the next `host_read` (which
    it then includes, and with it the device work it waited for) or
    `end_pending()`.  One left open by a solve that raised is dropped
    uncounted."""
    st = _state()
    if st.open is not None:
        st.open._close(False)
    st.open = span(name).__enter__()


def end_pending() -> None:
    """Close the span `until_read` left open, if any."""
    st = _state()
    if st.open is not None:
        st.open, s = None, st.open
        s._close(True)


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
    exists.  The port's spans appear as `tpdlp.<name>` host records.

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
