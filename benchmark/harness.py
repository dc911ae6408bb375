"""One run of one cell: set-up, the measured window, the check, the line.

    set-up   the LP from the seed (the cell's generator), the traffic's cost
             sets, and one warm request on the warm-up's costs, which builds
             or loads the kernel library (build/tpdlp_torch/ in the
             checkout) and runs every shape the window runs
    window   a closed loop: request i starts when request i - 1 has
             returned; the window starts with request 0 and ends when the
             first request to finish past `seconds` finishes
    check    every LP of the window against the reference (reference.py)
    line     the contract's JSON object

With `trace` the profiler covers the device activity of the cell's first
`traced_requests` requests of the window, which the per-layer metrics
read, and host and device activity of the next request, which names the
idle gaps of the breakdown.  Metrics of the host clock read the untraced
requests.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import sys
import time

from benchmark import spec as S
from benchmark.reference import Reference
from benchmark.traffic import Traffic

#: The status string of an answer within the tolerance.
SOLVED = "Solved"
#: The solver seed of the warm-up request; request i of the window takes i.
WARM_SEED = 1_000_003


@dataclasses.dataclass
class Request:
    index: int
    t0: float
    t1: float
    lps: int
    answers: list
    counters: dict  # the program's counters' increments over the request
    profile: str | None  # None, "device" or "host" (host and device)

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (metrics/<name>.py: read(run))."""

    cell: S.Cell
    m: int
    n: int
    nnz: int
    item: int
    batch: int
    setup_s: float
    window_s: float
    requests: list
    peak_window_bytes: int | None  # None off the card
    solved_ok: int
    #: trace.TraceData of the traced requests; None off the card, whose
    #: trace has no device to read.
    trace: object = None

    @property
    def untraced(self) -> list:
        """The requests that ran with no profiler."""
        return [r for r in self.requests if r.profile is None]

    @property
    def traced(self) -> list:
        """The requests of `trace`, the device profile."""
        return [r for r in self.requests if r.profile == "device"]

    def counted(self, name: str, requests) -> int:
        return sum(r.counters.get(name, 0) for r in requests)


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _device(device, cell, peak_bytes) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": None}
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        power = out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        power = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": peak_bytes,
            "power_limit": power}


def run_cell(cell: S.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, log=sys.stderr) -> dict:
    """One run of `cell`; `t0` is the process's start on the
    perf_counter clock.  Returns the result line as a dict."""
    import torch

    marks = [("python and torch", time.perf_counter())]
    from benchmark import program

    marks.append(("program import", time.perf_counter()))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
    marks.append(("CUDA init", time.perf_counter()))
    config, settings = cell.config, cell.settings
    lp = S.generator(config["generator"], cell.root).build(
        config["instance"], seed)
    marks.append(("LP", time.perf_counter()))
    traffic = Traffic(cell.traffic, lp, seed)
    prog = program.Program(config, cell.traffic, device)
    marks.append(("traffic", time.perf_counter()))
    prog.run(traffic.request(-1), seed=WARM_SEED)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm request", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("[bench] set-up s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev in
        zip(marks, [t0] + [t for _, t in marks])), file=log)

    traced_n = int(settings.get("traced_requests", 2)) if trace else 0
    # Requests 0 .. traced_n - 1 under a device profile, request traced_n
    # under a host and device one, the rest under none.
    kinds = ["device"] * traced_n + ["host"] if traced_n else []

    def kind(i):
        return kinds[i] if 0 <= i < len(kinds) else None

    profile, traces, requests = None, [], []
    start = time.perf_counter()
    while True:
        i = len(requests)
        lps = traffic.request(i)
        if kind(i) is not None and kind(i) != kind(i - 1):
            from benchmark.trace import Profile

            profile, first = Profile(host=kind(i) == "host"), i
            profile.start()
        c0 = program.counters()
        r0 = time.perf_counter()
        answers = prog.run(lps, seed=i)
        r1 = time.perf_counter()
        requests.append(Request(i, r0, r1, len(lps), answers,
                                _delta(program.counters(), c0), kind(i)))
        done = r1 - start >= seconds
        if profile is not None and (kind(i + 1) != kind(i) or done):
            traces.append(profile.stop((r1 - requests[first].t0) * 1e6))
            profile = None
        if done:
            break
    window_s = requests[-1].t1 - start
    trace_data = traces[0] if traces else None
    labels = traces[1] if len(traces) > 1 else None
    peak_window = torch.cuda.max_memory_allocated() if cuda else None

    # The check: every LP of the window, against the reference.
    limit = float(settings["limits"]["kkt_rel"])
    ref = Reference(lp)
    worst, not_solved, solved_ok = 0.0, 0, 0
    for req in requests:
        for b in range(req.lps):
            a = req.answers[b] if b < len(req.answers) else None
            if a is None:
                not_solved += 1
                continue
            kkt = ref.kkt(traffic.cost(req.index, b), a.x, a.y,
                          a.objective)["kkt_rel"]
            worst = max(worst, kkt)
            if a.status != SOLVED:
                not_solved += 1
            elif kkt <= limit:
                solved_ok += 1
    attempted = sum(r.lps for r in requests)
    checks = {"not_solved": {"value": not_solved,
                             "limit": int(settings["limits"]["not_solved"])},
              "kkt_rel": {"value": worst, "limit": limit}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    rec = RunRecord(
        cell=cell, m=lp.K.shape[0], n=lp.K.shape[1], nnz=int(lp.K.nnz),
        item=prog.dtype.itemsize, batch=traffic.batch, setup_s=setup_s,
        window_s=window_s, requests=requests, peak_window_bytes=peak_window,
        solved_ok=solved_ok, trace=trace_data if cuda else None)
    metrics = {}
    for entry in cell.metrics(trace):
        value = S.metric(entry["name"], cell.root).read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    walls = [r.wall for r in requests]
    ks = collections.Counter(a.iterations for r in requests
                             for a in r.answers)
    print(f"[bench] {cell.name} seed={seed} setup_s={setup_s:.3f} "
          f"requests={len(requests)} window_s={window_s:.3f} request wall "
          f"min/median/max {min(walls):.4f}/{statistics.median(walls):.4f}/"
          f"{max(walls):.4f} s, LPs by k {dict(sorted(ks.items()))}",
          file=log)
    print("[bench] request walls s: "
          + " ".join(f"{w:.3f}" for w in walls), file=log)
    dev = _device(device, cell, max(setup_peak, peak_window) if cuda
                  else None)
    result = {"correct": correct, "attempted": attempted,
              "failed": attempted - solved_ok, "metrics": metrics,
              "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = trace_data.busy_us / 1e6
        dev["window_s"] = trace_data.window_us / 1e6
        result["breakdown"] = {"device_ops": trace_data.top_device_ops()}
        if labels is not None:
            result["breakdown"]["idle_gaps"] = labels.idle_by_host_op()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=log)
    return result
