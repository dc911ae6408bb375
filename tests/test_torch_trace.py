"""The port's spans and counters (tpdlp_torch/timer.py): what a solve and a
fleet count, how the spans nest on the profiler's clock, and, on the card,
that no span reaches the device timeline and that the restart checks'
device time stays within their kernels.

This file imports neither JAX nor the JAX package, so the card tests run
on a machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import time

import pytest
import torch

import tpdlp_torch
from tpdlp_torch import timer
from tpdlp_torch.batch import vmapped
from tpdlp_torch.bench.fleet import fleet_config, perturbed_fleet
from tpdlp_torch.solver import loop as L
from tpdlp_torch.solver import solve as S

PREP = ("prep.operator", "prep.scale", "prep.power", "prep.init")
CFG = tpdlp_torch.SolverConfig(tol=1e-4)


def _lp():
    return tpdlp_torch.generate_feasible_lp(n=60, m_ineq=25, m_eq=8,
                                            seed=3)


def _call(entry, batch=8, cfg=CFG):
    """A CPU solve of `entry`, ready to call: `solve` (blocked cycles),
    `solve_periter` (masked blocks) or `solve_batch` (a fleet)."""
    p = _lp()
    if entry == "solve_batch":
        fleet = perturbed_fleet(p, batch, 0.05, 1)
        return lambda: tpdlp_torch.solve_batch(fleet, cfg, device="cpu")
    if entry == "solve_periter":
        cfg = cfg.replace(loop_mode="periter")
    return lambda: [tpdlp_torch.solve(p, cfg, device="cpu")]


def _calls(monkeypatch, module, name):
    """Count the calls of module.name (a spy around it)."""
    real, n = getattr(module, name), [0]

    def spy(*args, **kwargs):
        n[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return n


def _top_level_ns(monkeypatch):
    """Sum the walls of the spans that close with no other span open.  Only
    spans entered here count: one that an earlier test's failed solve left
    open, and that `until_read` drops, opened before the patch."""
    depth, total, seen = [0], [0], set()
    enter, close = timer.span.__enter__, timer.span._close

    def entered(self):
        depth[0] += 1
        seen.add(id(self))
        return enter(self)

    def closed(self, count):
        close(self, count)
        if id(self) not in seen:
            return
        seen.discard(id(self))
        depth[0] -= 1
        if depth[0] == 0:
            total[0] += self.ns

    monkeypatch.setattr(timer.span, "__enter__", entered)
    monkeypatch.setattr(timer.span, "_close", closed)
    return total


@pytest.mark.parametrize("entry", ["solve", "solve_periter", "solve_batch"])
def test_spans_count_and_tile_a_solve(monkeypatch, entry):
    """prep, steps, check, read and finish each count; check_n is the
    restart checks; read_n the reads the schedule implies; the top-level
    spans cover 95-100% of the call's wall."""
    if entry == "solve_batch":
        chunks = _calls(monkeypatch, vmapped, "_chunk_element")
        gathers = _calls(monkeypatch, vmapped, "_gather_results")
    else:
        chunks = _calls(monkeypatch, S, "run_chunk")
    top = _top_level_ns(monkeypatch)
    call = _call(entry)
    L.reset_launched()
    t0 = time.perf_counter_ns()
    results = call()
    wall = time.perf_counter_ns() - t0
    n = dict(L.launched)
    assert all(r.status == tpdlp_torch.Status.SOLVED for r in results)
    for name in ("prep", *PREP, "steps", "check", "read", "finish"):
        assert n[f"{name}_n"] > 0 and n[f"{name}_ns"] > 0, name
    assert n["prep_n"] == n["finish_n"] == 1
    assert n["check_n"] == n["restart_checks"] > 0
    assert "check_dev_ns" not in n  # CUDA events only on a card
    if entry == "solve_batch":
        # (status, j) per chunk and one past the last; (status, j, t) per
        # block and one past a chunk's last; the gathers.
        reads = chunks[0] + 1 + n["steps_n"] + chunks[0] + gathers[0]
    else:
        # (status, j[, t]) per block and one past a chunk's last; the
        # probe's per chunk; the result and its counters.
        reads = n["steps_n"] + 2 * chunks[0] + 2
    assert n["read_n"] == reads
    print(f"top-level spans {top[0] / wall:.4f} of the wall")
    assert 0.95 * wall <= top[0] <= wall, (top[0], wall)


def test_selects_count_the_fields_select_replaces(monkeypatch):
    """`selects` adds one a state field that `_select` replaces, and a
    fleet iteration's select replaces the fields the step moves."""
    per_call = []
    real = L._select

    def spy(mask, new, old):
        per_call.append(sum(getattr(new, f) is not getattr(old, f)
                            for f in L._FIELDS))
        return real(mask, new, old)

    monkeypatch.setattr(L, "_select", spy)
    L.reset_launched()
    _call("solve_batch")()
    n = dict(L.launched)
    assert n["selects"] == sum(per_call)
    # One select an iteration, one a check, one for the final evaluation.
    assert len(per_call) == n["iterations"] + n["restart_checks"] + 1
    step = max(set(per_call), key=per_call.count)  # an iteration's
    assert 10 <= step <= len(L._FIELDS)
    per_iter = n["selects"] / n["iterations"]
    assert step <= per_iter <= step + len(L._FIELDS) / CFG.restart_period


def _records(prof, prefix="tpdlp."):
    """(name, start_ns, end_ns) of the host records named `prefix`..."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefix)
            and e.device_type() == torch.autograd.DeviceType.CPU]


def _inside(rec, outer):
    return outer[1] <= rec[1] and rec[2] <= outer[2]


@pytest.mark.parametrize("entry", ["solve", "solve_batch"])
def test_spans_nest_on_the_profilers_clock(entry):
    """Under a CPU profiler the spans are host records `tpdlp.<name>`:
    the prep.* spans and the first read inside `tpdlp.prep`, no step,
    check or finish there, and the result's reads inside `tpdlp.finish`."""
    from torch.profiler import ProfilerActivity, profile

    call = _call(entry)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    recs = _records(prof)
    by = {}
    for r in recs:
        by.setdefault(r[0][len("tpdlp."):], []).append(r)
    for name in ("prep", *PREP, "steps", "check", "read", "finish"):
        assert by.get(name), name
    (prep,), (finish,) = by["prep"], by["finish"]
    for name in PREP:
        assert all(_inside(r, prep) for r in by[name]), name
    reads_in_prep = [r for r in by["read"] if _inside(r, prep)]
    assert len(reads_in_prep) == 1
    assert reads_in_prep[0][2] <= prep[2]
    for name in ("steps", "check"):
        assert not any(_inside(r, prep) for r in by[name])
        assert not any(_inside(r, finish) for r in by[name])
    assert prep[2] <= min(r[1] for r in by["steps"])
    assert max(r[2] for r in by["check"]) <= finish[1]
    assert any(_inside(r, finish) for r in by["read"])
    # steps and checks alternate, never nested in one another.
    for s in by["steps"]:
        assert not any(_inside(c, s) or _inside(s, c) for c in by["check"])


def test_a_span_left_open_by_a_failed_solve_is_dropped():
    L.reset_launched()
    timer.until_read("prep")
    with pytest.raises(ValueError):
        tpdlp_torch.solve_batch([_lp()], CFG, device="cpu",
                                restart_sync="neither")
    tpdlp_torch.solve(_lp(), CFG, device="cpu")
    assert L.launched["prep_n"] == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_fleet(max_kkt):
    """A device-bound fleet: 64 price scenarios of an 8000 x 20000 LP
    (the benchmark cell's shape), cut to `max_kkt` KKT passes."""
    p = tpdlp_torch.generate_feasible_lp(n=20000, m_ineq=6000, m_eq=2000,
                                         density=0.002, seed=7)
    return perturbed_fleet(p, 64, 0.05, 2), fleet_config(1e-4, max_kkt)


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True])
def test_no_device_record_carries_a_span_name(card, host):
    """The benchmark's device-only profile, and its profile of host and
    device, hold no device-typed `tpdlp.*` record."""
    from benchmark.trace import Profile

    fleet, cfg = _card_fleet(200)
    tpdlp_torch.solve_batch(fleet, cfg)  # builds the kernels
    prof = Profile(host=host)
    prof.start()
    t0 = time.perf_counter()
    tpdlp_torch.solve_batch(fleet, cfg)
    data = prof.stop((time.perf_counter() - t0) * 1e6)
    assert data.device
    assert not [n for n, _, _ in data.device if "tpdlp." in n]
    if host:
        names = {n for n, _, _ in data.host}
        assert {"tpdlp.prep", "tpdlp.steps", "tpdlp.check",
                "tpdlp.read"} <= names


@pytest.mark.cuda
def test_check_device_time_lies_within_its_kernels(card):
    """`check_dev_ns` (CUDA events around each restart check) is above 0
    and no more than the traced time from each check's first device
    operation to its last, matched to the check's launches by their
    correlation ids."""
    from torch.profiler import ProfilerActivity, profile

    fleet, cfg = _card_fleet(300)
    tpdlp_torch.solve_batch(fleet, cfg)
    L.reset_launched()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tpdlp_torch.solve_batch(fleet, cfg)
    dev_ns, checks = L.launched["check_dev_ns"], L.launched["check_n"]
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    device = {}
    for e in events:
        if e.device_type() == cuda:
            device.setdefault(e.correlation_id(), []).append(e)
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.name() == "tpdlp.check"]
    assert len(spans) == checks > 0
    traced = 0
    for a, b in spans:
        ids = {e.correlation_id() for e in events
               if e.device_type() != cuda and e.name().startswith("cu")
               and a <= e.start_ns() <= b}
        ops = [d for i in ids for d in device.get(i, [])]
        assert ops, "no device operation matched to a check"
        traced += (max(d.start_ns() + d.duration_ns() for d in ops)
                   - min(d.start_ns() for d in ops))
    print(f"check_dev_ns {dev_ns} traced {traced} checks {checks}")
    assert 0 < dev_ns <= 1.02 * traced + 5_000 * checks
