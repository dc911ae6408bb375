"""The readers of the program's spans and counters (prep_share,
check_share, select_ops_per_iter) on hand-built records, where the counters
are missing, and on a run of a tiny fleet on the CPU."""

import time
import types

import pytest

from benchmark import harness, spec
from benchmark.tests.tiny import tiny_root

prep = spec.metric("prep_share")
check = spec.metric("check_share")
selects = spec.metric("select_ops_per_iter")


def _request(i, wall, profile=None, **counters):
    return harness.Request(i, 10.0 * i, 10.0 * i + wall, 64, [],
                           {f"loop.{k}": v for k, v in counters.items()},
                           profile)


def _run(*requests):
    return harness.RunRecord(
        cell=None, m=8000, n=20000, nnz=320000, item=4, batch=64,
        setup_s=15.0, window_s=sum(r.wall for r in requests),
        requests=list(requests), peak_window_bytes=None, solved_ok=0)


def test_shares_read_the_untraced_requests():
    run = _run(
        # Profiled requests: left out of the shares (their wall is the
        # profiler's), counted in the selects.
        _request(0, 9.0, "device", iterations=100, selects=1000,
                 prep_ns=8e9, check_dev_ns=8e9),
        _request(1, 9.0, "host", iterations=100, selects=1000,
                 prep_ns=8e9, check_dev_ns=8e9),
        _request(2, 2.0, iterations=100, selects=1600, prep_ns=1e8,
                 check_dev_ns=5e7),
        _request(3, 2.0, iterations=100, selects=1600, prep_ns=3e8,
                 check_dev_ns=1.5e8))
    assert prep.read(run) == pytest.approx(100 * 0.4 / 4.0)
    assert check.read(run) == pytest.approx(100 * 0.2 / 4.0)
    assert selects.read(run) == pytest.approx(5200 / 400)


def test_missing_counters_read_none():
    # The parent of the spans: the loop counts iterations and checks only.
    old = _run(_request(0, 2.0, iterations=100, restart_checks=3),
               _request(1, 2.0, iterations=100, restart_checks=3))
    assert prep.read(old) is None
    assert check.read(old) is None
    assert selects.read(old) is None
    # A CPU run has spans and selects but no CUDA events.
    cpu = _run(_request(0, 2.0, iterations=100, selects=1500,
                        prep_ns=1e8))
    assert check.read(cpu) is None
    assert prep.read(cpu) == pytest.approx(5.0)
    # Only profiled requests: no share to read.
    traced = _run(_request(0, 2.0, "device", iterations=100, selects=1500,
                           prep_ns=1e8, check_dev_ns=1e8))
    assert prep.read(traced) is None and check.read(traced) is None


def test_the_readers_on_a_cpu_fleet_run(tmp_path, monkeypatch):
    """The readers on the record of a tiny fleet's run on the CPU, taken
    where the harness hands it to its own readers."""
    records, real = [], spec.metric

    def metric(name, root=spec.ROOT):
        module = real(name, root)
        return types.SimpleNamespace(
            read=lambda run: records.append(run) or module.read(run))

    monkeypatch.setattr(spec, "metric", metric)
    cell = spec.load_cell("tiny.mix", tiny_root(
        tmp_path, entry="solve_batch", batch=4, matrix_format="dense"))
    result = harness.run_cell(cell, 2**31 + 11, 0.3, False, "cpu",
                              time.perf_counter())
    assert result["correct"] and records
    run = records[0]
    assert 0 < prep.read(run) < 100
    assert 10 <= selects.read(run) <= 40
    assert check.read(run) is None
