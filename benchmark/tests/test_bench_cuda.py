"""On the card: a tiny cell's run and traced run through the harness, as
`python3 -m benchmark.run` makes them, and the control of every cell of
BENCHMARK.json at the cell's own size.  Skips without a CUDA card.

    python3 -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

import sys
import time

import pytest
import torch

from benchmark import control, harness, run, spec
from benchmark.tests.test_bench_spec import CELLS
from benchmark.tests.tiny import tiny_root

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    # The program handed K moved by bfloat16's backward error drives a
    # whole run of the cell, its LP and traffic at their own size, through
    # the harness.
    cell = spec.load_cell(name)
    seed = 2**33 + 5
    with control.perturbed_operator(seed):
        low = harness.run_cell(cell, seed, 1.0, False, "cuda",
                               time.perf_counter())
    kkt = low["checks"]["kkt_rel"]
    assert not low["correct"] and kkt["value"] > kkt["limit"]
    assert low["failed"] >= 1


@pytest.mark.parametrize("fmt,entry,batch,kernel_metric", [
    ("sparse", "solve", 1, "csr_roofline"),
    ("dense", "solve", 1, "k1_roofline"),
    ("dense", "solve_batch", 4, "k1_batch_roofline")])
def test_a_tiny_cell_on_the_card(card, tmp_path, fmt, entry, batch,
                                 kernel_metric):
    cell = spec.load_cell("tiny.mix", tiny_root(
        tmp_path, matrix_format=fmt, entry=entry, batch=batch))
    plain = harness.run_cell(cell, 2**33 + 1, 0.5, False, "cuda",
                             time.perf_counter())
    assert plain["correct"] and plain["failed"] == 0
    dev = plain["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    assert plain["metrics"]["peak_mem_gb"]["value"] > 0
    traced = harness.run_cell(cell, 2**33 + 2, 0.5, True, "cuda",
                              time.perf_counter())
    assert traced["correct"]
    m = traced["metrics"]
    assert 0 < m["idle_share"]["value"] < 100
    assert 0 < m[kernel_metric]["value"] <= 105
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert traced["breakdown"]["device_ops"]
    assert list(traced)[-1] == "checks"
    assert not run.forbidden_modules(), sorted(sys.modules)
