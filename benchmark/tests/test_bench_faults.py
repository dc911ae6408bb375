"""The correctness check against faults of the timed path: a run of a tiny
cell on the CPU, past the harness's look for a card, with the program
broken underneath, reads `correct` false; the sound program reads true;
and the control (K's values each moved by bfloat16's backward error, a
relative delta drawn uniformly from [-2**-8, 2**-8]) reads `correct` false
where the program reads true: on the random tiny LP, and on a transport LP
whose K, all ones, rounding to bfloat16 would leave as it is."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import tpdlp_torch
from benchmark import control, harness, spec
from benchmark.reference import Reference
from benchmark.tests.tiny import TINY_LIMIT, TRANSPORT_INSTANCE, tiny_root
from tpdlp_torch.solver import step


def _run(root):
    cell = spec.load_cell("tiny.mix", root)
    return harness.run_cell(cell, 2**32 + 3, 0.3, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("entry,batch", [("solve", 1), ("solve_batch", 4)])
def test_sound_program_is_correct(tmp_path, entry, batch):
    r = _run(tiny_root(tmp_path, entry=entry, batch=batch,
                       matrix_format="dense"))
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["kkt_rel"]["value"] <= TINY_LIMIT


def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch):
    def frozen(pb, cfg, x, y, kx, kty, eta, omega, k_new):
        return x, y, kx, eta, eta, 1, kty, None

    monkeypatch.setattr(step, "adaptive_step", frozen)
    r = _run(tiny_root(tmp_path, max_kkt=600))
    assert not r["correct"]
    assert r["failed"] == r["attempted"]


def test_half_of_a_fleet_left_out(tmp_path, monkeypatch):
    solve_batch = tpdlp_torch.solve_batch

    def half(problems, *args, **kwargs):
        done = solve_batch(problems[: len(problems) // 2], *args, **kwargs)
        return done + done

    monkeypatch.setattr(tpdlp_torch, "solve_batch", half)
    r = _run(tiny_root(tmp_path, entry="solve_batch", batch=4))
    assert not r["correct"]
    assert r["checks"]["kkt_rel"]["value"] > TINY_LIMIT


@pytest.mark.parametrize("where", ["objective", "x", "y"])
def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch,
                                                where):
    solve = tpdlp_torch.solve

    def altered(*args, **kwargs):
        r = solve(*args, **kwargs)
        if where == "objective":
            return dataclasses.replace(r, objective=r.objective * 1.01 + 1)
        v = getattr(r, where).copy()
        v[0] += 1.0
        return dataclasses.replace(r, **{where: v})

    monkeypatch.setattr(tpdlp_torch, "solve", altered)
    r = _run(tiny_root(tmp_path))
    assert not r["correct"]


def test_the_control_fails_where_the_program_passes(tmp_path):
    cell = spec.load_cell("tiny.mix", tiny_root(tmp_path,
                                                matrix_format="dense"))
    sound = control.reading(cell, 11, 0.3, False, "cpu")
    low = control.reading(cell, 11, 0.3, True, "cpu")
    assert sound["correct"] and sound["not_solved"] == 0
    assert sound["kkt_rel"] <= TINY_LIMIT
    assert not low["correct"] and low["kkt_rel"] > TINY_LIMIT


def _transport_cell(tmp_path):
    return spec.load_cell("tiny.mix", tiny_root(
        tmp_path, generator="transport", instance=TRANSPORT_INSTANCE))


def test_the_control_fails_on_a_transport_lp(tmp_path):
    # CSR, one LP a request: the path a transport cell would take.
    cell = _transport_cell(tmp_path)
    sound = control.reading(cell, 11, 0.3, False, "cpu")
    low = control.reading(cell, 11, 0.3, True, "cpu")
    assert sound["correct"] and sound["not_solved"] == 0
    assert sound["kkt_rel"] <= TINY_LIMIT
    assert not low["correct"] and low["kkt_rel"] > TINY_LIMIT


def test_rounding_to_bfloat16_leaves_a_transport_k_as_it_is(tmp_path):
    # Why the control moves K's values instead of rounding them: every
    # value of this K is exact in bfloat16, so rounding would hand the
    # program the LP it is judged by.
    cell = _transport_cell(tmp_path)
    K = spec.generator("transport", cell.root).build(
        TRANSPORT_INSTANCE, 11).K
    rounded = torch.from_numpy(K.data).to(torch.bfloat16).double().numpy()
    assert K.nnz == 2 * 64 * 64
    assert np.array_equal(rounded, K.data)


def test_reference_kkt_of_a_known_point():
    from benchmark.generators import feasible_lp

    lp = feasible_lp.build({"n": 30, "m_ineq": 10, "m_eq": 5,
                            "density": 0.3}, 4)
    ref = Reference(lp)
    K = lp.K.toarray()
    x, y = np.linspace(-1, 1, 30), np.linspace(0.5, -0.5, 15)
    assert np.allclose(ref.kx(x), K @ x) and np.allclose(ref.kty(y), K.T @ y)
    out = ref.kkt(lp.c, x, y, float(lp.c @ x))
    assert out["kkt_rel"] == max(out["primal_rel"], out["dual_rel"],
                                 out["gap_rel"]) > 0
    assert ref.kkt(lp.c, x * np.nan, y, 0.0)["kkt_rel"] == float("inf")
