"""The control's perturbation of K: each stored value times (1 + delta),
|delta| <= 2**-8, drawn from the seed; the pattern and the generated LP
stay as they are, and a run under `perturbed_operator` hands the program
the one perturbed K, drawn once."""

import dataclasses

import numpy as np
import pytest

from benchmark import control, program
from benchmark.generators import feasible_lp
from benchmark.tests import transport
from benchmark.tests.tiny import TINY_INSTANCE, TRANSPORT_INSTANCE

SEED = 2**33 + 7
LPS = {"random": lambda: feasible_lp.build(TINY_INSTANCE, SEED),
       "transport": lambda: transport.build(TRANSPORT_INSTANCE, SEED)}


def _bytes(K):
    return [a.tobytes() for a in (K.indptr, K.indices, K.data)]


@pytest.mark.parametrize("kind", sorted(LPS))
def test_every_value_moves_within_bfloat16s_unit_roundoff(kind):
    K = LPS[kind]().K
    low = control.perturbed(K, SEED)
    assert np.array_equal(low.indptr, K.indptr)
    assert np.array_equal(low.indices, K.indices)
    assert np.all(K.data != 0) and np.all(low.data != K.data)
    delta = low.data / K.data - 1.0
    # The quotient's own rounding: a few units of float64's last place.
    assert np.max(np.abs(delta)) <= 2.0**-8 + 1e-15
    assert np.max(np.abs(delta)) > 0.9 * 2.0**-8


@pytest.mark.parametrize("kind", sorted(LPS))
def test_the_same_seed_gives_the_same_k_and_the_lp_is_untouched(kind):
    lp = LPS[kind]()
    a = control.perturbed(lp.K, SEED)
    b = control.perturbed(lp.K, SEED)
    c = control.perturbed(lp.K, SEED + 1)
    assert _bytes(a) == _bytes(b) != _bytes(c)
    fresh = LPS[kind]()
    assert _bytes(lp.K) == _bytes(fresh.K)
    for field in ("c", "q", "l", "u"):
        assert getattr(lp, field).tobytes() == getattr(fresh, field).tobytes()


def test_a_run_under_the_control_hands_the_program_one_perturbed_k(
        monkeypatch):
    handed = []
    monkeypatch.setattr(program.Program, "run",
                        lambda self, lps, seed: handed.append(lps) or [])
    lp = LPS["transport"]()
    before = _bytes(lp.K)
    requests = [[dataclasses.replace(lp, c=lp.c * (1 + 0.01 * i))] * 2
                for i in range(3)]
    with control.perturbed_operator(SEED):
        for i, lps in enumerate(requests):
            program.Program.run(None, lps, seed=i)
    assert len(handed) == 3
    Ks = {id(p.K) for lps in handed for p in lps}
    assert len(Ks) == 1 and id(lp.K) not in Ks
    assert _bytes(handed[0][0].K) == _bytes(control.perturbed(lp.K, SEED))
    assert [p.c.tobytes() for lps in handed for p in lps] == [
        p.c.tobytes() for lps in requests for p in lps]
    assert _bytes(lp.K) == before
    handed.clear()
    program.Program.run(None, requests[0], seed=0)
    assert handed[0][0].K is lp.K
