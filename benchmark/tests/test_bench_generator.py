"""The benchmark's frozen generator: the same seed gives the same LP, byte
for byte, and it is the construction the port carries."""

import numpy as np
import pytest

from benchmark.generators import feasible_lp
from benchmark.traffic import Traffic

SMALL = {"n": 120, "m_ineq": 40, "m_eq": 15, "density": 0.1}


def _bytes(lp):
    K = lp.K.tocsr()
    return [a.tobytes() for a in (lp.c, lp.q, lp.l, lp.u, K.indptr,
                                  K.indices, K.data)] + [lp.m_ineq]


@pytest.mark.parametrize("bounds", ["box", "mixed"])
def test_same_seed_same_lp(bounds):
    inst = dict(SMALL, bounds=bounds)
    a = feasible_lp.build(inst, 2**33 + 1)
    b = feasible_lp.build(inst, 2**33 + 1)
    c = feasible_lp.build(inst, 2**33 + 2)
    assert _bytes(a) == _bytes(b)
    assert _bytes(a) != _bytes(c)


@pytest.mark.parametrize("bounds", ["box", "mixed"])
def test_frozen_copy_is_the_ports_construction(bounds):
    from tpdlp_torch.io.generator import generate_feasible_lp

    ours = feasible_lp.build(dict(SMALL, bounds=bounds), 99)
    port = generate_feasible_lp(seed=99, bounds=bounds, **SMALL)
    assert _bytes(ours) == _bytes(port)


def test_traffic_is_seeded_per_request():
    lp = feasible_lp.build(dict(SMALL, bounds="box"), 3)
    spec = {"entry": "solve_batch", "batch": 4, "cost_rel": 0.05}
    t1, t2 = Traffic(spec, lp, 7), Traffic(spec, lp, 7)
    for i in (-1, 0, 5, 1):
        assert np.array_equal(t1.costs(i), t2.costs(i))
    assert np.array_equal(t1.cost(3, 2), Traffic(spec, lp, 7).cost(3, 2))
    # Every LP of every request, the warm-up's too, has costs of its own,
    # 5% normal perturbations of the generated c.
    rows = np.concatenate([t1.costs(i) for i in range(-1, 4)])
    assert len({r.tobytes() for r in rows}) == len(rows) == 20
    rel = rows / lp.c - 1
    assert 0.03 < rel.std() < 0.07 and abs(rel.mean()) < 0.01
    req = t1.request(4)
    assert len(req) == 4 and all(p.K is lp.K for p in req)
    assert np.array_equal(req[2].c, t1.cost(4, 2))
    assert req[0] is not t1.request(4)[0]
    assert not np.array_equal(Traffic(spec, lp, 8).cost(1, 0),
                              t1.cost(1, 0))
    with pytest.raises(ValueError):
        Traffic(dict(spec, entry="solve"), lp, 7)
