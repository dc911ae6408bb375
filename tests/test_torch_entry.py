"""The port's entry points (tpdlp_torch/entry.py) against
__graft_entry__.py: `entry()`'s one flagship iteration equals the JAX
`make_body` step to 1e-12 in fp64, from the same state; and
`dryrun_multichip(4)` solves to Solved under the three sharded layouts on
four gloo ranks on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import tpdlp_torch
from tpdlp_torch.convert import state_from_numpy, state_to_numpy
from tpdlp_torch.entry import dryrun_multichip, entry

torch.set_num_threads(2)


def _fields(st):
    return {f.name: np.asarray(jax.device_get(getattr(st, f.name)))
            for f in dataclasses.fields(st)}


def test_entry_step_equals_jax_make_body():
    body_j, (st_j,) = graft.entry()
    body_t, (st_t,) = entry(device="cpu", dtype=torch.float64)
    start = _fields(st_j)
    # The same instance, scaling and starting point on both sides.
    got = state_to_numpy(st_t)
    for k, v in start.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    # One step from the JAX state, carried across, on each side.
    out_j = _fields(jax.jit(body_j)(st_j))
    out_t = state_to_numpy(body_t(state_from_numpy(start, device="cpu")))
    assert int(out_t["k"]) == int(out_j["k"]) == 1
    assert int(out_t["j"]) == int(out_j["j"])
    assert int(out_t["status"]) == int(out_j["status"])
    for k, v in out_j.items():
        np.testing.assert_allclose(out_t[k], v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_entry_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    out = dryrun_multichip(4, device="cpu")
    assert set(out) == {"dense", "sparse", "band"}
    assert "dryrun_multichip OK: mesh (2, 2) (4 ranks, gloo on cpu)" in (
        capsys.readouterr().out)
    # The JAX function's instances, solved unsharded by the port: the
    # objectives the three sharded solves reach, to the tolerance.
    cfg = tpdlp_torch.SolverConfig(tol=1e-5, max_kkt=40_000, scaling="ruiz",
                                   adaptive=True, primal_weight_update=True)
    dense = tpdlp_torch.solve(
        tpdlp_torch.generate_feasible_lp(n=45, m_ineq=26, m_eq=9, seed=0),
        cfg, device="cpu")
    band = tpdlp_torch.solve(
        tpdlp_torch.generate_banded_lp(n=520, m_ineq=260, m_eq=130,
                                       bandwidth=33, seed=1),
        cfg, device="cpu", matrix_format="band")
    for name, ref in (("dense", dense), ("sparse", dense), ("band", band)):
        assert abs(out[name][1] - ref.objective) <= 5e-5 * (
            1 + abs(ref.objective)), name
