"""The port's reference-compatible entry points (`tpdlp_torch.compat`)
against the JAX package's (`tpdlp.compat`): the same signatures, and the
same return tuples on a vendored instance in fp64 on the CPU (JAX
power-iteration draw injected; exact under fixed steps, the objective
within 5*tol under the adaptive rule)."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpdlp import compat as jax_compat
from tpdlp.bench.suite import INSTANCES_DIR
import tpdlp_torch.solver.power_iteration as PI
from tpdlp_torch import compat
from tpdlp_torch.bench.suite import INSTANCES_DIR as PORT_INSTANCES

torch.set_num_threads(2)

NAMES = ["pdhg_solver", "restarted_solver", "pdlp_solver"]


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(PI, "initial_vector", _jax_b0)
    monkeypatch.setattr(compat, "DEVICE", "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_signatures_equal_jax(name):
    assert inspect.signature(getattr(compat, name)) == inspect.signature(
        getattr(jax_compat, name))


def _paths(name):
    return (os.path.join(INSTANCES_DIR, name),
            os.path.join(PORT_INSTANCES, name))


def _same_tuple(a, b, rtol=1e-9):
    assert len(a) == len(b)
    np.testing.assert_allclose(a[0], np.asarray(b[0]), rtol=rtol, atol=rtol)
    assert a[1] == pytest.approx(b[1], rel=rtol)
    assert tuple(a[2:]) == tuple(b[2:])


@pytest.mark.parametrize("name,kw", [
    ("pdhg_solver", dict(max_iter=20000, tol=1e-4)),
    ("restarted_solver", dict(tol=1e-6)),
    ("pdlp_solver", dict(tol=1e-6, adaptive_step=False)),
])
def test_tuples_match_jax_fixed_steps(on_cpu, name, kw):
    pj, pt = _paths("netlib/afiro.mps")
    a = getattr(compat, name)(pt, verbose=False, **kw)
    b = getattr(jax_compat, name)(pj, verbose=False, **kw)
    _same_tuple(a, b)
    assert a[0].dtype == np.float64


def test_pdlp_solver_adaptive_same_objective(on_cpu):
    pj, pt = _paths("blend04.mps")
    a = compat.pdlp_solver(pt, tol=1e-4, verbose=False)
    b = jax_compat.pdlp_solver(pj, tol=1e-4, verbose=False)
    assert len(a) == len(b) == 5
    assert a[1] == pytest.approx(b[1], abs=5e-4 * (1 + abs(b[1])))


def test_verbose_names_the_torch_device(on_cpu, capsys):
    _, pt = _paths("netlib/afiro.mps")
    compat.restarted_solver(pt, tol=1e-4)
    out = capsys.readouterr().out
    assert "torch device: cpu" in out and "Restarts:" in out


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, pt = _paths("netlib/afiro.mps")
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.pdlp_solver(pt, verbose=False)
