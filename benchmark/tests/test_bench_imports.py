"""What the benchmark loads: no file under benchmark/ imports JAX or the
JAX package (whole top-level names: the port's name begins with the JAX
package's), only program.py imports the port, and a run refuses the CPU."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark import run, spec

FILES = sorted((spec.ROOT / "benchmark").rglob("*.py"))
# The program's adapter, and the tests that compare with the port.
PORT_USERS = {"benchmark/program.py",
              "benchmark/tests/test_bench_generator.py",
              "benchmark/tests/test_bench_faults.py"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(spec.ROOT).as_posix())
def test_no_jax_and_the_port_only_through_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(run.FORBIDDEN), path
    rel = path.relative_to(spec.ROOT).as_posix()
    if rel not in PORT_USERS:
        assert "tpdlp_torch" not in tops, rel


def test_forbidden_names_are_whole_top_level_names():
    assert set(run.FORBIDDEN) == {"jax", "jaxlib", "flax", "tpdlp"}
    before = dict(sys.modules)
    try:
        sys.modules["tpdlp_torch_fake"] = sys
        sys.modules["jaxfoo.bar"] = sys
        assert "tpdlp" not in run.forbidden_modules()
        sys.modules["tpdlp.solver"] = sys
        assert run.forbidden_modules() == ["tpdlp"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_a_run_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mittelmann-l.fleet64", "--seed", str(2**33), "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is false" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
