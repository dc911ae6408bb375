"""The port stands alone: no file of tpdlp_torch (nor chip_smoke.py)
imports JAX or the JAX package, importing it loads no JAX and changes no
global torch state, and its entry points never fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import tpdlp_torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpdlp_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tpdlp")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpdlp_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"tpdlp_torch/ops/_kernels.py", "tpdlp_torch/solver/loop.py",
            "chip_smoke.py"} <= names
    assert _forbidden("tpdlp.solver") and not _forbidden("tpdlp_torch.ops")


def test_import_loads_no_jax_and_keeps_torch_state():
    code = (
        "import sys, torch\n"
        "before = (torch.get_default_dtype(), "
        "torch.backends.cuda.matmul.allow_tf32, "
        "torch.get_float32_matmul_precision())\n"
        "import tpdlp_torch, tpdlp_torch.convert, tpdlp_torch.bench.suite\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'tpdlp' or m.startswith('tpdlp.') "
        "for m in sys.modules), 'tpdlp imported'\n"
        "after = (torch.get_default_dtype(), "
        "torch.backends.cuda.matmul.allow_tf32, "
        "torch.get_float32_matmul_precision())\n"
        "assert before == after, (before, after)\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


def test_solve_without_device_needs_cuda():
    p = tpdlp_torch.generate_feasible_lp(n=8, m_ineq=3, m_eq=2, seed=0)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpdlp_torch.solve(p)
    r = tpdlp_torch.solve(p, tpdlp_torch.SolverConfig(scaling="ruiz"),
                          device="cpu")
    assert r.x.dtype.name == "float64"


def test_chip_smoke_needs_a_card_and_the_repo(tmp_path):
    """Without CUDA the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
