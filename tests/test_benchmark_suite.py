"""The benchmark's own CPU tests (`benchmark/tests`) as one test of this
suite.  They run in a subprocess: they check what the benchmark's process
imports, and this suite's conftest imports JAX."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_the_benchmarks_own_tests_pass():
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q", "-p",
         "no:cacheprovider"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert r.returncode == 0, r.stdout[-6000:] + r.stderr[-2000:]
