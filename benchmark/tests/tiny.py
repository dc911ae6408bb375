"""A copy of the benchmark with one more cell, `tiny.mix`, added the way a
later change adds one: new files and new entries, no existing file edited.
Small enough to run on the CPU.  Its LP is the frozen generator's, or a
new generator file of this directory (`transport.py`) copied in."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import spec

TINY_INSTANCE = {"n": 300, "m_ineq": 90, "m_eq": 30, "density": 0.05,
                 "bounds": "box"}
#: The transport LP of `transport.py`: 8 x 8 pixels, 4,096 columns.
TRANSPORT_INSTANCE = {"resolution": 8}
TINY_LIMIT = 3e-4


def tiny_root(tmp: Path, *, matrix_format="sparse", entry="solve",
              batch=1, max_kkt=20000, generator="feasible_lp",
              instance=TINY_INSTANCE) -> Path:
    """A checkout's benchmark files under `tmp` plus the cell `tiny.mix`
    (a new configuration, traffic mix, cell file and metric, and the
    generator file `generator`.py of this directory where the benchmark
    has none of that name)."""
    root = tmp / "checkout"
    root.mkdir(parents=True)
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / bench["configs"][0]["file"]).read_text())
    gen = root / "benchmark/generators" / f"{generator}.py"
    if not gen.exists():
        shutil.copy(Path(__file__).with_name(gen.name), gen)
    cfg.update(name="tiny", generator=generator, instance=instance,
               matrix_format=matrix_format)
    cfg["solver"]["max_kkt"] = max_kkt
    _write(root / "benchmark/configs/tiny.json", cfg)
    _write(root / "benchmark/traffic/tiny-mix.json", {
        "entry": entry, "batch": batch, "cost_rel": 0.05, "solver": {},
        "why": "test"})
    _write(root / "benchmark/cells/tiny.mix.json", {
        "why": "test", "limits": {"not_solved": 0, "kkt_rel": TINY_LIMIT},
        "traced_requests": 1})
    (root / "benchmark/metrics/lps_attempted.py").write_text(
        "def read(run):\n"
        "    return sum(r.lps for r in run.requests)\n")
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.mix", "config": "tiny",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "lps_attempted", "unit": "lp",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny.mix"]})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny.mix")
    # Metric files that no cell of BENCHMARK.json reads yet, taken up by
    # entries alone.
    for name, unit, source, layer in [
            ("csr_roofline", "%", "device_trace", "kernels"),
            ("k1_roofline", "%", "device_trace", "kernels"),
            ("iter_per_s", "it/s", "program_counter", "restart loop")]:
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "higher",
            "source": source, "layer": layer, "moves": "lp_per_s",
            "workloads": ["tiny.mix"]})
    _write(root / "BENCHMARK.json", bench)
    return root


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")
