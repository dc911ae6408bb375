"""What a cell is made of, found by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix, and the metrics.  Each of these is a file
of its own under `benchmark/`:

    configs/<file named in BENCHMARK.json>   the deployment: LP generator,
                                             sizes, layout, solver settings
    traffic/<traffic>.json                   the request mix
    cells/<workload>.json                    the cell's own settings: the
                                             limits of its correctness check
                                             and the requests a traced run
                                             profiles
    metrics/<metric>.py                      one reader per metric
    generators/<generator>.py                one LP construction each

so a later change adds a cell, a configuration, a traffic mix or a metric
by adding files and entries, never by editing a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

#: The root of the checkout: BENCHMARK.json and benchmark/ lie here.
ROOT = Path(__file__).resolve().parent.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list
    root: Path

    def metrics(self, trace: bool) -> list:
        """The metric entries a run reports: the per-layer ones with
        `--trace 1`, else the end-to-end ones."""
        return self.per_layer if trace else self.end_to_end


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json; KeyError naming the known
    cells when there is none."""
    bench = _json(root / "BENCHMARK.json")
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(workloads)}")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        settings=_json(root / "benchmark" / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        root=root,
    )


def load_module(path: Path) -> ModuleType:
    """Import one file of the benchmark by its path (metric and generator
    names need not be Python identifiers)."""
    tag = "".join(ch if ch.isalnum() else "_" for ch in
                  f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{tag}",
                                                  path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    # Registered first: dataclasses look their module up while it runs.
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def metric(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of metric `name`: metrics/<name>.py, with read(run)."""
    return load_module(root / "benchmark" / "metrics" / f"{name}.py")


def generator(name: str, root: Path = ROOT) -> ModuleType:
    """LP construction `name`: generators/<name>.py, with
    build(instance, seed)."""
    return load_module(root / "benchmark" / "generators" / f"{name}.py")
