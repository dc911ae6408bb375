"""Deterministic benchmark instance suite (counterpart of
tpdlp/bench/suite.py).

Three sources, as in the JAX package:
- synthetic planted-feasible LPs, afiro-class tiny up to Mittelmann-class
  large sparse, built exactly as the JAX package's `bench.py` builds them;
- the vendored realistic MPS corpus (the port's own copies under
  tpdlp_torch/bench/instances/: blending, production, transportation,
  staircase, network-flow families), class "real";
- the Netlib set through `tpdlp_torch.io.netlib` where the network
  reaches a mirror (class "netlib"; empty offline).
"""

from __future__ import annotations

import glob
import os

from tpdlp_torch.io.generator import generate_feasible_lp

INSTANCES_DIR = os.path.join(os.path.dirname(__file__), "instances")

# name, n, m_ineq, m_eq, density[, bounds]
SMALL = [
    ("afiro-class", 51, 17, 10, 0.30),
    ("sc50-class", 78, 30, 18, 0.20),
    ("share-class", 225, 90, 27, 0.15),
]
MEDIUM = [
    ("deg2-class", 757, 280, 164, 0.05),
    ("bnl-class", 1586, 500, 132, 0.02),
    ("maros-class", 2000, 600, 246, 0.02),
]
LARGE = [
    ("mittelmann-s", 5000, 1500, 500, 0.01),
    ("mittelmann-m", 10000, 3000, 1000, 0.004),
    ("mittelmann-s-free", 5000, 1500, 500, 0.01, "mixed"),
    ("mittelmann-m-free", 10000, 3000, 1000, 0.004, "mixed"),
]
XL = [
    ("mittelmann-l", 20000, 6000, 2000, 0.002),
    ("mittelmann-l-free", 20000, 6000, 2000, 0.002, "mixed"),
]

_CLASSES = {"small": SMALL, "medium": MEDIUM, "large": LARGE, "xl": XL}


def corpus_paths(include_terminal: bool = False):
    """Paths of the vendored realistic MPS corpus (sorted); the terminal
    instances (infeas01, unbnd01) only with `include_terminal`."""
    paths = sorted(glob.glob(os.path.join(INSTANCES_DIR, "*.mps")))
    if not include_terminal:
        paths = [
            f for f in paths
            if not os.path.basename(f).startswith(("infeas", "unbnd"))
        ]
    return paths


def build_corpus():
    """Parse the vendored feasible corpus into LPProblems."""
    from tpdlp_torch.io.mps import read_mps

    problems = []
    for path in corpus_paths():
        p = read_mps(path)
        p.name = os.path.splitext(os.path.basename(path))[0]
        problems.append(p)
    return problems


def build_netlib(names=None):
    """Fetch and parse Netlib instances; an empty list when offline."""
    from tpdlp_torch.io import netlib

    problems = []
    for name in names or netlib.FEASIBLE:
        try:
            problems.append(netlib.load(name))
        except netlib.NetlibUnavailable:
            break  # offline: no point retrying every name
    return problems


def build_suite(classes=("small", "medium"), names=None):
    """Build the instances of `classes` (seed 7), optionally only `names`
    among the synthetic ones; "real" adds the vendored corpus and
    "netlib" the fetched Netlib set."""
    problems = []
    for cls in ("small", "medium", "large", "xl"):
        if cls not in classes:
            continue
        for row in _CLASSES[cls]:
            name, n, mi, me, d = row[:5]
            if names is not None and name not in names:
                continue
            bounds = row[5] if len(row) > 5 else "box"
            p = generate_feasible_lp(n=n, m_ineq=mi, m_eq=me, density=d,
                                     seed=7, bounds=bounds)
            p.name = name
            problems.append(p)
    if "real" in classes:
        problems += build_corpus()
    if "netlib" in classes:
        problems += build_netlib()
    return problems
