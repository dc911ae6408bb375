"""Deterministic synthetic benchmark instances (the planted-feasible rows of
tpdlp/bench/suite.py), so that the port builds mittelmann-s/-l exactly as
the JAX package's `bench.py` does."""

from __future__ import annotations

from tpdlp_torch.io.generator import generate_feasible_lp

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


def build_suite(classes=("small", "medium"), names=None):
    """Build the instances of `classes` (seed 7), optionally only `names`."""
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
    return problems
