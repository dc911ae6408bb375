"""Author the vendored realistic-MPS corpus (counterpart of
tpdlp/bench/instances/make_corpus.py, which wrote it; needs no network).

    python -m tpdlp_torch.bench.instances.make_corpus OUT_DIR

writes the corpus's REAL-WORLD-STYLE fixed-format MPS files from classic LP
model families (blending, multi-period production, transportation,
staircase/multistage, min-cost network flow, multicommodity flow,
production/inventory) into OUT_DIR.  They exercise the parser surface that
synthetic round trips never touch: fixed-format field layout, comment
lines, L/G/E senses mixed in file order, RANGES on G/L/E rows, every
BOUNDS type (UP/LO/FX/FR/MI), negative upper bounds, RHS entries for the
objective row (constants), and two-pairs-per-line COLUMNS/RHS records.

Every file is parsed back by the port's MPS reader and its linprog/HiGHS
status checked: the feasible files must be optimal, infeas01 infeasible
and unbnd01 unbounded.  The files in this directory are its output, byte
for byte.
"""

from __future__ import annotations

import os

import numpy as np

# ---------------------------------------------------------------- emitter
class MPS:
    """Fixed-format MPS emitter (classic field columns 2/5/15/25/40/50)."""

    def __init__(self, name, maximize=False):
        self.name = name
        self.maximize = maximize
        self.rows = []  # (sense, name)
        self.cols = {}  # var -> list[(row, val)]
        self.col_order = []
        self.rhs = []  # (row, val)
        self.ranges = []  # (row, val)
        self.bounds = []  # (type, var, val-or-None)
        self.comments = []

    def row(self, sense, name):
        self.rows.append((sense, name))

    def entry(self, var, row, val):
        if var not in self.cols:
            self.cols[var] = []
            self.col_order.append(var)
        self.cols[var].append((row, val))

    def write(self, path):
        L = [f"* {c}" for c in self.comments]
        L.append(f"NAME          {self.name.upper()}")
        if self.maximize:
            L += ["OBJSENSE", "    MAX"]
        L.append("ROWS")
        for sense, name in self.rows:
            L.append(f" {sense:<2} {name}")
        L.append("COLUMNS")
        for var in self.col_order:
            pairs = self.cols[var]
            for k in range(0, len(pairs), 2):
                chunk = pairs[k:k + 2]
                line = f"    {var:<10}"
                for row, val in chunk:
                    line += f"{row:<10}{val:<15.6g}"
                L.append(line.rstrip())
        L.append("RHS")
        for k in range(0, len(self.rhs), 2):
            chunk = self.rhs[k:k + 2]
            line = "    RHS       "
            for row, val in chunk:
                line += f"{row:<10}{val:<15.6g}"
            L.append(line.rstrip())
        if self.ranges:
            L.append("RANGES")
            for row, val in self.ranges:
                L.append(f"    RNG       {row:<10}{val:<15.6g}")
        if self.bounds:
            L.append("BOUNDS")
            for btype, var, val in self.bounds:
                if val is None:
                    L.append(f" {btype:<2} BND       {var}")
                else:
                    L.append(f" {btype:<2} BND       {var:<10}{val:<15.6g}")
        L.append("ENDATA")
        with open(path, "w") as f:
            f.write("\n".join(L) + "\n")


# ---------------------------------------------------------------- models
def blend04():
    """Gasoline blending (MAX profit): 4 crudes x 3 products, octane and
    vapor-pressure quality rows, demand windows via RANGES."""
    m = MPS("blend04", maximize=True)
    m.comments = [
        "Gasoline blending: maximize profit over 4 crudes x 3 products.",
        "Quality rows keep octane above and vapor pressure below spec.",
    ]
    crude = ["C1", "C2", "C3", "C4"]
    prod = ["PA", "PB", "PC"]
    avail = [3000.0, 2000.0, 4000.0, 1500.0]
    cost = [31.0, 33.0, 36.0, 39.0]
    price = [45.5, 42.5, 40.0]
    octane = [68.0, 86.0, 91.0, 99.0]
    vapor = [4.0, 9.0, 6.0, 12.0]
    oct_min = [89.0, 87.0, 78.0]
    vap_max = [10.0, 9.0, 7.0]
    dem_lo = [1200.0, 900.0, 800.0]
    dem_win = [1800.0, 1100.0, 900.0]  # demand window width (RANGES)

    m.row("N", "PROFIT")
    for i, ci in enumerate(crude):
        m.row("L", f"AVL{ci}")
    for j, pj in enumerate(prod):
        m.row("G", f"DEM{pj}")
        m.row("G", f"OCT{pj}")
        m.row("L", f"VAP{pj}")
    for i, ci in enumerate(crude):
        for j, pj in enumerate(prod):
            v = f"X{ci}{pj}"
            m.entry(v, "PROFIT", price[j] - cost[i])
            m.entry(v, f"AVL{ci}", 1.0)
            m.entry(v, f"DEM{pj}", 1.0)
            m.entry(v, f"OCT{pj}", octane[i] - oct_min[j])
            m.entry(v, f"VAP{pj}", vapor[i] - vap_max[j])
    for i, ci in enumerate(crude):
        m.rhs.append((f"AVL{ci}", avail[i]))
    for j, pj in enumerate(prod):
        m.rhs.append((f"DEM{pj}", dem_lo[j]))
        m.ranges.append((f"DEM{pj}", dem_win[j]))
    # Route caps: premium product PA takes at most 900 of any one crude.
    for ci in crude:
        m.bounds.append(("UP", f"X{ci}PA", 900.0))
    return m


def prod06():
    """Six-period production/inventory planning: balance equalities, ranged
    capacity rows, an objective-row constant (fixed cost), FX final
    inventory, and a backlog variable with a negative upper bound."""
    m = MPS("prod06", maximize=False)
    m.comments = [
        "Multi-period production planning, 6 periods.",
        "BAL rows: I[t-1] + P[t] - I[t] - B[t-1] + B[t] = D[t].",
        "CAP rows are ranged: a minimum-utilisation window.",
    ]
    T = 6
    demand = [110.0, 140.0, 95.0, 160.0, 130.0, 120.0]
    cap = [150.0, 150.0, 140.0, 150.0, 150.0, 140.0]
    pcost = [7.0, 7.4, 7.2, 7.8, 7.5, 7.6]
    hold = 0.4
    back = 2.5
    I0 = 30.0

    m.row("N", "COST")
    for t in range(1, T + 1):
        m.row("E", f"BAL{t}")
        m.row("L", f"CAP{t}")
    for t in range(1, T + 1):
        P, I, B = f"P{t}", f"I{t}", f"B{t}"
        m.entry(P, "COST", pcost[t - 1])
        m.entry(P, f"BAL{t}", 1.0)
        m.entry(P, f"CAP{t}", 1.0)
        m.entry(I, "COST", hold)
        m.entry(I, f"BAL{t}", -1.0)
        if t < T:
            m.entry(I, f"BAL{t + 1}", 1.0)
        m.entry(I, f"CAP{t}", 0.5)
        m.entry(B, "COST", back)
        m.entry(B, f"BAL{t}", 1.0)
        if t < T:
            m.entry(B, f"BAL{t + 1}", -1.0)
    for t in range(1, T + 1):
        d = demand[t - 1] - (I0 if t == 1 else 0.0)
        m.rhs.append((f"BAL{t}", d))
        m.rhs.append((f"CAP{t}", cap[t - 1]))
    # Objective constant: 850 of fixed cost per planning horizon.
    m.rhs.append(("COST", -850.0))
    for t in range(1, T + 1):
        m.ranges.append((f"CAP{t}", 60.0))  # utilisation window
        m.bounds.append(("UP", f"I{t}", 60.0))
        m.bounds.append(("UP", f"B{t}", 40.0))
    m.bounds.append(("FX", f"I{T}", 15.0))
    m.bounds.append(("FX", f"B{T}", 0.0))
    m.bounds.append(("LO", "P1", 20.0))
    return m


def trans48():
    """6x8 transportation with route caps and one forbidden route."""
    rng = np.random.default_rng(7)
    m = MPS("trans48")
    m.comments = ["Transportation: 6 plants x 8 markets, unbalanced."]
    S, D = 6, 8
    supply = [420.0, 380.0, 510.0, 290.0, 460.0, 350.0]
    demand = [230.0, 260.0, 240.0, 310.0, 220.0, 270.0, 250.0, 240.0]
    assert sum(supply) > sum(demand)
    cost = np.round(rng.uniform(2.0, 14.0, size=(S, D)), 1)
    m.row("N", "SHIPCOST")
    for i in range(S):
        m.row("L", f"SUP{i + 1}")
    for j in range(D):
        m.row("G", f"DEM{j + 1}")
    for i in range(S):
        for j in range(D):
            v = f"T{i + 1}{j + 1}"
            m.entry(v, "SHIPCOST", float(cost[i, j]))
            m.entry(v, f"SUP{i + 1}", 1.0)
            m.entry(v, f"DEM{j + 1}", 1.0)
    for i in range(S):
        m.rhs.append((f"SUP{i + 1}", supply[i]))
    for j in range(D):
        m.rhs.append((f"DEM{j + 1}", demand[j]))
    m.bounds.append(("FX", "T18", 0.0))  # embargoed route
    for j in range(D):
        m.bounds.append(("UP", f"T3{j + 1}", 120.0))  # plant-3 route caps
    return m


def stair20():
    """Twenty-stage staircase LP (SCSD/SCTAP-family structure): linking
    equalities between consecutive stages plus a within-stage resource
    row, built around a planted feasible point."""
    rng = np.random.default_rng(11)
    m = MPS("stair20")
    m.comments = [
        "Staircase multistage LP, 20 stages x 3 variables.",
        "LNK rows couple consecutive stages; RES rows are per-stage.",
    ]
    K, V = 20, 3
    xstar = rng.uniform(1.0, 2.0, size=(K, V))
    A = np.round(rng.uniform(0.5, 2.0, size=(K, V)), 3)
    B = np.round(rng.uniform(-1.0, 1.0, size=(K, V)), 3)
    c = np.round(rng.uniform(1.0, 5.0, size=(K, V)), 2)
    m.row("N", "COST")
    for k in range(K):
        m.row("E", f"LNK{k + 1}")
        m.row("G", f"RES{k + 1}")
    for k in range(K):
        for v in range(V):
            var = f"Y{k + 1}X{v + 1}"
            m.entry(var, "COST", float(c[k, v]))
            m.entry(var, f"LNK{k + 1}", float(A[k, v]))
            if k + 1 < K:
                m.entry(var, f"LNK{k + 2}", float(B[k + 1, v]))
            m.entry(var, f"RES{k + 1}", 1.0)
    for k in range(K):
        b = float(A[k] @ xstar[k])
        if k > 0:
            b += float(B[k] @ xstar[k - 1])
        m.rhs.append((f"LNK{k + 1}", round(b, 6)))
        m.rhs.append((f"RES{k + 1}", round(float(xstar[k].sum()) - 0.8, 6)))
    for k in range(K):
        for v in range(V):
            m.bounds.append(("UP", f"Y{k + 1}X{v + 1}", 10.0))
    # A couple of free/negative-capable stage-1 variables (MI + FR).
    m.bounds.append(("MI", "Y1X1", None))
    m.bounds.append(("FR", "Y1X2", None))
    return m


def flow150():
    """Min-cost flow on a 40-node, ~150-arc seeded digraph.  A random
    permutation cycle with ample capacity guarantees a feasible
    circulation; node-balance rows are equalities."""
    rng = np.random.default_rng(23)
    m = MPS("flow150")
    m.comments = ["Min-cost network flow: 40 nodes, ~150 arcs."]
    N = 40
    # Supplies/demands summing to zero.
    b = np.zeros(N)
    sources = rng.choice(N, size=8, replace=False)
    sinks = np.array([i for i in range(N) if i not in sources])[:8]
    amt = rng.integers(10, 40, size=8).astype(float)
    b[sources] += amt
    b[sinks] -= amt
    arcs = set()
    # Feasibility backbone: a permutation cycle through all nodes.
    perm = rng.permutation(N)
    for i in range(N):
        arcs.add((int(perm[i]), int(perm[(i + 1) % N])))
    while len(arcs) < 150:
        i, j = rng.integers(0, N, size=2)
        if i != j:
            arcs.add((int(i), int(j)))
    arcs = sorted(arcs)
    m.row("N", "FLOWCOST")
    for i in range(N):
        m.row("E", f"NODE{i + 1}")
    for (i, j) in arcs:
        v = f"F{i + 1}D{j + 1}"
        m.entry(v, "FLOWCOST", float(rng.integers(1, 20)))
        m.entry(v, f"NODE{i + 1}", 1.0)
        m.entry(v, f"NODE{j + 1}", -1.0)
    for i in range(N):
        if b[i] != 0.0:
            m.rhs.append((f"NODE{i + 1}", float(b[i])))
    on_cycle = {(int(perm[i]), int(perm[(i + 1) % N])) for i in range(N)}
    for (i, j) in arcs:
        cap = 400.0 if (i, j) in on_cycle else float(rng.integers(20, 90))
        m.bounds.append(("UP", f"F{i + 1}D{j + 1}", cap))
    return m


def mcf3x60():
    """Multicommodity flow: 3 commodities share a 24-node, ~60-arc
    digraph under COUPLED arc capacities (sum of commodity flows per arc
    <= cap, L rows) — the classic MCF family; per-commodity node-balance
    equalities.  A permutation-cycle backbone per commodity with ample
    capacity guarantees feasibility."""
    rng = np.random.default_rng(31)
    m = MPS("mcf3x60")
    m.comments = [
        "Multicommodity flow: 3 commodities, 24 nodes, ~60 arcs,",
        "coupled arc capacities (CAP rows sum all commodities).",
    ]
    N, C = 24, 3
    arcs = set()
    backbones = []
    for k in range(C):
        perm = rng.permutation(N)
        cyc = {(int(perm[i]), int(perm[(i + 1) % N])) for i in range(N)}
        backbones.append(cyc)
        arcs |= cyc
    while len(arcs) < 60:
        i, j = rng.integers(0, N, size=2)
        if i != j:
            arcs.add((int(i), int(j)))
    arcs = sorted(arcs)
    m.row("N", "TOTCOST")
    for a, (i, j) in enumerate(arcs):
        m.row("L", f"CAP{a + 1}")
    for k in range(C):
        for i in range(N):
            m.row("E", f"BAL{k + 1}N{i + 1}")
    b = np.zeros((C, N))
    for k in range(C):
        src = rng.choice(N, size=3, replace=False)
        snk = np.array([i for i in range(N) if i not in src])[:3]
        amt = rng.integers(5, 20, size=3).astype(float)
        b[k, src] += amt
        b[k, snk] -= amt
    for a, (i, j) in enumerate(arcs):
        for k in range(C):
            v = f"F{k + 1}A{a + 1}"
            m.entry(v, "TOTCOST", float(rng.integers(1, 15)))
            m.entry(v, f"CAP{a + 1}", 1.0)
            m.entry(v, f"BAL{k + 1}N{i + 1}", 1.0)
            m.entry(v, f"BAL{k + 1}N{j + 1}", -1.0)
    on_backbone = [
        any((i, j) in backbones[k] for k in range(C)) for (i, j) in arcs
    ]
    for a, (i, j) in enumerate(arcs):
        cap = 300.0 if on_backbone[a] else float(rng.integers(15, 60))
        m.rhs.append((f"CAP{a + 1}", cap))
    for k in range(C):
        for i in range(N):
            if b[k, i] != 0.0:
                m.rhs.append((f"BAL{k + 1}N{i + 1}", float(b[k, i])))
    return m


def infeas01():
    """Infeasible transportation: total demand exceeds total supply."""
    m = MPS("infeas01")
    m.comments = ["Infeasible by construction: demand 700 > supply 500."]
    supply = [200.0, 300.0]
    demand = [250.0, 250.0, 200.0]
    m.row("N", "COST")
    for i in range(2):
        m.row("L", f"SUP{i + 1}")
    for j in range(3):
        m.row("G", f"DEM{j + 1}")
    for i in range(2):
        for j in range(3):
            v = f"T{i + 1}{j + 1}"
            m.entry(v, "COST", float(2 + i + j))
            m.entry(v, f"SUP{i + 1}", 1.0)
            m.entry(v, f"DEM{j + 1}", 1.0)
    for i in range(2):
        m.rhs.append((f"SUP{i + 1}", supply[i]))
    for j in range(3):
        m.rhs.append((f"DEM{j + 1}", demand[j]))
    return m


def unbnd01():
    """Unbounded: a negative-cost recession direction along x1 = x2."""
    m = MPS("unbnd01")
    m.comments = ["Unbounded: (1,1) is a feasible improving ray."]
    m.row("N", "COST")
    m.row("L", "DIFF")
    m.row("G", "FLOOR")
    for v, cv in (("X1", -1.0), ("X2", -1.0)):
        m.entry(v, "COST", cv)
    m.entry("X1", "DIFF", 1.0)
    m.entry("X2", "DIFF", -1.0)
    m.entry("X1", "FLOOR", 1.0)
    m.entry("X2", "FLOOR", 1.0)
    m.rhs.append(("DIFF", 3.0))
    m.rhs.append(("FLOOR", 2.0))
    return m


def inv18():
    """Eighteen-period production/inventory chain with backorders
    (free inventory variables, the classic PILOT/SC-family shape) plus
    sectional accounting rows nested inside a horizon total.  The free
    inventories I_t link consecutive balance equalities (column support
    2, both equalities), so PaPILO-style implied-free aggregation can
    telescope the chain; the horizon row's support contains each
    sectional row's, so sparsify can cancel it down."""
    rng = np.random.default_rng(31)
    m = MPS("inv18")
    m.comments = [
        "Production/inventory LP, 18 periods, backorders allowed.",
        "BAL rows chain free inventories; SEC rows nest inside HORIZON.",
    ]
    T = 18
    dem = np.round(rng.uniform(4.0, 9.0, size=T), 1)
    cap = np.round(dem.mean() * 1.35, 1)
    cost = np.round(rng.uniform(2.0, 5.0, size=T), 2)
    hold = 0.25
    # Section quotas: 6-period production plans whose supports nest
    # inside the horizon row's (no extra tally variables, so each SEC row
    # is a strict support-subset of HORIZON).
    quota = [float(np.round(dem[6 * s:6 * s + 6].sum(), 1))
             for s in range(3)]
    m.row("N", "COST")
    for t in range(T):
        m.row("E", f"BAL{t + 1}")
    for s in range(3):
        m.row("E", f"SEC{s + 1}")
    m.row("E", "HORIZON")
    for t in range(T):
        pv = f"P{t + 1}"
        iv = f"I{t + 1}"
        m.entry(pv, "COST", float(cost[t]))
        m.entry(pv, f"BAL{t + 1}", 1.0)
        m.entry(pv, f"SEC{t // 6 + 1}", 1.0)
        m.entry(pv, "HORIZON", 1.0)
        # I_t: enters period t's balance (-1), feeds period t+1's (+1).
        m.entry(iv, "COST", hold)
        m.entry(iv, f"BAL{t + 1}", -1.0)
        if t + 1 < T:
            m.entry(iv, f"BAL{t + 2}", 1.0)
    for t in range(T):
        m.rhs.append((f"BAL{t + 1}", float(dem[t])))
    for s in range(3):
        m.rhs.append((f"SEC{s + 1}", quota[s]))
    m.rhs.append(("HORIZON", float(np.round(sum(quota), 1))))
    for t in range(T):
        m.bounds.append(("UP", f"P{t + 1}", float(cap)))
        m.bounds.append(("FR", f"I{t + 1}", None))  # backorders allowed
    return m


FEASIBLE = (blend04, prod06, trans48, stair20, flow150, mcf3x60, inv18)
TERMINAL = ((infeas01, 2), (unbnd01, 3))  # linprog status codes


def main(argv=None):
    import argparse

    from tpdlp_torch.bench.infeasibility import oracle_status
    from tpdlp_torch.io.mps import read_mps

    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", help="the directory the files go to")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for build, want in [(b, 0) for b in FEASIBLE] + list(TERMINAL):
        m = build()
        path = os.path.join(args.out_dir, f"{m.name}.mps")
        m.write(path)
        p = read_mps(path)
        status = oracle_status(p)
        if status != want:
            raise AssertionError(f"{m.name}: linprog status {status}, "
                                 f"expected {want}")
        print(f"{m.name}: m={p.m} (ineq {p.m_ineq}) n={p.n} "
              f"nnz={p.K.nnz} linprog status={status} (ok)")
    return 0


if __name__ == "__main__":
    main()
