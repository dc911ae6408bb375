"""MPS reader producing the stacked standard form (a copy of
tpdlp/io/mps.py: numpy/scipy code only, kept here so that this package
never imports the JAX package; the same file gives the same arrays).

Parity target: PDLP/util.py:76-268 (`mps_to_standard_form`) — free-format
MPS with ROWS / COLUMNS / RHS / RANGES / BOUNDS sections, emitting

    minimize c'x   s.t.  G x >= h,  A x = b,  l <= x <= u

stacked as K = [G; A], q = [h; b].  Reference semantics preserved:

- N row is the objective; E rows -> A; G rows -> G; L rows negated into
  G x >= h (util.py:219-228).
- RANGES: a ranged row [lb, ub] becomes two inequality rows
  (+row >= lb, -row >= -ub) with lb/ub per sense (util.py:197-217).
- Row emission order matches the reference: all inequality rows in ROWS
  order (ranged rows contribute their pair in place), then equality rows.
- Bound defaults lo=0, up=+inf; missing RHS entries are 0.

Deliberate fixes over the reference (each behind a compat flag):

- FR sets lo=-inf (the reference sets lo=0.0, util.py:162-164 — a bug that
  silently tightens free variables; `compat_fr_zero=True` restores it).
- MI / PL / BV bound types are supported (the reference drops them);
  integrality markers and UI/LI bounds parse as their LP relaxation.
- OBJSENSE MAX negates c; the RHS entry of the objective row is kept as
  `obj_offset` (both absent from the reference).

The matrix is accumulated as COO triplets into scipy CSR — O(nnz), versus
the reference's dense row materialisation (util.py:179-183).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import scipy.sparse as sp

from tpdlp_torch.problem import LPProblem

_INF = float("inf")


def _parse_sections(lines):
    """Split an MPS file into tokenised section entries."""
    section = None
    data = {
        "rows": [],  # (sense, name) in file order
        "cols": [],  # (var, row, val)
        "rhs": {},
        "ranges": {},
        "bounds": [],  # (type, var, val-or-None)
        "objsense": "MIN",
        "name": "",
    }
    for raw in lines:
        line = raw.rstrip()
        if not line or line.lstrip().startswith(("*", "$")):
            continue
        # Section headers start in column 1 (no leading whitespace).
        if not raw[:1].isspace():
            tokens = line.split()
            head = tokens[0].upper()
            if head in (
                "ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS", "OBJSENSE",
                "ENDATA", "NAME", "OBJSENSE",
            ):
                section = head
                if head == "NAME" and len(tokens) > 1:
                    data["name"] = tokens[1]
                if head == "ENDATA":
                    break
                continue
            # Unknown top-level section (SOS, RANGES variants...) — skip its
            # body by treating it as an ignorable section.
            section = f"_SKIP_{head}"
            continue

        tokens = line.split()
        if section == "OBJSENSE":
            data["objsense"] = tokens[0].upper()[:3]
        elif section == "ROWS":
            sense, row_name = tokens[0].upper(), tokens[1]
            data["rows"].append((sense, row_name))
        elif section == "COLUMNS":
            if len(tokens) >= 3 and tokens[1].upper() == "'MARKER'":
                # INTORG/INTEND integer markers: parsed as the LP relaxation.
                continue
            var = tokens[0]
            for i in range(1, len(tokens) - 1, 2):
                data["cols"].append((var, tokens[i], float(tokens[i + 1])))
        elif section == "RHS":
            for i in range(1, len(tokens) - 1, 2):
                data["rhs"][tokens[i]] = float(tokens[i + 1])
        elif section == "RANGES":
            for i in range(1, len(tokens) - 1, 2):
                data["ranges"][tokens[i]] = float(tokens[i + 1])
        elif section == "BOUNDS":
            # Layouts in the wild: "TYPE SET VAR [VAL]" (standard) and
            # "TYPE VAR [VAL]" (no bound-set name — emitted by several LP
            # tools).  Value-bearing types take the LAST token as the
            # value; valueless types may still carry a dummy numeric
            # (e.g. "BV BND X 1").
            btype = tokens[0].upper()
            rest = tokens[1:]
            needs_val = btype in ("LO", "UP", "FX", "UI", "LI")
            if needs_val:
                if len(rest) < 2:
                    raise ValueError(
                        f"BOUNDS line missing a value: {line!r}"
                    )
                try:
                    val = float(rest[-1])
                except ValueError:
                    raise ValueError(
                        f"BOUNDS line has a non-numeric value: {line!r}"
                    ) from None
                var = rest[-2]
            else:
                val = None
                var = rest[-1]
                if len(rest) >= 3:
                    try:
                        float(rest[-1])
                        var = rest[-2]  # trailing dummy numeric
                    except ValueError:
                        pass
            data["bounds"].append((btype, var, val))
        # _SKIP_* sections: ignore body lines.
    return data


def _range_bounds(sense, rhs_val, range_val):
    """[lb, ub] of a ranged row (reference table, util.py:197-212)."""
    if sense == "G":
        return rhs_val, rhs_val + abs(range_val)
    if sense == "L":
        return rhs_val - abs(range_val), rhs_val
    if sense == "E":
        if range_val > 0:
            return rhs_val, rhs_val + range_val
        return rhs_val + range_val, rhs_val
    raise ValueError(f"unsupported ranged sense: {sense}")


def read_mps(path, *, compat_fr_zero: bool = False) -> LPProblem:
    """Parse an MPS file into a standard-form LPProblem (scipy CSR K)."""
    with open(path) as f:
        lines = f.readlines()
    d = _parse_sections(lines)

    if not d["rows"]:
        raise ValueError(f"{path}: no ROWS section found — not an MPS file?")
    if not d["cols"]:
        raise ValueError(f"{path}: no COLUMNS entries found")

    # Objective row = first N row (util.py:129-130).
    obj_row = None
    constraint_rows = []  # (sense, name), file order
    for sense, name in d["rows"]:
        if sense == "N":
            if obj_row is None:
                obj_row = name
        else:
            constraint_rows.append((sense, name))

    # Variable ordering by first appearance in COLUMNS (util.py:134-137).
    var_index: dict[str, int] = {}
    for var, _, _ in d["cols"]:
        if var not in var_index:
            var_index[var] = len(var_index)
    n = len(var_index)

    # Per-row sparse entries.
    row_entries: dict[str, list[tuple[int, float]]] = defaultdict(list)
    c = np.zeros(n)
    for var, row, val in d["cols"]:
        jcol = var_index[var]
        if row == obj_row:
            c[jcol] = val  # last entry wins, as in the reference
        else:
            row_entries[row].append((jcol, val))

    if d["objsense"] == "MAX":
        c = -c
    obj_offset = -d["rhs"].get(obj_row, 0.0) if obj_row is not None else 0.0

    # Emit inequality rows (ROWS order; ranged rows expand in place), then
    # equality rows — matching the reference's two-list stacking
    # (util.py:185-228,250-261).
    ineq_specs = []  # (row_name, sign, rhs)
    eq_specs = []
    for sense, name in constraint_rows:
        rhs_val = d["rhs"].get(name, 0.0)
        range_val = d["ranges"].get(name)
        if range_val is not None:
            lb, ub = _range_bounds(sense, rhs_val, range_val)
            ineq_specs.append((name, +1.0, lb))
            ineq_specs.append((name, -1.0, -ub))
        elif sense == "E":
            eq_specs.append((name, +1.0, rhs_val))
        elif sense == "G":
            ineq_specs.append((name, +1.0, rhs_val))
        elif sense == "L":
            ineq_specs.append((name, -1.0, -rhs_val))
        else:
            raise ValueError(f"unknown row sense {sense!r} for row {name!r}")

    m_ineq = len(ineq_specs)
    specs = ineq_specs + eq_specs
    m = len(specs)

    rows_idx, cols_idx, vals = [], [], []
    q = np.zeros(m)
    for i, (name, sign, rhs) in enumerate(specs):
        q[i] = rhs
        for jcol, val in row_entries.get(name, ()):
            rows_idx.append(i)
            cols_idx.append(jcol)
            vals.append(sign * val)
    K = sp.coo_matrix(
        (np.asarray(vals, dtype=np.float64), (rows_idx, cols_idx)),
        shape=(m, n),
    ).tocsr()
    # Duplicate (row, col) entries sum — standard MPS semantics.
    K.sum_duplicates()

    # Bounds (util.py:152-164,230-237).
    l = np.zeros(n)
    u = np.full(n, _INF)
    explicit_lo = np.zeros(n, dtype=bool)
    for btype, var, val in d["bounds"]:
        jcol = var_index.get(var)
        if jcol is None:
            continue
        if btype == "LO":
            l[jcol] = val
            explicit_lo[jcol] = True
        elif btype == "UP":
            u[jcol] = val
            # Standard quirk: UP with a negative bound and no explicit lower
            # bound implies l = -inf.
            if val is not None and val < 0 and not explicit_lo[jcol]:
                l[jcol] = -_INF
        elif btype == "FX":
            l[jcol] = val
            u[jcol] = val
            explicit_lo[jcol] = True
        elif btype == "FR":
            l[jcol] = 0.0 if compat_fr_zero else -_INF
            u[jcol] = _INF
        elif btype == "MI":
            l[jcol] = -_INF
        elif btype == "PL":
            u[jcol] = _INF
        elif btype in ("BV",):
            l[jcol] = 0.0
            u[jcol] = 1.0
            explicit_lo[jcol] = True
        elif btype in ("UI", "LI"):
            if btype == "UI":
                u[jcol] = val
            else:
                l[jcol] = val
                explicit_lo[jcol] = True
        # Unknown bound types are ignored (reference behavior).

    name = d["name"] or str(path)
    return LPProblem(
        c=c, K=K, q=q, m_ineq=m_ineq, l=l, u=u, name=name,
        obj_offset=obj_offset, objsense=d["objsense"],
    )


def mps_to_standard_form(path, *, compat_fr_zero: bool = False):
    """API-parity wrapper returning (c, K, q, m_ineq, l, u) like
    PDLP/util.py:76 (tensors there; numpy/scipy here)."""
    p = read_mps(path, compat_fr_zero=compat_fr_zero)
    return p.c, p.K, p.q, p.m_ineq, p.l, p.u
