"""Presolve: PaPILO-equivalent reductions with a serializable postsolve
stack (counterpart of tpdlp/presolve/reductions.py, copied so the port
needs nothing of the JAX package).

The reductions PaPILO applies that matter for LP: empty/singleton rows,
empty columns, fixed-variable removal, dominated columns (duality fixing),
duplicate rows, and singleton-row bound tightening, iterated to a fixpoint
— plus infeasibility/unboundedness detection during reduction.

Postsolve maps the reduced x back through (column map, fixed values), and
`postsolve_dual` maps the reduced y back.  The postsolve data is a plain
dataclass of numpy arrays, serializable with `save`/`load`.

A C++ core (tpdlp_torch/presolve/core.cpp, via ctypes; presolve/cpp.py)
implements the same pass pipeline; `presolve(..., backend="cpp")` uses it,
with this module as the portable path and the correctness oracle.  All of
it runs on the host, in fp64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from tpdlp_torch.config import Status
from tpdlp_torch.problem import LPProblem


def _empty_subst():
    return dict(
        subst_kind=np.zeros(0, np.int8),
        subst_idx=np.zeros(0, np.int64),
        subst_scale=np.zeros(0),
        subst_rhs=np.zeros(0),
        subst_indptr=np.zeros(1, np.int64),
        subst_cols=np.zeros(0, np.int64),
        subst_vals=np.zeros(0),
        subst_row=np.zeros(0, np.int64),
        subst_cj=np.zeros(0),
        subst_flag=np.zeros(0, np.int8),
        dcol_indptr=np.zeros(1, np.int64),
        dcol_rows=np.zeros(0, np.int64),
        dcol_vals=np.zeros(0),
    )


@dataclasses.dataclass
class PostsolveData:
    """Everything needed to map a reduced primal solution back.

    Applied in this order at postsolve: (1) surviving-column scatter +
    fixed values, (2) the transform stack (free-singleton substitutions and
    parallel-column splits), evaluated in reverse chronological order with
    `cols` in ORIGINAL variable indices.
    """

    n_orig: int
    col_map: np.ndarray  # indices (into original x) of surviving columns
    fixed_idx: np.ndarray  # original indices of eliminated columns
    fixed_val: np.ndarray  # their values
    obj_offset: float  # c_fixed . x_fixed accumulated into the objective
    # Transform stack (CSR-like layout over stack entries), chronological.
    # kind 0 = linear substitution (free column singleton, doubleton eq):
    #     x[idx] = (rhs - vals . x[cols]) / scale
    # kind 1 = parallel-column split (idx was merged into cols[0] with
    #     column_idx = scale * column_cols0; rhs = kept var's upper bound
    #     at merge time; vals = [l_idx, u_idx]):
    #     x[idx] = clip((x[cols0] - rhs)/scale, l, u);  x[cols0] -= scale*x[idx]
    # kind 2 = bound transfer (primal no-op; dual recovery for a dropped
    #     row that became a variable bound): idx = col j, row = the dropped
    #     row i, scale = a_ij, rhs = the introduced bound value v, flag =
    #     +1/-1 lower/upper from an inequality row, +2/-2 from an equality
    #     row.  cj/dcol_* hold c_j and column j (other rows, original
    #     indices) at reduction time, so lambda_j can be evaluated exactly
    #     during the reverse sweep.
    # kind 3 = duplicate-row rhs winner (primal no-op): idx = the dropped
    #     row whose scaled rhs was the binding one, row = the kept row,
    #     scale = lam (row_idx = lam * row_kept); the kept row's recovered
    #     dual moves to the dropped row as y_idx = y_row / lam.
    subst_kind: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int8)
    )
    subst_idx: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    subst_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    subst_rhs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    subst_indptr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.int64)
    )
    subst_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    subst_vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    # Dual-recovery extensions (round 2): original-row map for surviving
    # rows, per-entry dual fields, and per-entry column snapshots (CSR-like
    # over entries; rows in ORIGINAL indices, values at reduction time).
    m_orig: int = 0
    row_map: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    subst_row: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    subst_cj: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    subst_flag: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int8)
    )
    dcol_indptr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.int64)
    )
    dcol_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    dcol_vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )

    def save(self, path) -> None:
        np.savez(
            path,
            n_orig=self.n_orig,
            col_map=self.col_map,
            fixed_idx=self.fixed_idx,
            fixed_val=self.fixed_val,
            obj_offset=self.obj_offset,
            subst_kind=self.subst_kind,
            subst_idx=self.subst_idx,
            subst_scale=self.subst_scale,
            subst_rhs=self.subst_rhs,
            subst_indptr=self.subst_indptr,
            subst_cols=self.subst_cols,
            subst_vals=self.subst_vals,
            m_orig=self.m_orig,
            row_map=self.row_map,
            subst_row=self.subst_row,
            subst_cj=self.subst_cj,
            subst_flag=self.subst_flag,
            dcol_indptr=self.dcol_indptr,
            dcol_rows=self.dcol_rows,
            dcol_vals=self.dcol_vals,
        )

    @classmethod
    def load(cls, path) -> "PostsolveData":
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        subst = _empty_subst()
        for k in subst:
            if k in z.files:
                subst[k] = z[k]
        if "subst_kind" not in z.files:
            subst["subst_kind"] = np.zeros(
                len(subst["subst_idx"]), np.int8
            )
        for name in ("subst_row", "subst_cj", "subst_flag"):
            if len(subst[name]) != len(subst["subst_idx"]):
                fill = -1 if name == "subst_row" else 0
                subst[name] = np.full(
                    len(subst["subst_idx"]), fill, subst[name].dtype
                )
        if len(subst["dcol_indptr"]) != len(subst["subst_idx"]) + 1:
            subst["dcol_indptr"] = np.zeros(
                len(subst["subst_idx"]) + 1, np.int64
            )
        return cls(
            n_orig=int(z["n_orig"]),
            col_map=z["col_map"],
            fixed_idx=z["fixed_idx"],
            fixed_val=z["fixed_val"],
            obj_offset=float(z["obj_offset"]),
            # -1 = legacy file without dual info (round-1 format): a
            # sentinel rather than 0 so postsolve_dual can raise a clear
            # error instead of silently returning a length-0 vector.
            m_orig=int(z["m_orig"]) if "m_orig" in z.files else -1,
            row_map=z["row_map"] if "row_map" in z.files else np.zeros(
                0, np.int64
            ),
            **subst,
        )


@dataclasses.dataclass
class PresolveResult:
    problem: Optional[LPProblem]  # None when status is terminal
    data: PostsolveData
    status: Status  # RUNNING = reduced problem to be solved
    rows_removed: int
    cols_removed: int
    passes: int


def postsolve(x_reduced: np.ndarray, data: PostsolveData) -> np.ndarray:
    """Map the reduced primal solution back to the original variable space
    (reference: papilo_wrapper.cpp:37-45)."""
    x = np.zeros(data.n_orig)
    x[data.col_map] = x_reduced
    x[data.fixed_idx] = data.fixed_val
    # Transform stack in reverse chronological order (later entries may
    # reference variables recovered by earlier reverse steps).
    kinds = data.subst_kind
    for t in range(len(data.subst_idx) - 1, -1, -1):
        s, e = data.subst_indptr[t], data.subst_indptr[t + 1]
        if len(kinds) and kinds[t] >= 2:
            continue  # kinds 2/3 are dual-only (see postsolve_dual)
        if len(kinds) and kinds[t] == 1:
            # Parallel-column split: recover the dropped variable from the
            # merged one, respecting both original bound boxes.
            j0 = data.subst_cols[s]
            lam = data.subst_scale[t]
            u0 = data.subst_rhs[t]
            lj, uj = data.subst_vals[s], data.subst_vals[s + 1]
            w = x[j0]
            with np.errstate(invalid="ignore"):
                xj = np.clip((w - u0) / lam, lj, uj)
            x[data.subst_idx[t]] = xj
            x[j0] = w - lam * xj
        else:
            x[data.subst_idx[t]] = (
                data.subst_rhs[t]
                - data.subst_vals[s:e] @ x[data.subst_cols[s:e]]
            ) / data.subst_scale[t]
    return x


def postsolve_dual(
    y_reduced: np.ndarray, x_full: np.ndarray, data: PostsolveData
) -> np.ndarray:
    """Map the reduced dual solution back to the original row space.

    The reference's PaPILO round trip is primal-only
    (Packages/papilo_wrapper.cpp:37-45); this goes beyond it.  Surviving
    rows take their reduced duals via `row_map`; removed rows are recovered
    in a reverse sweep over the transform stack using each entry's column
    snapshot (c_j and column j at reduction time), which makes the
    stationarity condition for the eliminated variable exact at every
    stage:

    - kind 0 (substituted-out variable, implied-free): the removed
      equality row's dual solves lambda_j = 0, i.e.
      y_i = (c_j - sum_r a_rj y_r) / a_ij.
    - kind 2 (row that became a variable bound): if the introduced bound
      is active at x (and, for inequality rows, the transferred multiplier
      is nonnegative), the variable's remaining reduced cost moves onto
      the row: y_i = lambda_j / a_ij.
    - kind 3 (duplicate inequality whose rhs won the merge): the kept
      row's dual moves to the dropped row, scaled by the proportionality
      factor.

    Rows removed as redundant (empty, activity-redundant, slack
    duplicates) keep y = 0, which satisfies complementary slackness.
    """
    if data.m_orig < 0:
        raise ValueError(
            "this transformation record predates dual postsolve support "
            "(no m_orig/row_map): re-run presolve to regenerate it; only "
            "postsolve()/postsolve_solution (primal) works with legacy "
            "files"
        )
    y = np.zeros(data.m_orig)
    if data.row_map.size != np.asarray(y_reduced).size:
        raise ValueError(
            f"reduced dual has {np.asarray(y_reduced).size} entries but "
            f"the transformation record maps {data.row_map.size} "
            "surviving rows"
        )
    if data.row_map.size:
        y[data.row_map] = y_reduced
    kinds = data.subst_kind
    for t in range(len(data.subst_idx) - 1, -1, -1):
        kind = kinds[t] if len(kinds) else 0
        if kind == 1:
            continue  # parallel-column split: dual no-op
        if kind == 3:
            i, i0 = data.subst_idx[t], data.subst_row[t]
            y[i] = y[i0] / data.subst_scale[t]
            y[i0] = 0.0
            continue
        if kind == 4:
            # Sparsify: row r absorbed lam * (equality row i); undoing the
            # combination moves the absorbed multiplier back onto row i.
            y[data.subst_idx[t]] += (
                data.subst_scale[t] * y[data.subst_row[t]]
            )
            continue
        i = data.subst_row[t]
        if i < 0:
            continue  # legacy entry without dual info
        ds, de = data.dcol_indptr[t], data.dcol_indptr[t + 1]
        lam_j = data.subst_cj[t] - (
            data.dcol_vals[ds:de] @ y[data.dcol_rows[ds:de]]
        )
        a = data.subst_scale[t]
        if kind == 0:
            y[i] = lam_j / a
            continue
        # kind 2: bound transfer.
        v = data.subst_rhs[t]
        j = data.subst_idx[t]
        flag = data.subst_flag[t]
        at_bound = abs(x_full[j] - v) <= 1e-7 * (1.0 + abs(v))
        if not at_bound:
            continue
        yi = lam_j / a
        if abs(flag) == 2:
            y[i] = yi  # equality row: free dual
        elif yi > 0.0:
            y[i] = yi  # inequality row: dual must stay nonnegative
    return y


def _feas_tol(q):
    return 1e-9 * (1.0 + float(np.max(np.abs(q))) if q.size else 1.0)


def presolve(
    problem: LPProblem,
    *,
    max_passes: int = 25,
    backend: str = "python",
) -> PresolveResult:
    """Reduce an LP; returns the reduced problem + postsolve data.

    status RUNNING -> solve `result.problem`, then `postsolve`.
    status PRIMAL_INFEASIBLE / DUAL_INFEASIBLE -> decided during presolve.
    """
    if backend == "cpp":
        from tpdlp_torch.presolve.cpp import presolve_cpp

        return presolve_cpp(problem, max_passes=max_passes)
    if backend != "python":
        raise ValueError(f"unknown presolve backend: {backend!r}")

    K = sp.csr_matrix(
        problem.K.astype(np.float64)
        if sp.issparse(problem.K)
        else np.asarray(problem.K, np.float64)
    )
    c = np.asarray(problem.c, np.float64).copy()
    q = np.asarray(problem.q, np.float64).copy()
    l = np.asarray(problem.l, np.float64).copy()
    u = np.asarray(problem.u, np.float64).copy()
    m, n = K.shape
    is_ineq = np.arange(m) < problem.m_ineq
    # Implied-bound flags (PaPILO's boundsImplied): True when the finite
    # value in l/u was DERIVED from row activities by the tightening pass
    # (the rows stay in the problem, so the box bound is redundant and can
    # never bind strictly).  Implied-freeness checks treat such bounds as
    # +-inf; bounds set by passes that REMOVE their implying row (singleton
    # rows, duality fixing) are real and clear the flag.
    l_imp = np.zeros(n, dtype=bool)
    u_imp = np.zeros(n, dtype=bool)

    # Bookkeeping against ORIGINAL indices.
    orig_cols = np.arange(n)
    orig_rows = np.arange(m)
    fixed_idx: list[int] = []
    fixed_val: list[float] = []
    subst_kind: list[int] = []
    subst_idx: list[int] = []
    subst_scale: list[float] = []
    subst_rhs: list[float] = []
    subst_cols: list[np.ndarray] = []
    subst_vals: list[np.ndarray] = []
    subst_row: list[int] = []
    subst_cj: list[float] = []
    subst_flag: list[int] = []
    dcol_rows: list[np.ndarray] = []
    dcol_vals: list[np.ndarray] = []
    obj_offset = 0.0
    rows_removed = 0
    cols_removed = 0
    status = Status.RUNNING

    def push_entry(
        kind, idx, scale, rhs, cols, vals,
        row=-1, cj=0.0, flag=0, dc_rows=None, dc_vals=None,
    ):
        """Append one transform-stack entry (original indices throughout)."""
        subst_kind.append(kind)
        subst_idx.append(int(idx))
        subst_scale.append(float(scale))
        subst_rhs.append(float(rhs))
        subst_cols.append(np.asarray(cols, dtype=np.int64))
        subst_vals.append(np.asarray(vals, dtype=np.float64))
        subst_row.append(int(row))
        subst_cj.append(float(cj))
        subst_flag.append(int(flag))
        dcol_rows.append(
            np.asarray(dc_rows if dc_rows is not None else [], np.int64)
        )
        dcol_vals.append(
            np.asarray(dc_vals if dc_vals is not None else [], np.float64)
        )

    def col_snapshot(Kc_cur, j, skip_row):
        """Column j of the CURRENT matrix as (original row indices, values),
        excluding local row `skip_row`."""
        s_, e_ = Kc_cur.indptr[j], Kc_cur.indptr[j + 1]
        rows_loc = Kc_cur.indices[s_:e_]
        vals_loc = Kc_cur.data[s_:e_]
        keep = rows_loc != skip_row
        return orig_rows[rows_loc[keep]], vals_loc[keep]

    def fail(s):
        nonlocal status
        status = s

    passes = 0
    changed = True
    while changed and passes < max_passes and status == Status.RUNNING:
        changed = False
        passes += 1
        K = K.tocsr()
        K.eliminate_zeros()
        m, n = K.shape

        row_nnz = np.diff(K.indptr)
        tol = _feas_tol(q)

        # ---- empty rows ----
        empty = row_nnz == 0
        if empty.any():
            bad_ineq = empty & is_ineq & (q > tol)
            bad_eq = empty & ~is_ineq & (np.abs(q) > tol)
            if bad_ineq.any() or bad_eq.any():
                fail(Status.PRIMAL_INFEASIBLE)
                break
            keep = ~empty
            K = K[keep]
            q = q[keep]
            is_ineq = is_ineq[keep]
            orig_rows = orig_rows[keep]
            rows_removed += int(empty.sum())
            changed = True
            continue

        # ---- singleton rows -> bounds ----
        singles = np.flatnonzero(row_nnz == 1)
        if singles.size:
            Kc_snap = K.tocsc()
            drop_rows = np.zeros(m, dtype=bool)
            for i in singles:
                a = K.data[K.indptr[i]]
                j = K.indices[K.indptr[i]]
                b = q[i]
                if a == 0.0:
                    continue
                v = b / a
                if is_ineq[i]:
                    if a > 0:
                        if v > l[j]:
                            dr, dv = col_snapshot(Kc_snap, j, i)
                            push_entry(
                                2, orig_cols[j], a, v, [], [],
                                row=orig_rows[i], cj=c[j], flag=1,
                                dc_rows=dr, dc_vals=dv,
                            )
                            l[j] = v
                            l_imp[j] = False
                    else:
                        if v < u[j]:
                            dr, dv = col_snapshot(Kc_snap, j, i)
                            push_entry(
                                2, orig_cols[j], a, v, [], [],
                                row=orig_rows[i], cj=c[j], flag=-1,
                                dc_rows=dr, dc_vals=dv,
                            )
                            u[j] = v
                            u_imp[j] = False
                else:
                    # equality pins the variable; the row's (free) dual
                    # absorbs whatever reduced cost remains on x_j.
                    dr, dv = col_snapshot(Kc_snap, j, i)
                    push_entry(
                        2, orig_cols[j], a, v, [], [],
                        row=orig_rows[i], cj=c[j], flag=2,
                        dc_rows=dr, dc_vals=dv,
                    )
                    l[j] = max(l[j], v)
                    u[j] = min(u[j], v)
                    l_imp[j] = False
                    u_imp[j] = False
                drop_rows[i] = True
            # NaN-safe threshold: u = -inf would give -inf + inf = NaN and
            # the comparison would silently miss the infeasibility.
            thr = np.where(
                np.isneginf(u), -np.inf, u + 1e-9 * (1 + np.abs(u))
            )
            if np.any(l > thr):
                fail(Status.PRIMAL_INFEASIBLE)
                break
            keep = ~drop_rows
            K = K[keep]
            q = q[keep]
            is_ineq = is_ineq[keep]
            orig_rows = orig_rows[keep]
            rows_removed += int(drop_rows.sum())
            changed = True
            continue

        # ---- row activities: redundancy, infeasibility, bound tightening
        # (PaPILO's ConstraintPropagation / redundant-row family) ----
        # Per-entry activity contributions; +-inf entries are counted, not
        # summed, so "activity minus one variable" stays exact.
        Kr = K.tocsr()
        ent_row = np.repeat(np.arange(m), np.diff(Kr.indptr))
        ent_col = Kr.indices
        ent_val = Kr.data
        with np.errstate(invalid="ignore"):
            lo_c = np.where(ent_val > 0, ent_val * l[ent_col],
                            ent_val * u[ent_col])
            hi_c = np.where(ent_val > 0, ent_val * u[ent_col],
                            ent_val * l[ent_col])
        lo_fin = np.where(np.isfinite(lo_c), lo_c, 0.0)
        hi_fin = np.where(np.isfinite(hi_c), hi_c, 0.0)
        min_fin = np.bincount(ent_row, lo_fin, minlength=m)
        max_fin = np.bincount(ent_row, hi_fin, minlength=m)
        n_min_inf = np.bincount(ent_row, np.isneginf(lo_c), minlength=m)
        n_max_inf = np.bincount(ent_row, np.isposinf(hi_c), minlength=m)
        min_act = np.where(n_min_inf > 0, -np.inf, min_fin)
        max_act = np.where(n_max_inf > 0, np.inf, max_fin)
        act_tol = tol + 1e-9 * (
            np.abs(min_fin) + np.abs(max_fin) + np.abs(q)
        )
        bad = np.where(
            is_ineq,
            max_act < q - act_tol,
            (max_act < q - act_tol) | (min_act > q + act_tol),
        )
        if bad.any():
            fail(Status.PRIMAL_INFEASIBLE)
            break
        redundant = np.where(
            is_ineq,
            min_act >= q - act_tol,
            (min_act >= q - act_tol) & (max_act <= q + act_tol),
        )
        if redundant.any():
            keep = ~redundant
            K = Kr[keep]
            q = q[keep]
            is_ineq = is_ineq[keep]
            orig_rows = orig_rows[keep]
            rows_removed += int(redundant.sum())
            changed = True
            continue

        # Bound tightening: for row a.x >= q (or = q), variable j's bound
        # implied by the others' extreme activities.  "Activity minus j"
        # is finite iff the row has no infinite contributions besides
        # possibly j's own.
        hi_wo_j_ok = (n_max_inf[ent_row] == 0) | (
            (n_max_inf[ent_row] == 1) & np.isposinf(hi_c)
        )
        lo_wo_j_ok = (n_min_inf[ent_row] == 0) | (
            (n_min_inf[ent_row] == 1) & np.isneginf(lo_c)
        )
        hi_wo_j = max_fin[ent_row] - np.where(np.isfinite(hi_c), hi_c, 0.0)
        lo_wo_j = min_fin[ent_row] - np.where(np.isfinite(lo_c), lo_c, 0.0)
        resid_hi = (q[ent_row] - hi_wo_j) / ent_val  # from max activity
        resid_lo = (q[ent_row] - lo_wo_j) / ent_val  # from min activity
        ineq_e = is_ineq[ent_row]
        # a > 0: resid_hi is a LOWER bound on x_j (ineq + eq);
        #         resid_lo is an UPPER bound (eq rows only).
        # a < 0: mirrored.
        cand_l = np.full(len(ent_val), -np.inf)
        cand_u = np.full(len(ent_val), np.inf)
        pos = ent_val > 0
        m_l = hi_wo_j_ok & pos
        cand_l[m_l] = resid_hi[m_l]
        m_u = hi_wo_j_ok & ~pos
        cand_u[m_u] = resid_hi[m_u]
        m_l2 = lo_wo_j_ok & ~pos & ~ineq_e
        cand_l[m_l2] = np.maximum(cand_l[m_l2], resid_lo[m_l2])
        m_u2 = lo_wo_j_ok & pos & ~ineq_e
        cand_u[m_u2] = np.minimum(cand_u[m_u2], resid_lo[m_u2])
        best_l = np.full(n, -np.inf)
        best_u = np.full(n, np.inf)
        np.maximum.at(best_l, ent_col, cand_l)
        np.minimum.at(best_u, ent_col, cand_u)
        # Significant-improvement threshold: avoids stack churn from
        # epsilon tightenings across passes.
        thresh = 1e-6 * (1.0 + np.minimum(np.abs(best_l), 1e12))
        imp_l = np.flatnonzero(
            (best_l > l + thresh) | (np.isneginf(l) & np.isfinite(best_l))
        )
        thresh_u = 1e-6 * (1.0 + np.minimum(np.abs(best_u), 1e12))
        imp_u = np.flatnonzero(
            (best_u < u - thresh_u) | (np.isposinf(u) & np.isfinite(best_u))
        )
        if imp_l.size or imp_u.size:
            Kc_snap = K.tocsc()
            # First entry (row-major order) achieving each column's best
            # bound, found in ONE vectorized sweep — a per-column rescan
            # of the entry arrays would be O(n_improved * nnz).
            ent_idx = np.arange(ent_col.size)

            def first_hits(imp, cand, best):
                mask = np.zeros(n, dtype=bool)
                mask[imp] = True
                match = mask[ent_col] & (cand == best[ent_col])
                first = np.full(n, ent_col.size, dtype=np.int64)
                np.minimum.at(first, ent_col[match], ent_idx[match])
                return first

            first_l = first_hits(imp_l, cand_l, best_l)
            for j in imp_l:
                e0 = first_l[j]
                i = ent_row[e0]
                dr, dv = col_snapshot(Kc_snap, j, i)
                push_entry(
                    2, orig_cols[j], ent_val[e0], best_l[j], [], [],
                    row=orig_rows[i], cj=c[j],
                    flag=1 if is_ineq[i] else 2,
                    dc_rows=dr, dc_vals=dv,
                )
                l[j] = best_l[j]
                l_imp[j] = True
            first_u = first_hits(imp_u, cand_u, best_u)
            for j in imp_u:
                e0 = first_u[j]
                i = ent_row[e0]
                dr, dv = col_snapshot(Kc_snap, j, i)
                push_entry(
                    2, orig_cols[j], ent_val[e0], best_u[j], [], [],
                    row=orig_rows[i], cj=c[j],
                    flag=-1 if is_ineq[i] else -2,
                    dc_rows=dr, dc_vals=dv,
                )
                u[j] = best_u[j]
                u_imp[j] = True
            if np.any(l > u + 1e-9 * (1 + np.abs(np.where(np.isfinite(u),
                                                          u, 0.0)))):
                fail(Status.PRIMAL_INFEASIBLE)
                break
            changed = True
            # Tightening leaves the matrix shape untouched, so FALL
            # THROUGH: propagation alone can keep improving bounds by
            # >threshold amounts for many rounds (staircase models), and
            # a `continue` here would starve every later family within
            # the pass budget.

        # ---- fixed variables (l == u) and empty columns ----
        Kc = K.tocsc()
        col_nnz = np.diff(Kc.indptr)
        with np.errstate(invalid="ignore"):
            fixed = np.isfinite(u) & (l >= u - 1e-12 * (1 + np.abs(u)))
        empty_col = (col_nnz == 0) & ~fixed
        if empty_col.any():
            for j in np.flatnonzero(empty_col):
                if c[j] > 0:
                    if np.isneginf(l[j]):
                        fail(Status.DUAL_INFEASIBLE)
                        break
                    v = l[j]
                elif c[j] < 0:
                    if np.isposinf(u[j]):
                        fail(Status.DUAL_INFEASIBLE)
                        break
                    v = u[j]
                else:
                    v = l[j] if np.isfinite(l[j]) else (
                        u[j] if np.isfinite(u[j]) else 0.0
                    )
                l[j] = u[j] = v
                l_imp[j] = u_imp[j] = False
            if status != Status.RUNNING:
                break
            with np.errstate(invalid="ignore"):
                fixed = np.isfinite(u) & (l >= u - 1e-12 * (1 + np.abs(u)))

        if fixed.any():
            vals = 0.5 * (l[fixed] + u[fixed])
            # Substitute: q -= K[:, fixed] @ vals ; objective offset.
            q = q - Kc[:, fixed] @ vals
            obj_offset += float(c[fixed] @ vals)
            fixed_idx.extend(orig_cols[fixed].tolist())
            fixed_val.extend(vals.tolist())
            keep_cols = ~fixed
            K = Kc[:, keep_cols].tocsr()
            c = c[keep_cols]
            l = l[keep_cols]
            u = u[keep_cols]
            l_imp = l_imp[keep_cols]
            u_imp = u_imp[keep_cols]
            orig_cols = orig_cols[keep_cols]
            cols_removed += int(fixed.sum())
            changed = True
            continue

        # ---- dominated columns (duality fixing; PaPILO's DualFix) ----
        # A column with no equality-row entries whose inequality entries all
        # share one sign admits a one-sided dual bound: with rows G x >= h
        # (dual y >= 0) the reduced cost lambda_j = c_j - sum_i a_ij y_i is
        # >= c_j when all a_ij <= 0, so c_j >= 0 forces x_j to its lower
        # bound; symmetrically c_j <= 0 with all a_ij >= 0 forces the upper
        # bound.  An infinite forced bound with strict cost sign certifies
        # dual infeasibility.
        Kc2 = K.tocsc()
        n = Kc2.shape[1]
        col_ids = np.repeat(np.arange(n), np.diff(Kc2.indptr))
        entry_eq = ~is_ineq[Kc2.indices]
        has_eq = np.bincount(col_ids[entry_eq], minlength=n) > 0
        pos_ineq = np.bincount(
            col_ids[(Kc2.data > 0) & ~entry_eq], minlength=n
        ) > 0
        neg_ineq = np.bincount(
            col_ids[(Kc2.data < 0) & ~entry_eq], minlength=n
        ) > 0
        nonempty = np.diff(Kc2.indptr) > 0
        unfixed = l < u
        cand_lo = ~has_eq & ~pos_ineq & (c >= 0) & nonempty & unfixed
        cand_hi = ~has_eq & ~neg_ineq & (c <= 0) & nonempty & unfixed
        dom = False
        for j in np.flatnonzero(cand_lo):
            if np.isfinite(l[j]):
                u[j] = l[j]
                l_imp[j] = u_imp[j] = False
                dom = True
            elif c[j] > 0:
                fail(Status.DUAL_INFEASIBLE)
                break
        if status == Status.RUNNING:
            for j in np.flatnonzero(cand_hi & ~cand_lo):
                if np.isfinite(u[j]):
                    l[j] = u[j]
                    l_imp[j] = u_imp[j] = False
                    dom = True
                elif c[j] < 0:
                    fail(Status.DUAL_INFEASIBLE)
                    break
        if status != Status.RUNNING:
            break
        if dom:
            changed = True
            continue  # the fixed-variable pass performs the substitution

        # ---- free column singletons in equality rows (substitution) ----
        # A free variable (l = -inf, u = +inf) with a single nonzero, in an
        # equality row, is determined by that row: x_j = (b_i - sum_k a_ik
        # x_k)/a_ij.  Remove row i and column j; fold c_j through the row
        # into the remaining costs.  Primal recovery happens in the
        # postsolve substitution stack (PaPILO's column-singleton family).
        col_nnz3 = np.diff(Kc2.indptr)
        # Effectively free: the bound is -inf/+inf OR was derived purely
        # from row activities (implied — it can never bind strictly, so
        # lambda_j = 0 and the shift-recovered dual stays exact).
        free_col = (np.isneginf(l) | l_imp) & (np.isposinf(u) | u_imp)
        cand_fs = np.flatnonzero((col_nnz3 == 1) & free_col)
        if cand_fs.size:
            Kr = K.tocsr()
            m = Kr.shape[0]
            row_used = np.zeros(m, dtype=bool)
            drop_row = np.zeros(m, dtype=bool)
            drop_col = np.zeros(Kr.shape[1], dtype=bool)
            for j in cand_fs:
                i = Kc2.indices[Kc2.indptr[j]]
                if is_ineq[i] or row_used[i]:
                    continue
                a_jj = Kc2.data[Kc2.indptr[j]]
                s, e = Kr.indptr[i], Kr.indptr[i + 1]
                vals = Kr.data[s:e]
                if abs(a_jj) < 1e-10 * (1.0 + np.max(np.abs(vals))):
                    continue  # numerically unsafe pivot
                cols = Kr.indices[s:e]
                keep_k = cols != j
                ratio = c[j] / a_jj
                push_entry(
                    0, orig_cols[j], a_jj, q[i],
                    orig_cols[cols[keep_k]].copy(), vals[keep_k].copy(),
                    row=orig_rows[i], cj=c[j],
                )
                c[cols[keep_k]] -= ratio * vals[keep_k]
                obj_offset += ratio * q[i]
                row_used[i] = True
                drop_row[i] = True
                drop_col[j] = True
            if drop_col.any():
                keep_r = ~drop_row
                keep_c = ~drop_col
                K = Kr[keep_r][:, keep_c]
                q = q[keep_r]
                is_ineq = is_ineq[keep_r]
                orig_rows = orig_rows[keep_r]
                c = c[keep_c]
                l = l[keep_c]
                u = u[keep_c]
                l_imp = l_imp[keep_c]
                u_imp = u_imp[keep_c]
                orig_cols = orig_cols[keep_c]
                rows_removed += int(drop_row.sum())
                cols_removed += int(drop_col.sum())
                changed = True
                continue

        # ---- doubleton equations (PaPILO DoubletonEq) ----
        # An equality row a x_j + b x_k = q with x_j implied free (its
        # bounds are implied by the row plus x_k's box) substitutes
        # x_j = (q - b x_k)/a into every other row, the costs, and the
        # postsolve stack.  The dual of the removed row follows from
        # lambda_j = 0 via the stored column snapshot.
        Kr4 = K.tocsr()
        Kc4 = Kr4.tocsc()
        row_nnz4 = np.diff(Kr4.indptr)
        col_nnz4 = np.diff(Kc4.indptr)
        dbl_rows = np.flatnonzero((row_nnz4 == 2) & ~is_ineq)
        if dbl_rows.size:
            used_vars: set[int] = set()
            upd_r: list[np.ndarray] = []  # COO update rows
            upd_c: list[np.ndarray] = []
            upd_v: list[np.ndarray] = []
            drop_row4 = np.zeros(Kr4.shape[0], dtype=bool)
            drop_col4 = np.zeros(Kr4.shape[1], dtype=bool)
            any_dbl = False
            for i in dbl_rows:
                s_, e_ = Kr4.indptr[i], Kr4.indptr[i + 1]
                j1, j2 = Kr4.indices[s_:e_]
                a1, a2 = Kr4.data[s_:e_]
                if j1 in used_vars or j2 in used_vars:
                    continue
                qi = q[i]
                picked = None
                for (j, a, k, b) in ((j1, a1, j2, a2), (j2, a2, j1, a1)):
                    if abs(a) < 1e-10 * (1.0 + abs(b)):
                        continue
                    if col_nnz4[j] > 32:
                        continue  # cap fill-in
                    # Implied interval of x_j over x_k's box.
                    with np.errstate(invalid="ignore"):
                        e1 = (qi - b * l[k]) / a
                        e2 = (qi - b * u[k]) / a
                    lo_j, hi_j = min(e1, e2), max(e1, e2)
                    bt = 1e-9 * (1.0 + abs(qi))
                    if np.isnan(lo_j) or np.isnan(hi_j):
                        continue  # 0 * inf: b vanishes under inf bound
                    lj_eff = -np.inf if l_imp[j] else l[j]
                    uj_eff = np.inf if u_imp[j] else u[j]
                    if lo_j >= lj_eff - bt and hi_j <= uj_eff + bt:
                        picked = (j, a, k, b)
                        break
                if picked is None:
                    continue
                j, a, k, b = picked
                # Rows other than i that contain x_j gain a x_k entry.
                cs, ce = Kc4.indptr[j], Kc4.indptr[j + 1]
                rws = Kc4.indices[cs:ce]
                gvs = Kc4.data[cs:ce]
                other = rws != i
                rws_o, gvs_o = rws[other], gvs[other]
                upd_r.append(rws_o)
                upd_c.append(np.full(rws_o.size, k, dtype=np.int64))
                upd_v.append(gvs_o * (-b / a))
                # ... and their rhs shifts; cancel x_j's own entries.
                q[rws_o] -= gvs_o * (qi / a)
                upd_r.append(rws_o)
                upd_c.append(np.full(rws_o.size, j, dtype=np.int64))
                upd_v.append(-gvs_o)
                push_entry(
                    0, orig_cols[j], a, qi,
                    [orig_cols[k]], [b],
                    row=orig_rows[i], cj=c[j],
                    dc_rows=orig_rows[rws_o], dc_vals=gvs_o,
                )
                obj_offset += c[j] * qi / a
                c[k] -= c[j] * b / a
                used_vars.add(int(j))
                used_vars.add(int(k))
                drop_row4[i] = True
                drop_col4[j] = True
                any_dbl = True
            if any_dbl:
                if upd_r:
                    U = sp.coo_matrix(
                        (
                            np.concatenate(upd_v),
                            (np.concatenate(upd_r), np.concatenate(upd_c)),
                        ),
                        shape=Kr4.shape,
                    )
                    K = (Kr4 + U.tocsr()).tocsr()
                else:
                    K = Kr4
                keep_r = ~drop_row4
                keep_c = ~drop_col4
                K = K[keep_r][:, keep_c]
                K.eliminate_zeros()
                q = q[keep_r]
                is_ineq = is_ineq[keep_r]
                orig_rows = orig_rows[keep_r]
                c = c[keep_c]
                l = l[keep_c]
                u = u[keep_c]
                l_imp = l_imp[keep_c]
                u_imp = u_imp[keep_c]
                orig_cols = orig_cols[keep_c]
                rows_removed += int(drop_row4.sum())
                cols_removed += int(drop_col4.sum())
                changed = True
                continue

        # ---- implied-free column substitution (PaPILO Substitution) ----
        # Aggregation: a column j with few nonzeros, pivoting on an
        # equality row i whose interval-implied range for x_j (over the
        # OTHER variables' boxes) lies inside [l_j, u_j] — x_j is implied
        # free, its bounds can never bind — substitutes
        # x_j = (q_i - sum_{k != j} a_ik x_k) / a_ij into every other row
        # containing x_j.  Generalizes the free-singleton (col support 1)
        # and doubleton-equation (row support 2) passes; reference
        # interface parity: the PaPILO binary the reference shells out to
        # (Packages/prepostsolve.py:17-26) applies the same family.
        # Postsolve rides the same kind-0 stack entry.  Batch exclusion:
        # an accepted substitution invalidates every row of column j and
        # every column of row i, so candidates touching them defer to the
        # next outer pass — this keeps the deferred COO update equivalent
        # to in-place application (and the C++ twin in lockstep).
        Kr6 = K.tocsr()
        Kc6 = Kr6.tocsc()
        row_nnz6 = np.diff(Kr6.indptr)
        col_nnz6 = np.diff(Kc6.indptr)
        cand_ag = np.flatnonzero((col_nnz6 >= 2) & (col_nnz6 <= 4))
        if cand_ag.size:
            m, n = Kr6.shape
            touched_r = np.zeros(m, dtype=bool)
            touched_c = np.zeros(n, dtype=bool)
            upd_r6: list[np.ndarray] = []
            upd_c6: list[np.ndarray] = []
            upd_v6: list[np.ndarray] = []
            drop_row6 = np.zeros(m, dtype=bool)
            drop_col6 = np.zeros(n, dtype=bool)
            any_ag = False
            for j in cand_ag:
                cs_, ce_ = Kc6.indptr[j], Kc6.indptr[j + 1]
                rows_j = Kc6.indices[cs_:ce_]
                vals_j = Kc6.data[cs_:ce_]
                if touched_c[j] or touched_r[rows_j].any():
                    continue
                picked6 = None
                for t6 in range(rows_j.size):
                    i = rows_j[t6]
                    a = vals_j[t6]
                    if is_ineq[i] or row_nnz6[i] > 32:
                        continue
                    if (col_nnz6[j] - 1) * (row_nnz6[i] - 1) > 16:
                        continue  # fill-in cap
                    rs_, re_ = Kr6.indptr[i], Kr6.indptr[i + 1]
                    cols_i = Kr6.indices[rs_:re_]
                    vals_i = Kr6.data[rs_:re_]
                    if touched_c[cols_i].any():
                        continue
                    if abs(a) < 1e-10 * (1.0 + np.max(np.abs(vals_i))):
                        continue  # numerically unsafe pivot
                    # Implied interval of x_j over the other columns'
                    # boxes (sum in ascending column order — the C++
                    # twin accumulates identically).
                    ok6 = True
                    smin = 0.0
                    smax = 0.0
                    for t7 in range(cols_i.size):
                        k = cols_i[t7]
                        if k == j:
                            continue
                        av = vals_i[t7]
                        p1 = av * l[k]
                        p2 = av * u[k]
                        if np.isnan(p1) or np.isnan(p2):
                            ok6 = False  # 0 * inf cannot happen for
                            break  # stored nonzeros, but stay NaN-safe
                        smin += min(p1, p2)
                        smax += max(p1, p2)
                    if not ok6:
                        continue
                    qi6 = q[i]
                    if a > 0:
                        lo_j = (qi6 - smax) / a
                        hi_j = (qi6 - smin) / a
                    else:
                        lo_j = (qi6 - smin) / a
                        hi_j = (qi6 - smax) / a
                    bt6 = 1e-9 * (1.0 + abs(qi6))
                    if np.isnan(lo_j) or np.isnan(hi_j):
                        continue
                    lj_eff = -np.inf if l_imp[j] else l[j]
                    uj_eff = np.inf if u_imp[j] else u[j]
                    if lo_j >= lj_eff - bt6 and hi_j <= uj_eff + bt6:
                        picked6 = (i, a, cols_i, vals_i)
                        break
                if picked6 is None:
                    continue
                i, a, cols_i, vals_i = picked6
                qi6 = q[i]
                other6 = rows_j != i
                rws_o6 = rows_j[other6]
                gvs_o6 = vals_j[other6]
                keep_k6 = cols_i != j
                cols_no = cols_i[keep_k6]
                vals_no = vals_i[keep_k6]
                # Every other row r with x_j: subtract (a_rj/a) * row_i —
                # cancels the x_j entry exactly and adds the pivot row's
                # other columns; rhs shifts by a_rj * q_i / a.
                for t8 in range(rws_o6.size):
                    g6 = gvs_o6[t8]
                    upd_r6.append(
                        np.full(cols_no.size, rws_o6[t8], dtype=np.int64)
                    )
                    upd_c6.append(cols_no.astype(np.int64))
                    upd_v6.append(vals_no * (-g6 / a))
                q[rws_o6] -= gvs_o6 * (qi6 / a)
                upd_r6.append(rws_o6.astype(np.int64))
                upd_c6.append(np.full(rws_o6.size, j, dtype=np.int64))
                upd_v6.append(-gvs_o6)
                push_entry(
                    0, orig_cols[j], a, qi6,
                    orig_cols[cols_no].copy(), vals_no.copy(),
                    row=orig_rows[i], cj=c[j],
                    dc_rows=orig_rows[rws_o6], dc_vals=gvs_o6,
                )
                obj_offset += c[j] * qi6 / a
                c[cols_no] -= c[j] * vals_no / a
                touched_r[rows_j] = True
                touched_c[cols_i] = True
                touched_c[j] = True
                drop_row6[i] = True
                drop_col6[j] = True
                any_ag = True
            if any_ag:
                if upd_r6:
                    U6 = sp.coo_matrix(
                        (
                            np.concatenate(upd_v6),
                            (
                                np.concatenate(upd_r6),
                                np.concatenate(upd_c6),
                            ),
                        ),
                        shape=Kr6.shape,
                    )
                    K = (Kr6 + U6.tocsr()).tocsr()
                else:
                    K = Kr6
                keep_r6 = ~drop_row6
                keep_c6 = ~drop_col6
                K = K[keep_r6][:, keep_c6]
                K.eliminate_zeros()
                q = q[keep_r6]
                is_ineq = is_ineq[keep_r6]
                orig_rows = orig_rows[keep_r6]
                c = c[keep_c6]
                l = l[keep_c6]
                u = u[keep_c6]
                l_imp = l_imp[keep_c6]
                u_imp = u_imp[keep_c6]
                orig_cols = orig_cols[keep_c6]
                rows_removed += int(drop_row6.sum())
                cols_removed += int(drop_col6.sum())
                changed = True
                continue

        # ---- parallel (proportional) columns (PaPILO ParallelCols) ----
        # Columns with identical row pattern and proportional values
        # (col_j = lam * col_j0) whose costs are consistent (c_j = lam *
        # c_j0) merge into one variable w = x_j0 + lam * x_j with summed
        # bounds; postsolve splits w back into a feasible (x_j0, x_j) pair
        # via the kind-1 stack entry.  Skipped when the split formula
        # would be ill-defined under infinite bounds.
        Kc5 = K.tocsc()
        n = Kc5.shape[1]
        # Hash by row PATTERN only; candidates in a bucket are compared by
        # value with a relative tolerance (exact bit-keys miss pairs whose
        # proportionality factor rounds, e.g. 1.5 * col).
        sig_c: dict = {}
        drop_col5 = np.zeros(n, dtype=bool)
        merged = False
        for j in range(n):
            s_, e_ = Kc5.indptr[j], Kc5.indptr[j + 1]
            if s_ == e_:
                continue  # empty columns are handled by their own pass
            idx_r = Kc5.indices[s_:e_]
            val_r = Kc5.data[s_:e_]
            lead = val_r[0]
            norm = val_r / lead
            bucket = sig_c.setdefault(idx_r.tobytes(), [])
            j0 = None
            for cand_j, cand_lead, cand_norm in bucket:
                if np.allclose(norm, cand_norm, rtol=1e-12, atol=0.0):
                    j0, lead0 = cand_j, cand_lead
                    break
            if j0 is None:
                bucket.append((j, lead, norm))
                continue
            lam = lead / lead0  # col_j = lam * col_j0
            if abs(c[j] - lam * c[j0]) > 1e-12 * (1.0 + abs(c[j])):
                continue  # costs inconsistent: not mergeable
            ok = (
                np.isfinite(u[j0])
                or (lam > 0 and np.isfinite(l[j]))
                or (lam < 0 and np.isfinite(u[j]))
            )
            if not ok:
                continue
            push_entry(
                1, orig_cols[j], lam, u[j0],
                np.array([orig_cols[j0], orig_cols[j0]], dtype=np.int64),
                np.array([l[j], u[j]], dtype=np.float64),
            )
            if lam > 0:
                l[j0] = l[j0] + lam * l[j]
                u[j0] = u[j0] + lam * u[j]
            else:
                l[j0] = l[j0] + lam * u[j]
                u[j0] = u[j0] + lam * l[j]
            l_imp[j0] = u_imp[j0] = False
            drop_col5[j] = True
            merged = True
        if merged:
            keep_c = ~drop_col5
            K = Kc5[:, keep_c].tocsr()
            c = c[keep_c]
            l = l[keep_c]
            u = u[keep_c]
            l_imp = l_imp[keep_c]
            u_imp = u_imp[keep_c]
            orig_cols = orig_cols[keep_c]
            cols_removed += int(drop_col5.sum())
            changed = True
            continue

        # ---- duplicate rows (identical pattern, proportional values) ----
        K = K.tocsr()
        m = K.shape[0]
        if m > 1:
            # Hash rows by (pattern, values normalised by first nonzero).
            sig: dict = {}
            drop_rows = np.zeros(m, dtype=bool)
            for i in range(m):
                s, e = K.indptr[i], K.indptr[i + 1]
                idx = K.indices[s:e]
                val = K.data[s:e]
                lead = val[0]
                key = (idx.tobytes(), (val / lead).tobytes())
                if key in sig:
                    i0, lead0 = sig[key]
                    lam = lead / lead0  # row_i = lam * row_i0
                    if is_ineq[i] and is_ineq[i0] and lam > 0:
                        if q[i] / lam > q[i0]:
                            # The dropped row's scaled rhs is the binding
                            # one: its dual must be recovered from the
                            # kept row's (kind-3 entry).
                            push_entry(
                                3, orig_rows[i], lam, 0.0, [], [],
                                row=orig_rows[i0],
                            )
                            q[i0] = q[i] / lam
                        drop_rows[i] = True
                    elif is_ineq[i] and is_ineq[i0] and lam < 0:
                        # row_i x >= q_i is an UPPER bound q_i/lam on
                        # row_i0 x: a range pair.  Only the contradiction
                        # is actionable (dominated-row infeasibility).
                        if q[i] / lam < q[i0] - tol:
                            fail(Status.PRIMAL_INFEASIBLE)
                            break
                    elif not is_ineq[i] and not is_ineq[i0]:
                        if abs(q[i] / lam - q[i0]) > tol:
                            fail(Status.PRIMAL_INFEASIBLE)
                            break
                        drop_rows[i] = True
                    elif is_ineq[i]:
                        # Equality i0 dominates the parallel inequality i:
                        # row_i x is pinned at lam * q_i0.
                        if lam * q[i0] < q[i] - tol:
                            fail(Status.PRIMAL_INFEASIBLE)
                            break
                        drop_rows[i] = True
                    else:
                        # Inequality i0 dominated by the new equality i:
                        # drop i0, keep i (redundant or contradictory).
                        if q[i] / lam < q[i0] - tol:
                            fail(Status.PRIMAL_INFEASIBLE)
                            break
                        drop_rows[i0] = True
                        sig[key] = (i, lead)
                else:
                    sig[key] = (i, lead)
            if status != Status.RUNNING:
                break
            if drop_rows.any():
                keep = ~drop_rows
                K = K[keep]
                q = q[keep]
                is_ineq = is_ineq[keep]
                orig_rows = orig_rows[keep]
                rows_removed += int(drop_rows.sum())
                changed = True

        # ---- sparsify (PaPILO Sparsify): row-combination cancellation --
        # Adding a multiple of an EQUALITY row i to any row r preserves
        # the feasible set exactly (for inequalities too: the added term
        # is identically q_i on it).  When supp(i) is a subset of supp(r)
        # the combination creates no fill, so choosing lam to cancel the
        # lead entry strictly reduces nonzeros; it is applied when at
        # least 2 entries cancel (the lead by construction, others only
        # when the fp sum is exactly zero — no tolerance-based
        # perturbation of the problem).  Primal is untouched; the kind-4
        # stack entry restores the absorbed dual: y_i += lam * y_r.
        K = K.tocsr()
        K.eliminate_zeros()
        row_nnz7 = np.diff(K.indptr)
        piv7 = np.flatnonzero(~is_ineq & (row_nnz7 >= 2) & (row_nnz7 <= 8))
        if piv7.size:
            Kc7 = K.tocsc()
            m = K.shape[0]
            touched7 = np.zeros(m, dtype=bool)
            upd_r7: list[np.ndarray] = []
            upd_c7: list[np.ndarray] = []
            upd_v7: list[np.ndarray] = []
            any_sp = False
            for i in piv7:
                if touched7[i]:
                    continue  # modified as a target earlier in the batch
                rs_, re_ = K.indptr[i], K.indptr[i + 1]
                cols_i = K.indices[rs_:re_]
                vals_i = K.data[rs_:re_]
                j0 = cols_i[0]
                a0 = vals_i[0]
                cs_, ce_ = Kc7.indptr[j0], Kc7.indptr[j0 + 1]
                for t9 in range(ce_ - cs_):
                    r = Kc7.indices[cs_ + t9]
                    if r == i or touched7[r]:
                        continue
                    if row_nnz7[r] < row_nnz7[i]:
                        continue
                    ts_, te_ = K.indptr[r], K.indptr[r + 1]
                    cols_r = K.indices[ts_:te_]
                    pos7 = np.searchsorted(cols_r, cols_i)
                    if np.any(pos7 >= cols_r.size) or np.any(
                        cols_r[np.minimum(pos7, cols_r.size - 1)] != cols_i
                    ):
                        continue  # supp(i) not a subset of supp(r)
                    vals_r = K.data[ts_:te_]
                    lam7 = -vals_r[pos7[0]] / a0
                    cancels = 1
                    for t10 in range(1, cols_i.size):
                        if vals_r[pos7[t10]] + lam7 * vals_i[t10] == 0.0:
                            cancels += 1
                    if cancels < 2:
                        continue
                    # Lead entry cancelled exactly by construction (the
                    # explicit -a_r,j0 dodges lam*a_i,j0 rounding).
                    upd_r7.append(np.full(1, r, dtype=np.int64))
                    upd_c7.append(np.full(1, j0, dtype=np.int64))
                    upd_v7.append(np.array([-vals_r[pos7[0]]]))
                    upd_r7.append(np.full(cols_i.size - 1, r, np.int64))
                    upd_c7.append(cols_i[1:].astype(np.int64))
                    upd_v7.append(lam7 * vals_i[1:])
                    q[r] += lam7 * q[i]
                    push_entry(
                        4, orig_rows[i], lam7, 0.0, [], [],
                        row=orig_rows[r],
                    )
                    touched7[r] = True
                    any_sp = True
            if any_sp:
                U7 = sp.coo_matrix(
                    (
                        np.concatenate(upd_v7),
                        (np.concatenate(upd_r7), np.concatenate(upd_c7)),
                    ),
                    shape=K.shape,
                )
                K = (K + U7.tocsr()).tocsr()
                K.eliminate_zeros()
                changed = True

        # ---- dual-bound strengthening (PaPILO DualInfer); runs LAST
        # so the structural families above (substitution,
        # aggregation, parallel columns) keep first claim on the
        # columns it would otherwise fix ----
        # The dominated-columns pass above needs a whole column's
        # inequality entries to share one sign; this pass generalizes it
        # by PROPAGATING bounds through the dual system.  Each column's
        # bound pattern constrains its dual activity s_j = sum_i a_ij y_i
        # (lambda_j = c_j - s_j must live in the bound cone):
        #   u_j = +inf            -> lambda_j >= 0 -> s_j <= c_j
        #   l_j = -inf            -> lambda_j <= 0 -> s_j >= c_j
        #   free                  -> s_j  = c_j
        #   finite box            -> no constraint.
        # Implied-finite bounds (l_imp/u_imp) count as infinite: SOME
        # optimal dual has lambda_j = 0 on a row-redundant bound, and the
        # inference only needs one optimal dual to satisfy the system.
        # Row duals start at y_i in [0, inf) (inequalities) / free
        # (equalities); activity propagation tightens them, and any
        # column whose lambda range ends strictly one-signed for EVERY
        # feasible dual is fixed to the bound complementarity dictates —
        # by strong duality that bound holds at every primal optimum.
        m, n = K.shape
        ge_j = np.isneginf(l) | l_imp   # s_j >= c_j
        le_j = np.isposinf(u) | u_imp   # s_j <= c_j
        ylo = np.where(is_ineq, 0.0, -np.inf)
        yhi = np.full(m, np.inf)
        Kcsc = K.tocsc()
        e_col = np.repeat(np.arange(n), np.diff(Kcsc.indptr))
        e_row = Kcsc.indices
        e_val = Kcsc.data
        s_min = s_max = None
        for _ in range(4):
            with np.errstate(invalid="ignore"):
                lo_e = np.where(e_val > 0, e_val * ylo[e_row],
                                e_val * yhi[e_row])
                hi_e = np.where(e_val > 0, e_val * yhi[e_row],
                                e_val * ylo[e_row])
            lo_f = np.where(np.isfinite(lo_e), lo_e, 0.0)
            hi_f = np.where(np.isfinite(hi_e), hi_e, 0.0)
            smin_f = np.bincount(e_col, lo_f, minlength=n)
            smax_f = np.bincount(e_col, hi_f, minlength=n)
            nlo_inf = np.bincount(e_col, np.isneginf(lo_e), minlength=n)
            nhi_inf = np.bincount(e_col, np.isposinf(hi_e), minlength=n)
            s_min = np.where(nlo_inf > 0, -np.inf, smin_f)
            s_max = np.where(nhi_inf > 0, np.inf, smax_f)
            # Implied y bounds from "s_j <= c_j" columns via min-activity-
            # without-entry (and from ">= c_j" via max-activity-without),
            # mirroring the primal tightening above.
            lo_wo_ok = (nlo_inf[e_col] == 0) | (
                (nlo_inf[e_col] == 1) & np.isneginf(lo_e)
            )
            hi_wo_ok = (nhi_inf[e_col] == 0) | (
                (nhi_inf[e_col] == 1) & np.isposinf(hi_e)
            )
            lo_wo = smin_f[e_col] - np.where(np.isfinite(lo_e), lo_e, 0.0)
            hi_wo = smax_f[e_col] - np.where(np.isfinite(hi_e), hi_e, 0.0)
            r_le = (c[e_col] - lo_wo) / e_val  # from s_j <= c_j
            r_ge = (c[e_col] - hi_wo) / e_val  # from s_j >= c_j
            ele = le_j[e_col] & lo_wo_ok
            ege = ge_j[e_col] & hi_wo_ok
            pos_e = e_val > 0
            cu = np.full(e_val.size, np.inf)
            cl = np.full(e_val.size, -np.inf)
            mask = ele & pos_e
            cu[mask] = r_le[mask]
            mask = ele & ~pos_e
            cl[mask] = r_le[mask]
            mask = ege & pos_e
            cl[mask] = np.maximum(cl[mask], r_ge[mask])
            mask = ege & ~pos_e
            cu[mask] = np.minimum(cu[mask], r_ge[mask])
            new_lo = ylo.copy()
            new_hi = yhi.copy()
            np.maximum.at(new_lo, e_row, cl)
            np.minimum.at(new_hi, e_row, cu)
            # Keep the propagation sound under roundoff: never CROSS the
            # previous range, and stop when nothing moved meaningfully.
            new_lo = np.minimum(new_lo, yhi)
            new_hi = np.maximum(new_hi, ylo)
            with np.errstate(invalid="ignore"):
                moved = bool(
                    np.any(new_lo > ylo + 1e-9 * (1 + np.abs(new_lo)))
                    or np.any(new_hi < yhi - 1e-9 * (1 + np.abs(new_hi)))
                )
            ylo, yhi = new_lo, new_hi
            if not moved:
                break
        lam_min = c - s_max
        lam_max = c - s_min
        strict = 1e-7 * (1.0 + np.abs(c))
        unfixed2 = l < u
        fix_lo2 = (lam_min > strict) & unfixed2
        fix_hi2 = (lam_max < -strict) & unfixed2 & ~fix_lo2
        dual_fixed = False
        for j in np.flatnonzero(fix_lo2):
            if np.isfinite(l[j]):
                u[j] = l[j]
                l_imp[j] = u_imp[j] = False
                dual_fixed = True
            else:
                fail(Status.DUAL_INFEASIBLE)
                break
        if status == Status.RUNNING:
            for j in np.flatnonzero(fix_hi2):
                if np.isfinite(u[j]):
                    l[j] = u[j]
                    l_imp[j] = u_imp[j] = False
                    dual_fixed = True
                else:
                    fail(Status.DUAL_INFEASIBLE)
                    break
        if status != Status.RUNNING:
            break
        if dual_fixed:
            changed = True
            continue  # the fixed-variable pass performs the substitution


    indptr = np.zeros(len(subst_idx) + 1, np.int64)
    if subst_idx:
        indptr[1:] = np.cumsum([len(a) for a in subst_cols])
    d_indptr = np.zeros(len(subst_idx) + 1, np.int64)
    if subst_idx:
        d_indptr[1:] = np.cumsum([len(a) for a in dcol_rows])
    # row_map in the FINAL reduced row order (ineq-prefix reordering below
    # must be applied to it too when the problem survives).
    data = PostsolveData(
        n_orig=problem.n,
        col_map=orig_cols,
        fixed_idx=np.asarray(fixed_idx, dtype=np.int64),
        fixed_val=np.asarray(fixed_val),
        obj_offset=obj_offset,
        subst_kind=np.asarray(subst_kind, dtype=np.int8),
        subst_idx=np.asarray(subst_idx, dtype=np.int64),
        subst_scale=np.asarray(subst_scale),
        subst_rhs=np.asarray(subst_rhs),
        subst_indptr=indptr,
        subst_cols=(
            np.concatenate(subst_cols).astype(np.int64)
            if subst_cols else np.zeros(0, np.int64)
        ),
        subst_vals=(
            np.concatenate(subst_vals) if subst_vals else np.zeros(0)
        ),
        m_orig=problem.m,
        row_map=orig_rows,
        subst_row=np.asarray(subst_row, dtype=np.int64),
        subst_cj=np.asarray(subst_cj),
        subst_flag=np.asarray(subst_flag, dtype=np.int8),
        dcol_indptr=d_indptr,
        dcol_rows=(
            np.concatenate(dcol_rows).astype(np.int64)
            if dcol_rows else np.zeros(0, np.int64)
        ),
        dcol_vals=(
            np.concatenate(dcol_vals) if dcol_vals else np.zeros(0)
        ),
    )

    if status != Status.RUNNING:
        return PresolveResult(None, data, status, rows_removed, cols_removed,
                              passes)

    if K.shape[1] == 0 and K.shape[0] == 0:
        # Fully reduced: the presolver solved the LP; the solution is
        # entirely in the postsolve data.
        data.row_map = np.zeros(0, np.int64)
        return PresolveResult(
            None, data, Status.SOLVED, rows_removed, cols_removed, passes
        )

    # Re-stack so inequality rows stay a prefix (reductions preserve order
    # within each block, but removals may interleave — enforce the invariant).
    K = K.tocsr()
    order = np.argsort(~is_ineq, kind="stable")
    K = K[order]
    q = q[order]
    data.row_map = orig_rows[order]
    m_ineq = int(is_ineq.sum())

    reduced = LPProblem(
        c=c, K=K, q=q, m_ineq=m_ineq, l=l, u=u,
        name=problem.name + "+presolved",
        obj_offset=problem.obj_offset + obj_offset,
        objsense=problem.objsense,
    )
    return PresolveResult(
        reduced, data, Status.RUNNING, rows_removed, cols_removed, passes
    )
