// tpdlp presolve core: PaPILO-equivalent LP reductions in C++.
//
// tpdlp_torch's copy of tpdlp/presolve/core.cpp, built by
// tpdlp_torch/presolve/cpp.py.  Native counterpart of
// tpdlp_torch/presolve/reductions.py (kept in lockstep and cross-tested
// against it).  Reference analog: the PaPILO presolve engine
// driven through Packages/papilo_wrapper.cpp:11-50; here the reductions are
// implemented directly on the standard form
//
//     min c'x   s.t.  G x >= h  (rows [0, m_ineq)),  A x = b,  l <= x <= u
//
// Passes, iterated to a fixpoint (bounded by max_passes):
//   1. empty rows        -> drop, or PRIMAL_INFEASIBLE on contradictions
//   2. singleton rows    -> variable bound updates, drop row (kind-2 dual
//                           entries record the bound transfer)
//   3. row activities    -> redundant-row removal, activity-based
//                           infeasibility, and bound tightening (PaPILO's
//                           ConstraintPropagation family)
//   4. empty columns     -> fix at the cost-optimal bound (DUAL_INFEASIBLE
//                           when that bound is infinite)
//   5. fixed variables   -> substitute into rhs, accumulate obj offset
//   6. dominated columns -> duality fixing at a bound (DUAL_INFEASIBLE when
//                           the forced bound is infinite with strict cost)
//   7. free column singletons in equality rows -> substituted out via the
//                           row (postsolve substitution stack)
//   8. doubleton equations (PaPILO DoubletonEq) -> implied-free variable in
//                           a 2-nnz equality row substituted through it
//   9. parallel columns  -> proportional columns with consistent costs
//                           merged (postsolve split entry)
//  10. duplicate rows    -> proportional rows merged (tighter rhs for
//                           inequalities, kind-3 dual entry when the
//                           dropped rhs wins; eq/ineq domination;
//                           contradiction checks)
//
// Exposed via a C ABI (ctypes).  The postsolve transformation carries both
// the primal data (surviving-column map, fixed values, objective offset,
// substitution stack) matching the reference's `postsolve_solution`
// semantics (papilo_wrapper.cpp:37-45), and the round-2 dual-recovery
// extension: per-entry removed-row ids, cost and column snapshots, and the
// surviving-row map, mirroring PostsolveData in reductions.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <utility>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

enum StatusCode {
  kRunning = 0,
  kSolved = 1,
  kDualInfeasible = 4,
  kPrimalInfeasible = 5,
};

struct Entry {
  int32_t col;
  double val;
};

struct Problem {
  std::vector<std::vector<Entry>> rows;  // sorted by col within each row
  std::vector<uint8_t> is_ineq;
  std::vector<double> c, q, l, u;
  // Implied-bound flags (PaPILO's boundsImplied): the finite bound was
  // DERIVED from row activities (rows stay in the problem, so the box
  // bound can never bind strictly).  Implied-freeness checks treat such
  // bounds as +-inf; bounds whose implying row is REMOVED are real.
  std::vector<uint8_t> l_imp, u_imp;
  std::vector<int64_t> orig_cols;
  std::vector<int64_t> orig_rows;
};

struct Result {
  int status = kRunning;
  Problem p;
  std::vector<int64_t> fixed_idx;
  std::vector<double> fixed_val;
  // Transform stack (CSR-like layout), chronological; kinds as in
  // reductions.py: 0 = linear substitution, 1 = parallel-column split,
  // 2 = bound transfer (dual-only), 3 = duplicate-row rhs winner
  // (dual-only).
  std::vector<int8_t> subst_kind;
  std::vector<int64_t> subst_idx;
  std::vector<double> subst_scale, subst_rhs;
  std::vector<int64_t> subst_indptr{0};
  std::vector<int64_t> subst_cols;
  std::vector<double> subst_vals;
  // Dual-recovery extension (per entry; parallel to subst_idx).
  std::vector<int64_t> subst_row;
  std::vector<double> subst_cj;
  std::vector<int8_t> subst_flag;
  std::vector<int64_t> dcol_indptr{0};
  std::vector<int64_t> dcol_rows;
  std::vector<double> dcol_vals;
  double obj_offset = 0.0;
  int64_t rows_removed = 0;
  int64_t cols_removed = 0;
  int passes = 0;

  // Append the scalar fields of one stack entry; the caller then pushes
  // into subst_cols/subst_vals and dcol_rows/dcol_vals and calls seal().
  void push_entry(int8_t kind, int64_t idx, double scale, double rhs,
                  int64_t row, double cj, int8_t flag) {
    subst_kind.push_back(kind);
    subst_idx.push_back(idx);
    subst_scale.push_back(scale);
    subst_rhs.push_back(rhs);
    subst_row.push_back(row);
    subst_cj.push_back(cj);
    subst_flag.push_back(flag);
  }
  void seal() {
    subst_indptr.push_back(static_cast<int64_t>(subst_cols.size()));
    dcol_indptr.push_back(static_cast<int64_t>(dcol_rows.size()));
  }
};

double feas_tol(const std::vector<double>& q) {
  double mx = 0.0;
  for (double v : q) mx = std::max(mx, std::fabs(v));
  return 1e-9 * (1.0 + mx);
}

// Column views (ascending row index, matching scipy CSC entry order).
void build_cols(const Problem& p,
                std::vector<std::vector<int64_t>>& col_rows,
                std::vector<std::vector<double>>& col_vals) {
  col_rows.assign(p.c.size(), {});
  col_vals.assign(p.c.size(), {});
  for (size_t i = 0; i < p.rows.size(); ++i) {
    for (const auto& e : p.rows[i]) {
      col_rows[e.col].push_back(static_cast<int64_t>(i));
      col_vals[e.col].push_back(e.val);
    }
  }
}

// Drop rows flagged in `drop`, preserving order.
void drop_rows(Problem& p, const std::vector<uint8_t>& drop, Result& r) {
  size_t w = 0;
  for (size_t i = 0; i < p.rows.size(); ++i) {
    if (drop[i]) {
      ++r.rows_removed;
      continue;
    }
    if (w != i) {
      p.rows[w] = std::move(p.rows[i]);
      p.is_ineq[w] = p.is_ineq[i];
      p.q[w] = p.q[i];
      p.orig_rows[w] = p.orig_rows[i];
    }
    ++w;
  }
  p.rows.resize(w);
  p.is_ineq.resize(w);
  p.q.resize(w);
  p.orig_rows.resize(w);
}

// Drop columns flagged in `drop`: strip their entries from every row,
// remap surviving column indices, compact c/l/u/orig_cols.
void drop_cols(Problem& p, const std::vector<uint8_t>& drop, Result& r) {
  const size_t n = p.c.size();
  std::vector<int32_t> new_col(n, -1);
  int32_t w = 0;
  for (size_t j = 0; j < n; ++j) {
    if (drop[j]) {
      ++r.cols_removed;
    } else {
      new_col[j] = w++;
    }
  }
  for (auto& row : p.rows) {
    size_t k = 0;
    for (size_t e = 0; e < row.size(); ++e) {
      if (drop[row[e].col]) continue;
      row[k].col = new_col[row[e].col];
      row[k].val = row[e].val;
      ++k;
    }
    row.resize(k);
  }
  std::vector<double> c2, l2, u2;
  std::vector<uint8_t> li2, ui2;
  std::vector<int64_t> oc2;
  c2.reserve(w);
  for (size_t j = 0; j < n; ++j) {
    if (drop[j]) continue;
    c2.push_back(p.c[j]);
    l2.push_back(p.l[j]);
    u2.push_back(p.u[j]);
    li2.push_back(p.l_imp[j]);
    ui2.push_back(p.u_imp[j]);
    oc2.push_back(p.orig_cols[j]);
  }
  p.c = std::move(c2);
  p.l = std::move(l2);
  p.u = std::move(u2);
  p.l_imp = std::move(li2);
  p.u_imp = std::move(ui2);
  p.orig_cols = std::move(oc2);
}

bool pass_empty_rows(Problem& p, Result& r) {
  const double tol = feas_tol(p.q);
  std::vector<uint8_t> drop(p.rows.size(), 0);
  bool any = false;
  for (size_t i = 0; i < p.rows.size(); ++i) {
    if (!p.rows[i].empty()) continue;
    const bool bad =
        p.is_ineq[i] ? (p.q[i] > tol) : (std::fabs(p.q[i]) > tol);
    if (bad) {
      r.status = kPrimalInfeasible;
      return false;
    }
    drop[i] = 1;
    any = true;
  }
  if (any) drop_rows(p, drop, r);
  return any;
}

bool pass_singleton_rows(Problem& p, Result& r) {
  const size_t m = p.rows.size();
  bool have_single = false;
  for (size_t i = 0; i < m && !have_single; ++i)
    have_single = (p.rows[i].size() == 1);
  if (!have_single) return false;
  // Column snapshot at pass start, for the dual-recovery entries.
  std::vector<std::vector<int64_t>> col_rows;
  std::vector<std::vector<double>> col_vals;
  build_cols(p, col_rows, col_vals);
  auto push_bound = [&](int32_t j, size_t i, double a, double v,
                        int8_t flag) {
    r.push_entry(2, p.orig_cols[j], a, v, p.orig_rows[i], p.c[j], flag);
    for (size_t e = 0; e < col_rows[j].size(); ++e) {
      if (col_rows[j][e] == static_cast<int64_t>(i)) continue;
      r.dcol_rows.push_back(p.orig_rows[col_rows[j][e]]);
      r.dcol_vals.push_back(col_vals[j][e]);
    }
    r.seal();
  };
  std::vector<uint8_t> drop(m, 0);
  bool any = false;
  for (size_t i = 0; i < m; ++i) {
    if (p.rows[i].size() != 1) continue;
    const double a = p.rows[i][0].val;
    const int32_t j = p.rows[i][0].col;
    if (a == 0.0) continue;
    const double v = p.q[i] / a;
    if (p.is_ineq[i]) {
      if (a > 0) {
        if (v > p.l[j]) {
          push_bound(j, i, a, v, 1);
          p.l[j] = v;
          p.l_imp[j] = 0;
        }
      } else {
        if (v < p.u[j]) {
          push_bound(j, i, a, v, -1);
          p.u[j] = v;
          p.u_imp[j] = 0;
        }
      }
    } else {
      // Equality pins the variable; the row's (free) dual absorbs
      // whatever reduced cost remains on x_j.
      push_bound(j, i, a, v, 2);
      p.l[j] = std::max(p.l[j], v);
      p.u[j] = std::min(p.u[j], v);
      p.l_imp[j] = 0;
      p.u_imp[j] = 0;
    }
    drop[i] = 1;
    any = true;
  }
  for (size_t j = 0; j < p.l.size(); ++j) {
    // NaN-safe: u = -inf would give -inf + inf = NaN (comparison false)
    // and silently miss the infeasibility.
    const double thr = (std::isinf(p.u[j]) && p.u[j] < 0)
                           ? -kInf
                           : p.u[j] + 1e-9 * (1.0 + std::fabs(p.u[j]));
    if (p.l[j] > thr) {
      r.status = kPrimalInfeasible;
      return false;
    }
  }
  if (any) drop_rows(p, drop, r);
  return any;
}

// Row activities: redundancy, infeasibility, and bound tightening
// (PaPILO's ConstraintPropagation / redundant-row family).  +-inf bound
// contributions are counted, not summed, so "activity minus one variable"
// stays exact.  Mirrors the vectorized numpy pass entry-for-entry.
bool pass_row_activity(Problem& p, Result& r, bool* tightened) {
  const size_t m = p.rows.size();
  const size_t n = p.c.size();
  const double tol = feas_tol(p.q);
  std::vector<double> min_fin(m, 0.0), max_fin(m, 0.0);
  std::vector<int64_t> n_min_inf(m, 0), n_max_inf(m, 0);
  auto contrib = [&](const Entry& e, double& lo_c, double& hi_c) {
    if (e.val > 0) {
      lo_c = e.val * p.l[e.col];
      hi_c = e.val * p.u[e.col];
    } else {
      lo_c = e.val * p.u[e.col];
      hi_c = e.val * p.l[e.col];
    }
  };
  for (size_t i = 0; i < m; ++i) {
    for (const auto& e : p.rows[i]) {
      double lo_c, hi_c;
      contrib(e, lo_c, hi_c);
      if (std::isfinite(lo_c)) min_fin[i] += lo_c;
      if (std::isfinite(hi_c)) max_fin[i] += hi_c;
      if (std::isinf(lo_c) && lo_c < 0) ++n_min_inf[i];
      if (std::isinf(hi_c) && hi_c > 0) ++n_max_inf[i];
    }
  }
  std::vector<uint8_t> redundant(m, 0);
  bool any_red = false;
  for (size_t i = 0; i < m; ++i) {
    const double act_tol =
        tol + 1e-9 * (std::fabs(min_fin[i]) + std::fabs(max_fin[i]) +
                      std::fabs(p.q[i]));
    const double min_act = n_min_inf[i] > 0 ? -kInf : min_fin[i];
    const double max_act = n_max_inf[i] > 0 ? kInf : max_fin[i];
    const bool bad =
        p.is_ineq[i]
            ? (max_act < p.q[i] - act_tol)
            : (max_act < p.q[i] - act_tol || min_act > p.q[i] + act_tol);
    if (bad) {
      r.status = kPrimalInfeasible;
      return false;
    }
    const bool red =
        p.is_ineq[i]
            ? (min_act >= p.q[i] - act_tol)
            : (min_act >= p.q[i] - act_tol && max_act <= p.q[i] + act_tol);
    if (red) {
      redundant[i] = 1;
      any_red = true;
    }
  }
  if (any_red) {
    drop_rows(p, redundant, r);
    return true;
  }

  // Bound tightening: for row a.x >= q (or = q), variable j's bound
  // implied by the others' extreme activities.  "Activity minus j" is
  // finite iff the row has no infinite contributions besides possibly
  // j's own.  Ties keep the FIRST achieving entry in row-major order
  // (matches hits[0] in the numpy pass).
  struct Hit {
    int64_t row = -1;
    double aval = 0.0;
  };
  std::vector<double> best_l(n, -kInf), best_u(n, kInf);
  std::vector<Hit> hit_l(n), hit_u(n);
  for (size_t i = 0; i < m; ++i) {
    for (const auto& e : p.rows[i]) {
      double lo_c, hi_c;
      contrib(e, lo_c, hi_c);
      const bool hi_ok =
          n_max_inf[i] == 0 ||
          (n_max_inf[i] == 1 && std::isinf(hi_c) && hi_c > 0);
      const bool lo_ok =
          n_min_inf[i] == 0 ||
          (n_min_inf[i] == 1 && std::isinf(lo_c) && lo_c < 0);
      const double hi_wo = max_fin[i] - (std::isfinite(hi_c) ? hi_c : 0.0);
      const double lo_wo = min_fin[i] - (std::isfinite(lo_c) ? lo_c : 0.0);
      const double resid_hi = (p.q[i] - hi_wo) / e.val;
      const double resid_lo = (p.q[i] - lo_wo) / e.val;
      const bool pos = e.val > 0;
      double cl = -kInf, cu = kInf;
      if (hi_ok && pos) cl = resid_hi;
      if (hi_ok && !pos) cu = resid_hi;
      if (lo_ok && !pos && !p.is_ineq[i]) cl = std::max(cl, resid_lo);
      if (lo_ok && pos && !p.is_ineq[i]) cu = std::min(cu, resid_lo);
      if (cl > best_l[e.col]) {
        best_l[e.col] = cl;
        hit_l[e.col] = {static_cast<int64_t>(i), e.val};
      }
      if (cu < best_u[e.col]) {
        best_u[e.col] = cu;
        hit_u[e.col] = {static_cast<int64_t>(i), e.val};
      }
    }
  }
  // Significant-improvement threshold: avoids stack churn from epsilon
  // tightenings across passes.
  std::vector<int64_t> imp_l, imp_u;
  for (size_t j = 0; j < n; ++j) {
    const double bl = best_l[j];
    const double thr = 1e-6 * (1.0 + std::min(std::fabs(bl), 1e12));
    if (bl > p.l[j] + thr ||
        (std::isinf(p.l[j]) && p.l[j] < 0 && std::isfinite(bl))) {
      imp_l.push_back(static_cast<int64_t>(j));
    }
    const double bu = best_u[j];
    const double thr_u = 1e-6 * (1.0 + std::min(std::fabs(bu), 1e12));
    if (bu < p.u[j] - thr_u ||
        (std::isinf(p.u[j]) && p.u[j] > 0 && std::isfinite(bu))) {
      imp_u.push_back(static_cast<int64_t>(j));
    }
  }
  if (imp_l.empty() && imp_u.empty()) return false;
  std::vector<std::vector<int64_t>> col_rows;
  std::vector<std::vector<double>> col_vals;
  build_cols(p, col_rows, col_vals);
  auto push_tighten = [&](int64_t j, const Hit& h, double v, int8_t flag) {
    r.push_entry(2, p.orig_cols[j], h.aval, v, p.orig_rows[h.row], p.c[j],
                 flag);
    for (size_t e = 0; e < col_rows[j].size(); ++e) {
      if (col_rows[j][e] == h.row) continue;
      r.dcol_rows.push_back(p.orig_rows[col_rows[j][e]]);
      r.dcol_vals.push_back(col_vals[j][e]);
    }
    r.seal();
  };
  for (int64_t j : imp_l) {
    const Hit& h = hit_l[j];
    push_tighten(j, h, best_l[j],
                 p.is_ineq[h.row] ? int8_t{1} : int8_t{2});
    p.l[j] = best_l[j];
    p.l_imp[j] = 1;
  }
  for (int64_t j : imp_u) {
    const Hit& h = hit_u[j];
    push_tighten(j, h, best_u[j],
                 p.is_ineq[h.row] ? int8_t{-1} : int8_t{-2});
    p.u[j] = best_u[j];
    p.u_imp[j] = 1;
  }
  for (size_t j = 0; j < n; ++j) {
    const double u_fin = std::isfinite(p.u[j]) ? std::fabs(p.u[j]) : 0.0;
    if (p.l[j] > p.u[j] + 1e-9 * (1.0 + u_fin)) {
      r.status = kPrimalInfeasible;
      return false;
    }
  }
  // Tightening leaves the matrix shape untouched, so the caller FALLS
  // THROUGH to the later families within the same pass (mirroring the
  // numpy pass): propagation alone can keep improving bounds by
  // >threshold amounts for many rounds on staircase models, and a
  // restart here would starve everything after it within the pass budget.
  *tightened = true;
  return false;
}

bool pass_columns(Problem& p, Result& r) {
  const size_t n = p.c.size();
  std::vector<int64_t> col_nnz(n, 0);
  for (const auto& row : p.rows)
    for (const auto& e : row) ++col_nnz[e.col];

  std::vector<uint8_t> fixed(n, 0);
  auto is_fixed = [&](size_t j) {
    return std::isfinite(p.u[j]) &&
           p.l[j] >= p.u[j] - 1e-12 * (1.0 + std::fabs(p.u[j]));
  };
  for (size_t j = 0; j < n; ++j) fixed[j] = is_fixed(j);

  // Empty columns: fix at the cost-optimal bound.
  for (size_t j = 0; j < n; ++j) {
    if (col_nnz[j] != 0 || fixed[j]) continue;
    double v;
    if (p.c[j] > 0) {
      if (std::isinf(p.l[j])) {
        r.status = kDualInfeasible;
        return false;
      }
      v = p.l[j];
    } else if (p.c[j] < 0) {
      if (std::isinf(p.u[j])) {
        r.status = kDualInfeasible;
        return false;
      }
      v = p.u[j];
    } else {
      v = std::isfinite(p.l[j]) ? p.l[j]
                                : (std::isfinite(p.u[j]) ? p.u[j] : 0.0);
    }
    p.l[j] = p.u[j] = v;
    p.l_imp[j] = p.u_imp[j] = 0;
    fixed[j] = 1;
  }

  bool any = false;
  for (size_t j = 0; j < n; ++j) any |= (fixed[j] != 0);
  if (!any) return false;

  // Substitute fixed variables into the rhs and compact columns.
  std::vector<double> val(n, 0.0);
  std::vector<int32_t> new_col(n, -1);
  int32_t w = 0;
  for (size_t j = 0; j < n; ++j) {
    if (fixed[j]) {
      val[j] = 0.5 * (p.l[j] + p.u[j]);
      r.fixed_idx.push_back(p.orig_cols[j]);
      r.fixed_val.push_back(val[j]);
      r.obj_offset += p.c[j] * val[j];
      ++r.cols_removed;
    } else {
      new_col[j] = w++;
    }
  }
  for (size_t i = 0; i < p.rows.size(); ++i) {
    auto& row = p.rows[i];
    size_t k = 0;
    for (size_t e = 0; e < row.size(); ++e) {
      const int32_t j = row[e].col;
      if (fixed[j]) {
        p.q[i] -= row[e].val * val[j];
      } else {
        row[k].col = new_col[j];
        row[k].val = row[e].val;
        ++k;
      }
    }
    row.resize(k);
  }
  std::vector<double> c2, l2, u2;
  std::vector<int64_t> oc2;
  c2.reserve(w);
  for (size_t j = 0; j < n; ++j) {
    if (fixed[j]) continue;
    c2.push_back(p.c[j]);
    l2.push_back(p.l[j]);
    u2.push_back(p.u[j]);
    oc2.push_back(p.orig_cols[j]);
  }
  p.c = std::move(c2);
  p.l = std::move(l2);
  p.u = std::move(u2);
  p.orig_cols = std::move(oc2);
  return true;
}

// Dominated columns (duality fixing; PaPILO's DualFix).  A column with no
// equality-row entries whose inequality entries all share one sign admits a
// one-sided dual bound: with rows G x >= h (dual y >= 0) the reduced cost
// lambda_j = c_j - sum_i a_ij y_i is >= c_j when all a_ij <= 0, so c_j >= 0
// forces x_j to its lower bound; symmetrically c_j <= 0 with all a_ij >= 0
// forces the upper bound.  An infinite forced bound with strict cost sign
// certifies dual infeasibility.  The bound pinch (l == u) is applied here;
// pass_columns performs the substitution.
bool pass_dominated_cols(Problem& p, Result& r) {
  const size_t n = p.c.size();
  std::vector<uint8_t> has_eq(n, 0), pos_ineq(n, 0), neg_ineq(n, 0),
      nonempty(n, 0);
  for (size_t i = 0; i < p.rows.size(); ++i) {
    for (const auto& e : p.rows[i]) {
      nonempty[e.col] = 1;
      if (!p.is_ineq[i]) {
        has_eq[e.col] = 1;
      } else if (e.val > 0) {
        pos_ineq[e.col] = 1;
      } else if (e.val < 0) {
        neg_ineq[e.col] = 1;
      }
    }
  }
  bool any = false;
  for (size_t j = 0; j < n; ++j) {
    if (!nonempty[j] || has_eq[j] || !(p.l[j] < p.u[j])) continue;
    const bool lo = !pos_ineq[j] && p.c[j] >= 0;
    const bool hi = !neg_ineq[j] && p.c[j] <= 0;
    if (lo) {
      if (std::isfinite(p.l[j])) {
        p.u[j] = p.l[j];
        p.l_imp[j] = p.u_imp[j] = 0;
        any = true;
      } else if (p.c[j] > 0) {
        r.status = kDualInfeasible;
        return false;
      }
    } else if (hi) {
      if (std::isfinite(p.u[j])) {
        p.l[j] = p.u[j];
        p.l_imp[j] = p.u_imp[j] = 0;
        any = true;
      } else if (p.c[j] < 0) {
        r.status = kDualInfeasible;
        return false;
      }
    }
  }
  return any;
}

// Dual-bound strengthening (PaPILO DualInfer); mirrors
// reductions.py's tail pass exactly.  Each column's bound pattern
// constrains its dual activity s_j = sum_i a_ij y_i (lambda_j =
// c_j - s_j must live in the bound cone): u_j = +inf (or implied)
// -> s_j <= c_j; l_j = -inf (or implied) -> s_j >= c_j; free -> both.
// Activity propagation over y (ineq rows y >= 0, eq rows free) tightens
// [ylo, yhi]; any column whose lambda range ends strictly one-signed
// for EVERY feasible dual is pinched to the bound complementarity
// dictates.  Runs LAST in the driver so the structural families keep
// first claim on the columns it would otherwise fix.
bool pass_dual_infer(Problem& p, Result& r) {
  const size_t m = p.rows.size(), n = p.c.size();
  if (!m || !n) return false;
  const double kInf = std::numeric_limits<double>::infinity();
  std::vector<uint8_t> ge_j(n, 0), le_j(n, 0);
  for (size_t j = 0; j < n; ++j) {
    ge_j[j] = (std::isinf(p.l[j]) && p.l[j] < 0) || p.l_imp[j];
    le_j[j] = (std::isinf(p.u[j]) && p.u[j] > 0) || p.u_imp[j];
  }
  std::vector<double> ylo(m), yhi(m, kInf);
  for (size_t i = 0; i < m; ++i) ylo[i] = p.is_ineq[i] ? 0.0 : -kInf;
  std::vector<std::vector<int64_t>> col_rows;
  std::vector<std::vector<double>> col_vals;
  build_cols(p, col_rows, col_vals);

  std::vector<double> smin_f(n), smax_f(n);
  std::vector<int32_t> nlo_inf(n), nhi_inf(n);
  std::vector<double> s_min(n), s_max(n);
  for (int round = 0; round < 4; ++round) {
    for (size_t j = 0; j < n; ++j) {
      double lo_sum = 0.0, hi_sum = 0.0;
      int32_t nlo = 0, nhi = 0;
      for (size_t k = 0; k < col_rows[j].size(); ++k) {
        const int64_t i = col_rows[j][k];
        const double v = col_vals[j][k];
        const double lo_e = v > 0 ? v * ylo[i] : v * yhi[i];
        const double hi_e = v > 0 ? v * yhi[i] : v * ylo[i];
        if (std::isinf(lo_e)) ++nlo; else lo_sum += lo_e;
        if (std::isinf(hi_e)) ++nhi; else hi_sum += hi_e;
      }
      smin_f[j] = lo_sum; smax_f[j] = hi_sum;
      nlo_inf[j] = nlo; nhi_inf[j] = nhi;
      s_min[j] = nlo ? -kInf : lo_sum;
      s_max[j] = nhi ? kInf : hi_sum;
    }
    std::vector<double> new_lo(ylo), new_hi(yhi);
    for (size_t j = 0; j < n; ++j) {
      if (!le_j[j] && !ge_j[j]) continue;
      for (size_t k = 0; k < col_rows[j].size(); ++k) {
        const int64_t i = col_rows[j][k];
        const double v = col_vals[j][k];
        const double lo_e = v > 0 ? v * ylo[i] : v * yhi[i];
        const double hi_e = v > 0 ? v * yhi[i] : v * ylo[i];
        const bool lo_wo_ok =
            nlo_inf[j] == 0 || (nlo_inf[j] == 1 && std::isinf(lo_e)
                                && lo_e < 0);
        const bool hi_wo_ok =
            nhi_inf[j] == 0 || (nhi_inf[j] == 1 && std::isinf(hi_e)
                                && hi_e > 0);
        const double lo_wo =
            smin_f[j] - (std::isinf(lo_e) ? 0.0 : lo_e);
        const double hi_wo =
            smax_f[j] - (std::isinf(hi_e) ? 0.0 : hi_e);
        if (le_j[j] && lo_wo_ok) {
          const double r_le = (p.c[j] - lo_wo) / v;
          if (v > 0) {
            new_hi[i] = std::min(new_hi[i], r_le);
          } else {
            new_lo[i] = std::max(new_lo[i], r_le);
          }
        }
        if (ge_j[j] && hi_wo_ok) {
          const double r_ge = (p.c[j] - hi_wo) / v;
          if (v > 0) {
            new_lo[i] = std::max(new_lo[i], r_ge);
          } else {
            new_hi[i] = std::min(new_hi[i], r_ge);
          }
        }
      }
    }
    bool moved = false;
    for (size_t i = 0; i < m; ++i) {
      // Never cross the previous range (roundoff soundness), mirroring
      // reductions.py's clamp.
      new_lo[i] = std::min(new_lo[i], yhi[i]);
      new_hi[i] = std::max(new_hi[i], ylo[i]);
      if (std::isfinite(new_lo[i])
          && new_lo[i] > ylo[i] + 1e-9 * (1 + std::fabs(new_lo[i]))) {
        moved = true;
      }
      if (std::isfinite(new_hi[i])
          && new_hi[i] < yhi[i] - 1e-9 * (1 + std::fabs(new_hi[i]))) {
        moved = true;
      }
    }
    ylo.swap(new_lo);
    yhi.swap(new_hi);
    if (!moved) break;
  }
  bool any = false;
  for (size_t j = 0; j < n; ++j) {
    if (!(p.l[j] < p.u[j])) continue;
    const double strict = 1e-7 * (1.0 + std::fabs(p.c[j]));
    const double lam_min = p.c[j] - s_max[j];
    if (lam_min > strict) {
      if (std::isfinite(p.l[j])) {
        p.u[j] = p.l[j];
        p.l_imp[j] = p.u_imp[j] = 0;
        any = true;
      } else {
        r.status = kDualInfeasible;
        return false;
      }
      continue;
    }
    const double lam_max = p.c[j] - s_min[j];
    if (lam_max < -strict) {
      if (std::isfinite(p.u[j])) {
        p.l[j] = p.u[j];
        p.l_imp[j] = p.u_imp[j] = 0;
        any = true;
      } else {
        r.status = kDualInfeasible;
        return false;
      }
    }
  }
  return any;
}

// Free column singletons in equality rows: a free variable (l = -inf,
// u = +inf) with a single nonzero a_ij in an equality row is determined by
// that row: x_j = (b_i - sum_k a_ik x_k)/a_ij.  Remove row i and column j,
// fold c_j through the row into the remaining costs, and push the
// substitution onto the postsolve stack (PaPILO's column-singleton family).
// The dual entry carries the removed row and c_j; the column snapshot is
// empty (x_j appears in no other row), so y_i = c_j / a_ij at recovery.
bool pass_free_singleton_cols(Problem& p, Result& r) {
  const size_t n = p.c.size();
  const size_t m = p.rows.size();
  std::vector<int64_t> col_nnz(n, 0);
  std::vector<int64_t> col_row(n, -1);
  std::vector<double> col_val(n, 0.0);
  for (size_t i = 0; i < m; ++i) {
    for (const auto& e : p.rows[i]) {
      ++col_nnz[e.col];
      col_row[e.col] = static_cast<int64_t>(i);
      col_val[e.col] = e.val;
    }
  }
  std::vector<uint8_t> row_used(m, 0), drop_row(m, 0), drop_col(n, 0);
  bool any = false;
  for (size_t j = 0; j < n; ++j) {
    if (col_nnz[j] != 1) continue;
    // Effectively free: -inf/+inf OR derived purely from row activities
    // (implied - can never bind strictly, so lambda_j = 0 stays exact).
    if (!((std::isinf(p.l[j]) && p.l[j] < 0) || p.l_imp[j])) continue;
    if (!((std::isinf(p.u[j]) && p.u[j] > 0) || p.u_imp[j])) continue;
    const int64_t i = col_row[j];
    if (p.is_ineq[i] || row_used[i]) continue;
    const double a_jj = col_val[j];
    double vmax = 0.0;
    for (const auto& e : p.rows[i]) vmax = std::max(vmax, std::fabs(e.val));
    if (std::fabs(a_jj) < 1e-10 * (1.0 + vmax)) continue;  // unsafe pivot
    const double ratio = p.c[j] / a_jj;
    r.push_entry(0, p.orig_cols[j], a_jj, p.q[i], p.orig_rows[i], p.c[j],
                 0);
    for (const auto& e : p.rows[i]) {
      if (e.col == static_cast<int32_t>(j)) continue;
      p.c[e.col] -= ratio * e.val;
      r.subst_cols.push_back(p.orig_cols[e.col]);
      r.subst_vals.push_back(e.val);
    }
    r.seal();
    r.obj_offset += ratio * p.q[i];
    row_used[i] = 1;
    drop_row[i] = 1;
    drop_col[j] = 1;
    any = true;
  }
  if (!any) return false;
  drop_rows(p, drop_row, r);
  drop_cols(p, drop_col, r);
  return true;
}

// Doubleton equations (PaPILO DoubletonEq).  An equality row
// a x_j + b x_k = q with x_j implied free (its bounds are implied by the
// row plus x_k's box) substitutes x_j = (q - b x_k)/a into every other
// row, the costs, and the postsolve stack.  The dual of the removed row
// follows from lambda_j = 0 via the stored column snapshot.  Candidate
// rows and column snapshots are taken at pass start (mirroring the numpy
// pass's deferred COO update); overlap is prevented by the used-variable
// guard, so in-place application is equivalent.
bool pass_doubleton_eq(Problem& p, Result& r) {
  const size_t m = p.rows.size();
  const size_t n = p.c.size();
  std::vector<size_t> dbl;
  for (size_t i = 0; i < m; ++i)
    if (!p.is_ineq[i] && p.rows[i].size() == 2) dbl.push_back(i);
  if (dbl.empty()) return false;
  std::vector<std::vector<int64_t>> col_rows;
  std::vector<std::vector<double>> col_vals;
  build_cols(p, col_rows, col_vals);
  std::vector<uint8_t> used(n, 0), drop_row(m, 0), drop_col(n, 0);
  bool any = false;
  for (size_t i : dbl) {
    if (p.rows[i].size() != 2) continue;  // modified mid-pass: skip
    const int32_t j1 = p.rows[i][0].col, j2 = p.rows[i][1].col;
    const double a1 = p.rows[i][0].val, a2 = p.rows[i][1].val;
    if (used[j1] || used[j2]) continue;
    const double qi = p.q[i];
    int32_t j = -1, k = -1;
    double a = 0.0, b = 0.0;
    bool found = false;
    for (int t = 0; t < 2 && !found; ++t) {
      const int32_t jj = (t == 0) ? j1 : j2;
      const int32_t kk = (t == 0) ? j2 : j1;
      const double aa = (t == 0) ? a1 : a2;
      const double bb = (t == 0) ? a2 : a1;
      if (std::fabs(aa) < 1e-10 * (1.0 + std::fabs(bb))) continue;
      if (static_cast<int64_t>(col_rows[jj].size()) > 32) continue;
      // Implied interval of x_j over x_k's box.
      const double e1 = (qi - bb * p.l[kk]) / aa;
      const double e2 = (qi - bb * p.u[kk]) / aa;
      const double lo_j = std::min(e1, e2);
      const double hi_j = std::max(e1, e2);
      const double bt = 1e-9 * (1.0 + std::fabs(qi));
      if (std::isnan(lo_j) || std::isnan(hi_j)) continue;
      const double lj_eff = p.l_imp[jj] ? -kInf : p.l[jj];
      const double uj_eff = p.u_imp[jj] ? kInf : p.u[jj];
      if (lo_j >= lj_eff - bt && hi_j <= uj_eff + bt) {
        j = jj;
        k = kk;
        a = aa;
        b = bb;
        found = true;
      }
    }
    if (!found) continue;
    const double cj = p.c[j];
    r.push_entry(0, p.orig_cols[j], a, qi, p.orig_rows[i], cj, 0);
    r.subst_cols.push_back(p.orig_cols[k]);
    r.subst_vals.push_back(b);
    for (size_t e = 0; e < col_rows[j].size(); ++e) {
      if (col_rows[j][e] == static_cast<int64_t>(i)) continue;
      r.dcol_rows.push_back(p.orig_rows[col_rows[j][e]]);
      r.dcol_vals.push_back(col_vals[j][e]);
    }
    r.seal();
    // Rows other than i that contain x_j: shift rhs, cancel the x_j
    // entry, and gain a x_k entry (kept column-sorted; exact zeros are
    // removed, matching eliminate_zeros).
    for (size_t e = 0; e < col_rows[j].size(); ++e) {
      const int64_t rr = col_rows[j][e];
      if (rr == static_cast<int64_t>(i)) continue;
      const double g = col_vals[j][e];
      p.q[rr] -= g * (qi / a);
      auto& row = p.rows[rr];
      for (size_t t2 = 0; t2 < row.size(); ++t2) {
        if (row[t2].col == j) {
          row.erase(row.begin() + t2);
          break;
        }
      }
      const double add = g * (-b / a);
      size_t pos2 = 0;
      while (pos2 < row.size() && row[pos2].col < k) ++pos2;
      if (pos2 < row.size() && row[pos2].col == k) {
        row[pos2].val += add;
        if (row[pos2].val == 0.0) row.erase(row.begin() + pos2);
      } else if (add != 0.0) {
        row.insert(row.begin() + pos2, Entry{k, add});
      }
    }
    r.obj_offset += cj * qi / a;
    p.c[k] -= cj * b / a;
    used[j] = 1;
    used[k] = 1;
    drop_row[i] = 1;
    drop_col[j] = 1;
    any = true;
  }
  if (!any) return false;
  drop_rows(p, drop_row, r);
  drop_cols(p, drop_col, r);
  return true;
}

// Parallel (proportional) columns (PaPILO ParallelCols): col_j = lam *
// col_j0 with consistent costs (c_j = lam c_j0) merge into one variable
// w = x_j0 + lam x_j with summed bounds; the postsolve kind-1 entry splits
// w back into a feasible pair.  Skipped when the split formula would be
// ill-defined under infinite bounds.  Mirrors the Python pass exactly
// (ascending kept-column order, same tolerances).
bool pass_parallel_cols(Problem& p, Result& r) {
  const size_t n = p.c.size();
  std::vector<std::vector<int64_t>> col_rows(n);
  std::vector<std::vector<double>> col_vals(n);
  for (size_t i = 0; i < p.rows.size(); ++i) {
    for (const auto& e : p.rows[i]) {
      col_rows[e.col].push_back(static_cast<int64_t>(i));
      col_vals[e.col].push_back(e.val);
    }
  }
  // Hash by row PATTERN only; candidates in a bucket are compared by
  // value with a relative tolerance (mirrors the Python pass; exact
  // bit-keys miss pairs whose proportionality factor rounds).
  using Key = std::vector<int64_t>;
  struct Cand {
    size_t j;
    double lead;
    std::vector<double> norm;
  };
  std::map<Key, std::vector<Cand>> sig;
  std::vector<uint8_t> drop(n, 0);
  bool any = false;
  for (size_t j = 0; j < n; ++j) {
    if (col_rows[j].empty()) continue;  // empty columns: own pass
    const double lead = col_vals[j][0];
    std::vector<double> norm(col_vals[j].size());
    for (size_t e = 0; e < col_vals[j].size(); ++e)
      norm[e] = col_vals[j][e] / lead;
    Key key(col_rows[j].begin(), col_rows[j].end());
    auto& bucket = sig[key];
    const Cand* hit = nullptr;
    for (const auto& cand : bucket) {
      bool close = true;
      for (size_t e = 0; e < norm.size() && close; ++e) {
        close = std::fabs(norm[e] - cand.norm[e]) <=
                1e-12 * std::fabs(cand.norm[e]);
      }
      if (close) {
        hit = &cand;
        break;
      }
    }
    if (hit == nullptr) {
      bucket.push_back({j, lead, std::move(norm)});
      continue;
    }
    const size_t j0 = hit->j;
    const double lam = lead / hit->lead;  // col_j = lam * col_j0
    if (std::fabs(p.c[j] - lam * p.c[j0]) >
        1e-12 * (1.0 + std::fabs(p.c[j]))) {
      continue;
    }
    const bool ok =
        std::isfinite(p.u[j0]) || (lam > 0 && std::isfinite(p.l[j])) ||
        (lam < 0 && std::isfinite(p.u[j]));
    if (!ok) continue;
    r.push_entry(1, p.orig_cols[j], lam, p.u[j0], -1, 0.0, 0);
    r.subst_cols.push_back(p.orig_cols[j0]);
    r.subst_cols.push_back(p.orig_cols[j0]);
    r.subst_vals.push_back(p.l[j]);
    r.subst_vals.push_back(p.u[j]);
    r.seal();
    if (lam > 0) {
      p.l[j0] = p.l[j0] + lam * p.l[j];
      p.u[j0] = p.u[j0] + lam * p.u[j];
    } else {
      p.l[j0] = p.l[j0] + lam * p.u[j];
      p.u[j0] = p.u[j0] + lam * p.l[j];
    }
    drop[j] = 1;
    any = true;
  }
  if (!any) return false;
  drop_cols(p, drop, r);
  return true;
}

// Duplicate rows (identical pattern, proportional values).  Beyond the
// plain merge: a dropped inequality whose scaled rhs wins leaves a kind-3
// dual entry; antiparallel inequalities are checked for contradiction;
// equalities dominate parallel inequalities in either direction.
bool pass_duplicate_rows(Problem& p, Result& r) {
  const double tol = feas_tol(p.q);
  if (p.rows.size() <= 1) return false;
  // Signature: column pattern + values normalised by the leading nonzero.
  using Key = std::vector<int64_t>;
  std::map<Key, std::pair<size_t, double>> sig;
  std::vector<uint8_t> drop(p.rows.size(), 0);
  bool any = false;
  for (size_t i = 0; i < p.rows.size(); ++i) {
    if (p.rows[i].empty()) continue;
    const double lead = p.rows[i][0].val;
    Key key;
    key.reserve(2 * p.rows[i].size());
    for (const auto& e : p.rows[i]) {
      key.push_back(e.col);
      double nv = e.val / lead;
      int64_t bits;
      std::memcpy(&bits, &nv, sizeof(bits));
      key.push_back(bits);
    }
    auto it = sig.find(key);
    if (it == sig.end()) {
      sig.emplace(std::move(key), std::make_pair(i, lead));
      continue;
    }
    const size_t i0 = it->second.first;
    const double lam = lead / it->second.second;  // row_i = lam * row_i0
    if (p.is_ineq[i] && p.is_ineq[i0] && lam > 0) {
      if (p.q[i] / lam > p.q[i0]) {
        // The dropped row's scaled rhs is the binding one: its dual is
        // recovered from the kept row's (kind-3 entry).
        r.push_entry(3, p.orig_rows[i], lam, 0.0, p.orig_rows[i0], 0.0, 0);
        r.seal();
        p.q[i0] = p.q[i] / lam;
      }
      drop[i] = 1;
      any = true;
    } else if (p.is_ineq[i] && p.is_ineq[i0] && lam < 0) {
      // row_i x >= q_i is an UPPER bound q_i/lam on row_i0 x: a range
      // pair.  Only the contradiction is actionable.
      if (p.q[i] / lam < p.q[i0] - tol) {
        r.status = kPrimalInfeasible;
        return false;
      }
    } else if (!p.is_ineq[i] && !p.is_ineq[i0]) {
      if (std::fabs(p.q[i] / lam - p.q[i0]) > tol) {
        r.status = kPrimalInfeasible;
        return false;
      }
      drop[i] = 1;
      any = true;
    } else if (p.is_ineq[i]) {
      // Equality i0 dominates the parallel inequality i.
      if (lam * p.q[i0] < p.q[i] - tol) {
        r.status = kPrimalInfeasible;
        return false;
      }
      drop[i] = 1;
      any = true;
    } else {
      // Inequality i0 dominated by the new equality i: drop i0, keep i.
      if (p.q[i] / lam < p.q[i0] - tol) {
        r.status = kPrimalInfeasible;
        return false;
      }
      drop[i0] = 1;
      it->second = std::make_pair(i, lead);
      any = true;
    }
  }
  if (any) drop_rows(p, drop, r);
  return any;
}

// Implied-free column substitution (PaPILO Substitution/aggregation).
// A column j with 2..4 nonzeros, pivoting on an equality row i whose
// interval-implied range for x_j (over the OTHER variables' boxes) lies
// inside [l_j, u_j], substitutes x_j = (q_i - sum_{k!=j} a_ik x_k)/a_ij
// into every other row containing x_j.  Mirrors the numpy pass: the
// pivot is the first eligible row in ascending order within the column;
// batch exclusion marks every row of column j and every column of row i,
// which makes this in-place application equivalent to numpy's deferred
// COO update.  Postsolve rides the same kind-0 stack entry.
bool pass_aggregate_cols(Problem& p, Result& r) {
  const size_t m = p.rows.size();
  const size_t n = p.c.size();
  std::vector<std::vector<int64_t>> col_rows;
  std::vector<std::vector<double>> col_vals;
  build_cols(p, col_rows, col_vals);
  std::vector<int64_t> row_nnz(m);
  for (size_t i = 0; i < m; ++i)
    row_nnz[i] = static_cast<int64_t>(p.rows[i].size());
  std::vector<uint8_t> touched_r(m, 0), touched_c(n, 0);
  std::vector<uint8_t> drop_row(m, 0), drop_col(n, 0);
  bool any = false;
  for (size_t j = 0; j < n; ++j) {
    const int64_t cnnz = static_cast<int64_t>(col_rows[j].size());
    if (cnnz < 2 || cnnz > 4) continue;
    if (touched_c[j]) continue;
    bool rskip = false;
    for (int64_t rr : col_rows[j])
      if (touched_r[rr]) { rskip = true; break; }
    if (rskip) continue;
    int64_t pi = -1;
    double pa = 0.0;
    for (size_t t = 0; t < col_rows[j].size() && pi < 0; ++t) {
      const int64_t i = col_rows[j][t];
      const double a = col_vals[j][t];
      if (p.is_ineq[i] || row_nnz[i] > 32) continue;
      if ((cnnz - 1) * (row_nnz[i] - 1) > 16) continue;  // fill-in cap
      bool ctouch = false;
      double vmax = 0.0;
      for (const auto& e : p.rows[i]) {
        if (touched_c[e.col]) { ctouch = true; break; }
        vmax = std::max(vmax, std::fabs(e.val));
      }
      if (ctouch) continue;
      if (std::fabs(a) < 1e-10 * (1.0 + vmax)) continue;  // unsafe pivot
      // Implied interval of x_j over the other columns' boxes (ascending
      // column order — the numpy twin accumulates identically).
      bool ok = true;
      double smin = 0.0, smax = 0.0;
      for (const auto& e : p.rows[i]) {
        if (e.col == static_cast<int32_t>(j)) continue;
        const double p1 = e.val * p.l[e.col];
        const double p2 = e.val * p.u[e.col];
        if (std::isnan(p1) || std::isnan(p2)) { ok = false; break; }
        smin += std::min(p1, p2);
        smax += std::max(p1, p2);
      }
      if (!ok) continue;
      const double qi = p.q[i];
      const double lo_j = (a > 0) ? (qi - smax) / a : (qi - smin) / a;
      const double hi_j = (a > 0) ? (qi - smin) / a : (qi - smax) / a;
      const double bt = 1e-9 * (1.0 + std::fabs(qi));
      if (std::isnan(lo_j) || std::isnan(hi_j)) continue;
      const double lj_eff = p.l_imp[j] ? -kInf : p.l[j];
      const double uj_eff = p.u_imp[j] ? kInf : p.u[j];
      if (lo_j >= lj_eff - bt && hi_j <= uj_eff + bt) {
        pi = i;
        pa = a;
      }
    }
    if (pi < 0) continue;
    const double a = pa;
    const double qi = p.q[pi];
    const double cj = p.c[j];
    // Stack entry first (row i's other columns; column j's other rows).
    r.push_entry(0, p.orig_cols[j], a, qi, p.orig_rows[pi], cj, 0);
    for (const auto& e : p.rows[pi]) {
      if (e.col == static_cast<int32_t>(j)) continue;
      r.subst_cols.push_back(p.orig_cols[e.col]);
      r.subst_vals.push_back(e.val);
    }
    for (size_t t = 0; t < col_rows[j].size(); ++t) {
      if (col_rows[j][t] == pi) continue;
      r.dcol_rows.push_back(p.orig_rows[col_rows[j][t]]);
      r.dcol_vals.push_back(col_vals[j][t]);
    }
    r.seal();
    // Every other row rr with x_j: subtract (a_rj/a) * row_i — cancels
    // the x_j entry exactly and adds the pivot row's other columns;
    // rhs shifts by a_rj * q_i / a.
    for (size_t t = 0; t < col_rows[j].size(); ++t) {
      const int64_t rr = col_rows[j][t];
      if (rr == pi) continue;
      const double g = col_vals[j][t];
      p.q[rr] -= g * (qi / a);
      auto& row = p.rows[rr];
      for (size_t t2 = 0; t2 < row.size(); ++t2) {
        if (row[t2].col == static_cast<int32_t>(j)) {
          row.erase(row.begin() + t2);
          break;
        }
      }
      for (const auto& e : p.rows[pi]) {
        if (e.col == static_cast<int32_t>(j)) continue;
        const double add = e.val * (-g / a);
        size_t pos = 0;
        while (pos < row.size() && row[pos].col < e.col) ++pos;
        if (pos < row.size() && row[pos].col == e.col) {
          row[pos].val += add;
          if (row[pos].val == 0.0) row.erase(row.begin() + pos);
        } else if (add != 0.0) {
          row.insert(row.begin() + pos, Entry{e.col, add});
        }
      }
    }
    r.obj_offset += cj * qi / a;
    for (const auto& e : p.rows[pi]) {
      if (e.col == static_cast<int32_t>(j)) continue;
      p.c[e.col] -= cj * e.val / a;
    }
    for (int64_t rr : col_rows[j]) touched_r[rr] = 1;
    for (const auto& e : p.rows[pi]) touched_c[e.col] = 1;
    touched_c[j] = 1;
    drop_row[pi] = 1;
    drop_col[j] = 1;
    any = true;
  }
  if (!any) return false;
  drop_rows(p, drop_row, r);
  drop_cols(p, drop_col, r);
  return true;
}

// Sparsify (PaPILO Sparsify): adding lam * (equality row i) to any row r
// preserves the feasible set exactly; when supp(i) is a subset of
// supp(r) the combination creates no fill, and lam chosen to cancel the
// lead entry strictly reduces nonzeros.  Applied when >= 2 entries
// cancel (the lead by construction, others only on exact fp zeros — no
// tolerance-based perturbation).  Primal no-op; the kind-4 stack entry
// restores the absorbed dual: y_i += lam * y_r.  Mirrors the numpy pass
// (pivots ascending; targets ascending within the lead column; a row
// modified as a target is excluded for the rest of the batch).
bool pass_sparsify(Problem& p, Result& r) {
  const size_t m = p.rows.size();
  std::vector<std::vector<int64_t>> col_rows;
  std::vector<std::vector<double>> col_vals;
  build_cols(p, col_rows, col_vals);
  std::vector<uint8_t> touched(m, 0);
  bool any = false;
  for (size_t i = 0; i < m; ++i) {
    if (p.is_ineq[i]) continue;
    const int64_t nn = static_cast<int64_t>(p.rows[i].size());
    if (nn < 2 || nn > 8) continue;
    if (touched[i]) continue;
    const int32_t j0 = p.rows[i][0].col;
    const double a0 = p.rows[i][0].val;
    for (size_t t = 0; t < col_rows[j0].size(); ++t) {
      const int64_t rr = col_rows[j0][t];
      if (rr == static_cast<int64_t>(i) || touched[rr]) continue;
      auto& row = p.rows[rr];
      if (static_cast<int64_t>(row.size()) < nn) continue;
      // Subset check + positions of supp(i) inside supp(r) (both sorted).
      std::vector<size_t> pos(nn);
      bool subset = true;
      size_t pr = 0;
      for (int64_t t2 = 0; t2 < nn && subset; ++t2) {
        const int32_t want = p.rows[i][t2].col;
        while (pr < row.size() && row[pr].col < want) ++pr;
        if (pr >= row.size() || row[pr].col != want) subset = false;
        else pos[t2] = pr;
      }
      if (!subset) continue;
      const double lam = -row[pos[0]].val / a0;
      int cancels = 1;
      for (int64_t t2 = 1; t2 < nn; ++t2) {
        if (row[pos[t2]].val + lam * p.rows[i][t2].val == 0.0) ++cancels;
      }
      if (cancels < 2) continue;
      p.q[rr] += lam * p.q[i];
      // Non-lead entries first (their positions survive the adds; exact
      // zeros erased afterwards, from the back, then the lead).
      for (int64_t t2 = 1; t2 < nn; ++t2) {
        row[pos[t2]].val += lam * p.rows[i][t2].val;
      }
      for (int64_t t2 = nn - 1; t2 >= 1; --t2) {
        if (row[pos[t2]].val == 0.0) row.erase(row.begin() + pos[t2]);
      }
      row.erase(row.begin() + pos[0]);  // lead cancels by construction
      r.push_entry(4, p.orig_rows[i], lam, 0.0, p.orig_rows[rr], 0.0, 0);
      r.seal();
      touched[rr] = 1;
      any = true;
    }
  }
  return any;
}

}  // namespace

extern "C" {

void* tpdlp_presolve_run(
    int64_t m, int64_t n, int64_t m_ineq,
    const int64_t* indptr, const int32_t* indices, const double* data,
    const double* c, const double* q, const double* l, const double* u,
    int max_passes) {
  auto* res = new Result();
  Problem& p = res->p;
  p.rows.resize(m);
  for (int64_t i = 0; i < m; ++i) {
    p.rows[i].reserve(indptr[i + 1] - indptr[i]);
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e) {
      if (data[e] != 0.0) p.rows[i].push_back({indices[e], data[e]});
    }
  }
  p.is_ineq.resize(m);
  for (int64_t i = 0; i < m; ++i) p.is_ineq[i] = i < m_ineq;
  p.c.assign(c, c + n);
  p.q.assign(q, q + m);
  p.l.assign(l, l + n);
  p.u.assign(u, u + n);
  p.l_imp.assign(n, 0);
  p.u_imp.assign(n, 0);
  p.orig_cols.resize(n);
  for (int64_t j = 0; j < n; ++j) p.orig_cols[j] = j;
  p.orig_rows.resize(m);
  for (int64_t i = 0; i < m; ++i) p.orig_rows[i] = i;

  bool changed = true;
  while (changed && res->passes < max_passes && res->status == kRunning) {
    changed = false;
    ++res->passes;
    if (pass_empty_rows(p, *res)) { changed = true; continue; }
    if (res->status != kRunning) break;
    if (pass_singleton_rows(p, *res)) { changed = true; continue; }
    if (res->status != kRunning) break;
    bool tightened = false;
    if (pass_row_activity(p, *res, &tightened)) { changed = true; continue; }
    if (res->status != kRunning) break;
    if (tightened) changed = true;
    if (pass_columns(p, *res)) { changed = true; continue; }
    if (res->status != kRunning) break;
    if (pass_dominated_cols(p, *res)) { changed = true; continue; }
    if (res->status != kRunning) break;
    if (pass_free_singleton_cols(p, *res)) { changed = true; continue; }
    if (pass_doubleton_eq(p, *res)) { changed = true; continue; }
    if (pass_aggregate_cols(p, *res)) { changed = true; continue; }
    if (pass_parallel_cols(p, *res)) { changed = true; continue; }
    if (pass_duplicate_rows(p, *res)) changed = true;
    if (res->status != kRunning) break;
    if (pass_sparsify(p, *res)) changed = true;
    if (pass_dual_infer(p, *res)) changed = true;
    if (res->status != kRunning) break;
  }

  if (res->status == kRunning && p.c.empty() && p.rows.empty()) {
    res->status = kSolved;
  }
  return res;
}

int tpdlp_status(void* h) { return static_cast<Result*>(h)->status; }
int64_t tpdlp_reduced_m(void* h) {
  return static_cast<Result*>(h)->p.rows.size();
}
int64_t tpdlp_reduced_n(void* h) {
  return static_cast<Result*>(h)->p.c.size();
}
int64_t tpdlp_reduced_m_ineq(void* h) {
  const auto& p = static_cast<Result*>(h)->p;
  int64_t k = 0;
  for (auto b : p.is_ineq) k += (b != 0);
  return k;
}
int64_t tpdlp_reduced_nnz(void* h) {
  const auto& p = static_cast<Result*>(h)->p;
  int64_t k = 0;
  for (const auto& row : p.rows) k += row.size();
  return k;
}
int64_t tpdlp_n_fixed(void* h) {
  return static_cast<Result*>(h)->fixed_idx.size();
}
int64_t tpdlp_rows_removed(void* h) {
  return static_cast<Result*>(h)->rows_removed;
}
int64_t tpdlp_cols_removed(void* h) {
  return static_cast<Result*>(h)->cols_removed;
}
int tpdlp_passes(void* h) { return static_cast<Result*>(h)->passes; }
double tpdlp_obj_offset(void* h) {
  return static_cast<Result*>(h)->obj_offset;
}

// Copy the reduced problem out with inequality rows re-packed as a prefix.
void tpdlp_get_reduced(void* h, int64_t* indptr, int32_t* indices,
                       double* data, double* c, double* q, double* l,
                       double* u) {
  const auto& p = static_cast<Result*>(h)->p;
  const size_t m = p.rows.size();
  std::vector<size_t> order;
  order.reserve(m);
  for (size_t i = 0; i < m; ++i)
    if (p.is_ineq[i]) order.push_back(i);
  for (size_t i = 0; i < m; ++i)
    if (!p.is_ineq[i]) order.push_back(i);

  int64_t e = 0;
  indptr[0] = 0;
  for (size_t oi = 0; oi < m; ++oi) {
    const auto& row = p.rows[order[oi]];
    for (const auto& ent : row) {
      indices[e] = ent.col;
      data[e] = ent.val;
      ++e;
    }
    indptr[oi + 1] = e;
    q[oi] = p.q[order[oi]];
  }
  std::memcpy(c, p.c.data(), p.c.size() * sizeof(double));
  std::memcpy(l, p.l.data(), p.l.size() * sizeof(double));
  std::memcpy(u, p.u.data(), p.u.size() * sizeof(double));
}

// Surviving rows' ORIGINAL indices, in the same ineq-prefix order as
// tpdlp_get_reduced (the reduced row i carries dual y_reduced[i] for
// original row row_map[i]).
void tpdlp_get_row_map(void* h, int64_t* out) {
  const auto& p = static_cast<Result*>(h)->p;
  const size_t m = p.rows.size();
  size_t w = 0;
  for (size_t i = 0; i < m; ++i)
    if (p.is_ineq[i]) out[w++] = p.orig_rows[i];
  for (size_t i = 0; i < m; ++i)
    if (!p.is_ineq[i]) out[w++] = p.orig_rows[i];
}

void tpdlp_get_postsolve(void* h, int64_t* col_map, int64_t* fixed_idx,
                         double* fixed_val) {
  const auto* r = static_cast<Result*>(h);
  std::memcpy(col_map, r->p.orig_cols.data(),
              r->p.orig_cols.size() * sizeof(int64_t));
  std::memcpy(fixed_idx, r->fixed_idx.data(),
              r->fixed_idx.size() * sizeof(int64_t));
  std::memcpy(fixed_val, r->fixed_val.data(),
              r->fixed_val.size() * sizeof(double));
}

int64_t tpdlp_n_subst(void* h) {
  return static_cast<Result*>(h)->subst_idx.size();
}
int64_t tpdlp_subst_nnz(void* h) {
  return static_cast<Result*>(h)->subst_cols.size();
}
int64_t tpdlp_dcol_nnz(void* h) {
  return static_cast<Result*>(h)->dcol_rows.size();
}
void tpdlp_get_subst(void* h, int64_t* idx, double* scale, double* rhs,
                     int64_t* indptr, int64_t* cols, double* vals,
                     int8_t* kind) {
  const auto* r = static_cast<Result*>(h);
  std::memcpy(idx, r->subst_idx.data(),
              r->subst_idx.size() * sizeof(int64_t));
  std::memcpy(scale, r->subst_scale.data(),
              r->subst_scale.size() * sizeof(double));
  std::memcpy(rhs, r->subst_rhs.data(),
              r->subst_rhs.size() * sizeof(double));
  std::memcpy(indptr, r->subst_indptr.data(),
              r->subst_indptr.size() * sizeof(int64_t));
  std::memcpy(cols, r->subst_cols.data(),
              r->subst_cols.size() * sizeof(int64_t));
  std::memcpy(vals, r->subst_vals.data(),
              r->subst_vals.size() * sizeof(double));
  std::memcpy(kind, r->subst_kind.data(),
              r->subst_kind.size() * sizeof(int8_t));
}

// Dual-recovery extension of the transform stack (parallel to subst_idx).
void tpdlp_get_subst_ext(void* h, int64_t* row, double* cj, int8_t* flag,
                         int64_t* d_indptr, int64_t* d_rows,
                         double* d_vals) {
  const auto* r = static_cast<Result*>(h);
  std::memcpy(row, r->subst_row.data(),
              r->subst_row.size() * sizeof(int64_t));
  std::memcpy(cj, r->subst_cj.data(), r->subst_cj.size() * sizeof(double));
  std::memcpy(flag, r->subst_flag.data(),
              r->subst_flag.size() * sizeof(int8_t));
  std::memcpy(d_indptr, r->dcol_indptr.data(),
              r->dcol_indptr.size() * sizeof(int64_t));
  std::memcpy(d_rows, r->dcol_rows.data(),
              r->dcol_rows.size() * sizeof(int64_t));
  std::memcpy(d_vals, r->dcol_vals.data(),
              r->dcol_vals.size() * sizeof(double));
}

void tpdlp_free(void* h) { delete static_cast<Result*>(h); }

}  // extern "C"
