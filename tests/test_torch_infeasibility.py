"""The port's certificate functions (tpdlp_torch/solver/infeasibility.py)
against the JAX package's, in fp64 on the CPU, on the same seeded numpy
inputs: random problem slices with every bound pattern, planted primal and
dual rays, the zero ray, and the synthetic normalized rays of
tests/test_infeasibility.py.  Statuses must be equal; the normalized
iterates must agree to 1e-12."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpdlp.config import Status as JStatus
from tpdlp.solver import infeasibility as JI
from tpdlp_torch import Status
from tpdlp_torch.solver import infeasibility as TI
from tpdlp_torch.solver.residuals import project_lambda_box

torch.set_num_threads(2)

TOL = 1e-4
RTOL = 1e-12
#: Bound patterns: (l finite, u finite).
PATTERNS = {"box": (True, True), "lower": (True, False),
            "upper": (False, True), "free": (False, False)}


def _bounds(rng, n, kinds=None):
    """(l, u) with each variable's pattern drawn from PATTERNS (or given)."""
    if kinds is None:
        kinds = rng.choice(list(PATTERNS), size=n)
    l = -rng.uniform(1, 5, n)
    u = rng.uniform(1, 5, n)
    for i, kind in enumerate(kinds):
        lo, hi = PATTERNS[kind]
        l[i] = l[i] if lo else -np.inf
        u[i] = u[i] if hi else np.inf
    return l, u, np.asarray(kinds)


def _pb(c, q, l, u, m_ineq):
    """The problem fields the certificates read, as numpy arrays."""
    m = q.shape[0]
    return dict(
        c=c, q=q, ineq_mask=np.arange(m) < m_ineq,
        is_neg_inf=np.isneginf(l), is_pos_inf=np.isposinf(u),
        l_dual=np.where(np.isneginf(l), 0.0, l),
        u_dual=np.where(np.isposinf(u), 0.0, u),
    )


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def _ns(d):
    return types.SimpleNamespace(**d)


def _both(name, pb, *args, **kw):
    """Call `name` in both packages on the same numpy inputs; returns
    (JAX result, port result) as numpy."""
    ja = [jnp.asarray(a) for a in args]
    ta = [torch.as_tensor(np.asarray(a)) for a in args]
    fj, ft = getattr(JI, name), getattr(TI, name)
    if pb is None:
        rj, rt = fj(*ja, **kw), ft(*ta, **kw)
    else:
        rj, rt = fj(_ns(_jax(pb)), *ja, **kw), ft(_ns(_torch(pb)), *ta,
                                                   **kw)
    if isinstance(rj, tuple):
        return [np.asarray(v) for v in rj], [v.numpy() for v in rt]
    return np.asarray(rj), rt.numpy()


def _random_case(seed, m=12, n=20, m_ineq=7):
    rng = np.random.default_rng(seed)
    K = rng.standard_normal((m, n))
    l, u, kinds = _bounds(rng, n)
    c, q = rng.standard_normal(n), rng.standard_normal(m)
    return rng, K, _pb(c, q, l, u, m_ineq), kinds


def _planted_primal_ray(seed, m=12, n=20, m_ineq=7):
    """(K, pb, r): r in the recession cone of [l, u], A r = 0, G r >= 0,
    c'r = -1."""
    rng = np.random.default_rng(seed)
    l, u, kinds = _bounds(rng, n)
    r = rng.standard_normal(n)
    r[kinds == "box"] = 0.0
    r[kinds == "lower"] = np.abs(r[kinds == "lower"])
    r[kinds == "upper"] = -np.abs(r[kinds == "upper"])
    K = rng.standard_normal((m, n))
    K[m_ineq:] -= np.outer(K[m_ineq:] @ r, r) / (r @ r)  # A r = 0
    sign = np.sign(K[:m_ineq] @ r)
    K[:m_ineq] *= np.where(sign < 0, -1.0, 1.0)[:, None]  # G r >= 0
    c = rng.standard_normal(n)
    c -= (c @ r + 1.0) * r / (r @ r)  # c'r = -1
    return K, _pb(c, rng.standard_normal(m), l, u, m_ineq), r


def _planted_dual_ray(seed, m=12, n=20, m_ineq=7):
    """(K, pb, yr, lr): yr >= 0 on inequality rows, lr = K'yr in the
    lambda cone of [l, u] (free columns orthogonal to yr), and a positive
    dual-objective rate."""
    rng = np.random.default_rng(seed)
    yr = rng.standard_normal(m)
    yr[:m_ineq] = np.abs(yr[:m_ineq])
    K = rng.standard_normal((m, n))
    kinds = rng.choice(list(PATTERNS), size=n)
    K[:, kinds == "free"] -= np.outer(yr, yr @ K[:, kinds == "free"]) / (
        yr @ yr)
    lr = K.T @ yr
    # Each column's bound pattern must admit the sign of its lr.
    kinds = np.where((kinds == "lower") & (lr < 0), "upper", kinds)
    kinds = np.where((kinds == "upper") & (lr > 0), "lower", kinds)
    l, u, kinds = _bounds(rng, n, kinds)
    lr = np.asarray(project_lambda_box(
        torch.as_tensor(lr), torch.as_tensor(np.isneginf(l)),
        torch.as_tensor(np.isposinf(u))))
    pb = _pb(rng.standard_normal(n), np.zeros(m), l, u, m_ineq)
    base = (pb["l_dual"] @ np.maximum(lr, 0)
            + pb["u_dual"] @ np.minimum(lr, 0))
    pb["q"] = rng.standard_normal(m)
    pb["q"] += (1.0 - base - pb["q"] @ yr) * yr / (yr @ yr)  # rate = 1
    return K, pb, yr, lr


def _detect(K, pb, x, y, x_prev, y_prev, lam, lam_prev):
    return _both("detect_infeasibility", pb, x, y, x_prev, y_prev, lam,
                 lam_prev, K @ (x - x_prev), K.T @ (y - y_prev), TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zero_ray_keeps_running(seed):
    rng, K, pb, _ = _random_case(seed)
    x, y = rng.standard_normal(20), rng.standard_normal(12)
    lam = rng.standard_normal(20)
    rj, rt = _detect(K, pb, x, y, x, y, lam, lam)
    assert int(rj) == int(rt) == int(Status.RUNNING)
    assert rt.dtype == np.int32


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_planted_primal_ray_certifies_dual_infeasible(seed):
    K, pb, r = _planted_primal_ray(seed)
    rng = np.random.default_rng(100 + seed)
    x_prev, y = rng.standard_normal(20), rng.standard_normal(12)
    lam = rng.standard_normal(20)
    rj, rt = _detect(K, pb, x_prev + 5.0 * r, y, x_prev, y, lam, lam)
    assert int(rj) == int(rt) == int(Status.DUAL_INFEASIBLE)
    # The ray alone, and its negation (ascent, out of the cone).
    for sign, want in ((1.0, True), (-1.0, False)):
        unit = sign * r / np.linalg.norm(r)
        rj, rt = _both("primal_ray_certifies", pb, unit, K @ unit, TOL)
        assert bool(rj) == bool(rt) == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_planted_dual_ray_certifies_primal_infeasible(seed):
    K, pb, yr, lr = _planted_dual_ray(seed)
    rng = np.random.default_rng(200 + seed)
    x, y_prev = rng.standard_normal(20), rng.standard_normal(12)
    lam_prev = rng.standard_normal(20)
    rj, rt = _detect(K, pb, x, y_prev + 3.0 * yr, x, y_prev,
                     lam_prev + 3.0 * lr, lam_prev)
    assert int(rj) == int(rt) == int(Status.PRIMAL_INFEASIBLE)
    norm = np.sqrt(yr @ yr + lr @ lr)
    for sign, want in ((1.0, True), (-1.0, False)):
        rj, rt = _both("dual_ray_certifies", pb, sign * yr / norm,
                       sign * lr / norm, sign * (K.T @ yr) / norm, TOL)
        assert bool(rj) == bool(rt) == want


@pytest.mark.parametrize("kind", list(PATTERNS))
@pytest.mark.parametrize("value", [-0.5, 0.0, 0.5])
def test_recession_cone_by_bound_pattern(kind, value):
    """A free-variable descent ray with one more coordinate of the given
    bound pattern: the ray stays certified only where the pattern's cone
    admits that coordinate's sign."""
    n, m = 3, 2
    kinds = ["free", kind, "box"]
    l, u, _ = _bounds(np.random.default_rng(0), n, kinds)
    r = np.array([1.0, value, 0.0])
    r /= np.linalg.norm(r)
    K = np.zeros((m, n))  # no constraint involves the ray
    pb = _pb(np.array([-1.0, 0.0, 0.3]), np.ones(m), l, u, 1)
    rj, rt = _both("primal_ray_certifies", pb, r, K @ r, TOL)
    admits = {"free": True, "box": value == 0.0, "lower": value >= 0.0,
              "upper": value <= 0.0}[kind]
    assert bool(rj) == bool(rt) == admits


@pytest.mark.parametrize("seed", range(6))
def test_random_rays_equal_jax(seed):
    """Random differences, which certify nothing, at tolerances from 1e-4
    to 10 (the planted-ray tests cover the certifying side)."""
    rng, K, pb, _ = _random_case(seed)
    x, xp = rng.standard_normal(20), rng.standard_normal(20)
    y, yp = rng.standard_normal(12), rng.standard_normal(12)
    lam, lamp = rng.standard_normal(20), rng.standard_normal(20)
    tol = [1e-4, 1.0, 10.0][seed % 3]
    rj, rt = _both("detect_infeasibility", pb, x, y, xp, yp, lam, lamp,
                   K @ (x - xp), K.T @ (y - yp), tol)
    assert int(rj) == int(rt)
    for sign in (1.0, -1.0):
        r = sign * (x - xp) / np.linalg.norm(x - xp)
        rj, rt = _both("primal_ray_certifies", pb, r, K @ r, tol)
        assert bool(rj) == bool(rt)
        rj, rt = _both("dual_ray_certifies", pb, sign * y, sign * lam,
                       sign * (K.T @ y), tol)
        assert bool(rj) == bool(rt)


@pytest.mark.parametrize("cert", [Status.RUNNING, Status.DUAL_INFEASIBLE,
                                  Status.PRIMAL_INFEASIBLE])
@pytest.mark.parametrize("case", ["primal_ray", "dual_ray", "random"])
def test_validate_normalized_candidate_equals_jax(cert, case):
    if case == "primal_ray":
        K, pb, r = _planted_primal_ray(5)
        x_ray, y_ray = 7.0 * r, np.zeros(12)
        want = {Status.DUAL_INFEASIBLE: Status.DUAL_INFEASIBLE}
    elif case == "dual_ray":
        K, pb, yr, _ = _planted_dual_ray(5)
        x_ray, y_ray = np.zeros(20), 7.0 * yr
        want = {Status.PRIMAL_INFEASIBLE: Status.PRIMAL_INFEASIBLE}
    else:
        rng, K, pb, _ = _random_case(5)
        x_ray, y_ray = rng.standard_normal(20), rng.standard_normal(12)
        want = {}
    rj, rt = _both("validate_normalized_candidate", pb,
                   np.int32(int(cert)), x_ray, K @ x_ray, y_ray,
                   K.T @ y_ray, TOL)
    assert int(rj) == int(rt) == int(want.get(cert, Status.RUNNING))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 2, 37])
def test_normalized_iterate_certificates_equal_jax(seed, k):
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal(20) * k, rng.standard_normal(12) * k
    # The previous normalized iterates: near this one's for some seeds.
    jitter = [1e-7, 1e-2, 1.0, 0.0][seed]
    xnp = x / max(k, 1) + jitter * rng.standard_normal(20)
    ynp = y / max(k, 1) + jitter * rng.standard_normal(12)
    tol_nonzero = [1e-3, 1e3][seed % 2]
    (sj, xj, yj), (st, xt, yt) = _both(
        "normalized_iterate_certificates", None, x, y, xnp, ynp,
        np.int32(k), 1e-4, tol_nonzero)
    assert int(sj) == int(st)
    np.testing.assert_allclose(xt, xj, rtol=RTOL, atol=0)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 2, 50])
def test_normalized_average_certificates_equal_jax(seed, k):
    rng = np.random.default_rng(seed)
    d, e = rng.standard_normal(20), rng.standard_normal(12)
    # A ray x_i = i d (plus noise) and its running sum.
    noise = [0.0, 1e-3, 1.0, 10.0][seed]
    x, y = k * d + noise * rng.standard_normal(20), k * e
    xs = d * (k * (k + 1) / 2.0) + noise * rng.standard_normal(20)
    ys = e * (k * (k + 1) / 2.0)
    rj, rt = _both("normalized_average_certificates", None, xs, ys, x, y,
                   np.int32(k))
    assert int(rj) == int(rt)


def test_synthetic_normalized_rays():
    """tests/test_infeasibility.py::test_normalized_certificate_families'
    synthetic ray x_k = k d: both normalized families fire on it."""
    d = np.array([1.0, -0.5, 0.25])
    k = np.int32(50)
    x_k = 50.0 * d
    x_sum = d * (50 * 51 / 2.0)
    zero = np.zeros(2)
    (sj, _, _), (st, _, _) = _both("normalized_iterate_certificates", None,
                                   x_k, zero, 49.0 * d / 49.0, zero, k)
    assert int(sj) == int(st) == int(JStatus.DUAL_INFEASIBLE)
    rj, rt = _both("normalized_average_certificates", None, x_sum,
                   np.zeros(2), x_k, zero, k)
    assert int(rj) == int(rt) == int(JStatus.DUAL_INFEASIBLE)
    # The same ray on y certifies primal infeasibility.
    (sj, _, _), (st, _, _) = _both("normalized_iterate_certificates", None,
                                   np.zeros(2), x_k, zero, 49.0 * d / 49.0,
                                   k)
    assert int(sj) == int(st) == int(JStatus.PRIMAL_INFEASIBLE)


def test_normalize_zero_norm():
    _, _, pb, _ = _random_case(0)
    cone = TI.cone_of(_ns(_torch(pb)), TOL)
    v = np.array([1.0, -2.0])
    for norm, want in ((0.0, [0.0, 0.0]), (2.0, [0.5, -1.0])):
        rj = np.asarray(JI._normalize(jnp.asarray(v), jnp.asarray(norm)))
        (rt,) = TI._normalize_all(cone, torch.tensor(norm),
                                  torch.as_tensor(v))
        np.testing.assert_array_equal(rt.numpy(), rj)
        np.testing.assert_array_equal(rt.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_cone_argument_changes_nothing(seed):
    """The loop passes a prebuilt Cone; the verdicts are the same."""
    K, pb, r = _planted_primal_ray(seed)
    tpb = _ns(_torch(pb))
    cone = TI.cone_of(tpb, TOL)
    args = [torch.as_tensor(a) for a in (r, K @ r)]
    assert bool(TI.primal_ray_certifies(tpb, *args, TOL, cone)) == bool(
        TI.primal_ray_certifies(tpb, *args, TOL))
    lam = torch.as_tensor(np.random.default_rng(seed).standard_normal(20))
    np.testing.assert_array_equal(
        TI.project_to_cone(cone, lam).numpy(),
        project_lambda_box(lam, tpb.is_neg_inf, tpb.is_pos_inf).numpy())
