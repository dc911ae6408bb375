"""The JAX package's high-accuracy runs on the CPU that PERF.md and
ROADMAP.md set beside the port's chip runs, and the port's runs on the CPU
from the JAX package's fp32 stage result (not a test: a script that
imports both packages, as the tests do).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/jax_reference_high_accuracy.py RUN

RUN is one of:
  tail          the JAX fp64 tail on mittelmann-s, tol 1e-8, max_kkt
                100,000 (`--lift-guard`: with its TPU element guard lifted,
                so the fp64 stage runs; as shipped it skips the stage);
  refine        the JAX refinement on mittelmann-s, tol 1e-8, max_kkt
                200,000, the signed gap (`--abs-gap`: |gap|);
  coarse-band   the JAX fp32 stage of banded 8192 through "band" (tol
                1e-6), its x, y, k, n and j written to `--out` (npz);
  refine-band   the JAX refinement on banded 8192 through "band";
  inject-refine the port's refinement on mittelmann-s from the JAX coarse
                stage's result (`--band`: banded 8192 through "band");
  inject-tail   the port's fp64 stage on mittelmann-s from the JAX fp32
                stage's result;
  round0        the port's round-0 correction LP of mittelmann-s (|gap|),
                captured from a CPU run, solved by both packages in fp32;
  from-dump     both packages' refinement of banded 8192 through "band"
                (max_kkt 100,000) from the incumbent a card run dumped
                before its first correction (`--dump PREFIX`: the files
                of `TPDLP_REFINE_DUMP=PREFIX python -m
                tpdlp_torch.bench.refine_1e8 --instance
                banded-8192-4096-2048-65-2 --matrix_format band`), its
                coarse stage's k and j given by `--k` and `--j`.
Each prints JSON lines: every inner solve, then the result.  The settings
are chip_smoke.py's: Ruiz, adaptive steps, primal-weight update, seed 0.
"""

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import tpdlp  # noqa: E402
from tpdlp.bench.suite import build_suite  # noqa: E402
import tpdlp_torch  # noqa: E402
import tpdlp_torch.solver.power_iteration as PI  # noqa: E402

JAX_SOLVE = importlib.import_module("tpdlp.solver.solve")
PORT_SOLVE = importlib.import_module("tpdlp_torch.solver.solve")
BASE = dict(tol=1e-8, scaling="ruiz", adaptive=True,
            primal_weight_update=True)


def _emit(**kw):
    print(json.dumps(kw, default=str), flush=True)


def _jax_b0(n, seed, dtype, device):
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                    dtype=jnp.float64))
    return torch.as_tensor(b0, dtype=dtype, device=device)


def _mittelmann_s():
    return {p.name: p for p in build_suite(("large",))}["mittelmann-s"]


def _banded_8192():
    return tpdlp.generate_banded_lp(n=8192, m_ineq=4096, m_eq=2048,
                                    bandwidth=65, seed=2)


def _recording(fn):
    """`fn` wrapped to print each call's problem, status, k and j."""
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        _emit(inner=a[0].name, shape=a[0].K.shape,
              dtype=str(kw.get("dtype")), status=r.status_string,
              k=r.iterations, n=r.restarts, j=r.kkt_passes,
              wall_s=time.perf_counter() - t0)
        return r
    return wrapped


def _result(tag, r, oracle=None, **extra):
    _emit(run=tag, status=r.status_string, k=r.iterations, n=r.restarts,
          j=r.kkt_passes, objective=repr(r.objective),
          primal_res=r.primal_res, dual_res=r.dual_res, gap=r.gap,
          rel_err=(abs(r.objective - oracle) / max(1.0, abs(oracle))
                   if oracle is not None else None), **extra)


def _oracle(p):
    from tests.oracles import solve_oracle

    o = solve_oracle(p)
    return float(o.fun) if o.status == 0 else None


def _as_port(r):
    fields = {f.name for f in dataclasses.fields(tpdlp_torch.SolveResult)}
    kw = {f: getattr(r, f) for f in fields if hasattr(r, f)}
    kw["status"] = tpdlp_torch.Status(int(r.status))
    return tpdlp_torch.SolveResult(**kw)


def _jax_stage1(p, **kw):
    """The JAX fp32 stage: tol escalation_tol (1e-6), max_kkt 80,000 (the
    refinement's 40% cap of 200,000; the tail's stage solves identically
    within it)."""
    cfg = tpdlp.SolverConfig(**BASE).replace(tol=1e-6, max_kkt=80_000)
    s1 = tpdlp.solve(p, cfg, dtype=jnp.float32, seed=0, **kw)
    _emit(inner="jax fp32 stage", status=s1.status_string,
          k=s1.iterations, j=s1.kkt_passes)
    return s1


def run_tail(lift_guard, max_kkt):
    if lift_guard:
        JAX_SOLVE._F64_DENSE_ELEM_LIMIT = float("inf")
    p = _mittelmann_s()
    cfg = tpdlp.SolverConfig(**BASE, max_kkt=max_kkt or 100_000,
                             escalation_mode="fp64_tail")
    JAX_SOLVE.solve = _recording(JAX_SOLVE.solve)
    r = JAX_SOLVE._solve_escalated(p, cfg, seed=0, matrix_format="dense")
    _result("jax fp64 tail", r, lift_guard=lift_guard,
            max_kkt=cfg.max_kkt)


def run_coarse_band(out):
    s1 = _jax_stage1(_banded_8192(), matrix_format="band")
    np.savez_compressed(out, x=np.asarray(s1.x), y=np.asarray(s1.y),
                        k=s1.iterations, n=s1.restarts, j=s1.kkt_passes)
    _emit(written=out)


def run_refine(abs_gap, band, max_kkt):
    from tpdlp.solver.refine import solve_refined

    p = _banded_8192() if band else _mittelmann_s()
    cfg = tpdlp.SolverConfig(**BASE, max_kkt=max_kkt or 200_000,
                             abs_gap_termination=abs_gap)
    kw = {"matrix_format": "band"} if band else {}
    r = solve_refined(p, cfg, solve_fn=_recording(tpdlp.solve), seed=0,
                      **kw)
    _result("jax refine", r, _oracle(p), abs_gap=abs_gap, band=band,
            max_kkt=cfg.max_kkt)


def run_inject_refine(band):
    from tpdlp_torch.solver import refine as R

    PI.initial_vector = _jax_b0
    p = _banded_8192() if band else _mittelmann_s()
    kw = {"matrix_format": "band"} if band else {}
    s1 = _jax_stage1(p, **kw)

    def fn(problem, config, **k):
        if "+refine" in problem.name:
            raise RuntimeError("a correction round ran")
        return _as_port(s1)

    r = R.solve_refined(p, tpdlp_torch.SolverConfig(**BASE,
                                                    max_kkt=200_000),
                        solve_fn=fn, seed=0, device="cpu", **kw)
    _result("port refine from the JAX fp32 stage", r, _oracle(p),
            band=band)


def run_inject_tail():
    PI.initial_vector = _jax_b0
    p = _mittelmann_s()
    s1 = _jax_stage1(p)
    real = PORT_SOLVE.solve

    def staged(problem, config, **k):
        if k["dtype"] == torch.float32:
            return _as_port(s1)
        return real(problem, config, **k)

    PORT_SOLVE.solve = staged
    cfg = tpdlp_torch.SolverConfig(**BASE, max_kkt=100_000,
                                   escalation_mode="fp64_tail")
    r = PORT_SOLVE._solve_escalated(p, cfg, seed=0, device="cpu")
    fp64 = r.escalation["stages"][1]
    _result("port fp64 tail from the JAX fp32 stage", r,
            fp64_k=fp64["k"], fp64_j=fp64["j"])


def run_round0():
    from tpdlp_torch.solver import refine as R

    p = _mittelmann_s()
    captured = {}

    class Captured(Exception):
        pass

    def fn(problem, config, **kw):
        if "+refine" in problem.name:
            captured.update(problem=problem, config=config,
                            omega0=kw.get("omega0"))
            raise Captured
        return tpdlp_torch.solve(problem, config, **kw)

    cfg = tpdlp_torch.SolverConfig(**BASE, max_kkt=200_000,
                                   abs_gap_termination=True)
    try:
        R.solve_refined(p, cfg, solve_fn=_recording(fn), seed=0,
                        device="cpu")
    except Captured:
        pass
    corr, c = captured["problem"], captured["config"]
    fields = {f: getattr(c, f) for f in c.__dataclass_fields__}
    rj = tpdlp.solve(corr, tpdlp.SolverConfig(**fields), dtype=jnp.float32,
                     omega0=captured["omega0"], seed=0,
                     _noisy_products_ok=True)
    _result("jax round 0", rj)
    rt = tpdlp_torch.solve(corr, c, dtype=torch.float32, device="cpu",
                           omega0=captured["omega0"], seed=0)
    _result("port round 0", rt)


def run_from_dump(prefix, k, j):
    """Refinement of banded 8192 from a card run's round-0 incumbent, by
    the JAX package and by the port, on the CPU: the coarse stage is
    replaced by a Solved result at that incumbent with the card's k and j
    (so the rounds get the card run's budgets)."""
    from tpdlp.solver.refine import solve_refined as jax_refined
    from tpdlp_torch.solver import refine as R

    d = np.load(f"{prefix}_r0.npz")
    p = _banded_8192()
    base = dict(BASE, max_kkt=100_000)
    for pkg, refined, solve_fn, cfg, kw in (
            ("jax", jax_refined, tpdlp.solve, tpdlp.SolverConfig(**base),
             {}),
            ("port", R.solve_refined, tpdlp_torch.solve,
             tpdlp_torch.SolverConfig(**base), {"device": "cpu"})):
        result_type = (JAX_SOLVE.SolveResult if pkg == "jax"
                       else tpdlp_torch.SolveResult)
        status = tpdlp.Status.SOLVED if pkg == "jax" else (
            tpdlp_torch.Status.SOLVED)
        s1 = result_type(x=d["xh"], y=d["yh"], objective=0.0,
                         iterations=k, restarts=0, kkt_passes=j,
                         status=status, solve_time=0.0, primal_res=0.0,
                         dual_res=0.0, gap=0.0)

        def fn(problem, config, _s1=s1, _solve=solve_fn, **k2):
            if "+refine" not in problem.name:
                return _s1
            return _recording(_solve)(problem, config, **k2)

        r = refined(p, cfg, solve_fn=fn, seed=0, matrix_format="band",
                    **kw)
        _result(f"{pkg} refine from the card's incumbent", r, _oracle(p))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run", choices=["tail", "refine", "refine-band",
                                    "coarse-band",
                                    "inject-refine", "inject-tail",
                                    "round0", "from-dump"])
    ap.add_argument("--dump", default=None)
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--j", type=int, default=0)
    ap.add_argument("--lift-guard", action="store_true")
    ap.add_argument("--abs-gap", action="store_true")
    ap.add_argument("--band", action="store_true")
    ap.add_argument("--max-kkt", type=int, default=None,
                    help="the budget of `tail` and `refine` (default: "
                         "100,000 and 200,000)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(3)
    if args.run == "tail":
        run_tail(args.lift_guard, args.max_kkt)
    elif args.run == "coarse-band":
        run_coarse_band(args.out)
    elif args.run in ("refine", "refine-band"):
        run_refine(args.abs_gap, args.run == "refine-band", args.max_kkt)
    elif args.run == "inject-refine":
        run_inject_refine(args.band)
    elif args.run == "inject-tail":
        run_inject_tail()
    elif args.run == "from-dump":
        run_from_dump(args.dump, args.k, args.j)
    else:
        run_round0()


if __name__ == "__main__":
    sys.exit(main())
