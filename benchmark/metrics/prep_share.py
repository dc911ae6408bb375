"""prep_share (%; entry and preprocessing, solver/solve.py,
batch/vmapped.py, scaling/ruiz.py, solver/power_iteration.py): the
program's `prep` span (tpdlp_torch.solver.loop.launched["prep_ns"]: from a
solve's entry to the end of its first host read after preprocessing, so
the operator build, Ruiz, the power iteration and the initial state, their
device work included) over the requests' wall, in the untraced requests.
None where the program has no such span."""


def read(run):
    reqs = run.untraced
    if not reqs or not any("loop.prep_ns" in r.counters for r in reqs):
        return None
    return (100.0 * run.counted("loop.prep_ns", reqs) * 1e-9
            / sum(r.wall for r in reqs))
