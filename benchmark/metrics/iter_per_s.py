"""iter_per_s (it/s; restart loop, solver/loop.py, step.py, residuals.py):
SolveResult.iterations summed over the untraced requests of a one-LP cell,
over their summed wall time (bench.py's rate).  Against lp_per_s it
separates faster iterations from fewer iterations."""


def read(run):
    reqs = run.untraced
    if run.batch != 1 or not reqs:
        return None
    return (sum(a.iterations for r in reqs for a in r.answers)
            / sum(r.wall for r in reqs))
