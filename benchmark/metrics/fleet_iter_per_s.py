"""fleet_iter_per_s (it/s; fleet, batch/vmapped.py): fleet iterations
issued (tpdlp_torch.solver.loop.launched["iterations"]) over the fleets'
wall time, in the untraced requests of a fleet cell."""


def read(run):
    reqs = run.untraced
    if run.batch == 1 or not reqs:
        return None
    return (run.counted("loop.iterations", reqs)
            / sum(r.wall for r in reqs))
