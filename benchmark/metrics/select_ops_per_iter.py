"""select_ops_per_iter (where/it; fleet, batch/vmapped.py and
solver/loop.py::_select): the `torch.where` calls of the state's selects
(tpdlp_torch.solver.loop.launched["selects"], one a state field replaced)
over the iterations issued (launched["iterations"]), in every request of
the window.  None where the program has no such counter."""


def read(run):
    reqs = run.requests
    if not any("loop.selects" in r.counters for r in reqs):
        return None
    issued = run.counted("loop.iterations", reqs)
    return run.counted("loop.selects", reqs) / issued if issued else None
