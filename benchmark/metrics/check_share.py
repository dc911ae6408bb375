"""check_share (%; restart loop, solver/loop.py): the restart checks'
device time (tpdlp_torch.solver.loop.launched["check_dev_ns"], CUDA events
around the work each check issues, read at the next host read) over the
requests' wall, in the untraced requests.  None where the program has no
such counter, as on the CPU."""


def read(run):
    reqs = run.untraced
    if not reqs or not any("loop.check_dev_ns" in r.counters for r in reqs):
        return None
    return (100.0 * run.counted("loop.check_dev_ns", reqs) * 1e-9
            / sum(r.wall for r in reqs))
