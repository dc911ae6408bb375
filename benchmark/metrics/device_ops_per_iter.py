"""device_ops_per_iter (ops/it; host launch path of the blocked cycle):
device activities in the trace of the traced requests (kernels, copies,
sets) over the iterations the loop issued in them
(tpdlp_torch.solver.loop.launched["iterations"])."""


def read(run):
    if run.trace is None:
        return None
    issued = run.counted("loop.iterations", run.traced)
    return len(run.trace.device) / issued if issued else None
