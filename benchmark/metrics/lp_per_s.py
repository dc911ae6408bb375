"""lp_per_s (lp/s, higher is better; host clock): LPs solved in the window
over the window's seconds.  The window runs from the start of the first
request to the end of the first request that finishes past `--seconds`,
so no partial request counts.  An LP that is not Solved, or that the
check finds wrong, is not counted.  In a fleet cell a request is a fleet,
and each of its LPs counts."""


def read(run):
    return run.solved_ok / run.window_s
