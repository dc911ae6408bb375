"""setup_s (s, lower is better; host clock): from the start of the
benchmark's process to the first request of the window: imports, CUDA
initialisation, the kernel library (compiled on a checkout's first run,
loaded after), the LP's generation, the traffic's cost sets and the warm
request."""


def read(run):
    return run.setup_s
