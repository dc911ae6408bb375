"""Run one cell of the benchmark once on the CUDA card(s) of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Prints the result as one JSON object, the
last line of standard output; the numbers the correctness check compared
are the last lines of standard error.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits with an error and prints no result:
the benchmark measures the card and never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

#: Top-level modules that may not be loaded in the process that prints the
#: result (whole names: the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "tpdlp")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(message: str) -> None:
    print(f"[bench] error: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark measures a "
             "CUDA card and does not run on the CPU")
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        fail(f"the run loaded {bad}: the benchmark measures tpdlp_torch "
             "alone")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
