"""The control of the correctness check, and the readings its limits were
set from, on the chip at a cell's own size; the benchmark's own runs never
run this.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 10] [--out <file.jsonl>]

Each seed is one run of the cell through `harness.run_cell`, as
`benchmark.run` makes it, with a window of `--seconds`; it prints the
run's `correct` and the numbers its check compared.  A seed of `--seeds`
runs the program as it is: a sound run's reading (the limit's lower end).
A seed of `--control-seeds` runs it under `perturbed_operator(seed)`: the
program is handed K with every stored value multiplied by (1 + delta),
delta uniform on [-2**-8, 2**-8] and drawn from the seed, while the check
judges the answers against the LP as generated: the control's reading
(the limit's upper end), which has to come out not `correct`.

The perturbation is the backward error of a K product in bfloat16, the
precision below the configuration's float32 (the step that would tempt a
later change: half of K's bytes): a product of K and x rounded to
bfloat16 and summed in float32 is (K + dK) x exactly, with |dK| within a
small multiple of 2**-8 |K|.  Rounding K's values alone would model it on
general values, but leaves 0, +-1 and small integers as they are, so on a
transport, assignment or set-covering LP it would hand the program the LP
it is judged by.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np

from benchmark import harness
from benchmark import spec as S


#: Keeps the control's random stream apart from the generator's, which
#: takes the bare seed, and the traffic's (`traffic.STREAM`).
STREAM = 2
#: bfloat16's unit roundoff: the largest relative error of one rounding.
UNIT_ROUNDOFF = 2.0 ** -8


def perturbed(K, seed: int):
    """A copy of the sparse matrix `K` with every stored value multiplied
    by (1 + delta), delta drawn from `seed` uniformly on [-UNIT_ROUNDOFF,
    UNIT_ROUNDOFF]; the pattern is K's, and K is left as it is."""
    rng = np.random.default_rng([seed, STREAM])
    low = K.copy()
    low.data = K.data * (1.0 + rng.uniform(-UNIT_ROUNDOFF, UNIT_ROUNDOFF,
                                           K.data.shape))
    return low


@contextlib.contextmanager
def perturbed_operator(seed: int):
    """Within it, every request hands the program its LPs with K replaced
    by `perturbed(K, seed)` (drawn once per K)."""
    from benchmark import program

    run = program.Program.run
    drawn = {}

    def low_of(K):
        if id(K) not in drawn:
            drawn.clear()
            drawn[id(K)] = (K, perturbed(K, seed))  # K kept: its id stays
        return drawn[id(K)][1]

    def run_perturbed(self, lps, seed):
        # `seed` here is the solver's, passed on; K's draw took the run's.
        low = low_of(lps[0].K)
        return run(self, [dataclasses.replace(p, K=low) for p in lps], seed)

    program.Program.run = run_perturbed
    try:
        yield
    finally:
        program.Program.run = run


def reading(cell: S.Cell, seed: int, seconds: float, control: bool,
            device) -> dict:
    """One run of `cell` from `seed`, under `perturbed_operator(seed)`
    where `control`: its verdict and the numbers its check compared."""
    with perturbed_operator(seed) if control else contextlib.nullcontext():
        result = harness.run_cell(cell, seed, seconds, False, device,
                                  time.perf_counter())
    return {"correct": result["correct"], "attempted": result["attempted"],
            **{k: c["value"] for k, c in result["checks"].items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("control: needs a CUDA card")
    cell = S.load_cell(args.workload)
    plan = ([(int(s), False) for s in args.seeds.split(",") if s]
            + [(int(s), True) for s in args.control_seeds.split(",") if s])
    for seed, control in plan:
        t = time.perf_counter()
        row = {"workload": cell.name, "seed": seed,
               "side": "control" if control else "program",
               **reading(cell, seed, args.seconds, control, "cuda"),
               "seconds": time.perf_counter() - t,
               "kind": torch.cuda.get_device_name(0)}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
