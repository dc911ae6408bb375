"""The control of the correctness check, and the readings its limits were
set from, on the chip at a cell's own size; the benchmark's own runs never
run this.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 10] [--out <file.jsonl>]

Each seed is one run of the cell through `harness.run_cell`, as
`benchmark.run` makes it, with a window of `--seconds`; it prints the
run's `correct` and the numbers its check compared.  A seed of `--seeds`
runs the program as it is: a sound run's reading (the limit's lower end).
A seed of `--control-seeds` runs it under `bf16_operator()`: the program
is handed K rounded to bfloat16, the precision below the configuration's
float32 (the step that would tempt a later change: half of K's bytes),
and every product is then exact on the rounded values, while the check
judges the answers against the LP as generated: the control's reading
(the limit's upper end), which has to come out not `correct`.
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


def round_bf16(values: np.ndarray) -> np.ndarray:
    """`values` rounded to the nearest bfloat16 (ties to even), as
    float64."""
    bits = np.asarray(values, dtype=np.float32).view(np.uint32)
    bits = bits.astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


@contextlib.contextmanager
def bf16_operator():
    """Within it, every request hands the program its LPs with K's values
    rounded to bfloat16 (rounded once per K)."""
    from benchmark import program

    run = program.Program.run
    rounded = {}

    def run_rounded(self, lps, seed):
        K = lps[0].K
        if id(K) not in rounded:
            low = K.copy()
            low.data = round_bf16(low.data)
            rounded.clear()
            rounded[id(K)] = (K, low)  # K kept, so its id stays its own
        low = rounded[id(K)][1]
        return run(self, [dataclasses.replace(p, K=low) for p in lps], seed)

    program.Program.run = run_rounded
    try:
        yield
    finally:
        program.Program.run = run


def reading(cell: S.Cell, seed: int, seconds: float, control: bool,
            device) -> dict:
    """One run of `cell` from `seed`, under `bf16_operator()` where
    `control`: its verdict and the numbers its check compared."""
    with bf16_operator() if control else contextlib.nullcontext():
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
