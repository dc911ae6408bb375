"""CLI driver: sweep a folder of MPS instances and write a results CSV
(counterpart of tpdlp/cli/main.py).

    python -m tpdlp_torch.cli.main --instance_path <folder> [flags]

The JAX CLI's flags, defaults and CSV schema (File, Objective, Iterations
(k), Restarts (n), KKT Passes (j), Time (s), Status, Sense), with one
try/except per instance so that one bad file does not stop the sweep: a
file that does not parse gets a "Failed to load" row.  The CSV is written
with the `csv` module.

`--device` takes cpu, cuda or auto; auto means CUDA and exits with an
error where there is none (no CPU fallback).  `--support_sparse` runs the
layout autotune (matrix_format="auto"), and `--matrix_format` forces a
layout.  `--presolve python|cpp` reduces each LP first and maps the
solution back.  A tolerance below `escalation_tol` with no --dtype on
CUDA (fp32) escalates as in the JAX CLI: iterative refinement by default.
`--fishnet` warm-starts each solve from the fishnet search
(tpdlp_torch/fishnet.py) on the scaled problem, through the layout the
solve uses; `--batch_solve` solves a folder of several files as one fleet
(`solve_batch`, restart_sync="global"), each row's time the batch's wall
over its size.

`--mesh RxC` solves each LP sharded over R*C ranks (tpdlp_torch/shard),
launched by torchrun:

    torchrun --nproc_per_node=4 -m tpdlp_torch.cli.main --mesh 2x2 ...

Every rank sweeps the folder, and rank 0 writes the CSV.  The ranks join
over NCCL with --device cuda (rank i on cuda:LOCAL_RANK) and over gloo
with --device cpu.  A world size other than R*C exits non-zero saying how
to launch; 1x1 runs without a launcher.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

CSV_FIELDS = ["File", "Objective", "Iterations (k)", "Restarts (n)",
              "KKT Passes (j)", "Time (s)", "Status", "Sense"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="tpdlp_torch: restarted-PDHG LP solver on CUDA"
    )
    p.add_argument("--device", type=str, choices=["cpu", "cuda", "auto"],
                   default="auto",
                   help="'cpu', 'cuda', or 'auto' (= cuda; default)")
    p.add_argument("--instance_path", type=str, default="feasible",
                   help="Folder containing .mps instances, or one .mps file")
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--precondition", action="store_true",
                   help="Enable Ruiz preconditioning")
    p.add_argument("--primal_weight_update", action="store_true")
    p.add_argument("--adaptive_stepsize", action="store_true")
    p.add_argument("--infeasibility_detect", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--support_sparse", action="store_true",
                   help="Autotune the constraint operator's layout")
    p.add_argument("--matrix_format", type=str, default=None,
                   choices=["dense", "sparse", "band", "auto"],
                   help="Force the operator layout (overrides "
                        "--support_sparse)")
    p.add_argument("--max_kkt", type=int, default=100_000)
    p.add_argument("--time_limit", type=int, default=3600)
    p.add_argument("--fishnet", action="store_true",
                   help="Fishnet multi-point warm start")
    p.add_argument("--scaling", type=str, default=None,
                   choices=["none", "ruiz", "ruiz+pc"],
                   help="Override scaling method (--precondition => ruiz)")
    p.add_argument("--adaptive_rule", type=str, default="reference",
                   choices=["reference", "linesearch"])
    p.add_argument("--infeas_tol", type=float, default=1e-4)
    p.add_argument("--dtype", type=str, default=None,
                   choices=[None, "float32", "float64"])
    p.add_argument("--mesh", type=str, default=None,
                   help="RxC mesh for a sharded solve, e.g. 2x2 (launch "
                        "R*C ranks with torchrun)")
    p.add_argument("--presolve", type=str, default="off",
                   choices=["off", "python", "cpp"],
                   help="PaPILO-equivalent presolve/postsolve round trip")
    p.add_argument("--compat_fr_zero", action="store_true",
                   help="Reproduce the reference's FR-bound quirk "
                        "(lo=0 instead of -inf)")
    p.add_argument("--step_scheme", type=str, default="vanilla",
                   choices=["vanilla", "halpern"],
                   help="iteration scheme: restarted PDHG, or "
                        "Halpern-anchored reflected PDHG (fixed steps only)")
    p.add_argument("--batch_solve", action="store_true",
                   help="solve the whole folder as one fleet (same-device "
                        "batch; ragged shapes padded)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--abs_gap_termination", action="store_true",
                   help="certify |gap| <= tol(1+|p|+|d|); the default "
                        "matches the reference's signed gap")
    return p.parse_args(argv)


def _mesh(spec: str, dev):
    """(mesh, device) of --mesh RxC: the ranks torchrun launched (its
    environment names them), joined over NCCL on CUDA (each rank its
    LOCAL_RANK's card) and over gloo on the CPU; 1x1 needs no launcher.
    Exits non-zero when the world size is not R*C."""
    from tpdlp_torch.shard.mesh import (
        init_distributed,
        launch_hint,
        make_solver_mesh,
    )

    try:
        shape = tuple(int(v) for v in spec.lower().split("x"))
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(spec)
    except ValueError:
        raise SystemExit(f"--mesh {spec}: expected RxC, e.g. 2x2")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != shape[0] * shape[1]:
        raise SystemExit(f"--mesh {spec} with {world} process(es): "
                         + launch_hint(shape))
    if "WORLD_SIZE" not in os.environ:
        return make_solver_mesh(shape), dev
    if dev.type == "cuda":
        import torch

        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    print(f"--mesh {spec}: rank {os.environ.get('RANK')} of {world} over "
          f"{backend} on {dev}")
    return init_distributed(backend, shape=shape), dev


def _failed_row(name, msg):
    return {
        "File": name,
        "Objective": "N/A",
        "Iterations (k)": "N/A",
        "Restarts (n)": "N/A",
        "KKT Passes (j)": "N/A",
        "Time (s)": "N/A",
        "Status": msg if len(msg) <= 60 else msg[:57] + "...",
        "Sense": "N/A",
    }


def write_csv(rows, path) -> None:
    """The results table, one row per instance (the JAX CLI's columns)."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def _batch_rows(loaded, cfg, dtype, dev, seed, matrix_format):
    """The CSV rows of one fleet solve of the loaded files (the JAX
    CLI's --batch_solve): restart_sync="global", each row's time the batch
    wall over its size; a failed batch fails every row."""
    from tpdlp_torch.batch import solve_batch

    print(f"\nBatch-solving {len(loaded)} instances (one fleet)...")
    rows = []
    try:
        batch = solve_batch([p for _, p in loaded], cfg, dtype=dtype,
                            device=dev, seed=seed, restart_sync="global",
                            matrix_format=matrix_format)
    except Exception as e:  # reported in every row of the batch
        print(f"Batch solve failed: {e}")
        return [_failed_row(name, f"Batch failed: {e}")
                for name, _ in loaded]
    for (name, _), r in zip(loaded, batch):
        row = r.csv_row(name)
        row["Time (s)"] = (f"{r.solve_time / len(batch):.4f} "
                           "(batch-amortised)")
        rows.append(row)
        print(f"{name}: {r.status_string}")
    return rows


def main(argv=None):
    args = parse_args(argv)
    if args.fishnet and args.presolve != "off":
        raise SystemExit(
            "--fishnet cannot be combined with --presolve: the fishnet "
            "warm start lives in the original variable space but the "
            "solve would run on the presolve-reduced problem"
        )

    import time

    import torch

    from tpdlp_torch import SolverConfig, read_mps, solve
    from tpdlp_torch.device import resolve_device
    from tpdlp_torch.fishnet import fishnet_start
    from tpdlp_torch.solver.solve import default_dtype

    scaling = args.scaling
    if scaling is None:
        scaling = "ruiz" if args.precondition else "none"

    cfg = SolverConfig(
        tol=args.tolerance,
        max_kkt=args.max_kkt,
        time_limit=float(args.time_limit),
        scaling=scaling,
        adaptive=args.adaptive_stepsize,
        adaptive_rule=args.adaptive_rule,
        primal_weight_update=args.primal_weight_update,
        infeasibility_detect=args.infeasibility_detect,
        infeas_tol=args.infeas_tol,
        step_scheme=args.step_scheme,
        abs_gap_termination=args.abs_gap_termination,
        verbose=args.verbose,
    )
    try:
        dev = resolve_device("cuda" if args.device == "auto"
                             else args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}")
    mesh = None
    if args.mesh:
        mesh, dev = _mesh(args.mesh, dev)
    name = f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" \
        else ""
    print(f"tpdlp_torch device: {dev}{name}")

    dtype = None
    if args.dtype:
        dtype = getattr(torch, args.dtype)
    matrix_format = args.matrix_format or (
        "auto" if args.support_sparse else "dense")

    print("\nConfiguration:")
    for k, v in (
        ("Instance path", args.instance_path),
        ("Tolerance", args.tolerance),
        ("Output path", args.output_path),
        ("Time limit", f"{args.time_limit} seconds"),
        ("Max KKT passes", args.max_kkt),
        ("Scaling", scaling),
        ("Primal weight update", args.primal_weight_update),
        ("Adaptive stepsize", args.adaptive_stepsize),
        ("Infeasibility detection", args.infeasibility_detect),
        ("Fishnet", args.fishnet),
        ("Matrix format", matrix_format),
        ("Mesh", args.mesh),
    ):
        print(f"{k}: {v}")

    if os.path.isfile(args.instance_path):
        mps_files = [args.instance_path]
    else:
        folder = args.instance_path
        mps_files = sorted(
            os.path.join(folder, f)
            for f in os.listdir(folder)
            if f.endswith(".mps")
        )

    results = []
    if args.batch_solve and (args.fishnet or args.presolve != "off"
                             or mesh):
        print("--batch_solve does not compose with --fishnet/--presolve/"
              "--mesh; falling back to the sequential sweep.")
        args.batch_solve = False
    if args.batch_solve and len(mps_files) > 1:
        # Fleet mode: per-file load failures are reported per row; the
        # batch solves the rest.
        loaded = []
        for path in mps_files:
            fname = os.path.basename(path)
            try:
                loaded.append(
                    (fname, read_mps(path,
                                     compat_fr_zero=args.compat_fr_zero)))
            except Exception as e:  # reported in the file's row
                print(f"Failed to load MPS file: {path}. Error: {e}")
                results.append(_failed_row(fname, f"Failed to load: {e}"))
        if loaded:
            results += _batch_rows(loaded, cfg, dtype, dev, args.seed,
                                   args.matrix_format or "dense")
        mps_files = []

    for path in mps_files:
        fname = os.path.basename(path)
        print(f"\nProcessing {path}...")
        try:
            problem = read_mps(path, compat_fr_zero=args.compat_fr_zero)
        except Exception as e:  # one bad file must not stop the sweep
            print(f"Failed to load MPS file: {path}. Error: {e}")
            results.append(_failed_row(fname, f"Failed to load: {e}"))
            continue
        try:
            time_used = 0.0
            x0 = y0 = None
            if args.fishnet:
                t0 = time.perf_counter()
                x0, y0 = fishnet_start(
                    problem, dtype or default_dtype(dev), dev,
                    matrix_format, scaling, args.seed)
                time_used = time.perf_counter() - t0
                if args.verbose:
                    print(f"Fishnet completed in {time_used:.4f}s")
            result = solve(problem, cfg, dtype=dtype, device=dev,
                           x0=x0, y0=y0, seed=args.seed,
                           time_used=time_used, mesh=mesh,
                           matrix_format=matrix_format,
                           presolve=args.presolve)
            print(f"Solver uses {result.solve_time:.4f} seconds.")
            print(f"Status: {result.status_string}")
            results.append(result.csv_row(fname))
        except Exception as e:  # reported in the instance's row
            print(f"Solver failed for {fname}. Error: {e}")
            results.append(_failed_row(fname, f"Solver failed: {e}"))

    if mesh is not None:
        if mesh.group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
        if mesh.rank != 0:
            return 0  # rank 0 writes the table
    os.makedirs(args.output_path, exist_ok=True)
    if results:
        csv_path = os.path.join(args.output_path, "solver_results.csv")
        write_csv(results, csv_path)
        print(f"\nResults saved to CSV: {csv_path}")
    else:
        print("No results to save.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
