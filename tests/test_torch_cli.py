"""The port's CLI (`python -m tpdlp_torch.cli.main`) end to end, as a
subprocess on the CPU, beside the JAX CLI on the same folder (the JAX
package's tests/test_cli.py flow): the CSV schema without pandas, the
JAX CLI's status, k and j per file under fixed steps, the "Failed to load"
row, --presolve, --fishnet, --batch_solve, --mesh (four gloo ranks
under torchrun) and the escalation of a tolerance below escalation_tol
against the JAX CLI."""

import csv
import os
import subprocess
import sys

import pytest

import tpdlp_torch
from tpdlp_torch.io.writer import write_mps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = ["File", "Objective", "Iterations (k)", "Restarts (n)",
          "KKT Passes (j)", "Time (s)", "Status", "Sense"]


def _run(module, args, cwd, device="cpu", launcher=(), **env_extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, *launcher, "-m", module, "--device", device,
         *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=cwd,
    )


@pytest.fixture(scope="module")
def mps_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("cli_mps")
    for s in range(2):
        p = tpdlp_torch.generate_feasible_lp(n=20, m_ineq=12, m_eq=4, seed=s)
        write_mps(p, str(folder / f"inst{s}.mps"))
    (folder / "broken.mps").write_text("THIS IS NOT AN MPS FILE\n")
    return folder


def _read(out_dir):
    with open(os.path.join(out_dir, "solver_results.csv")) as f:
        header = next(csv.reader(f))
        f.seek(0)
        return header, {row["File"]: row for row in csv.DictReader(f)}


FIXED_FLAGS = ["--tolerance", "1e-6", "--precondition",
               "--primal_weight_update", "--max_kkt", "60000"]


@pytest.mark.parametrize("fmt", [None, "sparse"])
def test_cli_sweep_matches_jax_cli(mps_folder, tmp_path, fmt):
    layout = [] if fmt is None else ["--matrix_format", fmt]
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    rt = _run("tpdlp_torch.cli.main",
              ["--instance_path", str(mps_folder), *FIXED_FLAGS, *layout,
               "--output_path", str(out_t)], str(tmp_path))
    assert rt.returncode == 0, rt.stderr[-2000:]
    rj = _run("tpdlp.cli.main",
              ["--instance_path", str(mps_folder), *FIXED_FLAGS, *layout,
               "--output_path", str(out_j)], str(tmp_path))
    assert rj.returncode == 0, rj.stderr[-2000:]
    head_t, rows_t = _read(out_t)
    head_j, rows_j = _read(out_j)
    assert head_t == head_j == HEADER
    assert set(rows_t) == set(rows_j) == {"inst0.mps", "inst1.mps",
                                          "broken.mps"}
    for name in ("inst0.mps", "inst1.mps"):
        a, b = rows_t[name], rows_j[name]
        assert a["Status"] == b["Status"] == "Solved"
        for key in ("Iterations (k)", "Restarts (n)", "KKT Passes (j)",
                    "Sense"):
            assert a[key] == b[key], (name, key)
        assert float(a["Objective"]) == pytest.approx(
            float(b["Objective"]), abs=1e-5)
    assert rows_t["broken.mps"]["Status"].startswith("Failed to load")
    assert rows_t["broken.mps"]["Objective"] == "N/A"


def test_cli_single_file_and_support_sparse(mps_folder, tmp_path):
    out = tmp_path / "out"
    r = _run("tpdlp_torch.cli.main",
             ["--instance_path", str(mps_folder / "inst0.mps"),
              "--support_sparse", "--precondition", "--adaptive_stepsize",
              "--output_path", str(out)], str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Matrix format: auto" in r.stdout
    _, rows = _read(out)
    assert list(rows) == ["inst0.mps"] and rows["inst0.mps"][
        "Status"] == "Solved"


@pytest.mark.parametrize("flags,item", [
    (["--fishnet"], 19),
    (["--batch_solve"], 20),
    (["--mesh", "2x2"], 21),
    (["--presolve", "cpp"], 18),
    (["--presolve", "python"], 18),
])
def test_unported_flags_exit_naming_their_item(mps_folder, tmp_path, flags,
                                               item):
    """The flags of the ROADMAP.md items that were once unported run
    against the JAX CLI on the same folder, rows for the same files and
    the broken file's "Failed to load" row, objectives to 1e-5: --presolve
    (item 18) with the JAX CLI's status, k, n and j per file under fixed
    steps; --fishnet (19), --batch_solve (20) and --mesh 2x2 (21), whose
    random draws (the fishnet's population, a distinct-K fleet's or a
    padded problem's power-iteration starts) are the port's own, with the
    JAX CLI's status, solved to 1e-8 so that both objectives sit well
    inside 1e-5.  --mesh 2x2 without a launcher exits before the sweep
    saying how to launch; under torchrun its four gloo ranks sweep and
    rank 0 writes the table, beside the JAX CLI on four virtual
    devices."""
    out = tmp_path / "out"
    run_flags = [*flags, *FIXED_FLAGS]
    if item in (19, 20, 21):
        run_flags += ["--tolerance", "1e-8"]
    args = ["--instance_path", str(mps_folder), *run_flags,
            "--output_path", str(out)]
    jax_env = {}
    if item == 21:
        r = _run("tpdlp_torch.cli.main", args, str(tmp_path))
        assert r.returncode != 0
        assert "torchrun --nproc_per_node=4" in r.stderr
        assert not out.exists()
        r = _run("tpdlp_torch.cli.main", args, str(tmp_path),
                 launcher=("-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=4"))
        jax_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    else:
        r = _run("tpdlp_torch.cli.main", args, str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    out_j = tmp_path / "jax"
    rj = _run("tpdlp.cli.main",
              ["--instance_path", str(mps_folder), *run_flags,
               "--output_path", str(out_j)], str(tmp_path), **jax_env)
    assert rj.returncode == 0, rj.stderr[-2000:]
    _, rows_t = _read(out)
    _, rows_j = _read(out_j)
    assert set(rows_t) == set(rows_j) == {"inst0.mps", "inst1.mps",
                                          "broken.mps"}
    assert rows_t["broken.mps"]["Status"].startswith("Failed to load")
    for name in ("inst0.mps", "inst1.mps"):
        a, b = rows_t[name], rows_j[name]
        assert a["Status"] == b["Status"] == "Solved"
        if item == 18:
            for key in ("Iterations (k)", "Restarts (n)", "KKT Passes (j)"):
                assert a[key] == b[key], (name, key)
        if item == 20:
            assert a["Time (s)"].endswith("(batch-amortised)")
        assert float(a["Objective"]) == pytest.approx(
            float(b["Objective"]), abs=1e-5)


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_escalation_tolerance_exits_naming_item_15(mps_folder, tmp_path,
                                                   device, monkeypatch):
    """Below escalation_tol with no --dtype the CLI escalates on CUDA
    (fp32) as the JAX CLI does on an accelerator: iterative refinement by
    default.  Both CLIs run in this process with their default dtype
    patched to fp32 (on the CPU): every row Solved, objectives within
    1e-8 relative.  As a subprocess with --device cuda|auto the CLI no
    longer refuses the tolerance: without a CUDA device it exits naming
    the device, with one it solves."""
    import importlib

    import jax.numpy as jnp
    import torch

    from tpdlp.cli import main as jax_cli
    from tpdlp_torch.cli import main as port_cli

    flags = ["--instance_path", str(mps_folder), "--tolerance", "1e-8",
             "--precondition", "--adaptive_stepsize",
             "--primal_weight_update"]
    monkeypatch.setattr(importlib.import_module("tpdlp.solver.solve"),
                        "default_dtype", lambda: jnp.float32)
    monkeypatch.setattr(importlib.import_module("tpdlp_torch.solver.solve"),
                        "default_dtype", lambda device: torch.float32)
    assert port_cli.main(["--device", "cpu", *flags, "--output_path",
                          str(tmp_path / "port")]) == 0
    assert jax_cli.main(["--device", "cpu", *flags, "--output_path",
                         str(tmp_path / "jax")]) == 0
    _, rows_t = _read(tmp_path / "port")
    _, rows_j = _read(tmp_path / "jax")
    for name in ("inst0.mps", "inst1.mps"):
        a, b = rows_t[name], rows_j[name]
        assert a["Status"] == b["Status"] == "Solved", (a, b)
        assert float(a["Objective"]) == pytest.approx(
            float(b["Objective"]), rel=1e-8, abs=1e-6)
    r = _run("tpdlp_torch.cli.main",
             ["--instance_path", str(mps_folder / "inst0.mps"),
              "--tolerance", "1e-8", "--output_path", str(tmp_path / "sub")],
             str(tmp_path), device=device)
    assert "item 15" not in r.stderr
    if torch.cuda.is_available():
        assert r.returncode == 0, r.stderr[-2000:]
        _, rows = _read(tmp_path / "sub")
        assert rows["inst0.mps"]["Status"] == "Solved"
    else:
        assert r.returncode != 0 and "--device" in r.stderr


def test_no_cuda_exits_without_cpu_fallback(mps_folder, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run("tpdlp_torch.cli.main",
             ["--instance_path", str(mps_folder),
              "--output_path", str(tmp_path / "out")], str(tmp_path),
             device="auto")
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert not (tmp_path / "out").exists()
