"""The port's harnesses on the CPU at tiny sizes: make_corpus writes the
vendored corpus byte for byte, report prints the JAX report's markdown
from the same rows, and runner, roofline and scaling run (their device
numbers come from the card: PERF.md)."""

import json
import os

import pytest
import torch

import tpdlp.bench.report as jax_report
import tpdlp_torch
from tpdlp_torch.bench import report, roofline, runner, scaling
from tpdlp_torch.bench.instances import make_corpus
from tpdlp_torch.bench.suite import INSTANCES_DIR

torch.set_num_threads(2)

ROWS = [
    {"instance": "afiro-class", "shape": [27, 51],
     "ours": {"time": 0.0123, "iterations": 240},
     "reference": {"time": 0.4567, "iterations": 300},
     "ours_iters_all": [240, 240, 240], "ref_iters_all": [300, 280, 320],
     "speedup_time": 37.13, "speedup_iters_per_sec": 29.4},
    {"instance": "mittelmann-s", "shape": [2000, 5000],
     "ours": {"time": 1.8462, "iterations": 1160},
     "reference": None, "ours_iters_all": [1160, 1200, 1160],
     "ref_iters_all": None},
]


def test_make_corpus_writes_the_vendored_files(tmp_path, capsys):
    make_corpus.main([str(tmp_path)])
    written = sorted(f for f in os.listdir(tmp_path) if f.endswith(".mps"))
    vendored = sorted(f for f in os.listdir(INSTANCES_DIR)
                      if f.endswith(".mps"))
    assert written == vendored and len(written) == 9
    for name in written:
        with open(tmp_path / name, "rb") as a, open(
                os.path.join(INSTANCES_DIR, name), "rb") as b:
            assert a.read() == b.read(), name
    assert capsys.readouterr().out.count("(ok)") == 9


def test_report_prints_the_jax_markdown(tmp_path, capsys):
    assert report.markdown_table(ROWS) == jax_report.markdown_table(ROWS)
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(ROWS))
    report.main(["--from", str(path)])
    assert capsys.readouterr().out.strip() == jax_report.markdown_table(ROWS)


def test_runner_rows_without_the_reference(monkeypatch, capsys):
    monkeypatch.delenv("TPDLP_REFERENCE_PATH", raising=False)
    rows = runner.main(["--classes", "small", "--reps", "2", "--dtype",
                        "float64", "--device", "cpu", "--json"])
    assert [r["instance"] for r in rows] == ["afiro-class", "sc50-class",
                                             "share-class"]
    for row in rows:
        assert row["reference"] is None and row["ref_iters_all"] is None
        assert row["ours"]["status"] == "Solved"
        assert len(row["ours_iters_all"]) == 2
        assert row["ours"]["iters_per_sec"] == max(
            row["ours"]["iters_per_sec"], 0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["instance"] for ln in lines] == [
        r["instance"] for r in rows]


@pytest.mark.parametrize("fmt", ["dense", "band", "ell"])
def test_roofline_runs_and_reports_no_share_on_the_cpu(fmt, capsys):
    r = roofline.main(["--m", "128", "--n", "256", "--iters", "600",
                       "--format", fmt, "--bandwidth", "17", "--dtype",
                       "float64", "--device", "cpu"])
    assert r["sec_per_iter"] > 0 and r["iterations"] > 0
    assert r["achieved_gbs"] > 0 and r["device"] == "cpu"
    assert r["fraction_of_peak"] is None and r["peak_gbs"] is None
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == f"fused_step_hbm_fraction_of_peak_{fmt}"


def test_roofline_rejects_a_fit_that_is_not_a_rate(monkeypatch):
    """Two chunk timings whose difference is not positive are reported as
    an error, never as a rate."""
    cfg = tpdlp_torch.SolverConfig(tol=0.0, max_kkt=10**9)
    p = tpdlp_torch.generate_feasible_lp(n=20, m_ineq=8, m_eq=4, seed=0)
    from tpdlp_torch.solver.solve import prepare

    pb, st = prepare(p, cfg, dtype=torch.float64, device="cpu")
    monkeypatch.setattr(roofline, "_seconds",
                        lambda fn, dev: (1.0, fn()))
    with pytest.raises(RuntimeError, match="not a rate"):
        roofline._measure_chunk(st, pb, cfg, 80, 400, torch.device("cpu"))


def test_scaling_one_all_reduce_per_product():
    rows = scaling.run_scaling(32, 64, 80, backend="gloo", ranks=(1, 2),
                               dtype_name="float64", device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["all_reduces_per_product"] == 0
    two = rows[1]
    assert two["all_reduces_per_product"] == 1.0
    assert two["backend"] == "gloo" and two["mesh"] == {"row": 1, "col": 2}
    # The padded 2-rank run sums its products in another order; the
    # adaptive rule amplifies that ~100x a cycle (ROADMAP queue 3), so the
    # fp64 trajectories agree to the parity tests' 1e-9.
    assert two["trajectory_rel_err_vs_single"] <= 1e-9
