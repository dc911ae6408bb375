"""The port's ingestion and infeasibility battery against the JAX package's:
`tpdlp_torch.read_mps` on every vendored .mps file and on
tests/test_io.py's golden texts, the port's own copies of the terminal
corpus, the planted-infeasible and planted-unbounded generators, and
`tpdlp_torch.bench.infeasibility` (rows, oracle, CLI) on the CPU."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpdlp
from tpdlp.bench import infeasibility as jax_battery
from tpdlp.io.mps import read_mps as jax_read_mps
import tpdlp_torch
from tpdlp_torch.bench import infeasibility as battery
from tests.test_io import BOUNDS, RANGED, TOY

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_INSTANCES = ROOT / "tpdlp" / "bench" / "instances"
MPS_FILES = sorted(JAX_INSTANCES.rglob("*.mps"))
#: The battery rows small enough for the CPU: (index in build_battery()).
SMALL_ROWS = {"infeas01": 0, "unbnd01": 1, "synth_unbounded_n30_s0": 6}


def _same_problem(p, q):
    assert p.K.shape == q.K.shape and p.m_ineq == q.m_ineq
    assert (sp.csr_matrix(p.K) != sp.csr_matrix(q.K)).nnz == 0
    for f in ("c", "q", "l", "u"):
        np.testing.assert_array_equal(getattr(p, f), getattr(q, f), f)
    assert (p.name, p.obj_offset, p.objsense) == (q.name, q.obj_offset,
                                                   q.objsense)


def test_every_vendored_file_is_found():
    names = {f.relative_to(JAX_INSTANCES).as_posix() for f in MPS_FILES}
    assert {"infeas01.mps", "unbnd01.mps", "netlib/afiro.mps"} <= names


@pytest.mark.parametrize("path", MPS_FILES,
                         ids=lambda f: f.relative_to(JAX_INSTANCES).as_posix())
def test_read_mps_equals_jax(path):
    _same_problem(tpdlp_torch.read_mps(path), jax_read_mps(path))
    ours = tpdlp_torch.mps_to_standard_form(path)
    ref = tpdlp.mps_to_standard_form(path)
    assert ours[3] == ref[3]
    for a, b in zip(ours[:3] + ours[4:], ref[:3] + ref[4:]):
        np.testing.assert_array_equal(
            a.toarray() if sp.issparse(a) else a,
            b.toarray() if sp.issparse(b) else b)


def _both(tmp_path, text, **kw):
    f = tmp_path / "t.mps"
    f.write_text(text)
    p = tpdlp_torch.read_mps(f, **kw)
    _same_problem(p, jax_read_mps(f, **kw))
    return p


def test_toy_parse(tmp_path):
    p = _both(tmp_path, TOY)
    assert p.shape == (3, 2) and p.m_ineq == 2
    np.testing.assert_allclose(p.c, [-1.0, -2.0])
    np.testing.assert_allclose(p.K.toarray(), [[-1, -1], [1, -1], [1, 2]])
    np.testing.assert_allclose(p.q, [-4.0, -2.0, 5.0])
    np.testing.assert_allclose(p.l, [0.0, 0.0])
    np.testing.assert_allclose(p.u, [3.0, 10.0])


def test_ranges_expand_to_row_pairs(tmp_path):
    p = _both(tmp_path, RANGED)
    assert p.m_ineq == 6 and p.m == 6
    np.testing.assert_allclose(p.K.toarray().ravel()[0:2], [2.0, -2.0])
    np.testing.assert_allclose(p.q, [6.0, -10.0, 1.0, -3.0, 1.5, -3.0])


def test_bounds_types(tmp_path):
    p = _both(tmp_path, BOUNDS)
    l, u = p.l, p.u
    np.testing.assert_allclose([l[0], u[0]], [-2.0, 7.0])
    np.testing.assert_allclose([l[1], u[1]], [3.5, 3.5])
    assert np.isneginf(l[2]) and np.isposinf(u[2])
    assert np.isneginf(l[3]) and np.isposinf(u[3])
    assert np.isneginf(l[4]) and u[4] == -1.0
    np.testing.assert_allclose([l[5], u[5]], [0.0, 1.0])


def test_fr_compat_flag(tmp_path):
    p = _both(tmp_path, BOUNDS, compat_fr_zero=True)
    assert p.l[2] == 0.0 and np.isposinf(p.u[2])


def test_default_rhs_zero(tmp_path):
    p = _both(tmp_path, "NAME Z\nROWS\n N OBJ\n G R1\nCOLUMNS\n"
                        " X OBJ 1.0 R1 1.0\nENDATA\n")
    np.testing.assert_allclose(p.q, [0.0])


@pytest.mark.parametrize("text,match", [
    ("not an mps file\n", "ROWS"),
    ("NAME E\nROWS\n N OBJ\n G R1\nENDATA\n", "COLUMNS"),
    ("NAME B\nROWS\n N OBJ\n G R1\nCOLUMNS\n X OBJ 1.0 R1 1.0\n"
     "BOUNDS\n UP X\nENDATA\n", "missing a value"),
    ("NAME B\nROWS\n N OBJ\n G R1\nCOLUMNS\n X OBJ 1.0 R1 1.0\n"
     "BOUNDS\n UP BND X\nENDATA\n", "non-numeric"),
])
def test_garbage_raises(tmp_path, text, match):
    f = tmp_path / "g.mps"
    f.write_text(text)
    with pytest.raises(ValueError, match=match):
        jax_read_mps(f)
    with pytest.raises(ValueError, match=match):
        tpdlp_torch.read_mps(f)


def test_objsense_max(tmp_path):
    p = _both(tmp_path, "NAME MX\nOBJSENSE\n MAX\nROWS\n N OBJ\n G R1\n"
                        "COLUMNS\n X OBJ 2.0 R1 1.0\nRHS\n RHS R1 1.0\n"
                        " RHS OBJ 3.0\nENDATA\n")
    np.testing.assert_allclose(p.c, [-2.0])
    assert p.objsense == "MAX" and p.obj_offset == -3.0


@pytest.mark.parametrize("name", ["infeas01.mps", "unbnd01.mps"])
def test_port_instances_are_copies(name):
    """The battery reads its own copies, byte for byte the JAX package's."""
    ours = battery.INSTANCES_DIR / name
    assert ours.parent == ROOT / "tpdlp_torch" / "bench" / "instances"
    assert ours.read_bytes() == (JAX_INSTANCES / name).read_bytes()


@pytest.mark.parametrize("kw", [dict(), dict(seed=3), dict(
    n=757, m_eq=280, density=0.05, seed=1)])
def test_generate_infeasible_lp_equals_jax(kw):
    _same_problem(tpdlp_torch.generate_infeasible_lp(**kw),
                  tpdlp.generate_infeasible_lp(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(seed=1), dict(
    n=757, m_ineq=280, seed=1)])
def test_generate_unbounded_lp_equals_jax(kw):
    _same_problem(tpdlp_torch.generate_unbounded_lp(**kw),
                  tpdlp.generate_unbounded_lp(**kw))


def test_build_battery_equals_jax():
    ours, ref = battery.build_battery(), jax_battery.build_battery()
    assert [(n, s) for n, _, s in ours] == [(n, s) for n, _, s in ref]
    for (_, p, _), (_, q, _) in zip(ours, ref):
        _same_problem(p, q)
    assert battery.EXPECT == {k: tpdlp_torch.Status(int(v)) for k, v in
                              jax_battery._EXPECT.items()}
    for name, i in SMALL_ROWS.items():
        assert ours[i][0] == name


@pytest.mark.parametrize("index", [0, 1, 2, 3, 6, 7])
def test_oracle_equals_jax(index):
    """The port's linprog oracle (interior point first, then the default
    method) gives the JAX package's verdict, the planted one, on every row
    the default method decides in about a second."""
    name, p, planted = battery.build_battery()[index]
    assert battery.oracle_status(p) == jax_battery._oracle_status(p) == (
        planted), name


@pytest.mark.parametrize("name", list(SMALL_ROWS))
def test_battery_row_on_cpu_like_jax(name):
    """The battery's flag set in fp64 on the CPU: the oracle's verdict, and
    the JAX package's status."""
    rname, p, oracle_st = battery.build_battery()[SMALL_ROWS[name]]
    cfg = battery.battery_config()
    row, r = battery.solve_row(rname, p, oracle_st, cfg, device="cpu",
                               warm=False)
    assert row["oracle_verified"] and row["match"], row
    rj = tpdlp.solve(p, tpdlp.SolverConfig(**{
        f: getattr(cfg, f) for f in ("tol", "max_kkt", "scaling", "adaptive",
                                     "primal_weight_update",
                                     "infeasibility_detect",
                                     "normalized_certificates")}),
        dtype=jnp.float64)
    assert row["status"] == rj.status.describe() == r.status_string
    assert set(row) == {"instance", "shape", "status",
                        "oracle_linprog_status", "oracle_verified",
                        "expected_status", "match", "iterations", "kkt",
                        "wall"}


def test_battery_cli_on_cpu(monkeypatch, tmp_path, capsys):
    """`python -m tpdlp_torch.bench.infeasibility --device cpu`, over the
    battery's small rows."""
    rows = battery.build_battery()
    monkeypatch.setattr(battery, "build_battery",
                        lambda: [rows[i] for i in SMALL_ROWS.values()])
    out = tmp_path / "battery.json"
    art = battery.main(["--device", "cpu", "--dtype", "float64",
                        "--no-warm", "--out", str(out)])
    assert art["matched"] == art["total"] == len(SMALL_ROWS)
    assert art["backend"] == "cpu"
    assert json.loads(out.read_text())["rows"] == art["rows"]
    printed = capsys.readouterr().out
    assert '"matched": 3' in printed


# ---------------------------------------------------------------------------
# The MPS writer, netlib access and the vendored corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.generate_feasible_lp(n=30, m_ineq=12, m_eq=5, seed=4),
    lambda m: m.generate_feasible_lp(n=25, m_ineq=8, m_eq=6, seed=2,
                                     bounds="mixed"),
    lambda m: m.generate_infeasible_lp(seed=1),
], ids=["box", "mixed", "infeasible"])
def test_write_mps_bytes_equal_jax(tmp_path, make):
    from tpdlp.io.writer import write_mps as jax_write_mps
    from tpdlp_torch.io.writer import write_mps

    p = make(tpdlp_torch)
    _same_problem(p, make(tpdlp))
    write_mps(p, tmp_path / "port.mps")
    jax_write_mps(p, tmp_path / "jax.mps")
    assert (tmp_path / "port.mps").read_bytes() == (
        tmp_path / "jax.mps").read_bytes()
    # The round trip gives the problem back.
    q = tpdlp_torch.read_mps(tmp_path / "port.mps")
    np.testing.assert_array_equal(sp.csr_matrix(q.K).toarray(),
                                  sp.csr_matrix(p.K).toarray())


def test_netlib_vendored_afiro_offline():
    from tpdlp.io import netlib as jax_netlib
    from tpdlp_torch.io import netlib

    path = netlib.vendored_path("afiro")
    assert path is not None and pathlib.Path(path).is_relative_to(
        ROOT / "tpdlp_torch")
    assert pathlib.Path(path).read_bytes() == pathlib.Path(
        jax_netlib.vendored_path("afiro")).read_bytes()
    assert netlib.vendored_path("adlittle") is None
    assert netlib.fetch("afiro") == path
    p = netlib.load("afiro")
    assert p.name == "afiro" and p.known_objective == -4.6475314286e2
    assert netlib.known_objective("nope") is None
    assert netlib.verify_objective("afiro", -464.7531428571)
    assert not netlib.verify_objective("nope", 1.0)
    with pytest.raises(netlib.ObjectiveMismatch):
        netlib.verify_objective("afiro", -460.0)
    assert (netlib.FEASIBLE, netlib.INFEASIBLE, netlib.KNOWN_OBJECTIVES) == (
        jax_netlib.FEASIBLE, jax_netlib.INFEASIBLE,
        jax_netlib.KNOWN_OBJECTIVES)


def test_netlib_fetch_through_a_local_mirror(tmp_path):
    """The network path against a loopback mirror (no outside host): a
    gzipped payload under a name that is not vendored, then the cache."""
    import gzip
    import http.server
    import threading

    from tpdlp_torch.io import netlib

    payload = gzip.compress(pathlib.Path(
        netlib.vendored_path("afiro")).read_bytes())

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/xfiro.mps.gz":
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        mirrors = [base + "/{name}.mps.gz"]
        path = netlib.fetch("xfiro", cache_dir=str(tmp_path),
                            mirrors=mirrors, timeout=10)
        assert path == str(tmp_path / "xfiro.mps")
        p = tpdlp_torch.read_mps(path)
        assert p.K.shape == netlib.load("afiro").K.shape
        got = netlib.fetch_all(["xfiro", "nothere"], cache_dir=str(tmp_path),
                               mirrors=mirrors, timeout=10)
        assert got == {"xfiro": path, "nothere": None}
        with pytest.raises(netlib.NetlibUnavailable):
            netlib.fetch("nothere", cache_dir=str(tmp_path),
                         mirrors=mirrors, timeout=10)
    finally:
        httpd.shutdown()
        thread.join(timeout=5)
    assert not thread.is_alive()


def test_corpus_paths_equal_jax():
    from tpdlp.bench import suite as jax_suite
    from tpdlp_torch.bench import suite

    for terminal in (False, True):
        ours = [pathlib.Path(f).name
                for f in suite.corpus_paths(terminal)]
        theirs = [pathlib.Path(f).name
                  for f in jax_suite.corpus_paths(terminal)]
        assert ours == theirs and ours
        for f in suite.corpus_paths(terminal):
            assert pathlib.Path(f).is_relative_to(ROOT / "tpdlp_torch")
            assert pathlib.Path(f).read_bytes() == (
                JAX_INSTANCES / pathlib.Path(f).name).read_bytes()


def test_build_corpus_equals_jax():
    from tpdlp.bench import suite as jax_suite
    from tpdlp_torch.bench import suite

    ours, theirs = suite.build_corpus(), jax_suite.build_corpus()
    assert [p.name for p in ours] == [p.name for p in theirs]
    for p, q in zip(ours, theirs):
        _same_problem(p, q)
    real = suite.build_suite(("small", "real"))
    assert [p.name for p in real] == [p.name for p in suite.build_suite(
        ("small",))] + [p.name for p in ours]
