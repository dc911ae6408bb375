"""Netlib LP corpus access: fetch, cache, verify, load (a copy of
tpdlp/io/netlib.py, kept here so that this package never imports the JAX
package; it serves its own vendored copy of afiro).

The reference evaluates on the Netlib feasible set (its CLI sweeps a folder
of MPS files — PDLP/main.py:83) and the Netlib infeasible set
(experiments/InfeasibilityDetection3.py:937).  This module fetches those
instances from public plain-MPS mirrors into a local cache and loads them
through the MPS reader, so `python -m tpdlp_torch.io.netlib --dest DIR` followed
by `python -m tpdlp_torch.cli.main --instance_path DIR` reproduces the
reference's evaluation flow on the real corpus.

Instances vendored inside the package (tpdlp_torch/bench/instances/netlib/ —
currently afiro, verified against its published optimum) are served
without any network access.  For the rest, zero-egress environments get
a clear `NetlibUnavailable` error from `fetch`; the vendored realistic
corpus in tpdlp_torch/bench/instances/ plus the synthetic suite
(tpdlp_torch/bench/suite.py) cover testing there.

Mirrors are URL templates with `{name}` placeholders, overridable via the
TPDLP_NETLIB_MIRRORS environment variable (comma-separated) or the
`mirrors=` argument; gzip payloads (mirror files named *.mps.gz, or
gzip-encoded responses) are decompressed transparently.
"""

from __future__ import annotations

import gzip
import os
import urllib.error
import urllib.request

# Plain-MPS mirror URL templates, tried in order.  netlib.org itself serves
# the original emps-compressed archive, which needs the emps expander;
# these mirrors host already-expanded MPS (optionally gzipped).
DEFAULT_MIRRORS = (
    "https://raw.githubusercontent.com/coin-or-tools/Data-Netlib/master/{name}.mps.gz",
    "https://raw.githubusercontent.com/coin-or-tools/Data-Netlib/master/{name}.mps",
    "https://raw.githubusercontent.com/ERGO-Code/HiGHS/master/check/instances/{name}.mps",
)

#: The classic Netlib feasible subset the reference's experiments sweep
#: (small-to-medium; the full set is ~95 instances).
FEASIBLE = (
    "25fv47", "adlittle", "afiro", "agg", "bandm", "beaconfd", "blend",
    "bnl1", "brandy", "degen2", "e226", "israel", "lotfi", "sc50a",
    "sc50b", "sc105", "sc205", "scagr7", "scagr25", "share1b", "share2b",
    "ship04s", "stocfor1",
)

#: The Netlib infeasible set (netlib/lp/infeas), the reference's
#: infeasibility-detection corpus.
INFEASIBLE = (
    "bgdbg1", "bgetam", "box1", "chemcom", "cplex1", "cplex2", "ex72a",
    "ex73a", "forest6", "galenet", "gosh", "gran", "itest2", "itest6",
    "klein1", "klein2", "klein3", "mondou2", "pang", "pilot4i", "qual",
    "reactor", "refinery", "vol1", "woodinfe",
)

#: Published optimal objective values (netlib README convention: the raw
#: c'x optimum without the objective-row RHS constant; see e226 note
#: below).  Checked by `verify_objective` (used by the vendored-instance
#: tests and the CLI netlib cross-check) at rtol 1e-5 — loose because the
#: README values are rounded to 11 significant digits and, for fetched
#: files, mirror copies occasionally differ in the objective constant.
#: e226 in particular: the README lists -18.751929066 but the file carries
#: an objective-row RHS of -7.113; solvers that add the constant report
#: -25.864929066 — `verify_objective` accepts either convention.
KNOWN_OBJECTIVES = {
    "afiro": -4.6475314286e2,
    "adlittle": 2.2549496316e5,
    "sc50a": -6.4575077059e1,
    "sc50b": -7.0000000000e1,
    "sc105": -5.2202061212e1,
    "sc205": -5.2202061212e1,
    "share1b": -7.6589318579e4,
    "share2b": -4.1573224074e2,
    "blend": -3.0812149846e1,
    "stocfor1": -4.1131976219e4,
    "scagr7": -2.3313892548e6,
    "israel": -8.9664482186e5,
    "brandy": 1.5185098965e3,
    "e226": -1.8751929066e1,
    "bandm": -1.5862801845e2,
    "beaconfd": 3.3592485807e4,
    "25fv47": 5.5018458883e3,
}


#: Directory of instances vendored inside the package (public-domain
#: classics small enough to ship).  `fetch` serves these without touching
#: the network, so `load("afiro")` works in zero-egress environments.
VENDORED_DIR = os.path.join(os.path.dirname(__file__), "..", "bench",
                            "instances", "netlib")


def vendored_path(name):
    """Path of a vendored netlib instance, or None if not shipped."""
    path = os.path.abspath(os.path.join(VENDORED_DIR, f"{name}.mps"))
    return path if os.path.exists(path) else None


class NetlibUnavailable(RuntimeError):
    """No mirror could be reached (offline / zero-egress environment)."""


class ObjectiveMismatch(AssertionError):
    """A solved netlib instance disagrees with its published optimum."""


def known_objective(name):
    """Published optimum for `name`, or None if not tabulated."""
    return KNOWN_OBJECTIVES.get(name)


def verify_objective(name, objective, rtol=1e-5, obj_offset=0.0):
    """Check a solved objective against the published netlib optimum.

    Accepts both objective-constant conventions (raw c'x and
    c'x + obj_offset — see the e226 note on KNOWN_OBJECTIVES).  Returns
    True when the value matches, False when `name` has no published
    optimum, and raises ObjectiveMismatch on a real disagreement.
    """
    published = KNOWN_OBJECTIVES.get(name)
    if published is None:
        return False
    scale = 1.0 + abs(published)
    candidates = {objective, objective - obj_offset, objective + obj_offset}
    best = min(abs(c - published) / scale for c in candidates)
    if best > rtol:
        raise ObjectiveMismatch(
            f"{name}: solved objective {objective!r} does not match the "
            f"published optimum {published!r} (rel err {best:.3e} > "
            f"rtol {rtol:g})"
        )
    return True


def _mirrors(mirrors=None):
    if mirrors is not None:
        return tuple(mirrors)
    env = os.environ.get("TPDLP_NETLIB_MIRRORS")
    if env:
        return tuple(u for u in env.split(",") if u.strip())
    return DEFAULT_MIRRORS


def default_cache_dir() -> str:
    return os.environ.get(
        "TPDLP_NETLIB_CACHE",
        os.path.join(
            os.path.expanduser("~"), ".cache", "tpdlp", "netlib"
        ),
    )


def fetch(name, cache_dir=None, mirrors=None, timeout=30) -> str:
    """Download (or reuse a cached copy of) one netlib instance.

    Vendored instances (see VENDORED_DIR) are served directly without
    network access.  Otherwise returns the path of a plain-text MPS file
    in the cache.  Raises NetlibUnavailable when every mirror fails.
    """
    vendored = vendored_path(name)
    if vendored is not None:
        return vendored
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    dest = os.path.join(cache_dir, f"{name}.mps")
    if os.path.exists(dest) and os.path.getsize(dest) > 0:
        return dest
    errors = []
    # Mirror file-name casing differs between hosts (Data-Netlib uses
    # upper case for some instances); try the name as given, then the
    # other case variants.
    variants = []
    for cand in (name, name.lower(), name.upper()):
        if cand not in variants:
            variants.append(cand)
    for template in _mirrors(mirrors):
        for cand in variants:
            url = template.format(name=cand)
            try:
                with urllib.request.urlopen(url, timeout=timeout) as resp:
                    payload = resp.read()
            except (urllib.error.URLError, OSError, ValueError) as e:
                errors.append(f"{url}: {e}")
                continue
            if payload[:2] == b"\x1f\x8b":  # gzip magic
                try:
                    payload = gzip.decompress(payload)
                except OSError as e:
                    errors.append(f"{url}: bad gzip ({e})")
                    continue
            text = payload.decode("utf-8", errors="replace")
            if "ROWS" not in text.upper():
                errors.append(f"{url}: payload does not look like MPS")
                continue
            tmp = dest + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, dest)
            return dest
    raise NetlibUnavailable(
        f"could not fetch netlib instance {name!r} from any mirror "
        f"(offline environment?). Tried:\n  " + "\n  ".join(errors)
    )


def load(name, cache_dir=None, mirrors=None, timeout=30):
    """Fetch (vendored/cached/network) and parse one instance.

    The returned LPProblem carries `known_objective` (the published
    optimum, or None) so callers can cross-check solves with
    `verify_objective`.
    """
    from tpdlp_torch.io.mps import read_mps

    path = fetch(name, cache_dir=cache_dir, mirrors=mirrors,
                 timeout=timeout)
    p = read_mps(path)
    p.name = name
    p.known_objective = known_objective(name)
    return p


def fetch_all(names, cache_dir=None, mirrors=None, timeout=30):
    """Fetch many instances; returns {name: path-or-None} (None = failed)."""
    out = {}
    for name in names:
        try:
            out[name] = fetch(name, cache_dir=cache_dir, mirrors=mirrors,
                              timeout=timeout)
        except NetlibUnavailable:
            out[name] = None
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Fetch netlib LP instances into a folder of MPS files."
    )
    ap.add_argument("--dest", default=None,
                    help="target folder (default: the cache dir)")
    ap.add_argument("--names", default=None,
                    help="comma-separated instance names")
    ap.add_argument("--set", choices=("feasible", "infeasible", "all"),
                    default="feasible")
    args = ap.parse_args(argv)
    names = (
        tuple(args.names.split(","))
        if args.names
        else {"feasible": FEASIBLE, "infeasible": INFEASIBLE,
              "all": FEASIBLE + INFEASIBLE}[args.set]
    )
    got = fetch_all(names, cache_dir=args.dest)
    ok = [n for n, p in got.items() if p]
    bad = [n for n, p in got.items() if not p]
    print(f"fetched {len(ok)}/{len(got)} instances into "
          f"{args.dest or default_cache_dir()}")
    if bad:
        print("failed:", ", ".join(bad))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
