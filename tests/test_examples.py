"""The examples (reference-driver equivalents, C23) must run end to end."""

import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=600):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=timeout,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": "/root",
             # pin the shipped medium tables (same reason as
             # conftest.py: a locally regenerated full-resolution
             # table would dominate the example's wall time)
             "NUSIPROP_PP_TABLES": str(ROOT / "data"
                                       / "pp_tables_medium.npz")},
        cwd=ROOT, check=True,
    )


def test_run_dsnb(tmp_path):
    out = _run("run_dsnb.py", str(tmp_path / "spec.txt"))
    assert "grid scan: 32 points" in out.stdout
    data = np.loadtxt(tmp_path / "spec.txt", skiprows=1)
    assert data.shape == (100, 4)
    golden = np.loadtxt(ROOT / "tests" / "data" / "data_massless.txt",
                        skiprows=1)
    # the example IS the golden configuration
    np.testing.assert_allclose(data[:, 1:], golden[:, 1:], rtol=2e-4)


def test_run_highenergy():
    out = _run("run_highenergy.py")
    lines = [l for l in out.stdout.splitlines() if not l.startswith("#")]
    vals = np.array([[float(x) for x in l.split()] for l in lines])
    assert vals.shape == (100, 4)
    assert np.isfinite(vals).all() and (vals[:, 1:] > 0).all()


def test_run_grid_scan():
    out = _run("run_grid_scan.py", "4", "2")
    assert "scanning 8 (g, mphi) points" in out.stdout
    assert "us/point" in out.stdout
    assert "deepest absorption" in out.stdout


def test_run_exclusion(tmp_path):
    out = _run("run_exclusion.py", "6", "8", str(tmp_path / "contour.txt"))
    assert "scanning 48 (mphi, g) points" in out.stdout
    assert "strongest exclusion" in out.stdout
    arr = np.loadtxt(tmp_path / "contour.txt")
    arr = np.atleast_2d(arr)
    # most columns cross 90% CL in the resonance window; the contour is
    # a physical exclusion boundary: tiny couplings, monotone cliff at
    # the high-mphi end
    assert arr.shape[0] >= 4 and arr.shape[1] == 2
    assert (arr[:, 1] > 1e-12).all() and (arr[:, 1] < 1e-6).all()
    assert arr[-1, 1] == arr[:, 1].max()  # cliff at the window edge


def test_run_fit():
    out = _run("run_fit.py", "150")
    assert "recovered:" in out.stdout
    ridge_line = [l for l in out.stdout.splitlines()
                  if l.startswith("ridge invariant g/mphi")]
    assert ridge_line, out.stdout
    # the ridge invariant must be recovered to <1%
    pct = float(ridge_line[0].rsplit("(", 1)[1].split("%")[0])
    assert pct < 1.0, out.stdout
    assert "Fisher eigenvalues" in out.stdout


def test_run_exclusion_production_mode(tmp_path):
    """The reference-default channel set (non_resonant + phiphi) as one
    chunked batched scan — tiny grid/bins so the CPU f64 build stays
    test-sized."""
    out = _run("run_exclusion.py", "--production", "3", "4",
               str(tmp_path / "contour.txt"), "--bins", "40",
               "--chunk", "6", "--f32-tables", timeout=1200)
    assert "non_resonant+phiphi (reference default)" in out.stdout
    assert "scanning 12 (mphi, g) points" in out.stdout
    assert "grid evolve" in out.stdout
    # The g=1e-12 free-streaming mock exercises the weak-coupling kernel
    # guards (specfun.log1p_sq_ratio): a NaN-poisoned mock would gate 0
    # bins and silently produce an empty/garbage contour (the example
    # itself aborts on non-finite flux since the guard landed).
    gated = [l for l in out.stdout.splitlines() if "gated bins" in l]
    assert gated, out.stdout
    n_gated = int(gated[0].split("DSNB,")[1].split("gated")[0])
    assert n_gated > 0, out.stdout
    assert "WARNING" not in out.stdout, out.stdout
    contour = np.loadtxt(tmp_path / "contour.txt")
    assert contour.size and np.isfinite(contour).all()
