#!/usr/bin/env python
"""Generate golden spectra with the GENUINE reference engine.

Compiles the unmodified reference translation unit (nuSIprop.hpp + aux.hpp +
interp.hpp from the read-only reference checkout) against the native/refshim
GSL / polylogarithm shims via tools/ref_golden.cpp, validates the build by
reproducing tests/data/data_massless.txt BYTE-IDENTICALLY (the output file
committed by the reference authors — any shim error in the dilog / LU /
quartic layers breaks this), then runs a battery of configurations and
writes full-precision fixtures to tests/data/refbin/.

The fixtures are committed; this script only needs re-running when the
battery changes. Configurations were screened so the reference runs them
WARNING-FREE (its closed forms print "Negative cross section ...
roundoff" complaints on stderr in deep sub-resonance corners; fixtures
avoid that regime, where the reference's own numbers are cancellation
noise — see docs/DESIGN.md and docs/VALIDATION.md).

Usage:
    python tools/make_reference_golden.py [--ref /root/reference]
        [--with-phiphi BIN_DIR]   # directory holding alphatilde_phiphi.bin
                                  # + alpha_phiphi.bin at the reference's
                                  # hardcoded full resolution
                                  # (nuSIprop.hpp:168-169); e.g. produced by
                                  # make_tables.py --preset full --bin-dir
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
DRIVER = REPO / "tools" / "ref_golden.cpp"
SHIM = REPO / "native" / "refshim"
OUT_DIR = REPO / "tests" / "data" / "refbin"

# mntot of the committed massless golden: exactly sqrt(dm21)+sqrt(dm31)
# (test.py:20), i.e. a massless lightest neutrino.
MNTOT_MASSLESS = "0.05875374673382991"

# argv layout: mphi g mntot si norm majorana non_resonant normal_ordering
#              N_bins_E lEmin lEmax zmax flav phiphi
BATTERY = {
    # s-channel, resonances inside the DSNB window (E_res = mphi^2/2mn).
    "s_mphi3e3": "3e3 1e-5 0.1 2.0 6 1 0 1 100 4 9 5 2 0",
    # Dirac + inverted ordering exercise the 1/2-symmetry factors and the
    # IO mass branch of the quartic.
    "s_dirac_io": "3e3 1e-5 0.1 2.0 6 0 0 0 100 4 9 5 2 0",
    # flav=0 exercises the PMNS row selection.
    "s_flav0": "3e3 1e-5 0.1 2.0 6 1 0 1 100 4 9 5 0 0",
    # Non-resonant channel set (t/u/interference), strong coupling,
    # resonance inside the window so all kinematic coordinates are O(1).
    "nr_mphi3e3": "3e3 0.3 0.1 2.0 6 1 1 1 100 4 9 5 2 0",
}

# phi-phi production on top of the strong-coupling point; requires the
# full-resolution tables (the reference hardcodes their shapes,
# nuSIprop.hpp:168-169). non_resonant MUST be 1: the reference skips all
# non-s channels — including phi-phi — when non_resonant is false
# (nuSIprop.hpp:793,972,1277), and only loads the splines under
# non_resonant && phiphi (:166).
PHIPHI_CASE = ("pp_mphi3e3", "3e3 0.3 0.1 2.0 6 1 1 1 100 4 9 5 2 1")


def build(ref: pathlib.Path, exe: pathlib.Path) -> None:
    cmd = [
        "g++", "-O2", "-std=gnu++17",
        "-I", str(SHIM), "-I", str(ref),
        str(DRIVER), "-o", str(exe),
    ]
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def run_case(exe: pathlib.Path, args: str, out: pathlib.Path,
             extra: list[str] | None = None,
             cwd: pathlib.Path | None = None) -> None:
    cmd = [str(exe)] + args.split() + (extra or [])
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd)
    if res.returncode != 0:
        sys.exit(f"reference run failed for {out.name}: {res.stderr}")
    if res.stderr.strip():
        sys.exit(
            f"reference printed warnings for {out.name} — pick a cleaner "
            f"configuration:\n{res.stderr[:2000]}"
        )
    out.write_text(res.stdout)
    print(f"  wrote {out} ({len(res.stdout.splitlines())} lines)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", default="/root/reference", type=pathlib.Path)
    ap.add_argument("--with-phiphi", type=pathlib.Path, default=None,
                    help="dir with full-res alphatilde_phiphi.bin + "
                         "alpha_phiphi.bin")
    args = ap.parse_args()

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        exe = pathlib.Path(td) / "ref_golden"
        build(args.ref, exe)

        # Shim validation: reproduce the committed reference output exactly.
        massless = pathlib.Path(td) / "massless.txt"
        run_case(exe, f"5e6 1e-6 {MNTOT_MASSLESS} 2.0 6 1 0 1 100 4 9 5 2 0",
                 massless, extra=["--golden-fmt"])
        committed = (REPO / "tests" / "data" / "data_massless.txt").read_bytes()
        if massless.read_bytes() != committed:
            sys.exit("shim-built reference does NOT reproduce "
                     "data_massless.txt — refusing to write fixtures")
        print("  shim validated: data_massless.txt reproduced byte-identically")

        for name, case in BATTERY.items():
            run_case(exe, case, OUT_DIR / f"{name}.txt")

        if args.with_phiphi is not None:
            # The reference opens xsec/*_phiphi.bin relative to its CWD.
            workdir = pathlib.Path(td) / "pp"
            (workdir / "xsec").mkdir(parents=True)
            for f in ("alphatilde_phiphi.bin", "alpha_phiphi.bin"):
                src = args.with_phiphi / f
                if not src.exists():
                    sys.exit(f"missing {src}")
                shutil.copy(src, workdir / "xsec" / f)
            name, case = PHIPHI_CASE
            run_case(exe, case, OUT_DIR / f"{name}.txt", cwd=workdir)

    print("done")


if __name__ == "__main__":
    main()
