"""Validate a generated phi-phi table file.

Two checks:
  1. spot-check >= N entries of both tables against adaptive scipy
     dblquad of the same integrand (the reference's offline method,
     xsec/tables_phiphi.py:24-59);
  2. end-to-end: evolve the phiphi battery configuration with this file
     vs the shipped medium-resolution tables and report the flux delta
     (the interpolation-resolution error).

Usage: python tools/validate_full_tables.py --npz /tmp/pp_tables_full.npz
       [--spots 60] [--seed 0]
"""

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def spot_check(npz_path, n_spots, seed):
    from scipy import integrate

    from tools.make_tables import dsigma_np

    d = np.load(npz_path)
    rng = np.random.default_rng(seed)
    worst_at = worst_a = 0.0

    def _s_int(t, T):
        lo = max(4.0, (t * t / (-1.0 - t)) if t < -1.0 else 4.0)
        lo = min(lo, T)
        val, _ = integrate.quad(lambda s: dsigma_np(s, t), lo, T,
                                epsabs=1e-300, epsrel=1e-9, limit=200)
        return val

    def at_entry_quad(T, log10d):
        # alphatilde entry by adaptive quadrature (tables_phiphi.py:24-37)
        delta = 10.0 ** log10d
        t_plus, t_minus = -T, -T / delta
        val, _ = integrate.quad(lambda t: _s_int(t, T), t_plus, t_minus,
                                epsabs=1e-300, epsrel=1e-8, limit=200)
        return val

    def a_entry_quad(S, n, log10d):
        # alpha entry (tables_phiphi.py:43-59)
        delta = 10.0 ** log10d
        s_min = S / delta
        t_minus = -s_min / delta ** n
        t_plus = t_minus * delta
        lo = max(s_min, 4.0)

        def s_int(t):
            l2 = max(lo, (t * t / (-1.0 - t)) if t < -1.0 else lo)
            l2 = min(l2, S)
            val, _ = integrate.quad(lambda s: dsigma_np(s, t), l2, S,
                                    epsabs=1e-300, epsrel=1e-9, limit=200)
            return val

        val, _ = integrate.quad(s_int, t_plus, t_minus, epsabs=1e-300,
                                epsrel=1e-8, limit=200)
        return val

    nt, nd = d["at_values"].shape
    checked_at = 0
    for _ in range(n_spots // 2):
        i, j = int(rng.integers(nt)), int(rng.integers(nd))
        got = d["at_values"][i, j]
        want = at_entry_quad(float(d["at_tplus"][i]),
                             float(d["at_log10d"][j]))
        if want == 0.0:
            assert abs(got) < 1e-300, (i, j, got)
            continue
        rel = abs(got / want - 1.0)
        worst_at = max(worst_at, rel)
        checked_at += 1
    print(f"alphatilde spots: {checked_at}, worst rel {worst_at:.3e}")

    ns, nn, nd2 = d["a_values"].shape
    checked_a = 0
    for _ in range(n_spots - n_spots // 2):
        i = int(rng.integers(ns))
        j = int(rng.integers(nn))
        k = int(rng.integers(nd2))
        got = d["a_values"][i, j, k]
        want = a_entry_quad(float(d["a_splus"][i]), float(d["a_n"][j]),
                            float(d["a_log10d"][k]))
        if abs(want) < 1e-37:       # generator zeroes below 1e-37
            assert got == 0.0 or abs(got) < 1e-30, (i, j, k, got, want)
            continue
        rel = abs(got / want - 1.0)
        worst_a = max(worst_a, rel)
        checked_a += 1
    print(f"alpha spots: {checked_a}, worst rel {worst_a:.3e}")
    return worst_at, worst_a


def flux_delta(npz_path):
    import jax

    jax.config.update("jax_platforms", "cpu")

    from nusiprop_tpu.config import Config, PhysicsParams
    from nusiprop_tpu.models import pp_tables as ppt
    from nusiprop_tpu.models import transport

    cfg = Config(N_bins_E=100, lEmin=9.0, lEmax=14.0, non_resonant=True,
                 phiphi=True, source="powerlaw", march="trisolve",
                 table_dtype="f64")
    p = PhysicsParams.create(6e5, 1e-2, 0.1, 2.5, 1.0)
    full = np.asarray(transport.evolve(
        p, cfg, pp_tables=ppt.load_npz(str(npz_path))).flux_fla)
    med = np.asarray(transport.evolve(
        p, cfg, pp_tables=ppt.load_npz(
            str(ROOT / "data" / "pp_tables_medium.npz"))).flux_fla)
    pk = np.abs(full).max()
    gate = np.abs(full) > pk * 1e-10
    rel = np.abs(med - full)[gate] / np.abs(full)[gate]
    print(f"medium-vs-full flux delta: max {rel.max():.3e}, "
          f"mean {rel.mean():.3e} (gated at 1e-10 of peak)")
    return rel.max()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", required=True)
    ap.add_argument("--spots", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-flux", action="store_true")
    args = ap.parse_args()

    spot_check(args.npz, args.spots, args.seed)
    if not args.skip_flux:
        flux_delta(args.npz)


if __name__ == "__main__":
    main()
