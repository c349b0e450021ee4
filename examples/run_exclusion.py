"""Exclusion contour in the (mphi, g) plane — the reference's science
product (arXiv:2107.13568 derives nuSI exclusion limits by comparing
evolved spectra with observation; the fork targets the DSNB).

The workflow the reference runs as a serial Python loop over
``set_parameters(...); evolve()`` (test.py:76-83) is here one batched
launch per grid: evolve every (mphi, g) point at once (``grid_scan``),
score each spectrum against a mock observation with a per-bin Gaussian
log-flux chi^2, and trace the 90% CL exclusion boundary g_excl(mphi)
by log-interpolating each mphi column to Delta-chi^2 = 4.61 (2 dof).

Mock observation: the free-streaming DSNB spectrum (no self-
interaction) with sigma = 0.1 dex per-bin uncertainty over the
detectable window (6 decades below peak) — so the contour answers
"which couplings would have visibly distorted a standard-DSNB
measurement".

Quick mode (default): s-channel-only, 100 bins — seconds anywhere.

Production mode (--production): the reference's DEFAULT configuration —
non_resonant=True AND phiphi=True (every channel the reference enables,
nuSIprop.hpp:166-170) at 500 energy bins (the BASELINE.json metric
point) on the same DSNB science window — run as batched chunked
launches. This is the regime the serial reference would grind through
at ~0.65 s/point x grid; here it is a few compiled launches.

Run: python examples/run_exclusion.py [n_mphi] [n_g] [contour_out.txt]
     python examples/run_exclusion.py --production [n_mphi] [n_g] [out]
                                      [--bins N] [--chunk B] [--sharded]
"""

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import nusiprop_tpu as nu

ap = argparse.ArgumentParser()
ap.add_argument("n_mphi", nargs="?", type=int, default=None)
ap.add_argument("n_g", nargs="?", type=int, default=None)
ap.add_argument("out_path", nargs="?", default=None)
ap.add_argument("--production", action="store_true",
                help="reference-default channel set (non_resonant + "
                     "phiphi) at production resolution")
ap.add_argument("--bins", type=int, default=None,
                help="energy bins [quick: 100, production: 500]")
ap.add_argument("--chunk", type=int, default=32,
                help="points per compiled launch in production mode")
ap.add_argument("--sharded", action="store_true",
                help="shard each chunk over all visible devices")
ap.add_argument("--f32-tables", action="store_true",
                help="use the f32 quadrature alpha build "
                     "(table_dtype='f32') instead of the f64 closed "
                     "forms; on coarse-grid CPU smoke runs it skips the "
                     "very slow LLVM compiles of the batched f64 "
                     "closed-form channel programs")
args = ap.parse_args()

n_mphi = args.n_mphi if args.n_mphi is not None else (16 if args.production
                                                      else 32)
n_g = args.n_g if args.n_g is not None else (16 if args.production else 24)
out_path = args.out_path

SIGMA_DEX = 0.1          # mock per-bin uncertainty on log10 flux
GATE_DECADES = 6.0       # detectable window below the spectral peak
DCHI2_90 = 4.61          # 90% CL, 2 degrees of freedom

if args.production:
    # The reference's DEFAULT channel set — non-resonant
    # t/u/interference channels + spline-backed phi-phi
    # (nuSIprop.hpp:166-170) — on the same DSNB science window as quick
    # mode, at production resolution (500 bins = the BASELINE.json
    # metric point, whose staged programs are the bench's shapes).
    cfg = nu.Config(N_bins_E=args.bins or 500, lEmin=4.0, lEmax=9.0,
                    zmax=5.0, non_resonant=True, phiphi=True,
                    table_dtype="f32" if args.f32_tables else "auto")
    from nusiprop_tpu.models import pp_tables as _ppt

    tables = _ppt.load_default()
else:
    cfg = nu.Config(N_bins_E=args.bins or 100, lEmin=4.0, lEmax=9.0,
                    zmax=5.0, non_resonant=False, phiphi=False)
    tables = None
mntot = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))

# mock observation: free-streaming limit (coupling too weak to matter).
# In production mode, run it THROUGH a chunk-shaped batch so it reuses
# the same compiled batched programs as the scan (an unbatched evolve
# would pay its own cold compile of every staged program).
mock_p = nu.PhysicsParams.create(5e6, 1e-12, mntot, 2.0, 6.0)
if args.production:
    import jax as _jax

    B0 = max(1, min(args.chunk, n_mphi * n_g))
    mock_b = _jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (B0,)), mock_p)
    fs_fla = np.asarray(
        nu.grid_scan(mock_b, cfg, pp_tables=tables).flux_fla)[0]
else:
    fs_fla = np.asarray(
        nu.evolve(mock_p, cfg, pp_tables=tables).flux_fla)
if not np.isfinite(fs_fla).all():
    # g = 1e-12 exercises the weak-coupling guards (specfun.log1p_sq_ratio);
    # a NaN here would silently gate ZERO bins and produce an empty contour
    raise SystemExit("mock observation contains non-finite flux — "
                     "weak-coupling kernel guard regression")
obs = fs_fla.sum(axis=0)                         # observed nu+x flux
gate = obs > obs.max() * 10.0 ** (-GATE_DECADES)
if int(gate.sum()) == 0:
    raise SystemExit("mock observation gated zero bins — degenerate scan")
log_obs = np.log10(np.where(gate, obs, 1.0))
print(f"# mock observation: standard DSNB, {int(gate.sum())} gated bins,"
      f" sigma = {SIGMA_DEX} dex")

# the s-channel resonance E = mphi^2 / (2 m_nu) sweeps the DSNB window
# (1e4-1e9 eV) for mphi ~ 30-1e4 eV; beyond that the spectrum is
# untouched and the exclusion cliff appears (~3e3 eV here). Production
# mode scans the same plane with every reference channel enabled.
mphi_vals = np.geomspace(1e2, 1e4, n_mphi)
g_vals = np.geomspace(1e-11, 1e-5, n_g)
params = nu.param_grid(mphi_vals=mphi_vals, g_vals=g_vals,
                       mntot=mntot, si=2.0, norm=6.0)
n = params.mphi.shape[0]
print(f"# scanning {n} (mphi, g) points, {cfg.N_bins_E} bins, "
      f"channels: {'non_resonant+phiphi (reference default)' if args.production else 's only'}")

t0 = time.perf_counter()
if args.production:
    import jax

    # chunked launches: every chunk reuses ONE compiled batch shape;
    # pad the tail by repeating the last point. --sharded additionally splits each chunk over the mesh.
    B = max(1, min(args.chunk, n))
    outs = []
    for c0 in range(0, n, B):
        chunk = jax.tree.map(lambda x: x[c0:c0 + B], params)
        pad = B - int(chunk.mphi.shape[0])
        if pad:
            chunk = jax.tree.map(
                lambda x: np.concatenate([x, np.repeat(x[-1:], pad, 0)]),
                chunk)
        run = nu.sharded_grid_scan if args.sharded else nu.grid_scan
        res = run(chunk, cfg, pp_tables=tables)
        outs.append(np.asarray(res.flux_fla)[:B - pad if pad else B])
        done = min(c0 + B, n)
        print(f"#   {done}/{n} points, {time.perf_counter() - t0:.1f} s",
              flush=True)
    flx = np.concatenate(outs).sum(axis=1)
else:
    flx = np.asarray(nu.grid_scan(params, cfg).flux_fla).sum(axis=1)
wall = time.perf_counter() - t0
print(f"# grid evolve: {wall:.2f} s ({wall / n * 1e3:.1f} ms/point, "
      f"compile included)")

n_bad = int((~np.isfinite(flx)).sum(axis=None))
if n_bad:
    # NaN scan points would read as "not excluded" through the argmax
    # below — make the degradation loud instead of silent
    print(f"# WARNING: {n_bad} non-finite scan fluxes; affected points "
          "are treated as unconstrained", flush=True)

# per-point Delta-chi^2 vs the (chi^2 = 0) free-streaming observation
log_f = np.log10(np.maximum(flx, 1e-300))
dchi2 = (((log_f - log_obs[None, :]) / SIGMA_DEX) ** 2 * gate).sum(axis=1)
dchi2 = dchi2.reshape(n_mphi, n_g)               # param_grid order

# contour: per mphi column, first g crossing DCHI2_90 (log-g interp).
# dchi2 rises monotonically with g here (more coupling, more distortion)
lg = np.log10(g_vals)
contour = np.full(n_mphi, np.nan)
for i in range(n_mphi):
    c = dchi2[i]
    k = np.argmax(c > DCHI2_90)
    if c[k] > DCHI2_90:                           # column crosses
        if k == 0:
            contour[i] = lg[0]                    # excluded from g_min on
        else:
            t = ((np.log(DCHI2_90) - np.log(c[k - 1]))
                 / (np.log(c[k]) - np.log(c[k - 1])))
            contour[i] = lg[k - 1] + t * (lg[k] - lg[k - 1])

n_excl = int(np.isfinite(contour).sum())
print(f"# 90% CL contour found in {n_excl}/{n_mphi} mphi columns")
print("#  mphi [eV]        g_excl(90% CL)")
rows = []
for i in range(n_mphi):
    if np.isfinite(contour[i]):
        rows.append((mphi_vals[i], 10.0 ** contour[i]))
        print(f"   {mphi_vals[i]:.4e}    {10.0 ** contour[i]:.4e}")

if rows:
    arr = np.array(rows)
    j = int(np.argmin(arr[:, 1]))
    print(f"# strongest exclusion: g > {arr[j, 1]:.3e} at "
          f"mphi = {arr[j, 0]:.3e} eV (the resonance-crossing window)")
if out_path and rows:
    np.savetxt(out_path, np.array(rows),
               header="mphi[eV]  g_excluded_90CL")
    print(f"# contour written to {out_path}")

# Production knobs for bigger grids:
#   nu.sharded_grid_scan(params, cfg)             -> multi-chip mesh
#   nu.checkpointed_grid_scan(params, cfg, path)  -> resumable chunks
