"""Production-scale (g, mphi) exclusion-grid scan — the flagship workflow.

The reference scans parameter space with a serial Python loop of
``set_parameters(...); evolve()`` (test.py:76-83), one ~9 ms C++ solve
at a time. Here the WHOLE grid is one batched, jit-compiled launch.
march="auto" runs the float64 rank1 march; pass march="rank1_f32" for
the float32 free-streaming-preconditioned march with the float32
kernel-table build (~1e-6 from the f64 march on every bin within 10
decades of peak).

Run: python examples/run_grid_scan.py [n_mphi] [n_g]
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import nusiprop_tpu as nu

n_mphi = int(sys.argv[1]) if len(sys.argv) > 1 else 64
n_g = int(sys.argv[2]) if len(sys.argv) > 2 else 16

cfg = nu.Config(
    N_bins_E=500, lEmin=4.0, lEmax=9.0, zmax=5.0,
    non_resonant=False, phiphi=False,
)
params = nu.param_grid(
    mphi_vals=np.geomspace(1e5, 1e8, n_mphi),
    g_vals=np.geomspace(1e-4, 1e-2, n_g),
    mntot=float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3)),
    si=2.0,
    norm=6.0,
)
n = params.mphi.shape[0]
print(f"# scanning {n} (g, mphi) points, {cfg.N_bins_E} bins")

t0 = time.perf_counter()
res = nu.grid_scan(params, cfg)          # one compiled launch
flx = np.asarray(res.flux_fla)           # (n, 3, NE)
wall = time.perf_counter() - t0
print(f"# first call (incl. compile): {wall:.2f} s")

t0 = time.perf_counter()
flx = np.asarray(nu.grid_scan(params, cfg).flux_fla)
wall = time.perf_counter() - t0
print(f"# warm call: {wall * 1e3:.1f} ms  ({wall / n * 1e6:.1f} us/point)")

# summary observable: flux suppression at the peak-absorption bin
E = np.asarray(res.E_nu)
if E.ndim == 2:  # grid results carry the (identical) grid per point
    E = E[0]
fs = flx[np.argmax(params.g == params.g.min())]  # weakest-coupling ref
supp = flx.sum(axis=1) / np.maximum(fs.sum(axis=0)[None, :], 1e-300)
imin = np.unravel_index(np.argmin(supp), supp.shape)
print(f"# deepest absorption: point {imin[0]} "
      f"(mphi={float(params.mphi[imin[0]]):.3e} eV, "
      f"g={float(params.g[imin[0]]):.1e}) at E={E[imin[1]]:.3e} eV, "
      f"surviving fraction {supp[imin]:.3e}")

# On a multi-chip mesh, shard the batch across devices instead:
#   res = nu.sharded_grid_scan(params, cfg)
# (scan points ride independent shards; no collectives needed.)

# For very long scans, checkpoint/resume chunk by chunk:
#   res = nu.checkpointed_grid_scan(params, cfg, "scan.npz", chunk=256)
