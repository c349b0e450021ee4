"""Gradient-based recovery of self-interaction parameters from a
spectrum — a workflow the serial C++ reference cannot run at all.

The reference maps exclusion contours by rasterizing a dense (g, mphi)
grid of forward evolves (test.py:76-83). Because this engine is one
pure JAX program, ``jax.grad`` differentiates flux with respect to the
physics parameters exactly (reverse-mode through the kernel tables,
the mass solve, and the implicit redshift march — validated against
finite differences to ~8 digits, tests/test_grad.py), so maximum-
likelihood parameter recovery takes ~10^2 evolve-equivalents instead
of a ~10^4-point raster.

Demo: evolve a "observed" spectrum at hidden (g*, mphi*), then recover
both from a deliberately wrong initialization with Adam in log10
space, as ONE compiled lax.scan of gradient steps.

Run: python examples/run_fit.py [steps]
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import nusiprop_tpu as nu

steps = int(sys.argv[1]) if len(sys.argv) > 1 else 150

cfg = nu.Config(N_bins_E=60, lEmin=4.0, lEmax=9.0, zmax=5.0,
                non_resonant=False, phiphi=False)
mntot = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))

true = nu.PhysicsParams.create(mphi=6e5, g=1e-2, mntot=mntot, si=2.0,
                               norm=6.0)
target = nu.evolve(true, cfg).flux_fla
print(f"hidden truth:  g = {float(true.g):.4e}   mphi = "
      f"{float(true.mphi):.4e} eV")

init = nu.PhysicsParams.create(mphi=3e6, g=3e-3, mntot=mntot, si=2.0,
                               norm=6.0)
print(f"start:         g = {float(init.g):.4e}   mphi = "
      f"{float(init.mphi):.4e} eV")

t0 = time.perf_counter()
res = nu.fit(cfg, target, init, fit_fields=("g", "mphi"), steps=steps,
             learning_rate=0.08)
wall = time.perf_counter() - t0

g_hat, m_hat = float(res.params.g), float(res.params.mphi)
print(f"recovered:     g = {g_hat:.4e}   mphi = {m_hat:.4e} eV")
print(f"log10 errors:  dg = {np.log10(g_hat / float(true.g)):+.4f}   "
      f"dmphi = {np.log10(m_hat / float(true.mphi)):+.4f}")
print(f"loss: {float(res.loss):.3e} (start {float(res.history[0]):.3e}) "
      f"in {steps} Adam steps, {wall:.1f} s wall (compile included)")

# The fit lands on the physical degeneracy ridge, not a failure: with
# a ~massless lightest state this configuration sits far below the
# s-channel resonance, where the spectrum depends on g and mphi only
# through g/mphi — equal log10 offsets above are the ridge direction.
# The invariant is recovered to ~0.1%; pinning both parameters
# individually needs data crossing the resonance (or fixing one).
r_true = float(true.g) / float(true.mphi)
r_hat = g_hat / m_hat
print(f"ridge invariant g/mphi: true {r_true:.4e}  recovered {r_hat:.4e}"
      f"  ({abs(r_hat / r_true - 1.0) * 100:.2f}% off)")

# The Fisher matrix quantifies the ridge the fit walked: its small
# eigenvalue's eigenvector IS the flat (1,1)/sqrt(2) direction.
F, _ = nu.fisher(cfg, res.params, fit_fields=("g", "mphi"))
w, v = np.linalg.eigh(np.asarray(F))
print(f"Fisher eigenvalues (log10-space): {w[0]:.3e}, {w[1]:.3e} "
      f"(ratio {w[0] / w[1]:.1e}); flat direction "
      f"[{v[0, 0]:+.3f}, {v[1, 0]:+.3f}] ~ the g/mphi ridge")
