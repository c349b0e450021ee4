"""DSNB benchmark run — the configuration that produced the reference's
golden output (mirrors /root/reference/test.py:6-59).

Evolves the Diffuse Supernova Neutrino Background flux with a 5 MeV-scale
scalar mediator, s-channel only, massless lightest neutrino (NO), and
writes the spectrum in the reference's exact output format. Also runs a
small (g, mphi) grid scan — the batched replacement for the
reference's serial set_parameters()+evolve() loop.

Run: python examples/run_dsnb.py [outfile]
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import nusiprop_tpu as nu
from nusiprop_tpu.utils.io import save_spectrum

evolver = nu.Evolver(
    mphi=5e6,            # Mediator mass [eV]
    si=2.0,              # Spectral index
    norm=6,              # Free-streaming flux normalization at 100 TeV
    majorana=True,
    normal_ordering=True,
    N_bins_E=100,
    lEmin=4,
    lEmax=9,
    zmax=5,
    mntot=0.0 + np.sqrt(7.42e-5) + np.sqrt(2.514e-3),  # massless m1, NO
    g=1e-6,
    non_resonant=False,
    phiphi=False,
    flav=2,
)

evolver.evolve()
flx = evolver.get_flux_fla()
energies = evolver.get_energies()

print("#Energy[eV]  nu_e flux   nu_mu flux  nu_tau flux")
for energy, fe, fm, ft in zip(energies, flx[0], flx[1], flx[2]):
    print("%.5e  %.4e  %.4e  %.4e" % (energy, fe, fm, ft))

print("# energy conservation drift:",
      evolver.check_energy_conservation())

if len(sys.argv) > 1:
    save_spectrum(sys.argv[1], energies, flx)
    print(f"# wrote {sys.argv[1]}")

# --- batched parameter scan: one compiled launch for the whole grid ---
params = nu.param_grid(
    mphi_vals=np.geomspace(1e5, 1e8, 8),
    g_vals=np.geomspace(1e-7, 1e-5, 4),
    mntot=float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3)),
    si=2.0,
    norm=6.0,
)
res = nu.grid_scan(params, evolver.config)
print(f"# grid scan: {params.mphi.shape[0]} points -> flux_fla "
      f"{res.flux_fla.shape}")
