"""Parity gates against GENUINE reference-engine outputs (refbin fixtures).

tests/data/refbin/*.txt were produced by the unmodified reference engine
(/root/reference nuSIprop.hpp:22-563) compiled against the in-tree GSL /
polylogarithm shim (native/refshim) — see tools/make_reference_golden.py,
which refuses to write fixtures unless the shim-built binary first
reproduces the committed tests/data/data_massless.txt BYTE-IDENTICALLY.

Unlike tests/data/data_nonresonant_cpp.txt (our own pinned output), these
are true reference products, so they close the "no NR-channel
validation against the actual reference binary" hole: the
non-resonant fixture here is the first reference-produced spectrum with
non_resonant=true that the JAX engine is gated on.

Fixture battery (constructor args at make_reference_golden.py:48-59):
every case is 100 bins over 1e4..1e9 eV, zmax=5, DSNB source, mphi=3e3 eV
(resonances inside the window), si=2.0, norm=6, mntot=0.1.

Measured agreement (CPU, recorded when the gates were set):
  s-channel f64 (trisolve):    max rel 5.8e-9   (all 300 bins)
  s-channel f32 (rank1_f32):   max rel 3.7e-7   (bins >1e-10 of peak)
  non-resonant f64 (trisolve): max rel 3.0e-6   (all gated bins)
  non-resonant f32 table:      max rel 6.9e-3   (see below — REFERENCE noise)
The s-channel f64 residual is dominated by the reference's own closed-form
roundoff (its GL3-rescued corners agree to ~1e-11); the NR residual matches
the independent C++ twin's 3.3e-6, i.e. it is the reference's cancellation
noise, not ours.

The NR f32 case deliberately carries a LOOSE vs-reference gate (2e-2, not
the 1e-3 physics gate): at g=0.3 the closed-form alpha entries feeding the
lowest bins carry ~4e-2 sub-resonance cancellation noise IN THE REFERENCE
(and in any faithful f64 twin — ours matches it to 3e-6), while the f32
matrix-element GL build is referee-exact there (adaptive scipy dblquad,
rel <= 2.4e-7 on sampled entries incl. the worst (1,2) corner —
test_kernels_nr_f32::test_sampled_entries_vs_scipy_referee[refbin-nr]).
The measured 6.8e-3 flux residual versus the reference is therefore the
reference's own kernel noise surfacing, with our f32 flux the closer to
truth; the gate exists to catch regressions an order of magnitude past
that envelope, not to assert reference-fidelity the reference itself
cannot support at this coupling.
"""

import pathlib

import numpy as np
import pytest

from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models import transport

REFBIN = pathlib.Path(__file__).parent / "data" / "refbin"

# name -> (constructor deltas, f64 tight gate, f32 tight gate)
CASES = {
    # s-channel, resonances inside the DSNB window
    "s_mphi3e3": (dict(), 1e-7, 1e-5),
    # Dirac + inverted ordering: 1/2-symmetry factors + IO quartic branch
    "s_dirac_io": (dict(majorana=False, normal_ordering=False), 1e-7, 1e-5),
    # flav=0: PMNS row selection
    "s_flav0": (dict(flav=0), 1e-7, 1e-5),
    # full non-resonant channel set at strong coupling — the first
    # reference-produced non_resonant=true spectrum gating this engine.
    # f32 gate is bounded by the REFERENCE's own closed-form noise at this
    # coupling (module docstring) — not by our build's accuracy.
    "nr_mphi3e3": (dict(non_resonant=True, g=0.3), 1e-5, 2e-2),
}

# phi-phi production on top of the strong-coupling non-resonant point: the
# reference ran with OUR generated full-resolution spline tables
# (make_tables.py --preset full --bin-dir, fed through its own
# interp.hpp loader — the shapes are hardcoded at nuSIprop.hpp:168-169).
# The committed engine ships the medium-resolution tables, so the gates
# absorb the measured medium-vs-full interpolation delta alongside the
# reference's closed-form noise (the nr_mphi3e3 envelope).
PP_CASE = "pp_mphi3e3"
if (REFBIN / f"{PP_CASE}.txt").exists():
    # measured (CPU, when the fixture landed): f64 max rel 3.0e-6 — the
    # medium-vs-full table delta is subdominant to the nr noise envelope;
    # f32 max rel 6.8e-3 — the nr closed-form-noise bound, as for
    # nr_mphi3e3.
    CASES[PP_CASE] = (
        dict(non_resonant=True, g=0.3, phiphi=True), 1e-5, 2e-2)

PHYSICS_GATE = 1e-3  # BASELINE.json per-bin acceptance


def _evolve(name: str, table_dtype: str):
    deltas, _, _ = CASES[name]
    g = deltas.get("g", 1e-5)
    non_resonant = deltas.get("non_resonant", False)
    march = ("trisolve" if (table_dtype == "f64" or non_resonant)
             else "rank1_f32")
    cfg = Config(
        N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
        flav=deltas.get("flav", 2),
        majorana=deltas.get("majorana", True),
        normal_ordering=deltas.get("normal_ordering", True),
        non_resonant=non_resonant, phiphi=deltas.get("phiphi", False),
        march=march, table_dtype=table_dtype,
    )
    p = PhysicsParams.create(3e3, g, 0.1, 2.0, 6.0)
    pp = None
    if cfg.phiphi:
        # the reference ran with the full-resolution splines; the engine
        # ships medium — the case gates absorb the measured medium-vs-full
        # delta (1.5e-5, tools/validate_full_tables.py) on top of the nr
        # noise envelope
        from nusiprop_tpu.models import pp_tables as _ppt

        pp = _ppt.load_default()
    return transport.evolve(p, cfg, pp_tables=pp)


@pytest.fixture(scope="module")
def ref():
    return {name: np.loadtxt(REFBIN / f"{name}.txt") for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_energy_grid_matches_reference(name, ref):
    res = _evolve(name, "f64")
    np.testing.assert_allclose(np.asarray(res.E_nu), ref[name][:, 0],
                               rtol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_f64_flux_matches_reference(name, ref):
    """Full-f64 trisolve vs the genuine reference engine, every bin."""
    _, tight, _ = CASES[name]
    flx = np.asarray(_evolve(name, "f64").flux_fla)
    rflx = ref[name][:, 1:].T
    rel = np.abs(flx - rflx) / np.abs(rflx)
    assert rel.max() < PHYSICS_GATE, f"max rel {rel.max():.3e}"
    assert rel.max() < tight, (
        f"max rel {rel.max():.3e} — regression past the measured quality; "
        "loosen only with evidence")


@pytest.mark.parametrize("name", list(CASES))
def test_f32_flux_matches_reference_within_envelope(name, ref):
    """Float32 paths vs the genuine reference, gated to bins within
    10 decades of the peak (below that the DSNB tail sits under the f32
    representable envelope — chip_smoke.py's convention)."""
    _, _, tight = CASES[name]
    flx = np.asarray(_evolve(name, "f32").flux_fla)
    rflx = ref[name][:, 1:].T
    gate = np.abs(rflx) > np.abs(rflx).max() * 1e-10
    rel = (np.abs(flx - rflx) / np.abs(rflx))[gate]
    assert gate.sum() > 150  # the window itself must stay populated
    # physics gate applies where the reference itself is clean; where the
    # case gate is looser, the bound is the reference's own noise
    assert rel.max() < max(PHYSICS_GATE, tight), f"max rel {rel.max():.3e}"
    assert rel.max() < tight, (
        f"max rel {rel.max():.3e} — regression past the measured quality")
