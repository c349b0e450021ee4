"""API-surface behavior: parity with the reference Python wrapper quirks."""

import numpy as np
import pytest

import nusiprop_tpu as nu

pytestmark = pytest.mark.smoke

GOLDEN_KW = dict(
    mphi=5e6, g=1e-6, mntot=float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3)),
    si=2.0, norm=6, N_bins_E=40, lEmin=4, lEmax=9, zmax=5,
    non_resonant=False, phiphi=False,
)


def test_unevolved_flux_warns_and_returns_zeros():
    ev = nu.Evolver(**GOLDEN_KW)
    with pytest.warns(UserWarning, match="not evolved"):
        flx = ev.get_flux_fla()
    assert flx.shape == (3, 40)
    assert (flx == 0).all()


def test_set_parameters_invalidates():
    ev = nu.Evolver(**GOLDEN_KW)
    ev.evolve()
    assert ev.evolved
    ev.set_parameters(g=2e-6)
    assert not ev.evolved
    assert ev.g == 2e-6
    with pytest.warns(UserWarning):
        ev.get_flux()


def test_public_field_setters():
    ev = nu.Evolver(**GOLDEN_KW)
    ev.mphi = 6e5
    ev.norm = 3.0
    assert ev.mphi == 6e5 and ev.norm == 3.0
    assert not ev.evolved


def test_mass_vs_flavor_rotation_consistency():
    ev = nu.Evolver(**GOLDEN_KW)
    ev.evolve()
    from nusiprop_tpu.models.mixing import pmns_sq

    W = pmns_sq(True)
    np.testing.assert_allclose(
        ev.get_flux_fla(), W @ ev.get_flux(), rtol=1e-12
    )
    # unitarity: flavor-summed == mass-summed
    np.testing.assert_allclose(
        ev.get_flux_fla().sum(0), ev.get_flux().sum(0), rtol=1e-10
    )


def test_interp_flux_matches_bins():
    ev = nu.Evolver(**GOLDEN_KW)
    ev.evolve()
    E = ev.get_energies()
    fla = ev.get_flux_fla()
    # at bin centers, interpolation must return the bin values
    np.testing.assert_allclose(ev.interp_flux_el(E[5:10]), fla[0, 5:10], rtol=1e-10)
    np.testing.assert_allclose(ev.interp_flux_mu(E[5:10]), fla[1, 5:10], rtol=1e-10)
    np.testing.assert_allclose(ev.interp_flux_ta(E[5:10]), fla[2, 5:10], rtol=1e-10)


def test_interp_flux_raises_out_of_range():
    """Reference parity: scipy interp1d with no fill_value raises outside
    the bin-center range (nuSIprop.pyx:120-128)."""
    ev = nu.Evolver(**GOLDEN_KW)
    ev.evolve()
    E = ev.get_energies()
    with pytest.raises(ValueError, match="interpolation range"):
        ev.interp_flux_el(E[0] * 0.5)
    with pytest.raises(ValueError, match="interpolation range"):
        ev.interp_flux_ta(np.array([E[3], E[-1] * 2.0]))


def test_pyprop_alias():
    assert nu.pyprop is nu.Evolver


def test_default_parity_with_reference():
    """Config() defaults pin the reference pyx defaults (nuSIprop.pyx:47-52);
    Config.cpp_defaults() pins the C++ ctor defaults (nuSIprop.hpp:61-68),
    which differ in exactly one flag: phiphi."""
    import dataclasses

    cfg = nu.Config()
    assert (cfg.majorana, cfg.non_resonant, cfg.normal_ordering) == (
        True, True, True)
    assert (cfg.N_bins_E, cfg.lEmin, cfg.lEmax, cfg.zmax, cfg.flav) == (
        300, 12.0, 17.0, 5.0, 2)
    assert cfg.phiphi is True  # nuSIprop.pyx:52

    cpp = nu.Config.cpp_defaults()
    assert cpp.phiphi is False  # nuSIprop.hpp:65
    # ... and ONLY phiphi differs
    assert dataclasses.replace(cpp, phiphi=True) == cfg

    # the Evolver constructor signature follows the pyx defaults too
    import inspect

    sig = inspect.signature(nu.Evolver.__init__)
    defaults = {k: v.default for k, v in sig.parameters.items()
                if v.default is not inspect.Parameter.empty}
    for key in ("majorana", "non_resonant", "normal_ordering", "N_bins_E",
                "lEmin", "lEmax", "zmax", "flav", "phiphi"):
        assert defaults[key] == getattr(cfg, key), key
    assert defaults["norm"] == 1  # nuSIprop.pyx:49


def test_config_validation():
    with pytest.raises(ValueError):
        nu.Config(flav=5)
    with pytest.raises(ValueError):
        nu.Config(source="nope")
    with pytest.raises(ValueError):
        nu.Config(lEmin=9, lEmax=4)


def test_grid_matches_reference_construction():
    from nusiprop_tpu.config import Config
    from nusiprop_tpu.models import grids

    cfg = Config(N_bins_E=100, lEmin=4, lEmax=9, zmax=5, non_resonant=False,
                 phiphi=False)
    gr = grids.build(cfg)
    # N_steps_z = ln(1+zmax)/ln(ratio) + 2 with int truncation
    assert gr.N_steps_z == 17
    # z grid locked to the bin ratio
    ratio = gr.Emax[0] / gr.Emin[0]
    np.testing.assert_allclose(1 + np.asarray(gr.z[1:]),
                               np.asarray((1 + gr.z[:-1]) * ratio), rtol=1e-14)
    # extended bins continue the top bin redshifted
    ne, nz = 100, 17
    assert gr.Emin_ext.shape == (ne + nz - 2,)
    np.testing.assert_allclose(
        gr.Emin_ext[ne + 3], gr.Emin[ne - 1] * (1 + gr.z[4]), rtol=1e-14
    )


def test_masses_bisection():
    from nusiprop_tpu.models.masses import mass_spectrum

    # NO with plenty of mass budget
    mn = np.asarray(mass_spectrum(0.3, True))
    assert abs(mn.sum() - 0.3) < 1e-12
    assert abs((mn[1] ** 2 - mn[0] ** 2) - 7.42e-5) < 1e-12
    assert abs((mn[2] ** 2 - mn[0] ** 2) - 2.514e-3) < 1e-12
    # IO
    mn = np.asarray(mass_spectrum(0.3, False))
    assert abs(mn.sum() - 0.3) < 1e-12
    assert abs((mn[1] ** 2 - mn[0] ** 2) - 7.42e-5) < 1e-10
    assert mn[2] < mn[0] < mn[1]
    # critical case: mntot at the NO minimum -> massless lightest (floored)
    mn = np.asarray(mass_spectrum(float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3)), True))
    assert mn[0] < 1e-9
    assert mn[0] > 0


def test_per_index_getters(capsys):
    """get_flux(i,j)/get_flux_fla(i,j)/get_energy(i): scalar access with
    the reference's out-of-range stderr warning + return-0 semantics
    (nuSIprop.hpp:359-429)."""
    ev = nu.Evolver(**GOLDEN_KW).evolve()
    flux = ev.get_flux()
    fla = ev.get_flux_fla()
    E = ev.get_energies()
    assert ev.get_flux(1, 7) == flux[1, 7]
    assert ev.get_flux_fla(2, 0) == fla[2, 0]
    assert ev.get_energy(3) == E[3]
    capsys.readouterr()
    # out-of-range: 0 + a stderr warning, one case per check branch
    for call, frag in [
        (lambda: ev.get_flux(3, 0), "mass eigenstate 3"),
        (lambda: ev.get_flux_fla(-1, 0), "flavor eigenstate -1"),
        (lambda: ev.get_flux(0, -2), "energy bin -2"),
        (lambda: ev.get_flux_fla(0, 40), "only 40 bins"),
        (lambda: ev.get_energy(-1), "bin -1"),
        (lambda: ev.get_energy(41), "only 40 bins"),
    ]:
        assert call() == 0.0
        err = capsys.readouterr().err
        assert frag in err and "Zero will be returned" in err, (frag, err)


def test_per_index_getters_unevolved(capsys):
    ev = nu.Evolver(**GOLDEN_KW)
    with pytest.warns(UserWarning, match="not evolved"):
        assert ev.get_flux(0, 0) == 0.0
    with pytest.warns(UserWarning, match="not evolved"):
        assert ev.get_flux_fla(1, 2) == 0.0


def test_single_index_getter_returns_row(capsys):
    """get_flux(i) / get_flux_fla(i) with one index: the whole spectrum
    of that state (previously a TypeError); bad
    index keeps warn-and-zero semantics; j alone is a clean TypeError."""
    ev = nu.Evolver(**GOLDEN_KW).evolve()
    np.testing.assert_array_equal(ev.get_flux(1), ev.get_flux()[1])
    np.testing.assert_array_equal(ev.get_flux_fla(2), ev.get_flux_fla()[2])
    capsys.readouterr()
    out = ev.get_flux(5)
    assert out.shape == (ev.get_N_bins_E(),) and (out == 0.0).all()
    assert "mass eigenstate 5" in capsys.readouterr().err
    with pytest.raises(TypeError):
        ev.get_flux(None, 3)


def test_health_signal_default_on(capsys):
    """EvolveResult.health rides along every evolve; a healthy golden
    run stays silent, a doctored unhealthy result screams on stderr."""
    ev = nu.Evolver(**GOLDEN_KW).evolve()
    h = np.asarray(ev._result.health)
    assert h.shape == (3,)
    assert h[1] == 0.0 and h[0] >= nu.Evolver._HEALTH_TOL
    # interaction-depth scalar rides along (finite, non-negative); the
    # golden config itself is nearly free-streaming (tau ~ 1e-18: at
    # mphi=5e6 with a massless lightest neutrino every resonance sits
    # above the energy window), so no magnitude assertion here
    assert np.isfinite(h[2]) and h[2] >= 0.0
    capsys.readouterr()
    # doctor the health vector: the host-side check must scream
    ev._result = ev._result._replace(health=np.array([-1e-3, 0.0, 1.0]))
    ev._check_health()
    err = capsys.readouterr().err
    assert "Negative cross section" in err and "Possible roundoff" in err


def test_health_signal_free_streaming_no_false_positive(capsys):
    """Red/green gate for a health-scream false positive: at g=1e-12
    the kernel tables are pure round-off noise around zero
    (worst_rel_neg ~ -1) but the flux free-streams, so the
    default-on health check must stay SILENT; the same negativity with
    a dynamically relevant interaction depth must still scream."""
    ev = nu.Evolver(**{**GOLDEN_KW, "g": 1e-12}).evolve()
    err = capsys.readouterr().err
    assert "Negative cross section" not in err
    h = np.asarray(ev._result.health)
    # the free-streaming gate (not a healthy table) is what kept quiet
    assert h[2] < nu.Evolver._HEALTH_TAU_FLOOR
    # red side: same-or-worse negativity, interacting-regime tau -> scream
    ev._result = ev._result._replace(
        health=np.array([min(float(h[0]), -1e-3), 0.0, 1.0]))
    ev._check_health()
    assert "Negative cross section" in capsys.readouterr().err
