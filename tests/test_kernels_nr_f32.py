"""Native-f32 non-resonant alpha table vs scipy referee and the f64 path.

Gating philosophy (mirrors test_kernels_f32): the strict accuracy gate
is an independent quadrature referee (scipy.integrate on the verified
matrix-element integrands plus the f64 s-channel closed form), NOT the
f64 builder — at sub-resonance bin pairs the f64 antiderivative
differences cancel to round-off noise up to ~1e9x the true value
(POSITIVE noise, so the reference's negative-only GL rescue never
fires; test_f64_noise_documented pins the phenomenon). The f64
comparison is kept where the closed forms are numerically healthy.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from scipy import integrate

from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models import (grids, kernels, kernels_nr_f32, masses,
                                 mixing, transport)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
PI = np.pi


def _setup(mphi, g, majorana, nbins, lo, hi, mntot):
    cfg = Config(N_bins_E=nbins, lEmin=lo, lEmax=hi, non_resonant=True,
                 phiphi=False, majorana=majorana,
                 source="powerlaw" if lo > 8 else "dsnb")
    gr = grids.build(cfg)
    Wf = jnp.asarray(mixing.pmns_sq(True))[cfg.flav]
    mn = masses.mass_spectrum(mntot, True)
    return cfg, gr, Wf, mn


def _tables(gr, Wf, mn, g, mphi, majorana):
    kw = dict(majorana=majorana, non_resonant=True, phiphi=False)
    a64 = np.asarray(kernels.alpha_table(
        gr.Emin_ext, gr.Emax_ext, mn, g, mphi, Wf, **kw))
    a32 = np.asarray(kernels_nr_f32.alpha_table_f32(
        gr.Emin_ext, gr.Emax_ext, mn, g, mphi, Wf, majorana=majorana))
    return a64, a32


def _truth_entry(gr, Wf, mn, g, mphi, majorana, j, m):
    """Independent referee: adaptive scipy quadrature of the verified
    matrix-element integrands (+ the f64 s-channel closed form, which
    is cancellation-free)."""
    ga = float(kernels.scalar_width(g, mphi, majorana))
    grv = ga / mphi
    tot = 0.0
    for e in range(3):
        mne = float(mn[e])
        tp = -2 * mne * float(gr.Emax_ext[j]) / mphi**2
        tm = -2 * mne * float(gr.Emin_ext[j]) / mphi**2
        if abs(tm + 1) < 1e-7:
            tm += tm * 1e-6
        if abs(tp + 1) < 1e-7:
            tp += tp * 1e-6
        smp = 2 * mne * float(gr.Emin_ext[m]) / mphi**2
        spp = 2 * mne * float(gr.Emax_ext[m]) / mphi**2
        nr = 0.0
        if spp >= 1e-8 and -tp >= 1e-8:
            tmf, tpf = min(tm, -1e-8), min(tp, -1e-8)
            smpf, sppf = max(smp, 1e-8), max(spp, 1e-8)

            def F_all(y, x):
                u = -x - y
                t_term = (y / x) ** 2 / (y - 1) ** 2
                if majorana:
                    u_term = (u / x) ** 2 / (u - 1) ** 2
                    interf = 2 * y * u / (x * x * (y - 1) * (u - 1))
                    tu = 2 * (t_term + u_term) + interf
                else:
                    tu = t_term
                Fst = 2 * y * (x - 1) / (x * ((x - 1) ** 2 + grv * grv) * (y - 1))
                if majorana:
                    Fsu = 2 * u * (x - 1) / (x * ((x - 1) ** 2 + grv * grv) * (u - 1))
                    st = 2 * (Fst + Fsu)
                else:
                    st = Fst
                return tu / (16 * PI) + st / (32 * PI)

            nr, _ = integrate.dblquad(
                lambda x, y: F_all(y, x), tpf, tmf,
                lambda y: smpf, lambda y: sppf,
                epsabs=1e-300, epsrel=1e-11)
        s_ = float(kernels.alpha_s(
            jnp.float64(tm), jnp.float64(tp), jnp.float64(smp),
            jnp.float64(spp), g, mphi, jnp.float64(ga))) / g**4
        if not majorana:
            s_ = s_ / 2.0
        tot += float(Wf[e]) / (2 * mne) * (nr + s_) * g**4
    return tot


# config family: (mphi, g, majorana, nbins, lEmin, lEmax, mntot)
HIGH_E_MAJ = (6e5, 1e-2, True, 150, 9.0, 14.0, 0.1)      # resonance in-grid
HIGH_E_DIR = (6e5, 1e-2, False, 150, 9.0, 14.0, 0.1)
GOLDEN_NR = (5e6, 1e-3, True, 150, 4.0, 9.0, MNTOT)      # sub-resonance
STRONG_SUB = (1e6, 1e-2, True, 150, 4.0, 9.0, MNTOT)     # f64-noise regime
# refbin nr_mphi3e3 point (tests/test_refbin_golden.py): g=0.3 drives the
# closed forms' sub-resonance cancellation noise to ~4e-2 at the low-E
# corner entries — the f32 quadrature build must stay referee-exact there
# (it does, ~1e-7), which is WHY the refbin f32 NR gate is bounded by the
# reference's own noise rather than ours.
REFBIN_NR = (3e3, 0.3, True, 100, 4.0, 9.0, 0.1)


@pytest.mark.parametrize("case", [HIGH_E_MAJ, HIGH_E_DIR, GOLDEN_NR,
                                  STRONG_SUB, REFBIN_NR],
                         ids=["highE-maj", "highE-dirac", "golden-nr",
                              "strong-sub", "refbin-nr"])
def test_sampled_entries_vs_scipy_referee(case):
    mphi, g, maj, nb, lo, hi, mntot = case
    cfg, gr, Wf, mn = _setup(*case)
    _, a32 = _tables(gr, Wf, mn, g, mphi, maj)
    N = a32.shape[0]
    # sample: adjacent pairs (u -> 0 corner), far pairs, the table peak,
    # and (for the in-grid-resonance config) columns crossing s = 1
    pairs = {(0, 1), (5, 6), (N // 2, N // 2 + 1), (3, N - 2),
             (N // 2, N - 1), (N - 3, N - 2)}
    pk = np.unravel_index(np.argmax(np.abs(a32)), a32.shape)
    pairs.add((int(pk[0]), int(pk[1])))
    svals = 2 * float(mn[2]) * np.asarray(gr.Emin_ext) / mphi**2
    if svals[0] < 1.0 < svals[-1]:
        mres = int(np.searchsorted(svals, 1.0)) - 1
        for m in (mres - 1, mres, mres + 1, mres + 15):
            if 0 < m < N:
                pairs.add((max(0, mres - 30), m))
                pairs.add((2, m))
    worst = 0.0
    for j, m in sorted(pairs):
        if not (0 <= j < m < N):
            continue
        t = _truth_entry(gr, Wf, mn, g, mphi, maj, j, m)
        if t == 0.0:
            assert a32[j, m] == 0.0
            continue
        rel = abs(a32[j, m] / t - 1.0)
        worst = max(worst, rel)
        assert rel < 5e-6, (j, m, a32[j, m], t, rel)


def test_f64_noise_documented():
    """Pin the phenomenon that motivates the quadrature build: at a
    sub-resonance pair the f64 closed forms return POSITIVE cancellation
    noise orders of magnitude above the true value (so the reference's
    negative-only rescue misses it), while the f32 build matches the
    scipy referee."""
    case = STRONG_SUB
    mphi, g, maj, *_ = case
    cfg, gr, Wf, mn = _setup(*case)
    a64, a32 = _tables(gr, Wf, mn, g, mphi, maj)
    # the global |a64| peak in this config IS a noise entry
    j, m = np.unravel_index(np.argmax(np.abs(a64)), a64.shape)
    t = _truth_entry(gr, Wf, mn, g, mphi, maj, int(j), int(m))
    assert abs(a64[j, m]) > 1e3 * abs(t)      # f64: noise-dominated
    assert abs(a32[j, m] / t - 1.0) < 5e-6    # f32: correct


@pytest.mark.parametrize("case", [HIGH_E_MAJ, HIGH_E_DIR],
                         ids=["maj", "dirac"])
def test_structural_match_vs_f64_in_clean_regime(case):
    """Where the closed forms are numerically healthy (high-energy
    config; coordinates O(1)), f32 and f64 agree to f32 round-off."""
    mphi, g, maj, *_ = case
    cfg, gr, Wf, mn = _setup(*case)
    a64, a32 = _tables(gr, Wf, mn, g, mphi, maj)
    pk = np.abs(a64).max()
    assert np.abs(a32 - a64).max() / pk < 1e-6
    mask = np.abs(a64) > pk * 1e-6
    rel = np.max(np.abs(a32 - a64)[mask] / np.abs(a64)[mask])
    assert rel < 2e-6


@pytest.mark.parametrize("case", [HIGH_E_MAJ, HIGH_E_DIR, GOLDEN_NR],
                         ids=["highE-maj", "highE-dirac", "golden-nr"])
def test_flux_level_match(case):
    """End-to-end evolve with the f32 alpha table vs the f64 table in
    regimes where the f64 table is trustworthy."""
    mphi, g, maj, nb, lo, hi, mntot = case
    cfg, gr, Wf, mn = _setup(*case)
    p = PhysicsParams.create(mphi, g, mntot,
                             2.5 if lo > 8 else 2.0,
                             1.0 if lo > 8 else 6.0)
    kw = dict(majorana=maj, non_resonant=True, phiphi=False)
    tblG = kernels.gamma_table(gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi,
                               Wf, **kw)
    tblAt = kernels.alphatilde_table(gr.Emin_ext, gr.Emax_ext, mn, p.g,
                                     p.mphi, Wf, **kw)
    a64, a32 = _tables(gr, Wf, mn, g, mphi, maj)
    cfg_t = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                   phiphi=False, majorana=maj, march="trisolve",
                   source=cfg.source)
    f64 = np.asarray(transport.evolve_core(
        p, cfg_t, tables=(tblG, tblAt, jnp.asarray(a64))).flux_fla)
    f32 = np.asarray(transport.evolve_core(
        p, cfg_t, tables=(tblG, tblAt, jnp.asarray(a32))).flux_fla)
    pk = np.abs(f64).max()
    gate = np.abs(f64) > pk * 1e-10
    rel = np.max(np.abs(f32 - f64)[gate] / np.abs(f64)[gate])
    assert rel < 1e-4, rel


def test_build_tables_integration_forced_f32():
    """table_dtype='f32' routes the alpha build through kernels_nr_f32
    inside build_tables/evolve on any backend."""
    mphi, g, maj, nb, lo, hi, mntot = HIGH_E_MAJ
    cfg32 = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                   phiphi=False, majorana=maj, march="trisolve",
                   table_dtype="f32", source="powerlaw")
    assert transport._use_f32_alpha(cfg32)
    cfg64 = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                   phiphi=False, majorana=maj, march="trisolve",
                   table_dtype="f64", source="powerlaw")
    assert not transport._use_f32_alpha(cfg64)
    p = PhysicsParams.create(mphi, g, mntot, 2.5, 1.0)
    r32 = np.asarray(transport.evolve(p, cfg32).flux_fla)
    r64 = np.asarray(transport.evolve(p, cfg64).flux_fla)
    pk = np.abs(r64).max()
    gate = np.abs(r64) > pk * 1e-10
    assert np.max(np.abs(r32 - r64)[gate] / np.abs(r64)[gate]) < 1e-4
    # batched grid_scan path compiles and agrees with single evolves
    import nusiprop_tpu as nu

    params = nu.param_grid([mphi, mphi * 2], [g], mntot=mntot, si=2.5,
                           norm=1.0)
    res = nu.grid_scan(params, cfg32)
    np.testing.assert_allclose(np.asarray(res.flux_fla)[0], r32, rtol=1e-12)


def test_per_state_f32_table_matches_f64_clean_regime():
    """Wf=None (general-coupling per-state contract): the f32 quadrature
    build matches the per-state f64 closed forms where those are
    healthy, including a width_factor (sum Q) scaling."""
    mphi, g, maj, nb, lo, hi, mntot = HIGH_E_MAJ
    cfg, gr, Wf, mn = _setup(*HIGH_E_MAJ)
    for wf in (None, 2.5):
        kw64 = dict(majorana=maj, non_resonant=True, phiphi=False,
                    width_factor=wf)
        a64 = np.asarray(kernels.alpha_table(
            gr.Emin_ext, gr.Emax_ext, mn, g, mphi, None, **kw64))
        a32 = np.asarray(kernels_nr_f32.alpha_table_f32(
            gr.Emin_ext, gr.Emax_ext, mn, g, mphi, None, majorana=maj,
            width_factor=wf))
        assert a64.shape == a32.shape == (3,) + (a64.shape[1],) * 2
        pk = np.abs(a64).max()
        mask = np.abs(a64) > pk * 1e-6
        rel = np.max(np.abs(a32 - a64)[mask] / np.abs(a64)[mask])
        assert rel < 2e-6, (wf, rel)


def test_evolve_general_with_f32_tables():
    """evolve_general picks up the per-state f32 quadrature build under
    table_dtype='f32' and agrees with the f64 build."""
    import dataclasses

    import nusiprop_tpu as nu

    mphi, g, maj, nb, lo, hi, mntot = HIGH_E_MAJ
    G = np.zeros((3, 3))
    G[1, 1], G[2, 2] = 0.5, 1.0
    Q = nu.flavor_coupling_to_Q(G)
    cfg64 = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                   phiphi=False, majorana=maj, table_dtype="f64",
                   source="powerlaw")
    cfg32 = dataclasses.replace(cfg64, table_dtype="f32")
    p = PhysicsParams.create(mphi, g, mntot, 2.5, 1.0)
    f64 = np.asarray(transport.evolve_general(p, Q, cfg64).flux_fla)
    f32 = np.asarray(transport.evolve_general(p, Q, cfg32).flux_fla)
    pk = np.abs(f64).max()
    gate = np.abs(f64) > pk * 1e-10
    assert np.max(np.abs(f32 - f64)[gate] / np.abs(f64)[gate]) < 1e-4


def test_config_validation_f32_trisolve():
    Config(non_resonant=True, march="trisolve", table_dtype="f32",
           phiphi=False)  # ok
    Config(non_resonant=True, march="auto", table_dtype="f32",
           phiphi=False)  # ok
    Config(non_resonant=True, march="trisolve_f32", phiphi=False)  # ok
    with pytest.raises(ValueError):
        Config(non_resonant=False, march="trisolve", table_dtype="f32",
               phiphi=False)
    with pytest.raises(ValueError):
        Config(non_resonant=False, march="trisolve_f32", phiphi=False)


@pytest.mark.parametrize("case", [HIGH_E_MAJ, HIGH_E_DIR, GOLDEN_NR],
                         ids=["highE-maj", "highE-dirac", "golden-nr"])
def test_trisolve_f32_march_matches_f64(case):
    """The native-f32 general-kernel march (free-streaming-preconditioned
    triangular solve against the normalized f32 alpha table) against the
    f64 trisolve march consuming the same f32 quadrature table."""
    mphi, g, maj, nb, lo, hi, mntot = case
    src = "powerlaw" if lo > 8 else "dsnb"
    p = PhysicsParams.create(mphi, g, mntot,
                             2.5 if lo > 8 else 2.0,
                             1.0 if lo > 8 else 6.0)
    cfg64 = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                   phiphi=False, majorana=maj, march="trisolve",
                   table_dtype="f32", source=src)
    cfg32 = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                   phiphi=False, majorana=maj, march="trisolve_f32",
                   source=src)
    f64 = np.asarray(transport.evolve(p, cfg64).flux_fla)
    f32 = np.asarray(transport.evolve(p, cfg32).flux_fla)
    pk = np.abs(f64).max()
    gate = np.abs(f64) > pk * 1e-10
    rel = np.max(np.abs(f32 - f64)[gate] / np.abs(f64)[gate])
    assert rel < 2e-5, rel


@pytest.mark.parametrize("case", [HIGH_E_MAJ, GOLDEN_NR],
                         ids=["highE", "golden-nr"])
def test_trisolve_f32_rows_survive_narrow_exponent_window(case):
    """Same float32-exponent-window guard as the rank1_f32 march
    (test_march.py::test_f32_rows_survive_narrow_exponent_window): run
    the trisolve_f32 row precompute through a float32-window flush
    emulator and require the flux to stay inside the physics gate."""
    import jax.numpy as jnp

    mphi, g, maj, nb, lo, hi, mntot = case
    src = "powerlaw" if lo > 8 else "dsnb"
    F32_TINY = float(np.finfo(np.float32).tiny)
    F32_HUGE = float(np.finfo(np.float32).max)

    def flush(x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        a = jnp.abs(x)
        x = jnp.where(a < F32_TINY, jnp.zeros_like(x), x)
        return jnp.where(a > F32_HUGE, jnp.sign(x) * jnp.inf, x)

    from nusiprop_tpu.models import kernels_nr_f32, sources

    cfg = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                 phiphi=False, majorana=maj, march="trisolve_f32",
                 source=src)
    p = PhysicsParams.create(mphi, g, mntot, 2.5 if lo > 8 else 2.0,
                             1.0 if lo > 8 else 6.0)
    cfg64 = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                   phiphi=False, majorana=maj, march="trisolve",
                   table_dtype="f32", source=src)
    truth = np.asarray(transport.evolve(p, cfg64).flux)

    gr = grids.build(cfg)
    Wf = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
    mn = masses.mass_spectrum(p.mntot, cfg.normal_ordering)
    norm_total = p.norm / sources.flux_fs_e0(p.si, gr.zmax_eff)
    kw = dict(majorana=maj, non_resonant=True, phiphi=False)
    tblG = kernels.gamma_table(gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi,
                               Wf, **kw)
    tblAt = kernels.alphatilde_table(gr.Emin_ext, gr.Emax_ext, mn, p.g,
                                     p.mphi, Wf, **kw)
    A32, pref = kernels_nr_f32.alpha_table_f32(
        gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf, majorana=maj,
        raw=True)

    xs, scale = transport._trisolve_f32_rows(
        cfg, gr, p, norm_total, flush(tblG), flush(tblAt), pref,
        window=flush)
    assert all(bool(jnp.isfinite(x).all()) for x in xs)
    phi = transport._trisolve_f32_scan(xs[:-1] + (xs[-1],), A32, Wf,
                                       cfg.N_bins_E)
    flux = (np.asarray(phi, dtype=np.float64)
            * np.asarray(scale, dtype=np.float64)[None, :]
            / np.asarray(gr.Emax - gr.Emin)[None, :])
    m = np.abs(truth) > np.abs(truth).max() * 1e-10
    rel = np.max(np.abs(flux - truth)[m] / np.abs(truth)[m])
    assert rel < 1e-3, rel


def test_trisolve_f32_phiphi_folds_pp_channel():
    """With phiphi on, the f64 pp channel folds into the normalized f32
    table; the f32 march must stay within the physics gate of the f64
    march consuming the same channels."""
    import pathlib

    from nusiprop_tpu.models import pp_tables as ppt

    data = pathlib.Path(__file__).parents[1] / "data" / "pp_tables_small.npz"
    if not data.exists():
        pytest.skip("small pp tables not generated")
    pp = ppt.load_npz(str(data))
    p = PhysicsParams.create(6e5, 1e-2, 0.1, 2.5, 1.0)
    kw = dict(N_bins_E=150, lEmin=9.0, lEmax=14.0, non_resonant=True,
              phiphi=True, source="powerlaw")
    f64 = np.asarray(transport.evolve(
        p, Config(march="trisolve", table_dtype="f32", **kw),
        pp_tables=pp).flux_fla)
    f32 = np.asarray(transport.evolve(
        p, Config(march="trisolve_f32", **kw), pp_tables=pp).flux_fla)
    pk = np.abs(f64).max()
    gate = np.abs(f64) > pk * 1e-10
    rel = np.max(np.abs(f32 - f64)[gate] / np.abs(f64)[gate])
    assert rel < 2e-5, rel


def test_alpha_pp_table_norm_matches_channel():
    """kernels.alpha_pp_table_norm (the g^4-free, spline-dtype-following
    pp build for the trisolve_f32 fold) times g^4 reproduces
    alpha_table(channel="pp"): at f64-level with f64 tables, at pure-f32
    round-off with the f32-cast tables transport._pp_f32 produces. The
    per-state (Wf=None) variant must be the unweighted decomposition."""
    import pathlib

    from nusiprop_tpu.models import pp_tables as ppt

    data = pathlib.Path(__file__).parents[1] / "data" / "pp_tables_small.npz"
    if not data.exists():
        pytest.skip("small pp tables not generated")
    pp = ppt.load_npz(str(data))
    mphi, g, maj, nb, lo, hi, mntot = HIGH_E_MAJ
    cfg, gr, Wf, mn = _setup(mphi, g, maj, nb, lo, hi, mntot)

    ref = np.asarray(kernels.alpha_table(
        gr.Emin_ext, gr.Emax_ext, mn, g, mphi, Wf, majorana=maj,
        non_resonant=True, phiphi=True, pp_tables=pp, channel="pp"))
    g4 = g * g * g * g

    norm64 = kernels.alpha_pp_table_norm(
        gr.Emin_ext, gr.Emax_ext, mn, mphi, Wf, majorana=maj, pp_tables=pp)
    np.testing.assert_allclose(g4 * np.asarray(norm64), ref,
                               rtol=1e-12, atol=0)

    pp32 = transport._pp_f32(pp)
    norm32 = kernels.alpha_pp_table_norm(
        gr.Emin_ext, gr.Emax_ext, mn, mphi, Wf, majorana=maj,
        pp_tables=pp32)
    assert norm32.dtype == jnp.float32
    got = g4 * np.asarray(norm32, dtype=np.float64)
    nz = ref != 0.0
    assert np.array_equal(got == 0.0, ref == 0.0)  # same sparsity mask
    rel = np.max(np.abs(got[nz] - ref[nz]) / np.abs(ref[nz]))
    assert rel < 5e-6, rel

    # per-state decomposition: Wf-weighted sum of the (3, N, N) output
    # must equal the flavor-summed table
    per = kernels.alpha_pp_table_norm(
        gr.Emin_ext, gr.Emax_ext, mn, mphi, None, majorana=maj,
        pp_tables=pp)
    summed = np.einsum("e,eij->ij", np.asarray(Wf), np.asarray(per))
    np.testing.assert_allclose(summed, np.asarray(norm64),
                               rtol=1e-13, atol=0)


def test_trisolve_f32_batched_grid_scan():
    """grid_scan routes trisolve_f32 through build_tables (raw f32 table
    + pref pytree) and agrees with single evolves."""
    import nusiprop_tpu as nu

    mphi, g, maj, nb, lo, hi, mntot = HIGH_E_MAJ
    cfg = Config(N_bins_E=nb, lEmin=lo, lEmax=hi, non_resonant=True,
                 phiphi=False, majorana=maj, march="trisolve_f32",
                 source="powerlaw")
    params = nu.param_grid([mphi, 3 * mphi], [g], mntot=mntot, si=2.5,
                           norm=1.0)
    res = nu.grid_scan(params, cfg)
    single = transport.evolve(
        PhysicsParams.create(mphi, g, mntot, 2.5, 1.0), cfg)
    # f32 march: vmap changes fusion order, so agreement is f32-level
    np.testing.assert_allclose(np.asarray(res.flux_fla)[0],
                               np.asarray(single.flux_fla), rtol=1e-6)


@pytest.mark.parametrize("ne", [37, 100, 129, 500])
def test_nilpotent_solve_matches_f64_truth(ne):
    """transport._nilpotent_solve: blocked Neumann-product inverse of
    I - N (N strictly upper, non-negative, nilpotent) matches the f64
    dense solve to f32 round-off, including the pad path (ne not a
    multiple of the 128 block) and the small-single-block path."""
    rng = np.random.default_rng(ne)
    N = np.triu(rng.uniform(0.0, 1.0, (ne, ne)), k=1) * (2.0 / ne)
    q = rng.uniform(0.5, 1.0, ne)
    x64 = np.linalg.solve(np.eye(ne) - N, q)
    x32 = np.asarray(transport._nilpotent_solve(
        jnp.asarray(N, jnp.float32), jnp.asarray(q, jnp.float32)))
    rel = np.max(np.abs(x32 - x64) / np.abs(x64))
    assert rel < 5e-6, (ne, rel)


class TestNrGammaAlphatildeF32:
    """The round-4 native-f32 Gamma/alphaTilde ladder extension
    (nr_gamma_alphatilde_f32): channel constants, accuracy vs the f64
    closed forms where those are well-conditioned, and accuracy vs a
    high-precision referee where they are NOT (tiny dimensionless
    coordinates — the f64 antiderivative differences are cancellation
    noise there, same phenomenon the alpha build documented)."""

    def test_ftu_series_matches_sympy(self):
        import sympy as sp

        z = sp.symbols("z")
        ser = sp.series(1 / z - 2 * (1 + z) * sp.log(1 + z)
                        / (z ** 2 * (2 + z)), z, 0, 42).removeO()
        ref = [float(ser.coeff(z, n)) for n in range(1, 42)]
        np.testing.assert_allclose(kernels_nr_f32._FTU_COEF, ref,
                                   rtol=1e-14)

    @pytest.mark.parametrize("z0", [1e-7, 1e-5, 1e-3, 0.05, 0.55, 0.7,
                                    5.0, 1e4])
    def test_gamma_shapes_vs_mpmath(self, z0):
        import mpmath as mp

        mp.mp.dps = 40
        f32 = jnp.float32
        z1 = z0 * 1.0391
        ds = f32(z1 - z0)
        shapes = [
            (kernels_nr_f32._f_t_u32,
             lambda z: (z + 2) / (z * (z + 1)) - 2 * mp.log1p(z) / z ** 2),
            (kernels_nr_f32._f_tu32,
             lambda z: 1 / z - 2 * (1 + z) * mp.log1p(z)
             / (z ** 2 * (2 + z))),
        ]
        for f32fn, mpfn in shapes:
            acc = 0.0
            for c, w in zip(kernels_nr_f32._GL3_C, kernels_nr_f32._GL3_W):
                acc = acc + f32(w) * f32fn(f32(z0) + f32(c) * ds)
            got = float(acc * ds)
            true = float(mp.quad(lambda t: mpfn(mp.mpf(t)), [z0, z1]))
            assert abs(got - true) / abs(true) < 3e-6, (z0, got, true)
        # h_st cofactor pointwise
        got_h = float(kernels_nr_f32._h_st32(f32(z0)))
        true_h = float(2 * (mp.mpf(z0) - mp.log1p(mp.mpf(z0))) / mp.mpf(z0))
        assert abs(got_h - true_h) / abs(true_h) < 3e-6

    @pytest.mark.parametrize("maj", [True, False], ids=["maj", "dirac"])
    def test_tables_vs_f64_clean_regime(self, maj):
        """Well-conditioned coordinates (z ~ 0.03-30): the f64 closed
        forms are trustworthy; the f32 build must match at table scale."""
        cfg = Config(N_bins_E=150, lEmin=9.0, lEmax=14.0, zmax=5.0,
                     non_resonant=True, majorana=maj, source="powerlaw")
        gr_ = grids.build(cfg)
        mn = masses.mass_spectrum(0.1, True)
        Wf = jnp.asarray(mixing.pmns_sq(True))[2]
        g, mphi = 1e-2, 6e5
        kw = dict(majorana=maj, non_resonant=True, phiphi=False)
        G64 = np.asarray(kernels.gamma_table(
            gr_.Emin_ext, gr_.Emax_ext, mn, g, mphi, Wf, **kw))
        At64 = np.asarray(kernels.alphatilde_table(
            gr_.Emin_ext, gr_.Emax_ext, mn, g, mphi, Wf, **kw))
        G32, At32 = kernels_nr_f32.nr_gamma_alphatilde_f32(
            gr_.Emin_ext, gr_.Emax_ext, mn, g, mphi, Wf, majorana=maj)
        G32, At32 = np.asarray(G32), np.asarray(At32)
        if not maj:  # Dirac st stays a separate f64 program
            At32 = At32 + np.asarray(kernels.alphatilde_table(
                gr_.Emin_ext, gr_.Emax_ext, mn, g, mphi, Wf,
                channel="st", **kw))
        assert (np.abs(G32 - G64) / np.abs(G64).max()).max() < 2e-5
        assert (np.abs(At32 - At64) / np.abs(At64).max()).max() < 2e-4

    def test_gamma_more_accurate_than_f64_at_tiny_coords(self):
        """At z ~ 1e-7 the f64 gamma_t_u closed form (and its equally
        cancelling rescue) carries percent-level noise while the f32
        series build tracks mpmath at ~1e-7 — the ladder's raison
        d'etre, pinned so a revert to closed forms goes red."""
        import mpmath as mp

        from nusiprop_tpu.models import kernels_nr

        mp.mp.dps = 40
        z0, z1 = 1e-7, 1e-7 * 1.0391
        true = float(mp.quad(
            lambda z: (z + 2) / (z * (z + 1)) - 2 * mp.log1p(z) / z ** 2,
            [z0, z1])) / (16 * np.pi)
        f64v = float(kernels_nr.gamma_t_u(
            jnp.asarray([z0]), jnp.asarray([z1]), 1.0)[0])
        f32 = jnp.float32
        ds = f32(z1 - z0)
        acc = 0.0
        for c, w in zip(kernels_nr_f32._GL3_C, kernels_nr_f32._GL3_W):
            acc = acc + f32(w) * kernels_nr_f32._f_t_u32(f32(z0) + f32(c) * ds)
        mine = float(acc * ds) / (16 * np.pi)
        assert abs(mine - true) / true < 1e-6
        assert abs(f64v - true) / true > 1e-3  # the f64 noise is real
