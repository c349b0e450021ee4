"""Oracle tests for the non-resonant kernel channels (kernels_nr.py).

Validation strategy (no GSL build exists in this environment, so the
reference C++ cannot be run; cf. SURVEY.md §4):

1. *Quadrature oracles*: each t/u/tu/phi-phi channel is the integral of an
   explicit differential cross-section (the integrands appear verbatim in
   the reference's numeric-rescue paths, nuSIprop.hpp:799-810, 985-1005,
   1286-1304, 889-903); scipy adaptive quadrature of those integrands is
   an independent high-precision oracle for our closed forms.
2. *Bin additivity*: every Gamma channel is int_a^b of a fixed integrand,
   so ch(a,c) == ch(a,b) + ch(b,c); a transcription error in any term
   generically breaks this.
3. *Triangle-rectangle identity*: alphaTilde integrates dsigma/dE over the
   triangle E in [a,b], Etilde in [E,b] while alpha integrates the same
   integrand over a rectangle, so
       alphaTilde(a,c) = alphaTilde(a,b) + alphaTilde(b,c) + alpha([a,b],[b,c]).
   This cross-validates the *independent* closed forms of alpha against
   alphaTilde per channel — including the s-t interference, where no
   explicit integrand is available.
4. *Branch continuity*: Taylor fallbacks must join their exact branches
   smoothly at the reference's thresholds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate

from nusiprop_tpu.models import kernels, kernels_nr

PI = np.pi
G = 0.37  # order-1 coupling so channel values are O(1); prefactor ~ g^4
GA_RED = kernels.scalar_width(G, 1.0, True)  # reduced width for mphi=1


def arr(x):
    return jnp.asarray(x, dtype=jnp.float64)


def val(x):
    return float(np.asarray(x))


# ---------------------------------------------------------------------------
# 1. quadrature oracles
# ---------------------------------------------------------------------------

class TestGammaOracles:
    @pytest.mark.parametrize("sm,sp", [(0.3, 0.9), (2.0, 7.0), (40.0, 90.0),
                                       (1e-3, 3e-3), (0.9, 1.1)])
    def test_t_u(self, sm, sp):
        got = val(kernels_nr.gamma_t_u(arr(sm), arr(sp), G))
        f = lambda z: (z + 2) / (z * (z + 1)) - 2 / z**2 * np.log1p(z)
        ref, _ = integrate.quad(f, sm, sp, epsabs=0, epsrel=1e-12)
        ref *= G**4 / (16 * PI)
        assert abs(got - ref) < 1e-9 * abs(ref) + 1e-18

    @pytest.mark.parametrize("sm,sp", [(0.3, 0.9), (2.0, 7.0), (40.0, 90.0),
                                       (0.9, 1.1)])
    def test_tu(self, sm, sp):
        got = val(kernels_nr.gamma_tu(arr(sm), arr(sp), G))
        f = lambda z: 1 / z - 2 * (1 + z) / (z**2 * (2 + z)) * np.log1p(z)
        ref, _ = integrate.quad(f, sm, sp, epsabs=0, epsrel=1e-12)
        ref *= G**4 / (16 * PI)
        assert abs(got - ref) < 1e-9 * abs(ref) + 1e-18

    @pytest.mark.parametrize("sm,sp", [(4.5, 9.0), (2.0, 8.0), (10.0, 400.0),
                                       (4.0 + 1e-6, 4.2)])
    def test_pp(self, sm, sp):
        got = val(kernels_nr.gamma_pp(arr(sm), arr(sp), G, majorana=False))

        def f(z):
            r = np.sqrt(z * (z - 4))
            return ((z**2 - 4 * z + 6) / (z**2 * (z - 2))
                    * np.log(((r + z - 2) / (r - z + 2))**2)
                    - 6 * r / z**2)

        ref, _ = integrate.quad(f, max(sm, 4.0), sp, epsabs=0, epsrel=1e-12)
        ref *= G**4 / (64 * PI)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-16

    def test_pp_below_threshold_is_zero(self):
        assert val(kernels_nr.gamma_pp(arr(1.0), arr(3.9), G,
                                       majorana=True)) == 0.0

    def test_pp_majorana_doubles(self):
        d = val(kernels_nr.gamma_pp(arr(5.0), arr(9.0), G, majorana=False))
        m = val(kernels_nr.gamma_pp(arr(5.0), arr(9.0), G, majorana=True))
        assert m == pytest.approx(2 * d, rel=1e-14)


def tri_quad(f, tp, tm, epsrel=1e-11):
    """Triangle: y in [tp, tm], x in [-y, -tp] (the alphaTilde domain)."""
    r, _ = integrate.dblquad(lambda x, y: f(y, x), tp, tm,
                             lambda y: -y, lambda y: -tp,
                             epsabs=0, epsrel=epsrel)
    return r


def rect_quad(f, tp, tm, smp, spp, epsrel=1e-11):
    r, _ = integrate.dblquad(lambda x, y: f(y, x), tp, tm,
                             lambda y: smp, lambda y: spp,
                             epsabs=0, epsrel=epsrel)
    return r


def F_t_maj(y, x):
    return (y / x)**2 / (y - 1)**2 + ((-x - y) / x)**2 / ((-x - y) - 1)**2


def F_t_dir(y, x):
    return (y / x)**2 / (y - 1)**2


def F_tu_maj(y, x):
    return 2 * y * (-y - x) / x**2 / ((y - 1) * (-y - x - 1))


TP_TM_CASES = [(-0.9, -0.3), (-7.0, -2.0), (-60.0, -25.0), (-1.4, -0.7),
               (-3e-3, -1e-3)]


class TestAlphaTildeOracles:
    @pytest.mark.parametrize("tp,tm", TP_TM_CASES)
    def test_t_majorana(self, tp, tm):
        got = val(kernels_nr.alphatilde_t(arr(tm), arr(tp), G, majorana=True))
        ref = G**4 / (16 * PI) * tri_quad(F_t_maj, tp, tm)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17

    @pytest.mark.parametrize("tp,tm", TP_TM_CASES)
    def test_t_dirac(self, tp, tm):
        got = val(kernels_nr.alphatilde_t(arr(tm), arr(tp), G, majorana=False))
        ref = 1.5 * G**4 / (32 * PI) * tri_quad(F_t_dir, tp, tm)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17

    @pytest.mark.parametrize("tp,tm", TP_TM_CASES)
    def test_u_dirac(self, tp, tm):
        got = val(kernels_nr.alphatilde_u(arr(tm), arr(tp), G, majorana=False))
        ref = 0.5 * G**4 / (32 * PI) * tri_quad(F_t_dir, tp, tm)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17

    @pytest.mark.parametrize("tp,tm", [(-0.9, -0.3), (-7.0, -2.0),
                                       (-60.0, -25.0), (-1.4, -0.7)])
    def test_tu_majorana(self, tp, tm):
        got = val(kernels_nr.alphatilde_tu(arr(tm), arr(tp), G, majorana=True))
        ref = G**4 / (16 * PI) * tri_quad(F_tu_maj, tp, tm)
        assert abs(got - ref) < 1e-7 * abs(ref) + 1e-16

    def test_tu_dirac_is_zero(self):
        assert val(kernels_nr.alphatilde_tu(arr(-2.0), arr(-5.0), G,
                                            majorana=False)) == 0.0


ALPHA_CASES = [
    # (tp, tm, smp, spp): source bin above target (smp >= -tp)
    (-0.9, -0.3, 1.0, 2.5),
    (-7.0, -2.0, 8.0, 20.0),
    (-60.0, -25.0, 70.0, 150.0),
    (-1.6, -0.6, 1.8, 3.3),   # target bin straddles t = -1
]


class TestAlphaOracles:
    @pytest.mark.parametrize("tp,tm,smp,spp", ALPHA_CASES)
    def test_t_majorana(self, tp, tm, smp, spp):
        got = val(kernels_nr.alpha_t(arr(tm), arr(tp), arr(smp), arr(spp),
                                     G, majorana=True))
        ref = G**4 / (16 * PI) * rect_quad(F_t_maj, tp, tm, smp, spp)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17

    @pytest.mark.parametrize("tp,tm,smp,spp", ALPHA_CASES)
    def test_t_dirac(self, tp, tm, smp, spp):
        got = val(kernels_nr.alpha_t(arr(tm), arr(tp), arr(smp), arr(spp),
                                     G, majorana=False))
        ref = 1.5 * G**4 / (32 * PI) * rect_quad(F_t_dir, tp, tm, smp, spp)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17

    @pytest.mark.parametrize("tp,tm,smp,spp", ALPHA_CASES)
    def test_u_dirac(self, tp, tm, smp, spp):
        got = val(kernels_nr.alpha_u(arr(tm), arr(tp), arr(smp), arr(spp),
                                     G, majorana=False))
        ref = 0.5 * G**4 / (32 * PI) * rect_quad(F_t_dir, tp, tm, smp, spp)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17

    @pytest.mark.parametrize("tp,tm,smp,spp", ALPHA_CASES)
    def test_tu_majorana(self, tp, tm, smp, spp):
        got = val(kernels_nr.alpha_tu(arr(tm), arr(tp), arr(smp), arr(spp),
                                      G, majorana=True))
        ref = G**4 / (16 * PI) * rect_quad(F_tu_maj, tp, tm, smp, spp)
        assert abs(got - ref) < 1e-7 * abs(ref) + 1e-16


def _st_phi_prime(s):
    """d/ds of the s-side factor of the separable Dirac alpha_st closed
    form (nuSIprop.hpp:1459-1463): the s-t interference differential
    cross section in s, up to the shared prefactor."""
    D = (s - 1) ** 2 + GA_RED**2
    return -2 * GA_RED**2 / D + 2 / s - 2 * (s - 1) / D


def _st_integrand_dirac(y, x):
    # (y, x) = (t, s), matching the tri_quad/rect_quad helper convention
    return -_st_phi_prime(x) * (-y / (1 - y))


def _st_integrand_maj(y, x):
    # Majorana adds the identical-particle reflection t -> u = -s-t
    return _st_integrand_dirac(y, x) + _st_integrand_dirac(-x - y, x)


class TestAlphaStOracle:
    """alpha_st vs. direct quadrature of the interference integrand.

    The integrand is *derived* from the reference's separable Dirac
    closed form (whose s- and t-dependence factorize exactly), plus the
    u-reflection for Majorana; it independently validates the much more
    intricate Majorana expression, including its on-cut dilogarithm
    conventions (signed-zero semantics of carg, GSL Im Li2 = -pi ln x).
    """

    PREF = G**4 / (32 * PI * (1 + GA_RED**2))

    @pytest.mark.parametrize("tp,tm,smp,spp", ALPHA_CASES)
    @pytest.mark.parametrize("maj", [True, False])
    def test_rectangle(self, tp, tm, smp, spp, maj):
        got = val(kernels_nr.alpha_st(arr(tm), arr(tp), arr(smp), arr(spp),
                                      G, GA_RED, majorana=maj))
        f = _st_integrand_maj if maj else _st_integrand_dirac
        ref = self.PREF * rect_quad(f, tp, tm, smp, spp)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17

    @pytest.mark.parametrize("tp,tm", [(-7.0, -2.0), (-0.9, -0.3),
                                       (-1.5, -0.6)])
    def test_triangle_majorana(self, tp, tm):
        # The Majorana alphaTilde_st closed form matches the integrand
        # exactly. (The reference's *Dirac* alphaTilde_st deviates from
        # the direct integral by up to ~1% — it reuses ga_red*tminus
        # inside its tplus term, nuSIprop.hpp:1172 — and we transcribe
        # it faithfully, so no Dirac triangle oracle here.)
        got = val(kernels_nr.alphatilde_st(arr(tm), arr(tp), G, GA_RED,
                                           majorana=True))
        ref = self.PREF * tri_quad(_st_integrand_maj, tp, tm)
        assert abs(got - ref) < 1e-8 * abs(ref) + 1e-17


# ---------------------------------------------------------------------------
# 2. bin additivity of the Gamma channels
# ---------------------------------------------------------------------------

class TestGammaAdditivity:
    @pytest.mark.parametrize("a,b,c", [(0.2, 1.3, 5.0), (5.0, 20.0, 80.0),
                                       (1e-4, 5e-4, 2e-3)])
    def test_channels(self, a, b, c):
        for ch in [
            lambda x, y: kernels_nr.gamma_t_u(arr(x), arr(y), G),
            lambda x, y: kernels_nr.gamma_tu(arr(x), arr(y), G),
            lambda x, y: kernels_nr.gamma_st(arr(x), arr(y), G, GA_RED),
        ]:
            whole = val(ch(a, c))
            parts = val(ch(a, b)) + val(ch(b, c))
            assert abs(whole - parts) < 1e-9 * max(abs(whole), 1e-14), ch

    @pytest.mark.parametrize("a,b,c", [(4.5, 9.0, 30.0), (6.0, 100.0, 900.0)])
    def test_pp(self, a, b, c):
        whole = val(kernels_nr.gamma_pp(arr(a), arr(c), G, majorana=True))
        parts = (val(kernels_nr.gamma_pp(arr(a), arr(b), G, majorana=True))
                 + val(kernels_nr.gamma_pp(arr(b), arr(c), G, majorana=True)))
        assert abs(whole - parts) < 1e-9 * abs(whole)


# ---------------------------------------------------------------------------
# 3. triangle-rectangle identity: validates alpha against alphaTilde
# ---------------------------------------------------------------------------

SPLIT_CASES = [(-0.9, -0.55, -0.3), (-7.0, -4.0, -2.0), (-60.0, -40.0, -25.0),
               (-1.5, -0.95, -0.6)]


class TestTriangleRectangle:
    def _check(self, at_fn, a_fn, tp, tmid, tm, tol):
        # bins in t: [tp, tmid] (lower-E... larger |t|) and [tmid, tm].
        # In energy: bin1 = [Em1, Ep1] <-> t in [tmid, tm] is the LOW bin.
        # alphaTilde(a,c) over [tp, tm] splits into the two sub-triangles
        # plus the rectangle with target = low-E bin, source = high-E bin:
        # target t-limits (tm_t, tp_t) = (tm, tmid); source s-limits
        # (smp, spp) = (-tmid, -tp).
        whole = val(at_fn(tm, tp))
        parts = (val(at_fn(tm, tmid)) + val(at_fn(tmid, tp))
                 + val(a_fn(tm, tmid, -tmid, -tp)))
        assert abs(whole - parts) < tol * max(abs(whole), 1e-14)

    @pytest.mark.parametrize("tp,tmid,tm", SPLIT_CASES)
    @pytest.mark.parametrize("maj", [True, False])
    def test_t(self, tp, tmid, tm, maj):
        at = lambda x, y: kernels_nr.alphatilde_t(arr(x), arr(y), G,
                                                  majorana=maj)
        a = lambda x, y, s, S: kernels_nr.alpha_t(arr(x), arr(y), arr(s),
                                                  arr(S), G, majorana=maj)
        self._check(at, a, tp, tmid, tm, 1e-8)

    @pytest.mark.parametrize("tp,tmid,tm", SPLIT_CASES)
    def test_tu(self, tp, tmid, tm):
        at = lambda x, y: kernels_nr.alphatilde_tu(arr(x), arr(y), G,
                                                   majorana=True)
        a = lambda x, y, s, S: kernels_nr.alpha_tu(arr(x), arr(y), arr(s),
                                                   arr(S), G, majorana=True)
        self._check(at, a, tp, tmid, tm, 1e-7)

    @pytest.mark.parametrize("tp,tmid,tm", SPLIT_CASES)
    @pytest.mark.parametrize("maj", [True, False])
    def test_st(self, tp, tmid, tm, maj):
        at = lambda x, y: kernels_nr.alphatilde_st(arr(x), arr(y), G, GA_RED,
                                                   majorana=maj)
        a = lambda x, y, s, S: kernels_nr.alpha_st(arr(x), arr(y), arr(s),
                                                   arr(S), G, GA_RED,
                                                   majorana=maj)
        self._check(at, a, tp, tmid, tm, 1e-6)

    @pytest.mark.parametrize("tp,tmid,tm", SPLIT_CASES)
    @pytest.mark.parametrize("maj", [True, False])
    def test_s_channel(self, tp, tmid, tm, maj):
        """Same identity for the resonant channel in kernels.py."""
        ga = kernels.scalar_width(G, 1.0, maj)
        at = lambda x, y: kernels.alphatilde_s(arr(x), arr(y), G, 1.0, ga)
        a = lambda x, y, s, S: kernels.alpha_s(arr(x), arr(y), arr(s),
                                               arr(S), G, 1.0, ga)
        self._check(at, a, tp, tmid, tm, 1e-8)


# ---------------------------------------------------------------------------
# 4. branch continuity at the Taylor thresholds
# ---------------------------------------------------------------------------

class TestBranchContinuity:
    def test_gamma_st_taylor(self):
        # splus < 1e-5 switches to the complex Taylor expansion
        for eps in [0.9999e-5, 1.0001e-5]:
            lo = val(kernels_nr.gamma_st(arr(eps * 0.5), arr(eps), G, GA_RED))
            assert np.isfinite(lo)
        below = val(kernels_nr.gamma_st(arr(0.5e-5), arr(0.9999e-5), G, GA_RED))
        above = val(kernels_nr.gamma_st(arr(0.5e-5), arr(1.0001e-5), G, GA_RED))
        assert abs(below - above) < 1e-3 * max(abs(below), abs(above))

    def test_alphatilde_st_taylor(self):
        below = val(kernels_nr.alphatilde_st(arr(-0.5e-5), arr(-0.9999e-5),
                                             G, GA_RED, majorana=True))
        above = val(kernels_nr.alphatilde_st(arr(-0.5e-5), arr(-1.0001e-5),
                                             G, GA_RED, majorana=True))
        assert abs(below - above) < 1e-3 * max(abs(below), abs(above))

    def test_alphatilde_tu_combi_small(self):
        lo = val(kernels_nr.alphatilde_tu(arr(-0.45e-2), arr(-0.99e-2), G,
                                          majorana=True))
        hi = val(kernels_nr.alphatilde_tu(arr(-0.46e-2), arr(-1.01e-2), G,
                                          majorana=True))
        assert abs(lo - hi) < 0.1 * max(abs(lo), abs(hi))

    def test_alphatilde_tu_combi_big(self):
        lo = val(kernels_nr.alphatilde_tu(arr(-45.0), arr(-99.0), G,
                                          majorana=True))
        hi = val(kernels_nr.alphatilde_tu(arr(-46.0), arr(-101.0), G,
                                          majorana=True))
        assert abs(lo - hi) < 0.1 * max(abs(lo), abs(hi))


# ---------------------------------------------------------------------------
# 5. physical positivity (the reference's own runtime check,
#    nuSIprop.hpp:909-918, 1215-1231, 1505-1516)
# ---------------------------------------------------------------------------

class TestPositivity:
    def test_gamma_sums(self):
        rng = np.random.default_rng(7)
        sm = 10.0 ** rng.uniform(-4, 2, 300)
        sp = sm * 10.0 ** rng.uniform(0.005, 0.05, 300)
        for maj in (True, False):
            ga = kernels.scalar_width(G, 1.0, maj)
            g_s = kernels.gamma_s(arr(sm), arr(sp), G, 1.0, ga)
            g_tu2 = 2.0 * kernels_nr.gamma_t_u(arr(sm), arr(sp), G)
            g_st = kernels_nr.gamma_st(arr(sm), arr(sp), G, ga)
            tot = np.asarray(g_s + g_tu2 + g_st * (2.0 if maj else 1.0))
            assert (tot > -1e-11 * G**4).all(), (maj, tot.min())

    def test_alphatilde_sums(self):
        rng = np.random.default_rng(8)
        tm = -(10.0 ** rng.uniform(-4, 2, 300))
        tp = tm * 10.0 ** rng.uniform(0.005, 0.05, 300)
        for maj in (True, False):
            ga = kernels.scalar_width(G, 1.0, maj)
            at_s = kernels.alphatilde_s(arr(tm), arr(tp), G, 1.0, ga)
            if not maj:
                at_s = at_s / 2.0
            at_t = kernels_nr.alphatilde_t(arr(tm), arr(tp), G, majorana=maj)
            at_st = kernels_nr.alphatilde_st(arr(tm), arr(tp), G, ga,
                                             majorana=maj)
            tot = np.asarray(at_s + at_t + at_st)
            assert (tot > -1e-10 * G**4).all(), (maj, tot.min())


class TestWeakCouplingWindow:
    """The s-t/s-u channels must survive float32's exponent window
    (the f32 paths, or an f64 emulated as float32 pairs), down to the
    run_exclusion free-streaming coupling g = 1e-12 (gr^2 ~ 4e-52
    underflows; the pre-guard closed forms NaN/inf-poisoned whole
    tables there — fixed via specfun.log1p_sq_ratio).

    Pure-f32 evaluation on PHYSICAL strict-upper-pair coordinates is
    the hardware-free emulation of that window (stricter in mantissa,
    identical in exponent range). Red if the log-space guards revert.
    """

    def _grid_coords(self, mphi):
        from nusiprop_tpu.config import Config
        from nusiprop_tpu.models import grids, masses

        cfg = Config(N_bins_E=120, lEmin=4.0, lEmax=9.0, zmax=5.0,
                     non_resonant=True)
        gr_ = grids.build(cfg)
        mn = np.asarray(masses.mass_spectrum(0.0587, True))[:, None]
        Em, Ep = np.asarray(gr_.Emin_ext), np.asarray(gr_.Emax_ext)
        N = Em.shape[0]
        rows, cols = np.triu_indices(N, k=1)
        tp = kernels._shift_near_minus1(
            arr(-2.0 * mn * Ep[rows][None, :] / mphi**2))
        tm = kernels._shift_near_minus1(
            arr(-2.0 * mn * Em[rows][None, :] / mphi**2))
        smp = arr(2.0 * mn * Em[cols][None, :] / mphi**2)
        spp = arr(2.0 * mn * Ep[cols][None, :] / mphi**2)
        sm_g = arr(2.0 * mn * Em[None, :] / mphi**2)
        sp_g = arr(2.0 * mn * Ep[None, :] / mphi**2)
        return (kernels_nr._floor_t(tm), kernels_nr._floor_t(tp),
                kernels_nr._floor_s(smp), kernels_nr._floor_s(spp),
                kernels_nr._floor_s(sm_g), kernels_nr._floor_s(sp_g))

    @pytest.mark.parametrize("g", [1e-12, 1e-9, 1e-6])
    @pytest.mark.parametrize("mphi", [1e5, 5e7])
    def test_st_channels_finite_in_f32_window(self, g, mphi):
        f32 = jnp.float32
        tm, tp, smp, spp, sm_g, sp_g = self._grid_coords(mphi)
        ga = kernels.scalar_width(g, mphi, True)
        grat = f32(ga / mphi)
        gam = kernels_nr.gamma_st(sm_g.astype(f32), sp_g.astype(f32),
                                  f32(g), grat)
        assert bool(jnp.isfinite(gam).all())
        for maj in (True, False):
            at = kernels_nr.alphatilde_st(
                tm[:, :120].astype(f32), tp[:, :120].astype(f32),
                f32(g), grat, majorana=maj)
            assert bool(jnp.isfinite(at).all()), ("alphatilde_st", maj)
            al = kernels_nr.alpha_st(tm.astype(f32), tp.astype(f32),
                                     smp.astype(f32), spp.astype(f32),
                                     f32(g), grat, majorana=maj)
            assert bool(jnp.isfinite(al).all()), ("alpha_st", maj)

    def test_weak_coupling_tables_finite_f64(self):
        """Full f64 table build at g = 1e-12 (the exclusion mock):
        every Gamma/alphaTilde/alpha entry finite."""
        from nusiprop_tpu.config import Config
        from nusiprop_tpu.models import grids, masses

        cfg = Config(N_bins_E=48, lEmin=4.0, lEmax=9.0, zmax=5.0,
                     non_resonant=True)
        gr_ = grids.build(cfg)
        mn = masses.mass_spectrum(0.0587, True)
        kw = dict(majorana=True, non_resonant=True, phiphi=False)
        for mphi in (1e5, 5e6):
            tblG = kernels.gamma_table(gr_.Emin_ext, gr_.Emax_ext, mn,
                                       1e-12, mphi, arr([0.3, 0.3, 0.4]), **kw)
            tblAt = kernels.alphatilde_table(gr_.Emin_ext, gr_.Emax_ext, mn,
                                             1e-12, mphi, arr([0.3, 0.3, 0.4]),
                                             **kw)
            tblA = kernels.alpha_table(gr_.Emin_ext, gr_.Emax_ext, mn,
                                       1e-12, mphi, arr([0.3, 0.3, 0.4]), **kw)
            for t in (tblG, tblAt, tblA):
                assert bool(jnp.isfinite(t).all()), mphi
