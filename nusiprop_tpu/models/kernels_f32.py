"""Float32 s-channel kernel tables for the rank1_f32 march.

With the march in float32 the f64 table build is the larger part of
the s-channel evolve. For the s-channel (the reference's benchmark
path, nuSIprop.hpp:779-791, 956-970, 1264-1275) the closed forms can
run in float32 with full accuracy, because
naive f32 evaluation fails only through cancellation — and every
cancellation here has an exact reformulation:

1. **Coordinates in f64, transcendentals in f32.** s-1 and 1+t (the
   distance to the resonance) and the exact bin-width difference
   d = sp-sm are precomputed in f64 — a handful of
   elementwise ops — and cast. Computing s-1 in f32 would carry a
   1e-7*s absolute error that atan((s-1)/gr) amplifies by 1/gr for bin
   edges landing near the resonance.
2. **Difference-form arctans.** atan(x) - atan(y) evaluates as
   atan((x-y)/(1+xy)) + pi*[xy < -1] (x > y always holds here), with
   x-y supplied exactly from d: uniformly ~1e-7 relative. The separate
   atans cancel catastrophically for adjacent bin edges (2.3% apart).
3. **The exact-integrand quadrature.** The combined closed forms
   (arctan core + ga*log term) cancel to O(s*d) out of O(d) pieces far
   from the resonance (for alphaTilde even to O(d^2)) — but their
   DERIVATIVE collapses exactly:
       (core_G + ga*lt_G)/(mphi*gr) = int_sm^sp 2s/((1-s)^2+gr^2) ds
       (core_T + ga*lt_T)/(mphi*gr) = int_um^up 2(u-um)/((1-u)^2+gr^2) du
   Both integrands are smooth and positive, so a 3-point Gauss-Legendre
   rule evaluates them to <~2.5e-7 relative in f32 EVERYWHERE the
   resonance (at s=1 / u=1, width gr) is farther than ~20 bin widths
   from the interval (mpmath-validated over u in [1e-8, 100] x gr in
   [1e-14, 2e-2]). Inside that vicinity the pieces do not cancel and
   the difference-form closed form is accurate. This echoes the
   reference's own "negative => Gauss-Legendre rescue" philosophy
   (nuSIprop.hpp:799-810) with an exactly-reduced integrand.
4. **Prefactors factored out.** The assembled tables for weak
   couplings sit below the f32 exponent window (rho ~ 1e-39 at the
   golden g = 1e-6 — which an f64 emulated as float32 pairs would
   silently flush too). The builders return NORMALIZED tables with the per-table
   prefactor returned separately as an f64 scalar, applied inside the
   f64 row groupings of transport._rank1_f32_rows where the exponent
   window machinery (pairing small with large factors) already lives.

Validated against the f64 build + mpmath (tests/test_kernels_f32.py),
end-to-end against the f64 march (tests/test_march.py), and on the
card by chip_smoke.py's f32_modes phase.
"""

import math

import jax.numpy as jnp

from nusiprop_tpu.models.kernels import scalar_width, _shift_near_minus1

PI = math.pi
F32 = jnp.float32

# 3-point Gauss-Legendre on [0, 1]: nodes as interval fractions,
# weights summing to 1.
_GL3_C = (0.5 * (1.0 - math.sqrt(3.0 / 5.0)), 0.5,
          0.5 * (1.0 + math.sqrt(3.0 / 5.0)))
_GL3_W = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)

# closed form takes over when sqrt(vmin^2 + gr^2) <= _T_NEAR * d
# (resonance within ~20 bin widths); GL3 error there is (1/20)^6 ~ 2e-8
_T_NEAR = 20.0


def _atandiff32(u, xy):
    """atan(x) - atan(y) for x > y, given u = (x-y)/(1+xy) and xy."""
    return jnp.arctan(u) + jnp.where(xy < -1.0, jnp.float32(PI),
                                     jnp.float32(0.0))


def _logratio32(d_num, m1_sq_gr, ratio):
    """log(ratio) with ratio = (gr^2+p1^2)/(gr^2+m1^2), given the exact
    log1p argument d_num/m1_sq_gr == ratio - 1. Switches to the plain
    log when the ratio is far from 1 (where the f32 log1p argument can
    round to -1 and produce -inf)."""
    arg = d_num / m1_sq_gr
    return jnp.where(jnp.abs(arg) < 0.5, jnp.log1p(arg), jnp.log(ratio))


def _gq_gamma(smf, sm1, d, gr2):
    """GL3 of 2s/((1-s)^2+gr^2) over [sm, sm+d]; s-1 from the f64-cast
    sm1 so edges near the resonance keep full precision."""
    acc = 0.0
    for c, w in zip(_GL3_C, _GL3_W):
        s_i = smf + F32(c) * d
        v_i = sm1 + F32(c) * d   # = s_i - 1
        acc = acc + F32(w) * (2.0 * s_i) / (v_i * v_i + gr2)
    return acc * d


def _gq_alphatilde(tm1, dt, gr2):
    """GL3 of 2(u-um)/((1-u)^2+gr^2) over [um, um+dt]; u-um == c*dt is
    exact, 1-u comes from the f64-cast tm1."""
    acc = 0.0
    for c, w in zip(_GL3_C, _GL3_W):
        v_i = tm1 - F32(c) * dt
        acc = acc + F32(w) * (2.0 * F32(c) * dt) / (v_i * v_i + gr2)
    return acc * dt


def _vicinity(m1, p1, gr2, d):
    """True where the resonance is within ~_T_NEAR bin widths of the
    interval whose edge-to-resonance distances are m1 and p1."""
    crossing = m1 * p1 < 0.0
    vmin = jnp.where(crossing, 0.0,
                     jnp.minimum(jnp.abs(m1), jnp.abs(p1)))
    t_d = F32(_T_NEAR) * d
    return (vmin * vmin + gr2) <= t_d * t_d


def s_channel_tables_f32(Emin_ext, Emax_ext, mn, g, mphi, Wf, *,
                         majorana: bool, width_factor=None):
    """Normalized s-channel tables in native float32.

    Returns ``(tblG, tblAt, rho, (pref_G, pref_At, pref_rho))``: three
    (N,) float32 arrays and their float64 scalar prefactors, such that
    ``pref_* * tbl_*`` equals the corresponding f64 builder output
    (kernels.gamma_table / alphatilde_table / alpha_s_rho restricted to
    channel="s"). Dirac halving and the near-resonance coordinate shift
    (nuSIprop.hpp:949-954) match the f64 builders exactly.
    """
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:
        ga = ga * width_factor

    # ---- f64 coordinate precompute (cheap elementwise) ----
    mn_c = mn[:, None]
    inv_m2 = 1.0 / (mphi * mphi)
    s_m = 2.0 * mn_c * Emin_ext[None, :] * inv_m2
    s_p = 2.0 * mn_c * Emax_ext[None, :] * inv_m2
    d64 = 2.0 * mn_c * (Emax_ext - Emin_ext)[None, :] * inv_m2
    sm1_64 = s_m - 1.0
    sp1_64 = s_p - 1.0
    tm64 = _shift_near_minus1(-s_m)
    tp64 = _shift_near_minus1(-s_p)
    tm1_64 = 1.0 + tm64
    tp1_64 = 1.0 + tp64
    dt64 = tm64 - tp64  # == d64 except where the shift fired

    gr64 = ga / mphi
    f = lambda a: jnp.asarray(a).astype(F32)
    sm1, sp1, tm1, tp1 = f(sm1_64), f(sp1_64), f(tm1_64), f(tp1_64)
    d, dt = f(d64), f(dt64)
    sp32, smf = f(s_p), f(s_m)
    gr = f(gr64)
    inv_gr = f(1.0 / gr64)
    mphi32 = f(mphi)
    ga32 = f(ga)
    gr2 = gr * gr
    G2 = 1.0 + gr2

    # ---- shared resonance factor R = atandiff((sp-1)/gr, (sm-1)/gr) ----
    x_p = sp1 * inv_gr
    x_m = sm1 * inv_gr
    xy_s = x_p * x_m
    u_s = (d * inv_gr) / (1.0 + xy_s)
    R_exact = _atandiff32(u_s, xy_s)
    R_taylor = (gr * (G2 + 2.0 * smf) / (G2 * G2) * d
                + gr / (G2 * G2) * d * d)
    R = jnp.where(sp32 < 1e-5, R_taylor, R_exact)

    # ---- Gamma (nuSIprop.hpp:779-791): pref_G*(2 mphi R + ga lt) ----
    sm1_sq_gr = gr2 + sm1 * sm1
    ratio_G = (gr2 + sp1 * sp1) / sm1_sq_gr
    lt_G = _logratio32(d * (sp1 + sm1), sm1_sq_gr, ratio_G)
    G_near = 2.0 * mphi32 * R_exact + ga32 * lt_G
    G_far = (mphi32 * gr) * _gq_gamma(smf, sm1, d, gr2)
    tblG_e = jnp.where(_vicinity(sm1, sp1, gr2, d), G_near, G_far)

    # ---- alphaTilde (nuSIprop.hpp:956-970) ----
    y_m = tm1 * inv_gr
    y_p = tp1 * inv_gr
    xy_t = y_m * y_p
    u_t = (dt * inv_gr) / (1.0 + xy_t)
    core_t = 2.0 * mphi32 * tm1 * _atandiff32(u_t, xy_t)
    tm1_sq_gr = gr2 + tm1 * tm1
    ratio_t = (gr2 + tp1 * tp1) / tm1_sq_gr
    lt_t = _logratio32(-dt * (tp1 + tm1), tm1_sq_gr, ratio_t)
    At_near = core_t + ga32 * lt_t
    At_far = (mphi32 * gr) * _gq_alphatilde(tm1, dt, gr2)
    tblAt_e = jnp.where(_vicinity(tm1, tp1, gr2, dt), At_near, At_far)

    # ---- rho: source factor of the rank-one alpha (kernels.alpha_s_rho,
    #      nuSIprop.hpp:1264-1269) ----
    rho_e = dt * R

    if not majorana:
        tblAt_e = tblAt_e * 0.5
        rho_e = rho_e * 0.5

    # eigenstate reduction |U|^2 / (2 mn); weights precomputed in f64
    w_e = f(Wf[:, None] / (2.0 * mn_c))
    tblG = jnp.sum(w_e * tblG_e, axis=0)
    tblAt = jnp.sum(w_e * tblAt_e, axis=0)
    inv_dE = f(1.0 / (Emax_ext - Emin_ext))
    rho = jnp.sum(w_e * rho_e, axis=0) * inv_dE

    # f64 scalar prefactors, range-safe order (g^2/denom)*g^2
    g64 = jnp.asarray(g, jnp.float64)
    g2_64 = g64 * g64
    pref_G = g2_64 / (32.0 * PI * ga) * g2_64
    pref_At = g2_64 / (16.0 * PI * ga) * g2_64
    pref_rho = (g2_64 / (8.0 * PI * ga) * g2_64) * mphi
    return tblG, tblAt, rho, (pref_G, pref_At, pref_rho)
