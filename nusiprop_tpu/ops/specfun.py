"""Special functions for the self-interaction kernels, in pure JAX.

No GSL and no polylogarithm library run on the device, so everything here is
implemented from scratch in float64 with branch-free region reduction
(``jnp.where`` over clamped arguments so every branch is evaluated on a
safe input). All functions are elementwise and vectorize/vmap freely.

Provided:
  * ``li2(x)``        — real dilogarithm Li2(x); returns Re(Li2) for x > 1
                        (same semantics the reference relies on from
                        gsl_sf_dilog, cf. nuSIprop.hpp:1098, 1375-1398).
  * ``li3(x)``        — real trilogarithm Li3(x) for x <= 1
                        (reference: polylogarithm::Li3, nuSIprop.hpp:633-636).
  * ``li2c(z)``       — principal-branch complex dilogarithm. For real
                        arguments on the cut (x > 1) the limit from *above*
                        is taken, Im = +pi ln x, which is the continuous
                        companion of the resonance-regulated arguments
                        z = (...)/(2 - i*gamma + t) that appear in the
                        s-t interference kernels (nuSIprop.hpp:1431-1451).
  * the six cancellation-controlled difference functions of the reference
    aux library (aux.hpp:63-166): ``atandiff``, ``dilogdiff``,
    ``dilogdiff_complex``, ``dilog1mdiff``, ``dilog1pdiff``,
    ``dilog1over1mdiff`` — exact evaluation in the mid-range, Taylor
    series for very large/small arguments where the direct difference
    would suffer catastrophic cancellation.
"""

import jax.numpy as jnp

from nusiprop_tpu.ops import cplx as cp

__all__ = [
    "li2",
    "li3",
    "li2c",
    "li2cx",
    "dilogdiff_cx",
    "atandiff",
    "dilogdiff",
    "dilogdiff_complex",
    "dilog1mdiff",
    "dilog1pdiff",
    "dilog1over1mdiff",
]

PI = float(jnp.pi) if False else 3.141592653589793
PI2_6 = 1.6449340668482264  # pi^2/6
ZETA3 = 1.202056903159594285

# Li2(z) = w - w^2/4 + sum_k LI2_C[k] * w^(2k+3),  w = -ln(1-z),
# LI2_C[k] = B_{2(k+1)} / (2k+3)!   (Bernoulli-number series; converges
# geometrically for |w| < 2*pi, we only use it with |w| <~ 1.72)
LI2_C = (
    0.02777777777777777778,
    -0.0002777777777777777778,
    4.724111866969009826e-6,
    -9.185773074661963551e-8,
    1.897886998897099907e-9,
    -4.064761645144225527e-11,
    8.921691020456452555e-13,
    -1.993929586072107569e-14,
    4.518980029619918192e-16,
    -1.035651761218124701e-17,
    2.395218621026186746e-19,
    -5.581785874325009336e-21,
    1.309150755418321286e-22,
    -3.087419802426740293e-24,
    7.31597565270220342e-26,
    -1.740845657234000741e-27,
    4.15763564461389972e-29,
    -9.962148488284622103e-31,
    2.394034424896165301e-32,
    -5.768347355367390084e-34,
)

# Li3(e^w) = zeta3 + zeta2*w + w^2/2*(3/2 - ln(-w)) + sum_{k>=3} zeta(3-k)/k! w^k
LI3_LOG_C = (
    -0.08333333333333333333,
    -0.003472222222222222222,
    0.0,
    1.157407407407407407e-5,
    0.0,
    -9.841899722852103804e-8,
    0.0,
    1.148221634332745444e-9,
    0.0,
    -1.581572499080916589e-11,
    0.0,
    2.419500979252515195e-13,
    0.0,
    -3.982897776989487748e-15,
    0.0,
    6.923366618305929058e-17,
    0.0,
    -1.255272230449977275e-18,
    0.0,
    2.353754002768465231e-20,
    0.0,
    -4.536398903458687018e-22,
    0.0,
    8.945169670392643167e-24,
)


def log1p_safe(x):
    """log(1+x) robust to huge ``x``.

    Under an f64 emulated as float32 pairs (float32's exponent range)
    any argument above ~3.4e38 IS inf, and both
    ``jnp.log1p`` and ``jnp.log`` return NaN at inf there (on true-f64
    CPU both are finite and correct up to ~1.8e308 — the original
    version of this docstring mis-attributed the failure to XLA's
    log1p lowering; tests/test_specfun.py::test_log1p_safe pins the
    actual contract). Above 1e15, log(x) equals log1p(x) to <1e-15
    relative, so switch over there; below, the argument is clamped into
    the reliable window so the discarded branch stays finite (the where
    keeps forward and reverse mode clean). An inf argument returns inf,
    never NaN — but note inf is already a range-safety failure upstream:
    expressions that can overflow the f32 exponent window must use
    ``log1p_sq_ratio`` (log-space) instead of forming the ratio.
    """
    big = x > 1e15
    finite_big = jnp.minimum(jnp.maximum(x, 1.0), 1e37)
    out = jnp.where(big, jnp.log(finite_big),
                    jnp.log1p(jnp.minimum(x, 1e15)))
    # restore the exact log for finite x > 1e37 on true-f64 backends
    # (on the emulated backend x > ~3.4e38 never reaches here finite)
    out = jnp.where(jnp.isfinite(x) & (x > 1e37),
                    jnp.log(jnp.where(jnp.isfinite(x) & (x > 1e37), x, 1.0)),
                    out)
    return jnp.where(jnp.isinf(x) & (x > 0), jnp.inf, out)


# |g|-floor of log1p_sq_ratio: representable (normal) on BOTH backends
# (f32 min normal 1.18e-38). Only reached when gr itself underflowed —
# physically the free-streaming regime, where the g^4 channel prefactor
# has underflowed the flux contribution anyway.
_RATIO_G_FLOOR = 1e-37


def log1p_sq_ratio(x, g):
    """log1p((x/g)^2) without forming x^2, g^2, or the ratio.

    The s-t/s-u interference channels (nuSIprop.hpp:842-872, 1134-1186,
    1427-1467) evaluate log(1 + v^2/gr^2) with gr = Gamma/mphi ~
    g^2/(16 pi). At weak coupling (g = 1e-12: gr ~ 2e-26) gr^2
    underflows float32's exponent range, the ratio becomes inf, and
    log(inf) is NaN there — this
    NaN-poisoned whole Gamma/alphaTilde tables and silently zeroed the
    run_exclusion free-streaming mock. Decompose instead as

        log1p((x/g)^2) = 2*(log M - log|g|) + log1p((m/M)^2),
        M = max(|x|, |g|), m = min(|x|, |g|),

    where every factor is representable whenever x and g themselves
    are: for |x| <= |g| this reduces EXACTLY to the direct form (the
    log difference is identically zero), otherwise it differs only by
    rounding (~1 ulp). |g| is floored at 1e-37 so a fully underflowed
    g yields a large finite value rather than inf.
    """
    a = jnp.abs(x)
    b = jnp.maximum(jnp.abs(g), _RATIO_G_FLOOR)
    M = jnp.maximum(a, b)
    r = jnp.minimum(a, b) / M
    return 2.0 * (jnp.log(M) - jnp.log(b)) + jnp.log1p(r * r)


def _li2_series(z):
    """Bernoulli series for Li2, valid for z in [-1, 0.5] (real)."""
    w = -jnp.log1p(-z)
    w2 = w * w
    s = jnp.zeros_like(w)
    for c in reversed(LI2_C):
        s = (s + c) * w2
    return w - w * w * 0.25 + s * w


def li2(x):
    """Real dilogarithm; equals Re(Li2(x)) for x > 1 (GSL convention)."""
    x = jnp.asarray(x)
    r_inv_neg = x < -1.0
    r_mid = (x > 0.5) & (x <= 2.0)
    r_inv_pos = x > 2.0
    safe_x = jnp.where(x == 0.0, 1.0, x)
    # mapped argument lands in [-1, 0.5] for every region
    xs = jnp.where(
        r_inv_neg | r_inv_pos,
        1.0 / safe_x,
        jnp.where(r_mid, 1.0 - x, x),
    )
    s = _li2_series(jnp.clip(xs, -1.0, 0.5))
    lx = jnp.log(jnp.abs(safe_x))
    l1mx = jnp.log(jnp.abs(jnp.where(x == 1.0, 1.0, 1.0 - x)))
    return jnp.where(
        r_mid,
        PI2_6 - lx * l1mx - s,
        jnp.where(
            r_inv_neg,
            -PI2_6 - 0.5 * lx * lx - s,
            jnp.where(r_inv_pos, 2.0 * PI2_6 - 0.5 * lx * lx - s, s),
        ),
    )


def _li3_power_series(x):
    """sum_{k=1..80} x^k/k^3, for |x| <= 0.6."""
    s = jnp.zeros_like(x)
    for k in range(80, 0, -1):
        s = s * x + 1.0 / (k * k * k)
    return s * x


def _li3_log_expansion(x):
    """Li3(x) for x in (0.4, 1] via the expansion in w = ln(x)."""
    w = jnp.log(jnp.clip(x, 0.4, 1.0))
    mw = jnp.where(w == 0.0, 1.0, -w)  # ln(-w) -> w^2 factor kills the w=0 case
    s = jnp.zeros_like(w)
    for c in reversed(LI3_LOG_C):
        s = s * w + c
    s = s * w * w * w
    return ZETA3 + PI2_6 * w + 0.5 * w * w * (1.5 - jnp.log(mw)) + s


def _li3_01(x):
    """Li3 on [0, 1]."""
    return jnp.where(
        x > 0.6,
        _li3_log_expansion(x),
        _li3_power_series(jnp.minimum(x, 0.6)),
    )


def li3(x):
    """Real trilogarithm Li3(x), valid for x <= 1."""
    x = jnp.asarray(x)
    # x < -1 -> inversion: Li3(x) = Li3(1/x) - zeta2 ln(-x) - ln^3(-x)/6
    inv = x < -1.0
    xi = jnp.where(inv, 1.0 / jnp.minimum(x, -1.0), jnp.clip(x, -1.0, 1.0))
    # xi in [-1, 1]; for xi in [-1, -0.5): Li3(xi) = Li3(xi^2)/4 - Li3(-xi)
    core = jnp.where(
        xi >= -0.5,
        jnp.where(
            xi >= 0.0,
            _li3_01(jnp.clip(xi, 0.0, 1.0)),
            _li3_power_series(jnp.clip(xi, -0.6, 0.0)),
        ),
        0.25 * _li3_01(jnp.clip(xi * xi, 0.0, 1.0)) - _li3_01(jnp.clip(-xi, 0.0, 1.0)),
    )
    lnx = jnp.log(jnp.maximum(-x, 1.0))
    return jnp.where(inv, core - PI2_6 * lnx - lnx * lnx * lnx / 6.0, core)


# ---------------------------------------------------------------------------
# Complex dilogarithm
# ---------------------------------------------------------------------------

def _li2_series_c(z):
    """Bernoulli series for complex Li2; needs |Log(1-z)| < 2*pi."""
    w = -jnp.log(1.0 - z)
    w2 = w * w
    s = jnp.zeros_like(w)
    for c in reversed(LI2_C):
        s = (s + c) * w2
    return w - w * w * 0.25 + s * w


def li2c(z):
    """Principal-branch complex dilogarithm.

    For arguments exactly on the cut (real x > 1) the limit from *below*
    is returned: Im Li2(x - i0) = -pi*ln(x). This is the convention of
    GSL's gsl_sf_complex_dilog_xy_e at y == 0 (and of Mathematica/mpmath),
    which the reference relies on when it feeds exactly-real arguments to
    its complex dilog differences (aux.hpp:91-94, nuSIprop.hpp:1444-1451).
    Genuinely complex arguments are unaffected.
    """
    z = jnp.asarray(z, dtype=jnp.complex128)
    az = jnp.abs(z)
    big = az > 1.0
    safe_z = jnp.where(z == 0.0, 1.0, z)
    zi = jnp.where(big, 1.0 / safe_z, z)  # |zi| <= 1
    refl = jnp.real(zi) > 0.5
    zs = jnp.where(refl, 1.0 - zi, zi)
    # keep the series argument in its convergence region for untaken branches
    s = _li2_series_c(jnp.where(jnp.abs(zs) > 1.0 + 1e-12, 0.0, zs))
    safe_zi = jnp.where(zi == 0.0, 1.0, zi)
    safe_1mzi = jnp.where(zi == 1.0, 1.0, 1.0 - zi)
    val = jnp.where(refl, PI2_6 - jnp.log(safe_zi) * jnp.log(safe_1mzi) - s, s)
    # inversion: Li2(z) = -pi^2/6 - Log(-z)^2/2 - Li2(1/z)
    # For z on the positive real axis the sign of Im(-z) is the sign of -0.0,
    # which is implementation-defined; force the limit-from-below (GSL)
    # convention by rotating real z > 1 infinitesimally into the lower
    # half-plane.
    on_cut = big & (jnp.imag(z) == 0.0) & (jnp.real(z) > 0.0)
    lnm = jnp.log(jnp.where(on_cut, -jnp.real(z) + 1e-300j, -safe_z))
    return jnp.where(big, -PI2_6 - 0.5 * lnm * lnm - val, val)


# ---------------------------------------------------------------------------
# Complex dilogarithm on (re, im) float64 pairs, for backends without
# complex dtypes: the s-t interference kernels use these
# pair-based versions; they mirror li2c / dilogdiff_complex exactly.
# ---------------------------------------------------------------------------

def _li2_series_cx(z):
    """Bernoulli series for Li2 on Cx pairs; needs |Log(1-z)| < 2*pi."""
    w = cp.log(1.0 - z)
    w = cp.Cx(-w.re, -w.im)
    w2 = w * w
    s = cp.cx(jnp.zeros_like(w.re))
    for c in reversed(LI2_C):
        s = (s + c) * w2
    return w - (w * w) * 0.25 + s * w


def li2cx(z):
    """Complex dilogarithm on a Cx pair — same algorithm and branch-cut
    convention as ``li2c`` (GSL: Im Li2(x - i0) = -pi ln x on the cut),
    but free of complex dtypes so it compiles on any backend."""
    az2 = z.re * z.re + z.im * z.im
    big = az2 > 1.0
    is_zero = (z.re == 0.0) & (z.im == 0.0)
    safe_z = cp.where(is_zero, cp.cx(jnp.ones_like(z.re)), z)
    zi = cp.where(big, 1.0 / safe_z, z)
    refl = zi.re > 0.5
    zs = cp.where(refl, 1.0 - zi, zi)
    zs_az2 = zs.re * zs.re + zs.im * zs.im
    zs = cp.where(zs_az2 > (1.0 + 1e-12) ** 2,
                  cp.cx(jnp.zeros_like(zs.re)), zs)
    s = _li2_series_cx(zs)
    zi_zero = (zi.re == 0.0) & (zi.im == 0.0)
    safe_zi = cp.where(zi_zero, cp.cx(jnp.ones_like(zi.re)), zi)
    zi_one = (zi.re == 1.0) & (zi.im == 0.0)
    safe_1mzi = cp.where(zi_one, cp.cx(jnp.ones_like(zi.re)), 1.0 - zi)
    val = cp.where(refl, PI2_6 - cp.log(safe_zi) * cp.log(safe_1mzi) - s, s)
    # inversion: Li2(z) = -pi^2/6 - Log(-z)^2/2 - Li2(1/z); on the cut
    # (real z > 1) force arg(-z) = +pi so Im Li2 = -pi ln z (from below).
    on_cut = big & (z.im == 0.0) & (z.re > 0.0)
    neg = cp.Cx(-z.re * jnp.ones_like(safe_z.re),
                jnp.where(on_cut, 0.0, -z.im))
    neg = cp.where(big, neg, cp.cx(jnp.ones_like(z.re)))
    lnm = cp.log(neg)
    return cp.where(big, -PI2_6 - (lnm * lnm) * 0.5 - val, val)


def dilogdiff_cx(x, y):
    """Li2(x) - Li2(y) on Cx pairs (mirrors ``dilogdiff_complex``)."""
    big = (cp.cabs(x) > 1e2) & (cp.cabs(y) > 1e2)

    def tail(z):
        sgn = jnp.where(z.im >= 0.0, 1.0, -1.0)
        is_zero = (z.re == 0.0) & (z.im == 0.0)
        sz = cp.where(is_zero, cp.cx(jnp.ones_like(z.re)), z)
        iz = 1.0 / sz
        lz = cp.log(sz)
        iz2 = iz * iz
        inner = lz * (-2.0 * PI * sgn) - cp.Cx(-lz.im, lz.re) * lz  # -sgn*2pi*L - i L^2
        return (
            -(iz2 * iz2) * (1.0 / 16.0)
            - (iz2 * iz) * (1.0 / 9.0)
            - iz2 * 0.25
            - iz
            - cp.Cx(-inner.im, inner.re) * 0.5  # -i/2 * inner = -0.5*(i*inner)
        )

    return cp.where(big, tail(x) - tail(y), li2cx(x) - li2cx(y))


# ---------------------------------------------------------------------------
# Cancellation-controlled difference functions (reference: aux.hpp:63-166)
# ---------------------------------------------------------------------------

def atandiff(x, y):
    """atan(x) - atan(y); Taylor in 1/x when both |x|,|y| >= 1e2, same sign."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    exact = (jnp.abs(x) < 1e2) | (jnp.abs(y) < 1e2) | (x * y < 0)
    sx = jnp.where(x == 0.0, 1.0, x)
    sy = jnp.where(y == 0.0, 1.0, y)
    ix, iy = 1.0 / sx, 1.0 / sy
    taylor = (-ix + ix * ix * ix / 3.0) - (-iy + iy * iy * iy / 3.0)
    return jnp.where(exact, jnp.arctan(x) - jnp.arctan(y), taylor)


def _dilog_tail_large(x):
    """Asymptotics of Li2(-x) + log(x)^2/2 for x >> 1 (x positive)."""
    ix = 1.0 / x
    return ix - ix * ix / 4.0 + ix * ix * ix / 9.0 - (ix * ix) * (ix * ix) / 16.0


def dilogdiff(x, y):
    """Li2(-x) - Li2(-y) for positive x, y (aux.hpp:98-113)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    big = (x > 1e2) & (y > 1e2)
    small = (x < 1e-2) & (y < 1e-2)
    sx = jnp.maximum(x, 1e-300)
    sy = jnp.maximum(y, 1e-300)
    lx, ly = jnp.log(sx), jnp.log(sy)
    t_big = (-0.5 * lx * lx + _dilog_tail_large(sx)) - (
        -0.5 * ly * ly + _dilog_tail_large(sy)
    )
    t_small = (-x + x * x / 4.0 - x * x * x / 9.0 + (x * x) * (x * x) / 16.0) - (
        -y + y * y / 4.0 - y * y * y / 9.0 + (y * y) * (y * y) / 16.0
    )
    return jnp.where(big, t_big, jnp.where(small, t_small, li2(-x) - li2(-y)))


def dilogdiff_complex(x, y):
    """Li2(x) - Li2(y) for complex x, y; asymptotic series when both big."""
    x = jnp.asarray(x, dtype=jnp.complex128)
    y = jnp.asarray(y, dtype=jnp.complex128)
    big = (jnp.abs(x) > 1e2) & (jnp.abs(y) > 1e2)

    def tail(z):
        sgn = jnp.where(jnp.imag(z) >= 0.0, 1.0, -1.0)
        sz = jnp.where(z == 0.0, 1.0, z)
        iz = 1.0 / sz
        lz = jnp.log(sz)
        return (
            -(iz * iz) * (iz * iz) / 16.0
            - iz * iz * iz / 9.0
            - iz * iz / 4.0
            - iz
            - 0.5j * (-sgn * 2.0 * PI * lz - 1j * lz * lz)
        )

    return jnp.where(big, tail(x) - tail(y), li2c(x) - li2c(y))


def dilog1mdiff(x, y):
    """Li2(-1-x) - Li2(-1-y) for positive x, y (aux.hpp:115-130)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    big = (x > 1e2) & (y > 1e2)
    small = (x < 1e-2) & (y < 1e-2)
    sx = jnp.maximum(x, 1e-300)
    sy = jnp.maximum(y, 1e-300)
    lx, ly = jnp.log(sx), jnp.log(sy)
    LN2 = 0.6931471805599453

    def tail(v, lv):
        v2 = v * v
        return (
            -0.5 * lv * lv
            + (1.0 - lv) / v
            + (-7.0 + 2.0 * lv) / (4.0 * v2)
            + (19.0 - 3.0 * lv) / (9.0 * v2 * v)
            + (-125.0 + 12.0 * lv) / (48.0 * v2 * v2)
        )

    def small_series(v):
        v2 = v * v
        return (
            -v * LN2
            + v2 * (-1.0 + 2.0 * LN2) / 4.0
            + v2 * v * (5.0 - 8.0 * LN2) / 24.0
            + v2 * v2 * (-1.0 / 6.0 + LN2 / 4.0)
        )

    return jnp.where(
        big,
        tail(sx, lx) - tail(sy, ly),
        jnp.where(small, small_series(x) - small_series(y), li2(-1.0 - x) - li2(-1.0 - y)),
    )


def dilog1pdiff(x, y):
    """Li2(1+x) - Li2(1+y) for negative x, y (aux.hpp:132-148)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    big = (-x > 1e2) & (-y > 1e2)
    small = (-x < 1e-2) & (-y < 1e-2)
    sx = jnp.minimum(x, -1e-300)
    sy = jnp.minimum(y, -1e-300)
    lx, ly = jnp.log(-sx), jnp.log(-sy)

    def tail(v, lv):
        v2 = v * v
        return (
            (-1.0 - 3.0 * lv) / (9.0 * v2 * v)
            + (-1.0 - lv) / v
            - 0.5 * lv * lv
            + (1.0 + 2.0 * lv) / (4.0 * v2)
            + (1.0 + 4.0 * lv) / (16.0 * v2 * v2)
        )

    def small_series(v, lv):
        v2 = v * v
        return (
            v * (1.0 - lv)
            + v2 * (-1.0 + 2.0 * lv) / 4.0
            + v2 * v * (1.0 - 3.0 * lv) / 9.0
            + v2 * v2 * (-1.0 + 4.0 * lv) / 16.0
        )

    return jnp.where(
        big,
        tail(sx, lx) - tail(sy, ly),
        jnp.where(
            small,
            small_series(sx, lx) - small_series(sy, ly),
            li2(1.0 + x) - li2(1.0 + y),
        ),
    )


def dilog1over1mdiff(x, y):
    """Li2(1/(1-x)) - Li2(1/(1-y)) for negative x, y (aux.hpp:150-166)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    big = (-x > 1e2) & (-y > 1e2)
    small = (-x < 1e-2) & (-y < 1e-2)
    sx = jnp.minimum(x, -1e-300)
    sy = jnp.minimum(y, -1e-300)
    lx, ly = jnp.log(-sx), jnp.log(-sy)

    def tail(v):
        v2 = v * v
        return (
            -25.0 / (48.0 * v2 * v2)
            - 11.0 / (18.0 * v2 * v)
            - 3.0 / (4.0 * v2)
            - 1.0 / v
        )

    def small_series(v, lv):
        v2 = v * v
        return (
            v2 * v2 * (-19.0 - 12.0 * lv) / 48.0
            + v2 * v * (-7.0 - 6.0 * lv) / 18.0
            + v2 * (-1.0 - 2.0 * lv) / 4.0
            + v * (1.0 - lv)
        )

    return jnp.where(
        big,
        tail(sx) - tail(sy),
        jnp.where(
            small,
            small_series(sx, lx) - small_series(sy, ly),
            li2(1.0 / (1.0 - x)) - li2(1.0 / (1.0 - y)),
        ),
    )
