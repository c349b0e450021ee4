"""Special functions vs mpmath oracles.

These are the foundation of every kernel; the reference gets them from GSL
and the polylogarithm library (aux.hpp, nuSIprop.hpp:628-636), we implement
them from scratch, so they are tested to near machine precision.
"""

import jax
import jax.numpy as jnp
import mpmath as mp
import numpy as np
import pytest

from nusiprop_tpu.ops import specfun as sf

pytestmark = pytest.mark.smoke

mp.mp.dps = 40
RNG = np.random.default_rng(42)


def rel_err(got, ref):
    ref = np.asarray(ref, dtype=float)
    got = np.asarray(got, dtype=float)
    return np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)


class TestLi2:
    def test_broad_domain(self):
        xs = np.concatenate(
            [
                -(10.0 ** RNG.uniform(-18, 18, 200)),
                10.0 ** RNG.uniform(-18, -0.31, 80),
                RNG.uniform(0.5, 2.0, 80),
                10.0 ** RNG.uniform(0.31, 18, 80),
                np.array([-1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 1 - 1e-14, 1 + 1e-14]),
            ]
        )
        got = np.asarray(sf.li2(jnp.asarray(xs)))
        ref = np.array([float(mp.re(mp.polylog(2, mp.mpf(x)))) for x in xs])
        assert rel_err(got, ref).max() < 5e-15

    def test_jit_and_grad(self):
        f = jax.jit(sf.li2)
        assert abs(float(f(0.3)) - float(mp.polylog(2, mp.mpf("0.3")))) < 1e-15
        # d/dx Li2(x) = -ln(1-x)/x
        g = jax.grad(lambda x: sf.li2(x))(0.3)
        assert abs(g - (-np.log(0.7) / 0.3)) < 1e-12


class TestLi3:
    def test_broad_domain(self):
        xs = np.concatenate(
            [
                -(10.0 ** RNG.uniform(-18, 18, 300)),
                10.0 ** RNG.uniform(-18, -0.0001, 120),
                np.array([-1.0, -0.6, -0.5, 0.0, 0.5, 0.6, 1.0, -1 - 1e-13]),
            ]
        )
        got = np.asarray(sf.li3(jnp.asarray(xs)))
        ref = np.array([float(mp.re(mp.polylog(3, mp.mpf(x)))) for x in xs])
        assert rel_err(got, ref).max() < 5e-15

    def test_dsnb_argument_range(self):
        # the DSNB source evaluates Li2/Li3 at -exp(-E(1+z)/T) in (-1, 0)
        u = 10.0 ** RNG.uniform(-6, 3, 200)
        xs = -np.exp(-u)
        got2 = np.asarray(sf.li2(jnp.asarray(xs)))
        got3 = np.asarray(sf.li3(jnp.asarray(xs)))
        ref2 = np.array([float(mp.polylog(2, mp.mpf(x))) for x in xs])
        ref3 = np.array([float(mp.polylog(3, mp.mpf(x))) for x in xs])
        assert rel_err(got2, ref2).max() < 5e-15
        assert rel_err(got3, ref3).max() < 5e-15


class TestLi2Complex:
    def test_generic_plane(self):
        zs = (
            RNG.uniform(-40, 40, 200) + 1j * RNG.uniform(-40, 40, 200)
        ) * 10.0 ** RNG.uniform(-3, 3, 200)
        zs = zs[np.abs(zs.imag) > 1e-12]
        got = np.asarray(sf.li2c(jnp.asarray(zs)))
        ref = np.array([complex(mp.polylog(2, complex(z))) for z in zs])
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
        assert err.max() < 1e-13

    def test_cut_limit_from_below(self):
        # real x > 1: GSL's y==0 convention, the limit from below
        # (Im = -pi ln x), cf. gsl_sf_complex_dilog_xy_e used at
        # nuSIprop.hpp:1444-1451 and aux.hpp:91-94.
        xs = np.array([1.5, 3.0, 10.0, 1e4])
        got = np.asarray(sf.li2c(jnp.asarray(xs + 0j)))
        ref = np.array([complex(mp.polylog(2, x)) for x in xs])
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-13
        assert np.allclose(got.imag, -np.pi * np.log(xs), rtol=1e-13)

    def test_matches_real_part(self):
        xs = np.array([-5.0, -1.0, 0.3, 0.9, 1.7, 25.0])
        got = np.asarray(sf.li2c(jnp.asarray(xs + 0j))).real
        ref = np.asarray(sf.li2(jnp.asarray(xs)))
        assert rel_err(got, ref).max() < 1e-13


class TestDiffFunctions:
    """Each diff function vs direct mpmath evaluation, across all branches."""

    def test_atandiff(self):
        xs = 10.0 ** RNG.uniform(-3, 14, 100) * RNG.choice([-1, 1], 100)
        ys = xs * 10.0 ** RNG.uniform(-2, 2, 100) * RNG.choice([1, 1, 1, -1], 100)
        got = np.asarray(sf.atandiff(jnp.asarray(xs), jnp.asarray(ys)))
        ref = np.array([float(mp.atan(x) - mp.atan(y)) for x, y in zip(xs, ys)])
        assert rel_err(got, ref).max() < 1e-9  # Taylor branch is O(1e-10) by design

    def test_dilogdiff(self):
        xs = 10.0 ** RNG.uniform(-8, 12, 150)
        ys = xs * 10.0 ** RNG.uniform(-0.5, 0.5, 150)
        got = np.asarray(sf.dilogdiff(jnp.asarray(xs), jnp.asarray(ys)))
        ref = np.array(
            [float(mp.polylog(2, -x) - mp.polylog(2, -y)) for x, y in zip(xs, ys)]
        )
        scale = np.array(
            [max(abs(float(mp.polylog(2, -x))), 1e-300) for x in xs]
        )
        assert (np.abs(got - ref) / scale).max() < 1e-9

    def test_dilog1mdiff(self):
        xs = 10.0 ** RNG.uniform(-8, 12, 150)
        ys = xs * 10.0 ** RNG.uniform(-0.5, 0.5, 150)
        got = np.asarray(sf.dilog1mdiff(jnp.asarray(xs), jnp.asarray(ys)))
        ref = np.array(
            [
                float(mp.re(mp.polylog(2, -1 - x) - mp.polylog(2, -1 - y)))
                for x, y in zip(xs, ys)
            ]
        )
        scale = np.array([abs(float(mp.re(mp.polylog(2, -1 - x)))) for x in xs])
        assert (np.abs(got - ref) / np.maximum(scale, 1e-300)).max() < 1e-9

    def test_dilog1pdiff(self):
        xs = -(10.0 ** RNG.uniform(-8, 12, 150))
        ys = xs * 10.0 ** RNG.uniform(-0.5, 0.5, 150)
        got = np.asarray(sf.dilog1pdiff(jnp.asarray(xs), jnp.asarray(ys)))
        ref = np.array(
            [
                float(mp.re(mp.polylog(2, 1 + x) - mp.polylog(2, 1 + y)))
                for x, y in zip(xs, ys)
            ]
        )
        scale = np.array(
            [max(abs(float(mp.re(mp.polylog(2, 1 + x)))), 1.0) for x in xs]
        )
        assert (np.abs(got - ref) / scale).max() < 1e-9

    def test_dilog1over1mdiff(self):
        xs = -(10.0 ** RNG.uniform(-8, 12, 150))
        ys = xs * 10.0 ** RNG.uniform(-0.5, 0.5, 150)
        got = np.asarray(sf.dilog1over1mdiff(jnp.asarray(xs), jnp.asarray(ys)))
        ref = np.array(
            [
                float(mp.polylog(2, 1 / (1 - x)) - mp.polylog(2, 1 / (1 - y)))
                for x, y in zip(xs, ys)
            ]
        )
        scale = np.array([max(abs(float(mp.polylog(2, 1 / (1 - x)))), 1e-300) for x in xs])
        assert (np.abs(got - ref) / scale).max() < 1e-9

    def test_dilogdiff_complex(self):
        re = RNG.uniform(-200, 200, 100)
        im = RNG.uniform(-200, 200, 100)
        zs = re + 1j * im
        ws = zs * (1 + RNG.uniform(-0.3, 0.3, 100))
        got = np.asarray(sf.dilogdiff_complex(jnp.asarray(zs), jnp.asarray(ws)))
        ref = np.array(
            [
                complex(mp.polylog(2, complex(z)) - mp.polylog(2, complex(w)))
                for z, w in zip(zs, ws)
            ]
        )
        scale = np.array([max(abs(complex(mp.polylog(2, complex(z)))), 1.0) for z in zs])
        assert (np.abs(got - ref) / scale).max() < 1e-9


class TestQuadrature:
    def test_gl3_exact_for_quintics(self):
        from nusiprop_tpu.ops.quadrature import gl3

        # GL3 integrates polynomials up to degree 5 exactly
        val = float(gl3(lambda x: x**5 - 2 * x**3 + x, 0.0, 2.0))
        exact = 2.0**6 / 6 - 2 * 2.0**4 / 4 + 2.0**2 / 2
        assert abs(val - exact) < 1e-12 * abs(exact)

    def test_gl3_segmented(self):
        from nusiprop_tpu.ops.quadrature import gl3_segmented

        val = float(gl3_segmented(jnp.exp, 0.0, 1.0, 100))
        assert abs(val - (np.e - 1)) < 1e-14


class TestLog1pSafe:
    """Pin the weak-coupling log guards.

    log1p_safe must track mpmath log1p over the whole f64 range on CPU
    and return inf (never NaN) at inf; log1p_sq_ratio must equal
    log1p((x/g)^2) without ever forming the ratio — the s-t/s-u
    channels feed it v^2/gr^2 arguments whose direct evaluation
    overflows float32's exponent window (gr^2 underflows at g ~< 1e-9;
    NaN-poisoned tables at g = 1e-12 were seen under that window before
    the guard).
    """

    def test_log1p_safe_oracle(self):
        xs = np.concatenate([
            10.0 ** RNG.uniform(-300, 60, 400),
            -(10.0 ** RNG.uniform(-300, -0.001, 100)),
            np.array([0.0, 1e15, 1.0000001e15, 1e37, 2e37, 1e60, 1e300]),
        ])
        got = np.asarray(sf.log1p_safe(jnp.asarray(xs)))
        ref = np.array([float(mp.log1p(mp.mpf(x))) for x in xs])
        assert rel_err(got, ref).max() < 3e-16

    def test_log1p_safe_inf_is_inf(self):
        out = np.asarray(sf.log1p_safe(jnp.asarray([np.inf])))
        assert np.isposinf(out).all()

    def test_log1p_sq_ratio_oracle(self):
        x = np.concatenate([
            10.0 ** RNG.uniform(-30, 12, 300),
            -(10.0 ** RNG.uniform(-30, 12, 300)),
            np.array([0.0, 1e-37, 1e12]),
        ])
        g = 10.0 ** RNG.uniform(-30, 2, x.shape[0])
        got = np.asarray(sf.log1p_sq_ratio(jnp.asarray(x), jnp.asarray(g)))
        ref = np.array([float(mp.log1p((mp.mpf(a) / mp.mpf(b)) ** 2))
                        for a, b in zip(x, g)])
        assert rel_err(got, ref).max() < 5e-15

    def test_log1p_sq_ratio_exact_below_one(self):
        # |x| <= |g|: the decomposition collapses to the direct form
        x = jnp.asarray(10.0 ** RNG.uniform(-10, 0, 100)) * 0.5
        g = jnp.asarray(np.ones(100))
        direct = jnp.log1p((x / g) ** 2)
        assert np.array_equal(np.asarray(sf.log1p_sq_ratio(x, g)),
                              np.asarray(direct))

    def test_log1p_sq_ratio_f32_window(self):
        """In pure float32 the ratio form is inf -> NaN territory; the log-space
        form stays finite and accurate. Red if the guard is reverted
        to log1p_safe(x**2 / g**2)."""
        f32 = jnp.float32
        gr = f32(1e-24 / (16.0 * np.pi))   # g = 1e-12 scalar width ratio
        x = jnp.asarray(10.0 ** RNG.uniform(-6, 6, 200), f32)
        naive = sf.log1p_safe(x * x / (gr * gr))          # gr^2 == 0 here
        assert not bool(jnp.isfinite(naive).all())
        got = np.asarray(sf.log1p_sq_ratio(x, gr))
        assert np.isfinite(got).all()
        ref = np.array([float(mp.log1p((mp.mpf(float(a)) / mp.mpf(float(gr))) ** 2))
                        for a in np.asarray(x)])
        assert rel_err(got, ref).max() < 1e-6              # f32 round-off
