"""Tests for the N-D spline interpolator (ops/interp.py) against the
semantics of the reference interp::spline_ND (interp.hpp)."""

import jax.numpy as jnp
import numpy as np
import pytest

from nusiprop_tpu.ops import interp

RNG = np.random.default_rng(42)


def random_grid(n, lo=0.0, hi=3.0, regular=False):
    if regular:
        return np.linspace(lo, hi, n)
    x = np.sort(RNG.uniform(lo, hi, n))
    x[0], x[-1] = lo, hi
    # keep intervals non-degenerate
    while np.min(np.diff(x)) < 1e-3:
        x = np.sort(RNG.uniform(lo, hi, n))
        x[0], x[-1] = lo, hi
    return x


class TestSpline1D:
    def test_nodes_are_interpolated(self):
        x = random_grid(17)
        f = np.sin(x) + x**2
        spl = interp.build_spline([x], f)
        got = np.asarray(spl.eval(jnp.asarray(x[1:-1])))
        assert np.allclose(got, f[1:-1], rtol=1e-13, atol=1e-13)

    @pytest.mark.parametrize("regular", [True, False])
    def test_quadratic_exactness(self, regular):
        # cubic-Hermite with finite-difference tangents reproduces
        # quadratics exactly on any grid, including the 3-node edges
        x = random_grid(12, regular=regular)
        f = 2.0 + 0.7 * x - 1.3 * x**2
        spl = interp.build_spline([x], f, regular=regular)
        q = np.linspace(x[0] + 1e-9, x[-1] - 1e-9, 400)
        got = np.asarray(spl.eval(jnp.asarray(q)))
        ref = 2.0 + 0.7 * q - 1.3 * q**2
        assert np.abs(got - ref).max() < 1e-12

    def test_continuity_across_intervals(self):
        x = random_grid(9)
        f = np.cos(2 * x)
        spl = interp.build_spline([x], f)
        for xk in x[1:-1]:
            lo = float(spl.eval(jnp.asarray(xk - 1e-9)))
            hi = float(spl.eval(jnp.asarray(xk + 1e-9)))
            assert abs(lo - hi) < 1e-7

    def test_accuracy_smooth_function(self):
        x = np.linspace(0.0, 3.0, 60)
        spl = interp.build_spline([x], np.sin(x), regular=True)
        q = np.linspace(0.01, 2.99, 500)
        err = np.abs(np.asarray(spl.eval(jnp.asarray(q))) - np.sin(q))
        assert err.max() < 2e-5  # local cubic: ~h^4 with h = 0.05 here

    def test_log_axis_and_log_value(self):
        x = np.geomspace(1.0, 1e3, 40)
        f = x**-2.5
        spl = interp.build_spline([x], f, regular=True, log_axes=[True],
                                  log_value=True)
        q = np.geomspace(1.1, 900.0, 200)
        got = np.asarray(spl.eval(jnp.asarray(q)))
        # power law is exactly linear in (log x, log f): reproduced exactly
        assert np.abs(got / q**-2.5 - 1.0).max() < 1e-11

    def test_clamp_out_of_range(self):
        x = np.linspace(0.0, 1.0, 8)
        spl = interp.build_spline([x], x)
        assert float(spl.eval(jnp.asarray(-5.0))) == pytest.approx(0.0)
        assert float(spl.eval(jnp.asarray(7.0))) == pytest.approx(1.0)
        oob = np.asarray(spl.out_of_bounds(jnp.asarray([-5.0, 0.5, 7.0])))
        assert oob.tolist() == [True, False, True]


class TestSplineND:
    def test_tensor_factorization(self):
        # separable f(x, y) = g(x) h(y) must interpolate to the product of
        # the 1-D interpolants (the scheme is a tensor product)
        x = random_grid(11)
        y = random_grid(9, 1.0, 2.0)
        g = np.exp(0.3 * x)
        h = 1.0 + y**2
        spl2 = interp.build_spline([x, y], np.outer(g, h))
        sx = interp.build_spline([x], g)
        sy = interp.build_spline([y], h)
        qx = RNG.uniform(0.01, 2.99, 50)
        qy = RNG.uniform(1.01, 1.99, 50)
        got = np.asarray(spl2.eval(jnp.asarray(qx), jnp.asarray(qy)))
        ref = np.asarray(sx.eval(jnp.asarray(qx))) * np.asarray(
            sy.eval(jnp.asarray(qy)))
        assert np.abs(got - ref).max() < 1e-12

    def test_3d_quadratic(self):
        xs = [random_grid(7), random_grid(6, 1.0, 2.0),
              random_grid(8, -1.0, 1.0)]
        X, Y, Z = np.meshgrid(*xs, indexing="ij")
        F = X * X + 2 * Y * Z + 0.5 * Z * Z + X * Y
        spl = interp.build_spline(xs, F)
        q = [RNG.uniform(lo + 0.01, hi - 0.01, 30)
             for lo, hi in [(0, 3), (1, 2), (-1, 1)]]
        got = np.asarray(spl.eval(*[jnp.asarray(v) for v in q]))
        ref = (q[0] ** 2 + 2 * q[1] * q[2] + 0.5 * q[2] ** 2
               + q[0] * q[1])
        assert np.abs(got - ref).max() < 1e-11

    def test_vectorization_matches_scalar(self):
        x = np.linspace(0, 3, 10)
        y = np.linspace(1, 2, 12)
        F = np.sin(np.outer(x, y))
        spl = interp.build_spline([x, y], F, regular=True)
        qx = RNG.uniform(0.01, 2.99, 20)
        qy = RNG.uniform(1.01, 1.99, 20)
        batch = np.asarray(spl.eval(jnp.asarray(qx), jnp.asarray(qy)))
        singles = [float(spl.eval(jnp.asarray(a), jnp.asarray(b)))
                   for a, b in zip(qx, qy)]
        assert np.allclose(batch, singles, rtol=0, atol=0)

    def test_astype_f32_eval(self):
        """astype(float32) keeps the index arithmetic and weight
        polynomials in f64 but contracts the stencil in the values
        dtype: the result is f32 and within pure-f32 round-off of the
        f64 interpolant (the f32 path for the phi-phi tables)."""
        xs = [random_grid(7), random_grid(6, 1.0, 2.0),
              random_grid(8, -1.0, 1.0)]
        X, Y, Z = np.meshgrid(*xs, indexing="ij")
        F = np.exp(0.2 * X) * (1 + Y * Y) + Z * X
        spl = interp.build_spline(xs, F)
        spl32 = spl.astype(jnp.float32)
        q = [jnp.asarray(RNG.uniform(lo + 0.01, hi - 0.01, 40))
             for lo, hi in [(0, 3), (1, 2), (-1, 1)]]
        ref = np.asarray(spl.eval(*q))
        got = np.asarray(spl32.eval(*q))
        assert got.dtype == np.float32
        rel = np.abs(got - ref) / np.abs(ref)
        assert rel.max() < 5e-6, rel.max()


class TestBinaryLoader:
    def test_round_trip(self, tmp_path):
        # write a file in the reference binary layout
        # (text_to_binary.cpp:35-37: float32 rows x0 x1 f, last axis fastest)
        x0 = np.geomspace(4.0, 100.0, 20)
        x1 = np.linspace(0.005, 0.05, 10)
        F = np.outer(x0**-1.5, 1.0 + x1)
        rows = np.zeros((200, 3), dtype=np.float32)
        k = 0
        for i in range(20):
            for j in range(10):
                rows[k] = [x0[i], x1[j], F[i, j]]
                k += 1
        path = tmp_path / "tbl.bin"
        rows.tofile(path)
        spl = interp.load_binary_table(str(path), (20, 10), regular=True,
                                       log_axes=[True, False, False])
        # nodes/values survive the float32 round trip
        got = np.asarray(spl.eval(jnp.asarray(x0[5]), jnp.asarray(x1[4])))
        assert got == pytest.approx(F[5, 4], rel=1e-6)

    def test_row_count_mismatch_raises(self, tmp_path):
        path = tmp_path / "bad.bin"
        np.zeros((7, 3), dtype=np.float32).tofile(path)
        with pytest.raises(ValueError):
            interp.load_binary_table(str(path), (4, 2))
