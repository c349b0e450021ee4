"""Tests for the phi-phi table pipeline: the on-device generator
(tools/make_tables.py), the PPTables interpolation plumbing, and the
table-backed kernel channels (kernels_nr.alphatilde_pp / alpha_pp)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import make_tables  # noqa: E402

from nusiprop_tpu.models import kernels_nr, pp_tables  # noqa: E402

DATA = Path(__file__).resolve().parents[1] / "data" / "pp_tables_small.npz"


def ref_alphatilde_entry(T, d):
    """scipy dblquad oracle — the reference's own integral
    (tables_phiphi.py:30-34)."""
    delta = 10.0**d
    tp, tm = -T, -T / delta
    val, _ = integrate.dblquad(
        lambda s, t: make_tables.dsigma_np(s, t), tp, tm,
        lambda t: max(-t, 4.0, -t * t / (1 + t)), lambda t: -tp,
        epsabs=1e-300, epsrel=1e-10)
    return val


def ref_alpha_entry(S, n, d):
    """scipy dblquad oracle (tables_phiphi.py:48-55)."""
    delta = 10.0**d
    smin = S / delta
    tmin = -smin / delta**n
    tplus = tmin * delta
    val, _ = integrate.dblquad(
        lambda s, t: make_tables.dsigma_np(s, t), tplus, tmin,
        lambda t: max(smin, 4.0), lambda t: S,
        epsabs=1e-300, epsrel=1e-10)
    return val


class TestGeneratorQuadrature:
    """The JAX fixed-order quadrature vs scipy adaptive dblquad."""

    def test_alphatilde_entries(self):
        at_fn, _ = make_tables._jax_fns()
        rng = np.random.default_rng(11)
        for _ in range(6):
            T = 10.0 ** rng.uniform(np.log10(4.001), 4)
            d = rng.uniform(0.005, 0.05)
            ref = ref_alphatilde_entry(T, d)
            got = float(at_fn(jnp.asarray(T), jnp.asarray(d)))
            if ref == 0.0:
                assert got == 0.0
            else:
                assert abs(got - ref) < 3e-6 * abs(ref)

    def test_alpha_entries(self):
        _, a_fn = make_tables._jax_fns()
        rng = np.random.default_rng(12)
        cases = [(10.0 ** rng.uniform(np.log10(4.001), 4),
                  rng.uniform(1, 1000), rng.uniform(0.005, 0.05))
                 for _ in range(5)]
        # adversarial: boundary curve crosses the integration rectangle
        cases += [(8.0, 1.5, 0.04), (30.0, 2.0, 0.04), (5.0, 1.0, 0.01)]
        for S, n, d in cases:
            ref = ref_alpha_entry(S, n, d)
            got = float(a_fn(jnp.asarray(S), jnp.asarray(n),
                             jnp.asarray(d)))
            assert abs(got - ref) < 3e-6 * abs(ref) + 1e-40, (S, n, d)


@pytest.fixture(scope="module")
def small_tables():
    if not DATA.exists():
        pytest.skip("small tables not generated")
    # pin to the small file: the node-value assertions below
    # compare against ITS grid (load_default may pick a finer table)
    return pp_tables.load_npz(str(DATA))


class TestPPTables:
    def test_spline_hits_nodes(self, small_tables):
        d = np.load(DATA)
        # interpolation at interior nodes reproduces the table values
        i, j = 57, 9
        got = float(small_tables.alphatilde.eval(
            jnp.asarray(d["at_tplus"][i]), jnp.asarray(d["at_log10d"][j])))
        assert got == pytest.approx(float(d["at_values"][i, j]), rel=1e-10)
        i, j, k = 31, 17, 11
        got = float(small_tables.alpha.eval(
            jnp.asarray(d["a_splus"][i]), jnp.asarray(d["a_n"][j]),
            jnp.asarray(d["a_log10d"][k])))
        assert got == pytest.approx(float(d["a_values"][i, j, k]),
                                    rel=1e-10)

    def test_interp_between_nodes(self, small_tables):
        # off-node lookups track the direct quadrature at table accuracy
        T, dd = 237.0, 0.0313
        ref = ref_alphatilde_entry(T, dd)
        got = float(small_tables.eval_alphatilde(jnp.asarray(T),
                                                 jnp.asarray(dd)))
        assert abs(got - ref) < 5e-3 * abs(ref)

    def test_binary_round_trip(self, tmp_path, small_tables):
        d = np.load(DATA)
        at_p = tmp_path / "alphatilde_phiphi.bin"
        a_p = tmp_path / "alpha_phiphi.bin"
        pp_tables.save_binary(
            at_p, a_p, d["at_tplus"], d["at_log10d"], d["at_values"],
            d["a_splus"], d["a_n"], d["a_log10d"], d["a_values"])
        loaded = pp_tables.load_binary(
            str(at_p), str(a_p),
            alphatilde_shape=d["at_values"].shape,
            alpha_shape=d["a_values"].shape)
        q = (jnp.asarray(500.0), jnp.asarray(0.02))
        a = float(small_tables.eval_alphatilde(*q))
        b = float(loaded.eval_alphatilde(*q))
        assert b == pytest.approx(a, rel=1e-5)  # float32 round trip

    def test_text_format_round_trip(self, tmp_path, small_tables):
        """The reference interpolator also reads .dat text tables
        (interp.hpp:173-247); load_text must agree with the in-memory
        spline to full float64 precision (no float32 packing)."""
        d = np.load(DATA)

        def write_dat(path, cols):
            rows = np.column_stack([np.asarray(c).reshape(-1) for c in cols])
            with open(path, "w") as f:
                f.write("# comment line must be skipped\n")
                for r in rows:
                    f.write(" ".join(f"{v:.17g}" for v in r) + "\n")

        at_shape = d["at_values"].shape
        a_shape = d["a_values"].shape
        write_dat(tmp_path / "at.dat", [
            np.repeat(d["at_tplus"], at_shape[1]),
            np.tile(d["at_log10d"], at_shape[0]),
            d["at_values"]])
        write_dat(tmp_path / "a.dat", [
            np.repeat(d["a_splus"], a_shape[1] * a_shape[2]),
            np.tile(np.repeat(d["a_n"], a_shape[2]), a_shape[0]),
            np.tile(d["a_log10d"], a_shape[0] * a_shape[1]),
            d["a_values"]])
        loaded = pp_tables.load_text(
            str(tmp_path / "at.dat"), str(tmp_path / "a.dat"),
            alphatilde_shape=at_shape, alpha_shape=a_shape)
        q = (jnp.asarray(500.0), jnp.asarray(0.02))
        np.testing.assert_allclose(
            float(loaded.eval_alphatilde(*q)),
            float(small_tables.eval_alphatilde(*q)), rtol=1e-14)
        q3 = (jnp.asarray(50.0), jnp.asarray(3.0), jnp.asarray(0.02))
        np.testing.assert_allclose(
            float(loaded.eval_alpha(*q3)),
            float(small_tables.eval_alpha(*q3)), rtol=1e-14)


class TestKernelChannels:
    """The table-backed kernel channels against direct quadrature.

    alphatilde_pp(tm, tp) should equal (up to multiplicities and the
    table's interpolation error) the dsigma double integral over the
    same-bin window; kernels_nr evaluates the spline at the reference's
    exact lookup coordinates (nuSIprop.hpp:1199, 1483).
    """

    def test_alphatilde_pp(self, small_tables):
        tp, tm = -200.0, -190.0
        got = float(kernels_nr.alphatilde_pp(
            jnp.asarray(tm), jnp.asarray(tp), 1.0, majorana=False,
            pp_tables=small_tables))
        ref = 2.0 * ref_alphatilde_entry(200.0, float(np.log10(tp / tm)))
        assert abs(got - ref) < 5e-3 * abs(ref)

    def test_alphatilde_pp_majorana_x4(self, small_tables):
        args = (jnp.asarray(-95.0), jnp.asarray(-100.0), 1.0)
        d_ = float(kernels_nr.alphatilde_pp(*args, majorana=False,
                                            pp_tables=small_tables))
        m_ = float(kernels_nr.alphatilde_pp(*args, majorana=True,
                                            pp_tables=small_tables))
        assert m_ == pytest.approx(4.0 * d_, rel=1e-12)

    def test_alphatilde_pp_below_threshold(self, small_tables):
        got = float(kernels_nr.alphatilde_pp(
            jnp.asarray(-3.0), jnp.asarray(-3.9), 1.0, majorana=True,
            pp_tables=small_tables))
        assert got == 0.0

    def test_alpha_pp(self, small_tables):
        # bins: target t in [tp, tm], source s' in [smp, spp]
        smp, spp = 50.0, 52.0
        delta = spp / smp
        tm, tp = -8.0, -8.0 * delta
        got = float(kernels_nr.alpha_pp(
            jnp.asarray(tm), jnp.asarray(tp), jnp.asarray(smp),
            jnp.asarray(spp), 1.0, majorana=False,
            pp_tables=small_tables))
        n = np.log(smp / -tm) / np.log(delta)
        ref = 2.0 * ref_alpha_entry(spp, n, float(np.log10(delta)))
        assert abs(got - ref) < 2e-2 * abs(ref)

    def test_alphatilde_pp_taylor_tail(self):
        # -tplus >= 1e4: analytic tail, no tables needed
        # (nuSIprop.hpp:1202). Oracle: direct quadrature.
        tp, tm = -1.2e4, -1.1e4
        got = float(kernels_nr.alphatilde_pp(
            jnp.asarray(tm), jnp.asarray(tp), 1.0, majorana=False,
            pp_tables=None))
        ref = 2.0 * ref_alphatilde_entry(1.2e4, float(np.log10(tp / tm)))
        assert abs(got - ref) < 2e-2 * abs(ref)

    def test_alpha_pp_taylor_tail_regimes(self):
        # sminus' >= 1e4: three tail regimes by target-bin position
        # relative to t = -1 (nuSIprop.hpp:1487-1492)
        smp, spp = 1.2e4, 1.25e4
        delta = spp / smp
        for tm, label in [(-5.0, "tminus<-1"),
                          (-0.99, "straddle"),
                          (-0.5, "above")]:
            tp = tm * 1.05
            got = float(kernels_nr.alpha_pp(
                jnp.asarray(tm), jnp.asarray(tp), jnp.asarray(smp),
                jnp.asarray(spp), 1.0, majorana=False, pp_tables=None))
            val, _ = integrate.dblquad(
                lambda s, t: make_tables.dsigma_np(s, t), tp, tm,
                lambda t: smp, lambda t: spp,
                epsabs=1e-300, epsrel=1e-10)
            ref = 2.0 * val
            assert abs(got - ref) < 5e-2 * abs(ref) + 1e-30, label


class TestEvolveWithPhiPhi:
    def test_pp_jit_cached_per_config(self, small_tables):
        """evolve(params, cfg, pp_tables=...) must reuse one jitted
        program per Config — a fresh jit object per call would retrace
        (and recompile) every evolve."""
        import dataclasses

        from nusiprop_tpu.config import Config, PhysicsParams
        from nusiprop_tpu.models import transport

        transport._jitted_evolve_with_pp.cache_clear()
        # rank1 is the march family that reaches the traced-pp-tables
        # jit branch (staged configs consume pp_tables in build_tables)
        cfg = Config(N_bins_E=16, lEmin=9, lEmax=14, non_resonant=False,
                     phiphi=False, march="rank1", source="powerlaw")
        p = PhysicsParams.create(6e5, 0.03, 0.1, 2.5, 1.0)
        transport.evolve(p, cfg, pp_tables=small_tables)
        transport.evolve(
            dataclasses.replace(p, g=jnp.asarray(0.02)), cfg,
            pp_tables=small_tables)
        info = transport._jitted_evolve_with_pp.cache_info()
        assert info.misses == 1 and info.hits == 1, info

    def test_end_to_end(self, small_tables):
        import nusiprop_tpu as nu

        kw = dict(mphi=6e5, g=0.03, mntot=0.1, si=2.5, norm=1.0,
                  N_bins_E=32, lEmin=9, lEmax=14, non_resonant=True,
                  source="powerlaw")
        ev = nu.Evolver(phiphi=True, **kw).evolve()
        f = ev.get_flux_fla()
        assert np.isfinite(f).all() and (f > 0).all()
        # the channel must actually contribute
        f0 = nu.Evolver(phiphi=False, **kw).evolve().get_flux_fla()
        rel = np.abs(f - f0) / np.abs(f0)
        assert rel.max() > 1e-3
        # and not wreck the energy budget
        assert abs(ev.check_energy_conservation()) < 0.2


class TestStrictExtrapolation:
    """Config(extrapolation='raise'): reference-strict out-of-table
    behavior for the phi-phi spline path (interp.hpp:354-361). The
    realistic trigger is the log10(delta) axis — tables cover bin
    ratios of [0.005, 0.05] decades."""

    @pytest.fixture(scope="class")
    def medium_tables(self):
        p = DATA.parent / "pp_tables_medium.npz"
        if not p.exists():
            pytest.skip("medium tables not generated")
        return pp_tables.load_npz(str(p))

    def test_out_of_range_config_raises(self, medium_tables):
        from nusiprop_tpu.config import Config, PhysicsParams
        from nusiprop_tpu.models import transport

        # 50 bins over 5 decades: delta = 0.1 decades, above the
        # tables' 0.05 ceiling -> every active pp lookup extrapolates
        cfg = Config(N_bins_E=50, lEmin=9, lEmax=14, non_resonant=True,
                     phiphi=True, extrapolation="raise",
                     source="powerlaw")
        p = PhysicsParams.create(6e5, 0.03, 0.1, 2.5, 1.0)
        with pytest.raises(RuntimeError, match="extrapolation"):
            transport.check_pp_extrapolation(p, cfg, medium_tables)
        with pytest.raises(RuntimeError, match="exit\\(1\\)"):
            transport.evolve(p, cfg, pp_tables=medium_tables)

    def test_in_range_config_passes(self, medium_tables):
        from nusiprop_tpu.config import Config, PhysicsParams
        from nusiprop_tpu.models import transport

        # 250 bins over 5 decades: delta = 0.02, inside the table axes
        cfg = Config(N_bins_E=250, lEmin=9, lEmax=14, non_resonant=True,
                     phiphi=True, extrapolation="raise",
                     source="powerlaw")
        p = PhysicsParams.create(6e5, 0.03, 0.1, 2.5, 1.0)
        transport.check_pp_extrapolation(p, cfg, medium_tables)  # no raise

    def test_default_clamp_unchanged(self, medium_tables):
        """The default policy stays 'clamp': the out-of-range config
        evolves without raising (documented deviation)."""
        from nusiprop_tpu.config import Config, PhysicsParams
        from nusiprop_tpu.models import transport

        cfg = Config(N_bins_E=50, lEmin=9, lEmax=14, non_resonant=True,
                     phiphi=True, source="powerlaw")
        assert cfg.extrapolation == "clamp"
        p = PhysicsParams.create(6e5, 0.03, 0.1, 2.5, 1.0)
        res = transport.evolve(p, cfg, pp_tables=medium_tables)
        assert bool(jnp.isfinite(res.flux).all())
