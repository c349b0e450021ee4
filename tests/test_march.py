"""Cross-validation of the three march implementations.

The "loop" march is shaped like the reference's descending-bin sweep
(nuSIprop.hpp:266-315) and serves as the oracle; "rank1" (associative
scan over the exactly-rank-one s-channel alpha) and "trisolve" (scalar
triangular-solve closure of the back-substitution) must agree with it to
float64 round-off — they are reformulations, not approximations.
"""

import dataclasses

import numpy as np
import pytest

from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models import transport

pytestmark = pytest.mark.smoke

MNTOT = 0.0 + np.sqrt(7.42e-5) + np.sqrt(2.514e-3)


def _run(cfg):
    p = PhysicsParams.create(mphi=5e6, g=1e-6, mntot=MNTOT, si=2.0, norm=6.0)
    return np.asarray(transport.evolve(p, cfg).flux_fla)


def _rel(a, b):
    scale = np.maximum(np.abs(a), np.abs(b))
    return np.max(np.abs(a - b) / np.where(scale > 0, scale, 1.0))


@pytest.fixture(scope="module")
def base_cfg():
    return Config(
        N_bins_E=60, lEmin=4.0, lEmax=9.0, zmax=5.0,
        non_resonant=False, phiphi=False, source="dsnb",
    )


def test_rank1_matches_loop(base_cfg):
    loop = _run(dataclasses.replace(base_cfg, march="loop"))
    fast = _run(dataclasses.replace(base_cfg, march="rank1"))
    assert _rel(loop, fast) < 1e-11


def test_trisolve_matches_loop_schannel(base_cfg):
    loop = _run(dataclasses.replace(base_cfg, march="loop"))
    tri = _run(dataclasses.replace(base_cfg, march="trisolve"))
    assert _rel(loop, tri) < 1e-11


def test_trisolve_matches_loop_nonresonant(base_cfg):
    cfg = dataclasses.replace(
        base_cfg, non_resonant=True, N_bins_E=40,
        lEmin=9.0, lEmax=14.0, source="powerlaw",
    )
    p = PhysicsParams.create(mphi=6e5, g=0.01, mntot=0.1, si=2.5, norm=1.0)
    loop = np.asarray(
        transport.evolve(p, dataclasses.replace(cfg, march="loop")).flux_fla
    )
    tri = np.asarray(
        transport.evolve(p, dataclasses.replace(cfg, march="trisolve")).flux_fla
    )
    assert _rel(loop, tri) < 1e-11


def test_rank1_rejects_nonresonant(base_cfg):
    cfg = dataclasses.replace(base_cfg, non_resonant=True, march="rank1")
    with pytest.raises(ValueError, match="rank1"):
        _run(cfg)


def test_rank1_f32_matches_f64(base_cfg):
    """The free-streaming-preconditioned native-f32 march must agree with
    the f64 engine far inside the physical gate on every bin within 10
    decades of peak (f32 round-off touches only the interaction
    corrections; see transport.march_rank1_f32)."""
    ref = _run(dataclasses.replace(base_cfg, march="rank1"))
    f32 = _run(dataclasses.replace(base_cfg, march="rank1_f32"))
    m = np.abs(ref) > np.abs(ref).max() * 1e-10
    rel = np.max(np.abs(f32 - ref)[m] / np.abs(ref)[m])
    assert rel < 1e-4, rel


def test_march_unroll_identical(base_cfg):
    """Unrolling the z-scan is a scheduling choice, not an arithmetic
    one: results must be bit-identical to the unroll=1 program."""
    one = _run(dataclasses.replace(base_cfg, march="rank1_f32"))
    four = _run(dataclasses.replace(base_cfg, march="rank1_f32",
                                    march_unroll=4))
    assert np.array_equal(one, four)


@pytest.mark.parametrize("mphi,g", [(1e5, 1e-2), (2.7e5, 1e-2), (5e6, 1e-6)])
@pytest.mark.parametrize("tables", ["f64", "f32"])
def test_f32_rows_survive_narrow_exponent_window(mphi, g, tables):
    """Guard the row precompute against float32's exponent window.

    Under an f64 emulated as float32 pairs (double-single arithmetic),
    any grouping that wanders below ~1.2e-38 flushes to zero and
    silently corrupts the rows (this killed regeneration via
    rho*ndfac ~ 1e-40 before the _RSCALE pairing). The row builder
    routes every grouping through a ``window`` hook; passing a flush
    emulator reproduces that range behavior at full f64 precision, so
    window bugs are caught on any machine. On the card, chip_smoke.py's
    f32_modes phase checks the f32 march against the f64 one.
    """
    import jax
    import jax.numpy as jnp

    from nusiprop_tpu.models import grids, kernels, masses, mixing, sources

    F32_TINY = float(np.finfo(np.float32).tiny)   # 1.18e-38
    F32_HUGE = float(np.finfo(np.float32).max)    # 3.40e38

    def flush(x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        a = jnp.abs(x)
        x = jnp.where(a < F32_TINY, jnp.zeros_like(x), x)
        return jnp.where(a > F32_HUGE, jnp.sign(x) * jnp.inf, x)

    cfg = Config(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=False, phiphi=False, march="rank1_f32")
    p = PhysicsParams.create(mphi=mphi, g=g, mntot=MNTOT, si=2.0, norm=6.0)
    truth = np.asarray(transport.evolve(
        p, dataclasses.replace(cfg, march="rank1")).flux)

    gr = grids.build(cfg)
    Wf = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
    mn = masses.mass_spectrum(p.mntot, cfg.normal_ordering)
    norm_total = p.norm / sources.flux_fs_e0(p.si, gr.zmax_eff)
    dE_ext = gr.Emax_ext - gr.Emin_ext
    if tables == "f32":
        from nusiprop_tpu.models import kernels_f32

        tblG, tblAt, rho, prefs = kernels_f32.s_channel_tables_f32(
            gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf,
            majorana=cfg.majorana)
    else:
        kw = dict(majorana=cfg.majorana, non_resonant=False, phiphi=False)
        tblG = kernels.gamma_table(gr.Emin_ext, gr.Emax_ext, mn, p.g,
                                   p.mphi, Wf, **kw)
        tblAt = kernels.alphatilde_table(gr.Emin_ext, gr.Emax_ext, mn, p.g,
                                         p.mphi, Wf, **kw)
        rho = kernels.alpha_s_rho(gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi,
                                  Wf, majorana=cfg.majorana, scaled=True)
        prefs = (1.0, 1.0, transport._INV_RSCALE)

    # tables built under the same window arrive already flushed
    xs, scale = transport._rank1_f32_rows(
        cfg, gr, p, norm_total, flush(tblG), flush(tblAt), flush(rho),
        dE_ext, window=flush, prefs=prefs)
    assert all(bool(jnp.isfinite(x).all()) for x in xs)
    phi = transport._rank1_f32_scan(xs, Wf, cfg.N_bins_E)
    flux = (np.asarray(phi, dtype=np.float64)
            * np.asarray(scale, dtype=np.float64)[None, :]
            / np.asarray(gr.Emax - gr.Emin)[None, :])

    m = np.abs(truth) > np.abs(truth).max() * 1e-10
    rel = np.max(np.abs(flux - truth)[m] / np.abs(truth)[m])
    assert rel < 1e-3, rel


def test_rank1_f32_strong_coupling():
    cfg = Config(N_bins_E=80, lEmin=9.0, lEmax=14.0, zmax=5.0,
                 non_resonant=False, phiphi=False, source="powerlaw")
    p = PhysicsParams.create(3e5, 0.02, 0.1, 2.5, 1.0)
    ref = np.asarray(transport.evolve(p, cfg).flux_fla)
    f32 = np.asarray(transport.evolve(
        p, dataclasses.replace(cfg, march="rank1_f32")).flux_fla)
    m = np.abs(ref) > np.abs(ref).max() * 1e-10
    rel = np.max(np.abs(f32 - ref)[m] / np.abs(ref)[m])
    assert rel < 1e-4, rel


def test_scaled_rho_survives_f32_window():
    """The raw weak-coupling rho table sits at ~1e-39..1e-50 — entirely
    below the f32 exponent floor, so under float32's range it
    would flush IN STORAGE before any consumer rescale. The scaled=True
    form must keep every physically relevant entry above the floor."""
    import jax.numpy as jnp

    from nusiprop_tpu.models import grids, kernels, masses, mixing

    cfg = Config(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=False, phiphi=False)
    gr = grids.build(cfg)
    Wf = jnp.asarray(mixing.pmns_sq(True))[cfg.flav]
    mn = masses.mass_spectrum(MNTOT, True)
    raw = np.asarray(kernels.alpha_s_rho(
        gr.Emin_ext, gr.Emax_ext, mn, 1e-6, 5e6, Wf, majorana=True))
    sc = np.asarray(kernels.alpha_s_rho(
        gr.Emin_ext, gr.Emax_ext, mn, 1e-6, 5e6, Wf, majorana=True,
        scaled=True))
    f32_tiny = float(np.finfo(np.float32).tiny)
    assert np.abs(raw).max() < f32_tiny          # the hazard is real
    pk = np.abs(sc).max()
    assert pk > f32_tiny                          # and the fix lifts it
    m = np.abs(sc) > pk * 1e-6                    # relevant entries
    assert np.abs(sc)[m].min() > f32_tiny
    np.testing.assert_allclose(sc, raw * 2.0**100, rtol=0)  # exact
