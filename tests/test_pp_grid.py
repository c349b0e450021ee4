"""Cross-validation of the separable phi-phi alpha build.

kernels.alpha_pp_grid evaluates the reference's 3-D spline lookup
(nuSIprop.hpp:1483) separably over the tensor grid that the log-uniform
energy grid induces — axis-by-axis matmuls instead of a 64-point gather
stencil per bin pair. These tests gate it against the general per-pair
oracle (kernels_nr.alpha_pp_norm via _PP_BUILD="pairs") at table and
flux level, in both table dtypes.

Known, deliberate delta (alpha_pp_grid docstring): the per-pair path
floors |tminus| at 1e-8 (and applies the near -1 shift) inside its n
coordinate; the reference uses raw coordinates, where n is exactly
(col-row)*1.0001 on its grids. The affected rows are excluded from the
elementwise comparison and counted instead.
"""

import contextlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config
from nusiprop_tpu.models import (grids, kernels, masses, mixing,
                                 pp_tables, transport)

pytestmark = pytest.mark.smoke

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
DATA = Path(__file__).resolve().parents[1] / "data"


@contextlib.contextmanager
def pp_build(mode):
    old = kernels._PP_BUILD
    kernels._PP_BUILD = mode
    # the transport-level builders close over kernels._PP_BUILD at trace
    # time; drop their jit wrappers so each mode traces fresh
    transport._pp_norm_builder_jit.cache_clear()
    transport._channel_builder_jit.cache_clear()
    transport._jitted_evolve_with_pp.cache_clear()
    try:
        yield
    finally:
        kernels._PP_BUILD = old
        transport._pp_norm_builder_jit.cache_clear()
        transport._channel_builder_jit.cache_clear()
        transport._jitted_evolve_with_pp.cache_clear()


@pytest.fixture(scope="module")
def tables():
    return pp_tables.load_npz(str(DATA / "pp_tables_medium.npz"))


def _coords(cfg, mphi, mntot):
    gr = grids.build(cfg)
    mn = masses.mass_spectrum(jnp.asarray(mntot), cfg.normal_ordering)
    Wf = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
    return gr, mn, Wf


def _sliver_rows(gr, mn, mphi):
    """Rows where the per-pair path's n-coordinate deviates from
    d*1.0001: |tminus| below the 1e-8 floor, or the near -1 shift."""
    mtm = 2.0 * np.asarray(mn)[:, None] * np.asarray(gr.Emin_ext)[None, :] \
        / (mphi * mphi)
    return (mtm < 1e-8) | (np.abs(mtm - 1.0) < 1e-7)


CASES = [
    # mphi, mntot, lEmin, lEmax, N  (spline + tail regimes, Maj/Dirac)
    (6e5, 0.1, 9.0, 14.0, 48),
    (2e6, MNTOT, 9.0, 14.0, 48),
]


@pytest.mark.parametrize("mphi,mntot,lo,hi,N", CASES)
@pytest.mark.parametrize("majorana", [True, False])
def test_grid_vs_pairs_norm_f64(tables, mphi, mntot, lo, hi, N, majorana):
    cfg = Config(N_bins_E=N, lEmin=lo, lEmax=hi, non_resonant=True,
                 phiphi=True, majorana=majorana)
    gr, mn, Wf = _coords(cfg, mphi, mntot)
    args = (gr.Emin_ext, gr.Emax_ext, mn, jnp.asarray(mphi))
    kw = dict(majorana=majorana, pp_tables=tables)
    with pp_build("grid"):
        got = np.asarray(kernels.alpha_pp_table_norm(*args, None, **kw))
    with pp_build("pairs"):
        ref = np.asarray(kernels.alpha_pp_table_norm(*args, None, **kw))
    sliver = _sliver_rows(gr, mn, mphi)[:, :, None]
    sliver = np.broadcast_to(sliver, ref.shape)
    ok = ~sliver
    denom = np.abs(ref) + 1e-300
    rel = np.abs(got - ref) / denom
    assert rel[ok & (ref != 0)].max() < 1e-7, rel[ok & (ref != 0)].max()
    # zeros must agree exactly (masking/strict-upper parity)
    assert (got[ok & (ref == 0)] == 0).all()
    # the sliver is a sliver: at most one row per (state) can straddle
    # the floor AND survive the -tplus >= 1e-8 mask
    diff_rows = np.unique(np.nonzero(
        np.any((rel > 1e-7) & sliver & (got != 0), axis=2))[1])
    assert diff_rows.size <= 6, diff_rows


def test_grid_vs_pairs_norm_f32(tables):
    """f32-cast tables (the trisolve_f32 path). Different summation
    order (matmul vs per-pair fma chain) -> f32 round-off gate."""
    t32 = tables._replace(alpha=tables.alpha.astype(jnp.float32))
    cfg = Config(N_bins_E=48, lEmin=9.0, lEmax=14.0, non_resonant=True,
                 phiphi=True)
    gr, mn, Wf = _coords(cfg, 6e5, 0.1)
    args = (gr.Emin_ext, gr.Emax_ext, mn, jnp.asarray(6e5))
    kw = dict(majorana=True, pp_tables=t32)
    with pp_build("grid"):
        got = np.asarray(kernels.alpha_pp_table_norm(*args, Wf, **kw))
    with pp_build("pairs"):
        ref = np.asarray(kernels.alpha_pp_table_norm(*args, Wf, **kw))
    assert got.dtype == np.float32 == ref.dtype
    nz = ref != 0
    rel = np.abs(got[nz] - ref[nz]) / np.abs(ref[nz])
    assert rel.max() < 5e-6, rel.max()


def test_alpha_table_pp_channel_grid_vs_pairs(tables):
    """The g^4-carrying alpha_table(channel='pp') staged-build entry."""
    cfg = Config(N_bins_E=40, lEmin=9.0, lEmax=14.0, non_resonant=True,
                 phiphi=True)
    gr, mn, Wf = _coords(cfg, 6e5, 0.1)
    args = (gr.Emin_ext, gr.Emax_ext, mn, jnp.asarray(0.03),
            jnp.asarray(6e5), Wf)
    kw = dict(majorana=True, non_resonant=True, phiphi=True,
              pp_tables=tables, channel="pp")
    with pp_build("grid"):
        got = np.asarray(kernels.alpha_table(*args, **kw))
    with pp_build("pairs"):
        ref = np.asarray(kernels.alpha_table(*args, **kw))
    nz = ref != 0
    rel = np.abs(got[nz] - ref[nz]) / np.abs(ref[nz])
    assert rel.max() < 1e-7, rel.max()
    assert (got[~nz] == 0).all()


def test_flux_end_to_end_grid_vs_pairs(tables):
    """Full phi-phi evolve, grid vs per-pair build: flux-level gate."""
    kw = dict(mphi=6e5, g=0.03, mntot=0.1, si=2.5, norm=1.0,
              N_bins_E=32, lEmin=9, lEmax=14, non_resonant=True,
              phiphi=True, source="powerlaw")
    # Evolver loads the packaged default tables (the same medium ones)
    with pp_build("grid"):
        f_grid = nu.Evolver(**kw).evolve().get_flux_fla()
    with pp_build("pairs"):
        f_pairs = nu.Evolver(**kw).evolve().get_flux_fla()
    assert np.isfinite(f_grid).all()
    rel = np.abs(f_grid - f_pairs) / (np.abs(f_pairs) + 1e-300)
    gate = np.abs(f_pairs) > 1e-10 * np.abs(f_pairs).max()
    assert rel[gate].max() < 1e-8, rel[gate].max()


@pytest.mark.parametrize("lo,hi,mphi", [(4.0, 9.0, 1e2), (12.0, 17.0, 6e5)])
def test_tail_bases_vs_elementwise(lo, hi, mphi):
    """The rank-5 bilinear tail factorization (alpha_pp_tail_bases) must
    reproduce the elementwise closed forms (alpha_pp_tail) to f64
    round-off in f64 and to f32 round-off when the bases are cast —
    i.e. no cross-term cancellation survives the factorization."""
    from nusiprop_tpu.models import kernels_nr as knr

    cfg = Config(N_bins_E=120, lEmin=lo, lEmax=hi, zmax=5.0,
                 non_resonant=True, phiphi=True)
    gr_ = grids.build(cfg)
    mn = np.asarray(masses.mass_spectrum(0.1, True))[:, None]
    Em, Ep = np.asarray(gr_.Emin_ext), np.asarray(gr_.Emax_ext)
    N = Em.shape[0]
    tm_f = knr._floor_t(kernels._shift_near_minus1(
        jnp.asarray(-2.0 * mn * Em[None, :] / mphi**2)))
    tp_f = knr._floor_t(kernels._shift_near_minus1(
        jnp.asarray(-2.0 * mn * Ep[None, :] / mphi**2)))
    smp_s = jnp.maximum(knr._floor_s(
        jnp.asarray(2.0 * mn * Em[None, :] / mphi**2)), 4.0 + 1e-12)
    spp_s = jnp.maximum(knr._floor_s(
        jnp.asarray(2.0 * mn * Ep[None, :] / mphi**2)),
        smp_s * (1.0 + 1e-12))
    ref = np.asarray(knr.alpha_pp_tail(
        tm_f[:, :, None], tp_f[:, :, None],
        smp_s[:, None, :], spp_s[:, None, :]))
    F, H = knr.alpha_pp_tail_bases(tm_f, tp_f, smp_s, spp_s)
    got64 = np.asarray(jnp.einsum("srk,skc->src", F, H))
    import jax as _jax

    got32 = np.asarray(jnp.einsum(
        "srk,skc->src", F.astype(jnp.float32), H.astype(jnp.float32),
        precision=_jax.lax.Precision.HIGHEST)).astype(np.float64)
    # gate on the physically used region (tail columns, strict upper)
    mask = ((np.asarray(smp_s) >= 1e4)[:, None, :]
            & (np.arange(N)[None, :, None] < np.arange(N)[None, None, :]))
    assert mask.any() == (mphi in (1e2, 6e5))
    scale = np.abs(ref[mask]).max() if mask.any() else np.abs(ref).max()
    floor = scale * 1e-15
    rel64 = (np.abs(got64 - ref)[mask]
             / np.maximum(np.abs(ref)[mask], floor)).max() if mask.any() else 0
    rel32 = (np.abs(got32 - ref)[mask]
             / np.maximum(np.abs(ref)[mask], floor)).max() if mask.any() else 0
    assert rel64 < 1e-9, rel64
    assert rel32 < 2e-6, rel32
