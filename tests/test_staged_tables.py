"""Staged per-channel table builds must equal the monolithic in-graph
build (the staging exists purely to bound compile times)."""

import jax
import jax.numpy as jnp
import numpy as np

from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models import grids, kernels, masses, mixing, transport


def test_staged_matches_monolithic():
    cfg = Config(N_bins_E=40, lEmin=9.0, lEmax=14.0, non_resonant=True,
                 phiphi=False, source="powerlaw")
    p = PhysicsParams.create(6e5, 0.01, 0.1, 2.5, 1.0)

    tblG, tblAt, tblA = transport.build_tables(p, cfg)

    gr = grids.build(cfg)
    Wf = jnp.asarray(mixing.pmns_sq(True))[cfg.flav]
    mn = masses.mass_spectrum(p.mntot, True)
    kw = dict(majorana=True, non_resonant=True, phiphi=False, pp_tables=None)
    mG = kernels.gamma_table(gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf, **kw)
    mAt = kernels.alphatilde_table(gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf, **kw)
    mA = kernels.alpha_table(gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf, **kw)

    # The channel-sum association differs (staged weights each channel by
    # |U|^2/(2 mn) before summing). Where opposite-sign interference
    # channels cancel several digits, reassociation shows up at ~1e-8
    # relative on the CANCELLED REMAINDER — neither order is more exact,
    # and the physical gates (golden <1e-3, march cross-checks <1e-11 on
    # the flux) are far above this.
    np.testing.assert_allclose(np.asarray(tblG), np.asarray(mG), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tblAt), np.asarray(mAt), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tblA), np.asarray(mA), rtol=1e-6)


def test_staged_batched_matches_single():
    cfg = Config(N_bins_E=30, lEmin=9.0, lEmax=14.0, non_resonant=True,
                 phiphi=False, source="powerlaw")
    batch = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        PhysicsParams.create(6e5, 0.01, 0.1, 2.5, 1.0),
        PhysicsParams.create(3e6, 0.003, 0.1, 2.5, 1.0),
    )
    bG, bAt, bA = transport.build_tables(batch, cfg, batched=True)
    for k in range(2):
        p = jax.tree.map(lambda x: x[k], batch)
        sG, sAt, sA = transport.build_tables(p, cfg)
        np.testing.assert_array_equal(np.asarray(bG[k]), np.asarray(sG))
        np.testing.assert_array_equal(np.asarray(bAt[k]), np.asarray(sAt))
        np.testing.assert_array_equal(np.asarray(bA[k]), np.asarray(sA))


def test_pp_alpha_chunked_matches_unchunked(monkeypatch):
    """The lax.map pair-chunking of the spline-backed pp alpha program
    (a compiler-memory bound, see kernels._PP_CHUNK) is elementwise
    restructuring only: forcing a small chunk on a small grid must
    reproduce the unchunked build up to fusion-dependent last-ulp
    rounding (the chunk body compiles standalone, so XLA's FMA/fusion
    choices differ; measured max 5.3e-16 rel on CPU)."""
    from nusiprop_tpu.models import pp_tables as ppt

    cfg = Config(N_bins_E=24, lEmin=9.0, lEmax=14.0, non_resonant=True,
                 phiphi=True, source="powerlaw")
    p = PhysicsParams.create(6e5, 0.01, 0.1, 2.5, 1.0)
    tables = ppt.load_default()
    gr = grids.build(cfg)
    Wf = jnp.asarray(mixing.pmns_sq(True))[cfg.flav]
    mn = masses.mass_spectrum(p.mntot, True)
    kw = dict(majorana=True, non_resonant=True, phiphi=True,
              pp_tables=tables, channel="pp")

    ref = np.asarray(kernels.alpha_table(
        gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf, **kw))
    # NT at 24 bins is well under the production threshold; force
    # chunking (incl. a ragged tail: NT = 31*61 pairs vs chunk 64)
    monkeypatch.setattr(kernels, "_PP_CHUNK", 64)
    chunked = np.asarray(kernels.alpha_table(
        gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf, **kw))
    np.testing.assert_allclose(chunked, ref, rtol=1e-14, atol=0)
