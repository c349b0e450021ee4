"""Mesh-sharded grid scans on the 8-virtual-device CPU mesh.

conftest.py provisions ``xla_force_host_platform_device_count=8``; these
tests exercise the actual ``jax.sharding`` paths — the default-mesh
``sharded_grid_scan`` (the path the reference replaces with serial
re-runs, SURVEY.md §5 comm-backend entry), explicit sub-meshes, the
uneven-batch error, and shard placement of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config
from nusiprop_tpu.parallel.scan import sharded_grid_scan

pytestmark = pytest.mark.smoke

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))


@pytest.fixture(scope="module")
def cfg():
    return Config(N_bins_E=24, lEmin=4.0, lEmax=9.0, non_resonant=False,
                  phiphi=False)


@pytest.fixture(scope="module")
def params16():
    return nu.param_grid(np.geomspace(1e5, 1e8, 8), [1e-6, 1e-4],
                         mntot=MNTOT, si=2.0, norm=6.0)  # 16 points


def test_devices_provisioned():
    assert len(jax.devices()) == 8, (
        "conftest must provision 8 virtual CPU devices")


def test_default_mesh_matches_unsharded(cfg, params16):
    """The zero-argument path (builds its own mesh from jax.devices())
    must agree with plain vmap batching to float64 round-off."""
    sharded = sharded_grid_scan(params16, cfg)
    ref = nu.grid_scan(params16, cfg)
    np.testing.assert_allclose(np.asarray(sharded.flux_fla),
                               np.asarray(ref.flux_fla), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sharded.flux),
                               np.asarray(ref.flux), rtol=1e-12)


def test_result_is_sharded_across_devices(cfg, params16):
    res = sharded_grid_scan(params16, cfg)
    sh = res.flux_fla.sharding
    assert len(sh.device_set) == 8
    # batch axis split 16/8 = 2 points per device
    shard_shapes = {s.data.shape for s in res.flux_fla.addressable_shards}
    assert shard_shapes == {(2, 3, cfg.N_bins_E)}


def test_explicit_submesh(cfg, params16):
    devs = np.asarray(jax.devices()[:4])
    mesh = Mesh(devs, ("batch",))
    res = sharded_grid_scan(params16, cfg, mesh=mesh)
    ref = nu.grid_scan(params16, cfg)
    np.testing.assert_allclose(np.asarray(res.flux_fla),
                               np.asarray(ref.flux_fla), rtol=1e-12)
    assert len(res.flux_fla.sharding.device_set) == 4


def test_sharded_scan_jit_cached(cfg, params16):
    """Repeat sharded scans with the same (Config, sharding) must reuse
    one jitted program instead of retracing per call."""
    from nusiprop_tpu.parallel import scan as scan_mod

    scan_mod._grid_scan_jit.clear_cache()
    sharded_grid_scan(params16, cfg)
    assert scan_mod._grid_scan_jit._cache_size() == 1
    sharded_grid_scan(
        jax.tree.map(lambda x: x * (1.0 + 1e-12), params16), cfg)
    assert scan_mod._grid_scan_jit._cache_size() == 1


def test_uneven_batch_raises(cfg):
    params = nu.param_grid(np.geomspace(1e5, 1e8, 5), [1e-6],
                           mntot=MNTOT, si=2.0, norm=6.0)  # 5 points, 8 devs
    with pytest.raises(ValueError, match="must divide"):
        sharded_grid_scan(params, cfg)


def test_presharded_input_respected(cfg, params16):
    """Inputs already placed with a NamedSharding evolve correctly (the
    device_put inside is a no-op re-placement)."""
    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, ("batch",))
    sharding = NamedSharding(mesh, P("batch"))
    placed = jax.tree.map(lambda x: jax.device_put(x, sharding), params16)
    res = sharded_grid_scan(placed, cfg, mesh=mesh)
    ref = nu.grid_scan(params16, cfg)
    np.testing.assert_allclose(np.asarray(res.flux_fla),
                               np.asarray(ref.flux_fla), rtol=1e-12)


def test_phiphi_sharded_matches_unsharded():
    """The FULL reference channel set (non_resonant + spline-backed
    phi-phi production) under mesh sharding: the interpolation tables are
    replicated onto every device, the batch is sharded, and the result
    must equal the unsharded table-fed grid_scan. Config is the battery's
    phi-phi point (high-energy window, where the spline-backed channel
    visibly moves the flux — asserted below, so a silent failure to
    thread the tables through the sharded path cannot pass)."""
    from nusiprop_tpu.models import pp_tables as ppt

    cfg = Config(N_bins_E=24, lEmin=9.0, lEmax=14.0, non_resonant=True,
                 phiphi=True, march="trisolve", source="powerlaw")
    tables = ppt.load_default()
    params = nu.param_grid(np.geomspace(2e5, 2e6, 8), [1e-3],
                           mntot=0.1, si=2.5, norm=1.0)
    ref = np.asarray(nu.grid_scan(params, cfg, pp_tables=tables).flux_fla)
    taylor = np.asarray(nu.grid_scan(params, cfg).flux_fla)
    # the tables must matter at this config, else the equality below
    # could not detect dropped-table plumbing
    assert np.max(np.abs(ref - taylor) / np.abs(ref)) > 1e-6
    res = np.asarray(
        sharded_grid_scan(params, cfg, pp_tables=tables).flux_fla)
    # per-shard batch shapes change XLA's fusion/reduction association;
    # measured cross-shard reassociation is ~2.6e-12
    np.testing.assert_allclose(res, ref, rtol=1e-10)


def test_nonresonant_f32_march_sharded_matches_unsharded():
    """The float32 non-resonant march (march='trisolve_f32', the
    reference's default channel set) under mesh sharding: each
    device runs its shard's trisolve_f32 march; results must equal the
    unsharded batched evolve bit-for-bit (same program per point)."""
    cfg = Config(N_bins_E=24, lEmin=4.0, lEmax=9.0, non_resonant=True,
                 phiphi=False, march="trisolve_f32", source="powerlaw")
    params = nu.param_grid(np.geomspace(5e5, 5e7, 8), [1e-3],
                           mntot=0.1, si=2.5, norm=1.0)
    ref = nu.grid_scan(params, cfg)
    res = sharded_grid_scan(params, cfg)
    np.testing.assert_allclose(np.asarray(res.flux_fla),
                               np.asarray(ref.flux_fla), rtol=1e-12)


def test_sharded_scan_with_pp_tables():
    """The reference's FULL channel set under sharding: non-resonant +
    phi-phi via the interpolation tables (nuSIprop.hpp:166-170). The
    tables replicate onto every device; the batch stays sharded. Result
    must match the unsharded scan bit-for-bit (same program, same
    data, different placement)."""
    from pathlib import Path

    from nusiprop_tpu.models import pp_tables as ppt

    tables = ppt.load_npz(str(Path(__file__).resolve().parents[1]
                              / "data" / "pp_tables_small.npz"))
    cfg_pp = Config(N_bins_E=24, lEmin=9.0, lEmax=14.0, non_resonant=True,
                    phiphi=True, source="powerlaw")
    params = nu.param_grid(np.geomspace(1e5, 1e7, 8), [0.03],
                           mntot=0.1, si=2.5, norm=1.0)
    res = sharded_grid_scan(params, cfg_pp, pp_tables=tables)
    assert res.flux_fla.shape == (8, 3, 24)
    assert bool(np.isfinite(np.asarray(res.flux_fla)).all())
    ref = nu.grid_scan(params, cfg_pp, pp_tables=tables)
    # per-shard batch shapes change XLA's fusion/reduction association
    # (same bound as test_phiphi_sharded_matches_unsharded)
    np.testing.assert_allclose(np.asarray(res.flux_fla),
                               np.asarray(ref.flux_fla), rtol=1e-10)


def _esharded_reference(p, cfg):
    """Unsharded referee consuming the BYTE-IDENTICAL tables the
    storage-sharded march consumes (the alpha blocks come from the same
    sharded build program — the f32 build's rounding depends on the
    compiled program, so the referee must share the built array, not
    rebuild): the comparison then isolates the sharding
    re-association."""
    from nusiprop_tpu.models import (grids, kernels_nr_f32, masses,
                                     mixing, transport)
    from nusiprop_tpu.parallel import eshard

    gr = grids.build(cfg)
    NEXT = gr.Emin_ext.shape[0]
    mn = masses.mass_spectrum(p.mntot, cfg.normal_ordering)
    Wf = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
    tblG, tblAt = kernels_nr_f32.nr_gamma_alphatilde_f32(
        gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf,
        majorana=cfg.majorana)
    devs = jax.devices()
    mesh = Mesh(np.asarray(devs).reshape(len(devs)), ("ecol",))
    D = len(devs)
    C = -(-NEXT // D)
    A_full = jnp.asarray(np.asarray(
        eshard.build_alpha_sharded(p, cfg, mesh, D, C))[:NEXT, :NEXT])
    return transport.evolve_core(p, cfg, tables=(tblG, tblAt, A_full))


def test_esharded_march_matches_unsharded():
    """Storage-sharded E'-axis march (SURVEY §5, parallel/eshard.py):
    per-device column-block tables + the extended-block solve + psum
    contraction over the 8-device mesh must agree with the unsharded
    march='trisolve' consuming the same tables to 1e-12 (sum
    re-association only)."""
    from nusiprop_tpu.parallel import eshard

    cfg = Config(N_bins_E=256, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=True, march="trisolve", table_dtype="f64")
    mntot = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
    p = nu.PhysicsParams.create(5e6, 1e-3, mntot, 2.0, 6.0)

    ref = _esharded_reference(p, cfg)
    flux, flux_fla = eshard.evolve_esharded(p, cfg)
    ref_flux = np.asarray(ref.flux)
    got = np.asarray(flux)
    scale = np.abs(ref_flux).max()
    gate = np.abs(ref_flux) > scale * 1e-12
    rel = np.abs(got - ref_flux)[gate] / np.abs(ref_flux)[gate]
    assert rel.max() < 1e-12, rel.max()
    np.testing.assert_allclose(np.asarray(flux_fla),
                               np.asarray(ref.flux_fla), rtol=1e-11)


def test_esharded_rejects_bad_configs():
    from nusiprop_tpu.parallel import eshard

    mntot = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
    p = nu.PhysicsParams.create(5e6, 1e-3, mntot, 2.0, 6.0)
    with pytest.raises(ValueError, match="non-resonant"):
        eshard.evolve_esharded(
            p, Config(N_bins_E=256, lEmin=4.0, lEmax=9.0, zmax=5.0,
                      non_resonant=False))
    with pytest.raises(ValueError, match="resolution"):
        eshard.evolve_esharded(
            p, Config(N_bins_E=60, lEmin=4.0, lEmax=9.0, zmax=5.0,
                      non_resonant=True, march="trisolve"))
    with pytest.raises(ValueError, match="Dirac"):
        eshard.evolve_esharded(
            p, Config(N_bins_E=256, lEmin=4.0, lEmax=9.0, zmax=5.0,
                      non_resonant=True, march="trisolve",
                      majorana=False))
