"""Parameter-grid scans: vmap batching and mesh sharding.

The reference workflow scans (g, mphi) points serially via
set_parameters()+evolve() (nuSIprop.pyx:60-90, test.py:76-83). The
scaling axis here is this parameter grid: a batched PhysicsParams
pytree turns the whole scan into ONE compiled program whose inner
3x3 solves and kernel contractions become batched matmuls, and
`jax.sharding` splits the batch across devices with no per-step
cross-device traffic (the points are independent; only the final
gather of spectra moves data).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models import transport


def stack_params(points) -> PhysicsParams:
    """Build a batched PhysicsParams from an iterable of (mphi, g, mntot,
    si, norm) tuples or PhysicsParams."""
    rows = []
    for p in points:
        if isinstance(p, PhysicsParams):
            rows.append(p)
        else:
            rows.append(PhysicsParams.create(*p))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


def param_grid(mphi_vals, g_vals, mntot, si, norm=1.0) -> PhysicsParams:
    """Dense (mphi x g) grid flattened to a batch, matching the reference's
    exclusion-contour scan pattern."""
    mm, gg = jnp.meshgrid(
        jnp.asarray(mphi_vals, dtype=jnp.float64),
        jnp.asarray(g_vals, dtype=jnp.float64),
        indexing="ij",
    )
    n = mm.size
    ones = jnp.ones((n,), dtype=jnp.float64)
    return PhysicsParams(
        mphi=mm.ravel(),
        g=gg.ravel(),
        mntot=ones * mntot,
        si=ones * si,
        norm=ones * norm,
    )


@partial(jax.jit, static_argnums=(1, 2))
def _grid_scan_jit(params: PhysicsParams, cfg: Config, chunk_size: int,
                   pp_tables=None):
    f = lambda p: transport.evolve_core(p, cfg, pp_tables=pp_tables)
    batch = params.mphi.shape[0]
    if chunk_size and 0 < chunk_size < batch and batch % chunk_size == 0:
        # chunked vmap: bounds peak memory of the (3, NEXT, NEXT)
        # kernel-table intermediates at chunk_size x table size
        chunked = jax.tree.map(
            lambda x: x.reshape((batch // chunk_size, chunk_size) + x.shape[1:]),
            params,
        )
        res = lax.map(jax.vmap(f), chunked)
        return jax.tree.map(
            lambda x: x.reshape((batch,) + x.shape[2:]), res
        )
    return jax.vmap(f)(params)


@partial(jax.jit, static_argnums=(2,))
def _march_batch_jit(params: PhysicsParams, tables, cfg: Config):
    return jax.vmap(lambda p, t: transport.evolve_core(p, cfg, tables=t))(
        params, tables)


def grid_scan(params: PhysicsParams, cfg: Config, chunk_size: int | None = None,
              pp_tables=None):
    """Evolve a whole batch of parameter points in one compiled launch.

    params leaves must share a leading batch axis. Returns an EvolveResult
    whose array fields carry that batch axis. pp_tables (a PPTables
    pytree) is shared across the batch when cfg.phiphi is on.

    Non-resonant configurations build kernel tables with the staged
    per-channel programs (transport.build_tables) — see docs/DESIGN.md.
    """
    march = transport._resolve_march(cfg)
    if march not in ("rank1", "rank1_f32") and not chunk_size:
        tables = transport.build_tables(params, cfg, pp_tables=pp_tables,
                                        batched=True)
        return _march_batch_jit(params, tables, cfg)
    return _grid_scan_jit(params, cfg, int(chunk_size or 0), pp_tables)


def checkpointed_grid_scan(params: PhysicsParams, cfg: Config, path,
                           chunk_size: int = 64, pp_tables=None,
                           progress=None):
    """Evolve a large grid in restartable chunks.

    Each chunk's flux spectra are persisted to ``<path>.chunkNNNNN.npz``
    as soon as they finish; a rerun with the same path skips complete
    chunks, so a preempted multi-hour scan resumes where it stopped (the
    reference has no checkpointing at all — SURVEY.md §5). On completion
    the chunks merge into ``<path>`` (one .npz) and the chunk files are
    removed.

    Returns dict with 'flux', 'flux_fla' (B, 3, NE), 'E_nu' (NE,) arrays.
    """
    import os

    import numpy as np

    batch = int(params.mphi.shape[0])
    n_chunks = (batch + chunk_size - 1) // chunk_size
    path = str(path)

    for c in range(n_chunks):
        cp = f"{path}.chunk{c:05d}.npz"
        if os.path.exists(cp):
            continue
        sl = slice(c * chunk_size, min((c + 1) * chunk_size, batch))
        # pad the tail chunk so every chunk reuses one compiled shape
        chunk = jax.tree.map(lambda x: x[sl], params)
        pad = chunk_size - int(chunk.mphi.shape[0])
        if pad:
            chunk = jax.tree.map(
                lambda x: jnp.concatenate([x, x[-1:].repeat(pad, axis=0)]),
                chunk,
            )
        res = grid_scan(chunk, cfg, pp_tables=pp_tables)
        n_real = sl.stop - sl.start
        E_nu = np.asarray(res.E_nu)
        if E_nu.ndim == 2:  # batched result carries a per-point grid axis
            E_nu = E_nu[0]
        tmp = cp + ".tmp.npz"
        np.savez(tmp,
                 flux=np.asarray(res.flux)[:n_real],
                 flux_fla=np.asarray(res.flux_fla)[:n_real],
                 E_nu=E_nu)
        os.replace(tmp, cp)  # atomic: a chunk file is complete or absent
        if progress:
            progress(c + 1, n_chunks)

    # merge incrementally into preallocated output arrays: peak memory is
    # the final result + ONE chunk, not 2x the result (pod-scale grids
    # produce many GB of spectra; loading every chunk at once is a trap)
    out = None
    pos = 0
    for c in range(n_chunks):
        with np.load(f"{path}.chunk{c:05d}.npz") as p:
            if out is None:
                out = {
                    "flux": np.empty((batch,) + p["flux"].shape[1:],
                                     dtype=p["flux"].dtype),
                    "flux_fla": np.empty((batch,) + p["flux_fla"].shape[1:],
                                         dtype=p["flux_fla"].dtype),
                    "E_nu": np.asarray(p["E_nu"]),
                }
            n = p["flux"].shape[0]
            out["flux"][pos:pos + n] = p["flux"]
            out["flux_fla"][pos:pos + n] = p["flux_fla"]
            pos += n
    assert pos == batch, (pos, batch)
    np.savez(path, **out)
    for c in range(n_chunks):
        os.remove(f"{path}.chunk{c:05d}.npz")
    return out


def sharded_grid_scan(params: PhysicsParams, cfg: Config,
                      mesh: Mesh | None = None, axis_name: str = "batch",
                      pp_tables=None):
    """Shard the parameter batch across a device mesh and evolve.

    Places the batch on the mesh (one slice of points per device) and
    runs ``grid_scan`` on it: the same programs as an unsharded scan,
    partitioned along the batch, so each device evolves its shard with
    the per-point arithmetic of a one-device run. Results come back with
    the same sharding (gather happens only if the caller materializes
    the full array). Batch size must divide the mesh size. pp_tables (the
    phi-phi interpolation tables, nuSIprop.hpp:166-170) are replicated
    onto every device — they are read-only gather sources, so
    replication costs one broadcast and no per-step traffic.
    """
    if mesh is None:
        import numpy as np

        devs = jax.devices()
        mesh = Mesh(np.asarray(devs).reshape(len(devs)), (axis_name,))
    n_dev = mesh.devices.size
    batch = int(params.mphi.shape[0])
    if batch % n_dev != 0:
        raise ValueError(
            f"batch size {batch} must divide the {n_dev}-device mesh; pad "
            f"the grid (e.g. repeat the last point) to a multiple of {n_dev}")
    sharding = NamedSharding(mesh, P(axis_name))
    params = jax.tree.map(lambda x: jax.device_put(x, sharding), params)
    if pp_tables is not None:
        replicated = NamedSharding(mesh, P())
        pp_tables = jax.tree.map(lambda x: jax.device_put(x, replicated),
                                 pp_tables)
    return grid_scan(params, cfg, pp_tables=pp_tables)
