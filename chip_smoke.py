"""Smoke test of the cascade engine on the GPU: the main path, at the
widths users run, through the normal entry points (``Evolver``,
``grid_scan``, ``checkpointed_grid_scan``, ``fit``), each phase checked
against the float64 engine run on the CPU in the same process.

    python chip_smoke.py               # one card: every one-card phase
    python chip_smoke.py --cards 4     # only the four-card phases
    python chip_smoke.py --trace DIR   # also trace the non_resonant and
                                       # phiphi phases and report the
                                       # march's share of device time

Before the phases it prints the cards' name and power limit (nvidia-smi),
the JAX version, XLA_FLAGS and the devices. Each phase prints one JSON
line: its name, ``ok``, the march ``auto`` chose, ``compile_s`` (the
first call's wall, compilation included) and ``warm_s`` (a repeat call),
both fenced with ``jax.block_until_ready``, every deviation beside its
``tol``, the CPU points compared, and ``peak_bytes_in_use`` of the
first card so far. Only when every phase passed is the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
otherwise the script exits non-zero. It refuses to run (exit 1) when
JAX's first device is not a GPU.

Deviations are relative, over the bins within ``DECADES`` decades of
each spectrum's peak (one spectrum = one point and flavour): below that
the flux is far under anything an analysis reads.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DECADES = 10.0
N_CPU_POINTS = 8
MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))

ONE_CARD_PHASES = ("golden", "s_channel", "non_resonant", "phiphi",
                   "f32_modes", "gradient")
MULTI_CARD_PHASES = ("sharded_scan", "eshard")

# In f64 the GPU's libdevice and the CPU's libm differ by an ulp in the
# polylogarithms of the DSNB source; sources.lum_dsnb takes differences
# of antiderivatives at adjacent bin edges, which magnifies that ulp to
# ~4e-7 in the source rows (measured: the card's rows with the CPU's
# rows injected agree to ~4e-13). Hence 1e-6 and not round-off.
TOL_F64 = 1e-6
# The golden file prints 4 significant digits.
TOL_GOLDEN = 1e-3
# The energy drift of the golden point, to the 4 digits it is recorded
# with: half a unit in the last place.
ENERGY_DRIFT, TOL_ENERGY = 0.8816, 5e-5
# f32 round-off through ~80 implicit z-steps.
TOL_F32 = 1e-4
# A bin where the f64 closed-form flux and the flux from the
# independent quadrature table (kernels_nr_f32) differ by more than the
# physics gate (1e-3) is one where the closed form is cancellation noise
# (docs/DESIGN.md): there an ulp of difference between the two
# machines' transcendentals is magnified by the same cancellation.
# Such bins are held to TOL_NOISE instead of TOL_F64.
NOISE_CF_ERR, TOL_NOISE = 1e-3, 1e-4
# The four-card paths run the same program per point (scan) or reorder
# one sum over four blocks with psum (eshard).
TOL_SHARDED, TOL_ESHARD = 1e-9, 1e-10
# The phi-phi phase must be able to see the tables.
MIN_PP_EFFECT = 1e-2


# --------------------------------------------------------------------------
# pure helpers (tested on the CPU)
# --------------------------------------------------------------------------

def peak_window(ref, decades=DECADES):
    """Mask of the bins within ``decades`` of each spectrum's peak (the
    last axis is the energy axis of one spectrum)."""
    a = np.abs(np.asarray(ref, dtype=np.float64))
    peak = a.max(axis=-1, keepdims=True)
    return (peak > 0) & (a >= peak * 10.0 ** -decades)


def rel_dev(got, ref, decades=DECADES):
    """(per-bin relative deviation, zero outside the window; window)."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"shape {got.shape} vs reference {ref.shape}")
    mask = peak_window(ref, decades)
    dev = np.zeros(ref.shape)
    dev[mask] = np.abs(got[mask] - ref[mask]) / np.abs(ref[mask])
    dev[~np.isfinite(got) & mask] = np.inf
    return dev, mask


def max_dev(got, ref, decades=DECADES):
    return float(rel_dev(got, ref, decades)[0].max())


def spread_indices(batch, n=N_CPU_POINTS):
    """``n`` indices spread evenly over a batch (its points are ordered
    in mphi, so they span the scanned masses)."""
    return np.unique(np.linspace(0, batch - 1, min(n, batch)).round()
                     .astype(int))


def noise_split(card, cpu_cf, cpu_quad, decades=DECADES):
    """Deviation of the card from the CPU closed-form run, split into
    clean bins and bins where the closed form is cancellation noise.
    Returns a dict of the maxima, the number of noise bins and the
    largest card deviation relative to the closed form's own error."""
    dev, mask = rel_dev(card, cpu_cf, decades)
    cf_err, _ = rel_dev(cpu_cf, cpu_quad, decades)
    noise = mask & (cf_err > NOISE_CF_ERR)
    clean = mask & ~noise
    ratio = dev[noise] / cf_err[noise] if noise.any() else np.zeros(1)
    return {
        "clean_dev": float(dev[clean].max()) if clean.any() else 0.0,
        "noise_dev": float(dev[noise].max()) if noise.any() else 0.0,
        "noise_bins": int(noise.sum()),
        "window_bins": int(mask.sum()),
        "noise_dev_over_cf_err": float(ratio.max()),
    }


def last_line(device):
    """The final stdout line, printed only when every phase passed."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def phases_for(cards):
    if cards == 1:
        return ONE_CARD_PHASES
    if cards == 4:
        return MULTI_CARD_PHASES
    raise ValueError(f"--cards takes 1 or 4, not {cards}")


def require_gpu(platform):
    if platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX's first device is "
                 f"{platform!r}")


# --------------------------------------------------------------------------
# running the phases
# --------------------------------------------------------------------------

def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _first_and_warm(fn):
    out, first = _timed(fn)
    out, warm = _timed(fn)
    return out, first, warm


@contextlib.contextmanager
def on_cpu():
    """Run the enclosed referee on the CPU with the persistent compile
    cache off: XLA:CPU entries are machine code whose cache key does not
    cover the host's CPU features, so an entry written on another host
    can fail to load here (or crash). The cache is re-armed on exit."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            yield jax.devices("cpu")[0]
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        cc.reset_cache()


def _to(tree, device):
    import jax

    return jax.tree.map(lambda x: jax.device_put(x, device), tree)


def _subset(params, idx):
    import jax

    return jax.tree.map(lambda x: x[idx], params)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _check(line, devs_tols):
    """Attach each deviation and its tol; ok when all are within."""
    line["tol"] = {}
    ok = True
    for name, (dev, tol) in devs_tols.items():
        line[name] = dev
        line["tol"][name] = tol
        ok &= bool(np.isfinite(dev)) and dev <= tol
    line["ok"] = line.get("ok", True) and ok
    return line


def _cfg(**kw):
    import nusiprop_tpu as nu

    base = dict(N_bins_E=500, lEmin=4.0, lEmax=9.0, zmax=5.0,
                non_resonant=False, phiphi=False)
    base.update(kw)
    return nu.Config(**base)


def _grid(mphi_lo, mphi_hi, batch, g, mntot=MNTOT, si=2.0, norm=6.0):
    import nusiprop_tpu as nu

    return nu.param_grid(np.geomspace(mphi_lo, mphi_hi, batch), [g],
                         mntot=mntot, si=si, norm=norm)


def _scan_cpu(params, cfg, idx, pp_tables=None):
    import nusiprop_tpu as nu

    with on_cpu() as cpu:
        sub = _to(_subset(params, idx), cpu)
        tables = None if pp_tables is None else _to(pp_tables, cpu)
        return np.asarray(nu.grid_scan(sub, cfg, pp_tables=tables).flux_fla)


def _points(params, idx):
    return {"index": idx.tolist(),
            "mphi": np.asarray(params.mphi)[idx].tolist()}


def device_time_by_module(xplane_path):
    """Device time of a jax.profiler trace: the union of busy intervals
    per GPU and the summed kernel time per XLA module (``hlo_module``)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(str(xplane_path))
    by_module, busy = {}, 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        spans = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                mod = str(stats.get("hlo_module", "?"))
                by_module[mod] = by_module.get(mod, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        end = -1
        for s, e in sorted(spans):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
    return busy, by_module


def _march_share(fn, logdir):
    """Trace one warm call of ``fn`` and read the march's share of the
    device's kernel time: the march is the jitted ``_march_batch_jit``
    program of parallel/scan.py, the table build is every other."""
    import jax

    jax.profiler.start_trace(str(logdir))
    try:
        jax.block_until_ready(fn())
    finally:
        jax.profiler.stop_trace()
    path = max(pathlib.Path(logdir).rglob("*.xplane.pb"),
               key=lambda p: p.stat().st_mtime)
    busy, by_module = device_time_by_module(path)
    total = sum(by_module.values())
    march = sum(v for k, v in by_module.items() if "_march_batch_jit" in k)
    top = sorted(by_module.items(), key=lambda kv: -kv[1])[:8]
    return {"march_share": march / total if total else None,
            "device_kernel_s": total * 1e-9, "device_busy_s": busy * 1e-9,
            "march_kernel_s": march * 1e-9,
            "top_modules_s": {k: v * 1e-9 for k, v in top}}


def phase_golden(ctx):
    import nusiprop_tpu as nu

    ev = nu.Evolver(mphi=5e6, g=1e-6, mntot=MNTOT, si=2.0, norm=6,
                    majorana=True, normal_ordering=True, N_bins_E=100,
                    lEmin=4, lEmax=9, zmax=5, non_resonant=False,
                    phiphi=False, flav=2)
    _, first, warm = _first_and_warm(lambda: ev.evolve()._result)
    ref = np.loadtxt(ROOT / "tests" / "data" / "data_massless.txt",
                     skiprows=1)
    flux = ev.get_flux_fla()
    golden_dev = float((np.abs(flux - ref[:, 1:].T)
                        / np.abs(ref[:, 1:].T)).max())
    drift = ev.check_energy_conservation()
    line = {"phase": "golden", "march": _march(ev.config),
            "compile_s": first, "warm_s": warm, "energy_drift": drift,
            "ok": bool(np.isfinite(flux).all())}
    return _check(line, {"golden_dev": (golden_dev, TOL_GOLDEN),
                         "energy_drift_err": (abs(drift - ENERGY_DRIFT),
                                              TOL_ENERGY)})


def _march(cfg):
    from nusiprop_tpu.models import transport

    return transport._resolve_march(cfg)


def phase_s_channel(ctx, batch=1024, bins=500):
    import nusiprop_tpu as nu

    cfg = _cfg(N_bins_E=bins)
    params = _grid(1e5, 1e8, batch, 1e-2)
    res, first, warm = _first_and_warm(lambda: nu.grid_scan(params, cfg))
    idx = spread_indices(batch)
    card = np.asarray(res.flux_fla)
    cpu = _scan_cpu(params, cfg, idx)
    line = {"phase": "s_channel", "march": _march(cfg), "batch": batch,
            "bins": bins, "compile_s": first, "warm_s": warm,
            "cpu_points": _points(params, idx),
            "ok": bool(np.isfinite(card).all())}
    return _check(line, {"s_f64_dev": (max_dev(card[idx], cpu), TOL_F64)})


def phase_non_resonant(ctx, batch=128, bins=500, chunk=64):
    import nusiprop_tpu as nu

    cfg = _cfg(N_bins_E=bins, non_resonant=True)
    params = _grid(1e5, 1e8, batch, 1e-3)
    res, first, warm = _first_and_warm(lambda: nu.grid_scan(params, cfg))
    card = np.asarray(res.flux_fla)
    with tempfile.TemporaryDirectory() as tmp:
        ck, ck_first = _timed(lambda: nu.checkpointed_grid_scan(
            params, cfg, os.path.join(tmp, "scan.npz"), chunk_size=chunk))
    ck = np.asarray(ck["flux_fla"])
    idx = spread_indices(batch)
    cpu_cf = _scan_cpu(params, cfg, idx)
    cpu_quad = _scan_cpu(params, dataclasses.replace(cfg, table_dtype="f32"),
                         idx)
    scan = noise_split(card[idx], cpu_cf, cpu_quad)
    chunked = noise_split(ck[idx], cpu_cf, cpu_quad)
    line = {"phase": "non_resonant", "march": _march(cfg), "batch": batch,
            "bins": bins, "compile_s": first, "warm_s": warm,
            "checkpointed_chunks": batch // chunk,
            "checkpointed_first_s": ck_first,
            "cpu_points": _points(params, idx),
            "noise_rule": (f"closed form vs quadrature table > "
                           f"{NOISE_CF_ERR} on the CPU"),
            "noise_bins": scan["noise_bins"],
            "window_bins": scan["window_bins"],
            "noise_dev_over_cf_err": scan["noise_dev_over_cf_err"],
            "ok": bool(np.isfinite(card).all() and np.isfinite(ck).all())}
    if ctx.get("trace"):
        line.update(_march_share(lambda: nu.grid_scan(params, cfg),
                                 pathlib.Path(ctx["trace"]) / "non_resonant"))
    return _check(line, {
        "nr_f64_dev": (scan["clean_dev"], TOL_F64),
        "nr_noise_dev": (scan["noise_dev"], TOL_NOISE),
        "checkpointed_f64_dev": (chunked["clean_dev"], TOL_F64),
        "checkpointed_noise_dev": (chunked["noise_dev"], TOL_NOISE)})


def phase_phiphi(ctx, batch=64, bins=500):
    import nusiprop_tpu as nu
    from nusiprop_tpu.models import pp_tables as ppt

    tables = ppt.load_npz(str(ROOT / "data" / "pp_tables_medium.npz"))
    cfg = _cfg(N_bins_E=bins, lEmin=9.0, lEmax=14.0, non_resonant=True,
               phiphi=True, source="powerlaw")
    params = _grid(1e5, 1e6, batch, 0.03, mntot=0.1, si=2.5, norm=1.0)
    run = lambda: nu.grid_scan(params, cfg, pp_tables=tables)
    res, first, warm = _first_and_warm(run)
    card = np.asarray(res.flux_fla)
    no_tables = np.asarray(nu.grid_scan(params, cfg).flux_fla)
    idx = spread_indices(batch)
    cpu = _scan_cpu(params, cfg, idx, pp_tables=tables)
    line = {"phase": "phiphi", "march": _march(cfg), "batch": batch,
            "bins": bins, "compile_s": first, "warm_s": warm,
            "pp_effect": max_dev(no_tables, card),
            "cpu_points": _points(params, idx),
            "ok": bool(np.isfinite(card).all())}
    line["ok"] &= line["pp_effect"] > MIN_PP_EFFECT
    line["min_pp_effect"] = MIN_PP_EFFECT
    if ctx.get("trace"):
        line.update(_march_share(run, pathlib.Path(ctx["trace"]) / "phiphi"))
    return _check(line, {"pp_f64_dev": (max_dev(card[idx], cpu), TOL_F64)})


def phase_f32_modes(ctx, s_batch=1024, nr_batch=128, bins=500):
    import nusiprop_tpu as nu

    s_params = _grid(1e5, 1e8, s_batch, 1e-2)
    cfg_s = _cfg(N_bins_E=bins)
    s64, _, s64_warm = _first_and_warm(lambda: nu.grid_scan(s_params, cfg_s))
    cfg_s32 = dataclasses.replace(cfg_s, march="rank1_f32")
    s32, s32_first, s32_warm = _first_and_warm(
        lambda: nu.grid_scan(s_params, cfg_s32))

    nr_params = _grid(1e5, 1e8, nr_batch, 1e-3)
    cfg_nr = _cfg(N_bins_E=bins, non_resonant=True, table_dtype="f32")
    nr64, _, nr64_warm = _first_and_warm(
        lambda: nu.grid_scan(nr_params, dataclasses.replace(
            cfg_nr, march="trisolve")))
    nr32, nr32_first, nr32_warm = _first_and_warm(
        lambda: nu.grid_scan(nr_params, dataclasses.replace(
            cfg_nr, march="trisolve_f32")))
    line = {"phase": "f32_modes",
            "rank1_f32": {"march": _march(cfg_s32), "batch": s_batch,
                          "compile_s": s32_first,
                          "warm_s": s32_warm, "f64_warm_s": s64_warm},
            "trisolve_f32": {"march": "trisolve_f32", "batch": nr_batch,
                             "table_dtype": "f32",
                             "compile_s": nr32_first, "warm_s": nr32_warm,
                             "f64_warm_s": nr64_warm},
            "ok": bool(np.isfinite(np.asarray(s32.flux_fla)).all()
                       and np.isfinite(np.asarray(nr32.flux_fla)).all())}
    return _check(line, {
        "rank1_f32_dev": (max_dev(s32.flux_fla, s64.flux_fla), TOL_F32),
        "trisolve_f32_dev": (max_dev(nr32.flux_fla, nr64.flux_fla),
                             TOL_F32)})


def phase_gradient(ctx, bins=100, steps=5):
    import jax
    import jax.numpy as jnp

    import nusiprop_tpu as nu

    cfg = _cfg(N_bins_E=bins)
    true = nu.PhysicsParams.create(mphi=6e5, g=1e-2, mntot=MNTOT, si=2.0,
                                   norm=6.0)
    init = nu.PhysicsParams.create(mphi=3e6, g=3e-3, mntot=MNTOT, si=2.0,
                                   norm=6.0)

    def loss(x, base, target):
        p = dataclasses.replace(base, g=x[0], mphi=x[1])
        return nu.spectral_loss(nu.evolve(p, cfg).flux_fla, target)

    grad = jax.jit(jax.grad(loss))
    target = nu.evolve(true, cfg).flux_fla
    x0 = jnp.asarray([float(init.g), float(init.mphi)])
    g_card, first, warm = _first_and_warm(lambda: grad(x0, init, target))
    with on_cpu() as cpu:
        g_cpu = np.asarray(grad(*_to((x0, init, target), cpu)))
    g_card = np.asarray(g_card)
    grad_dev = float((np.abs(g_card - g_cpu) / np.abs(g_cpu)).max())
    res, fit_s = _timed(lambda: nu.fit(cfg, target, init,
                                       fit_fields=("g", "mphi"),
                                       steps=steps, learning_rate=0.08))
    hist = np.asarray(res.history)
    line = {"phase": "gradient", "march": _march(cfg), "bins": bins,
            "compile_s": first, "warm_s": warm, "grad_card": g_card.tolist(),
            "fit_steps": steps, "fit_first_s": fit_s,
            "fit_loss_first": float(hist[0]), "fit_loss_last": float(hist[-1]),
            "ok": bool(np.isfinite(g_card).all() and hist[-1] < hist[0])}
    return _check(line, {"grad_dev": (grad_dev, TOL_F64)})


def phase_sharded_scan(ctx, batch=512, bins=500):
    import jax
    from jax.sharding import Mesh

    import nusiprop_tpu as nu

    devs = jax.devices()[:4]
    cfg = _cfg(N_bins_E=bins, non_resonant=True)
    params = _grid(1e5, 1e8, batch, 1e-3)
    mesh = Mesh(np.asarray(devs), ("batch",))
    res, first, warm = _first_and_warm(
        lambda: nu.sharded_grid_scan(params, cfg, mesh=mesh))
    # One card runs the batch in slices of one shard's size: the f64
    # closed-form table build of the whole batch does not fit one card.
    per = batch // len(devs)

    def one_card():
        return np.concatenate([np.asarray(nu.grid_scan(
            _subset(params, slice(i, i + per)), cfg).flux_fla)
            for i in range(0, batch, per)])

    one, one_first, one_warm = _first_and_warm(one_card)
    n_dev = len(res.flux_fla.sharding.device_set)
    line = {"phase": "sharded_scan", "march": _march(cfg), "cards": n_dev,
            "batch": batch, "bins": bins, "compile_s": first,
            "warm_s": warm, "one_card_slices": batch // per,
            "one_card_compile_s": one_first, "one_card_warm_s": one_warm,
            "ok": n_dev == 4 and bool(np.isfinite(
                np.asarray(res.flux_fla)).all())}
    return _check(line, {"sharded_dev": (max_dev(res.flux_fla, one),
                                         TOL_SHARDED)})


def phase_eshard(ctx, bins=2048):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import nusiprop_tpu as nu
    from nusiprop_tpu.models import (grids, kernels_nr_f32, masses, mixing,
                                     transport)
    from nusiprop_tpu.parallel import eshard

    devs = jax.devices()[:4]
    cfg = _cfg(N_bins_E=bins, non_resonant=True, march="trisolve",
               table_dtype="f64")
    p = nu.PhysicsParams.create(5e6, 1e-3, MNTOT, 2.0, 6.0)
    mesh = Mesh(np.asarray(devs), ("ecol",))
    (flux, _), first, warm = _first_and_warm(
        lambda: eshard.evolve_esharded(p, cfg, mesh=mesh))

    # the unsharded trisolve march on one card, fed the byte-identical
    # tables (the f32 block build's rounding depends on the compiled
    # program, so the referee shares the built array)
    gr = grids.build(cfg)
    NEXT = gr.Emin_ext.shape[0]
    D = len(devs)
    C = -(-NEXT // D)
    A_sh = eshard.build_alpha_sharded(p, cfg, mesh, D, C)
    n_dev = len(A_sh.sharding.device_set)
    # Called eagerly, as evolve_esharded evaluates the source rows
    # eagerly: the DSNB rows' rounding depends on the compiled context
    # (eshard._march_esharded docstring), so both sides evaluate them the
    # same way and the comparison sees only the sharding.
    with jax.default_device(devs[0]):
        mn = masses.mass_spectrum(p.mntot, cfg.normal_ordering)
        Wf = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
        tblG, tblAt = kernels_nr_f32.nr_gamma_alphatilde_f32(
            gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf,
            majorana=cfg.majorana)
        A_full = jax.device_put(np.asarray(A_sh)[:NEXT, :NEXT], devs[0])
        ref, one_first, one_warm = _first_and_warm(
            lambda: transport.evolve_core(p, cfg, tables=(tblG, tblAt,
                                                          A_full)))
    line = {"phase": "eshard", "march": _march(cfg), "cards": n_dev,
            "bins": bins, "compile_s": first, "warm_s": warm,
            "unsharded_compile_s": one_first, "unsharded_warm_s": one_warm,
            "ok": n_dev == 4 and bool(np.isfinite(np.asarray(flux)).all())}
    return _check(line, {"eshard_dev": (max_dev(flux, ref.flux),
                                        TOL_ESHARD)})


PHASES = {
    "golden": phase_golden, "s_channel": phase_s_channel,
    "non_resonant": phase_non_resonant, "phiphi": phase_phiphi,
    "f32_modes": phase_f32_modes, "gradient": phase_gradient,
    "sharded_scan": phase_sharded_scan, "eshard": phase_eshard,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="1: every one-card phase; 4: only the four-card "
                         "phases (sharded scan and E'-sharded march)")
    ap.add_argument("--trace", metavar="DIR",
                    help="write jax.profiler traces of the non_resonant "
                         "and phiphi phases under DIR and report the "
                         "march's share of device time")
    args = ap.parse_args(argv)
    phases = phases_for(args.cards)

    import jax

    require_gpu(jax.devices()[0].platform)
    if len(jax.devices()) < args.cards:
        sys.exit(f"--cards {args.cards} needs {args.cards} GPUs; JAX has "
                 f"{len(jax.devices())}")

    import nusiprop_tpu  # noqa: F401  (enables x64, sets the compile cache)
    from nusiprop_tpu.utils import profiling

    for line in profiling.gpu_power_limits():
        print(line, flush=True)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')};"
          f" compile cache {jax.config.jax_compilation_cache_dir}", flush=True)
    print(f"devices: {jax.devices()}", flush=True)

    ctx = {"trace": args.trace}
    all_ok = True
    for name in phases:
        t0 = time.perf_counter()
        line = PHASES[name](ctx)
        line["phase_s"] = time.perf_counter() - t0
        line["peak_bytes_in_use"] = _peak_bytes()
        print(json.dumps(line), flush=True)
        all_ok &= line["ok"]
    if not all_ok:
        sys.exit("chip_smoke.py: a phase failed")
    print(last_line(profiling.device_record()), flush=True)


if __name__ == "__main__":
    main()
