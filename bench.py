"""Benchmark: redshift-steps/sec at 500 energy bins (BASELINE.json metric).

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"device": {"platform", "kind", "count"}, "power_limit": [...],
"secondary": {...}}.

Needs a GPU: with no GPU among JAX's devices it exits non-zero before
timing anything. The workload is the BASELINE.json metric point: 500
energy bins spanning 5 decades, zmax = 5 => N_steps_z = 79
(nuSIprop.hpp:124). The headline number is batched throughput on the
s-channel path (the reference's benchmark/golden configuration) with
the float32 march+tables (march='rank1_f32'); the ``secondary`` block
reports the other engine regimes, each through ``march='auto'`` (the
float64 marches):

  * ``s_channel_f64``  — the float64 rank1 march;
  * ``non_resonant``   — the reference's DEFAULT channel set
    (non_resonant=true): f64 closed-form tables + the f64 trisolve
    march;
  * ``phiphi``         — the reference's FULL channel set (non_resonant +
    the nu nu -> phi phi production channel via the interpolation tables,
    nuSIprop.hpp:166-170), against the phi-phi serial-C++ denominator.

vs_baseline divides by the measured serial C++ re-implementation of the
same algorithm (-O3, single thread; the reference itself compiles
against GSL, absent here, and publishes no numbers) — see
BASELINE_MEASURED.json, which carries separate s-channel and
non-resonant denominators. Until that file exists, vs_baseline is 0.0.

Robustness contract:
  * the HEADLINE record is printed (and flushed) the moment the
    headline regime finishes — a later kill can no longer erase it;
  * every secondary regime runs under a wall budget (deadline checks +
    SIGALRM); on overrun or failure it reports {"error": ...}, the
    remaining regimes still run, and the bench exits non-zero after
    printing the merged record;
  * the phi-phi regime pins NUSIPROP_PP_TABLES to the shipped medium
    preset unless BENCH_PP_FULL=1 — load_default()'s "largest file wins"
    must not silently recompile against a locally generated 800 MB
    table;
  * the final line re-prints the full merged record, so the last JSON
    line of stdout is always the most complete one available.

Regimes on a float32 march also report modeled roofline fields (mfu /
hbm_frac against the device's published peaks —
nusiprop_tpu/utils/costmodel.py); float64 regimes report none.

Env knobs: BENCH_NON_RESONANT=1 makes the NR regime the headline;
BENCH_F32=0 forces the f64 march as headline; BENCH_SECONDARY=0 skips
the secondary regimes; BENCH_PHIPHI=0 skips the phi-phi regime;
BENCH_PP_FULL=1 un-pins the phi-phi tables; BENCH_DEADLINE_SEC (default
1500) caps total wall, BENCH_REGIME_BUDGET (default 600) caps each
secondary regime; BENCH_BATCH/BENCH_REPS/BENCH_NR_BATCH/BENCH_PP_BATCH/
BENCH_UNROLL as named.
"""

import json
import os
import pathlib
import signal
import time

import numpy as np

_T_START = time.time()

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))


def _cfg(non_resonant, march, unroll=1, phiphi=False):
    from nusiprop_tpu.config import Config

    # BENCH_BINS exists for cheap smoke tests of the bench plumbing;
    # the recorded metric is always the 500-bin point.
    return Config(
        N_bins_E=int(os.environ.get("BENCH_BINS", "500")),
        lEmin=4.0, lEmax=9.0, zmax=5.0,
        non_resonant=non_resonant, phiphi=phiphi,
        march=march, march_unroll=unroll,
    )


def _params(batch, g0):
    import nusiprop_tpu as nu

    return nu.param_grid(
        np.geomspace(1e5, 1e8, batch), [g0], mntot=MNTOT, si=2.0, norm=6.0)


def _time_regime(cfg, batch, g0, reps, run=None):
    """Wall-time one compiled batched evolve; returns (zsteps/s, wall)."""
    import jax
    import jax.numpy as jnp

    import nusiprop_tpu as nu
    from nusiprop_tpu.models import grids

    nz = grids.n_steps_z(cfg)
    params = _params(batch, g0)
    if run is None:
        run = lambda p: nu.grid_scan(p, cfg).flux

    warm = jax.block_until_ready(run(params))  # compile
    if not bool(jnp.isfinite(warm).all()):
        raise SystemExit(
            "bench aborted: non-finite flux — refusing to time garbage")

    times = []
    for r in range(reps):
        p = jax.tree.map(lambda x: x * (1.0 + 1e-12 * (r + 1)), params)
        t0 = time.perf_counter()
        jax.block_until_ready(run(p))
        times.append(time.perf_counter() - t0)
    wall = min(times)
    return (nz - 1) * batch / wall, wall


def _stage_split(cfg, batch, g0, pp_tables=None, reps=2):
    """Per-stage walls (ms) of a staged-table evolve: the kernel-table
    build (alpha + Gamma/alphaTilde programs) vs the z-march consuming
    precomputed tables, each fenced with ``jax.block_until_ready``."""
    import jax

    from nusiprop_tpu.models import transport

    params = _params(batch, g0)

    def timeit(fn):
        jax.block_until_ready(fn(params))  # compile
        ts = []
        for r in range(reps):
            p = jax.tree.map(lambda x: x * (1.0 + 1e-12 * (r + 1)), params)
            t0 = time.perf_counter()
            jax.block_until_ready(fn(p))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_tables = timeit(lambda p: transport.build_tables(
        p, cfg, pp_tables=pp_tables, batched=True))
    tables = jax.block_until_ready(transport.build_tables(
        params, cfg, pp_tables=pp_tables, batched=True))
    march = jax.jit(lambda p, t: jax.vmap(
        lambda q, tt: transport.evolve_core(q, cfg, tables=tt))(p, t).flux)
    t_march = timeit(lambda p: march(p, tables))
    return {"table_build_ms": round(t_tables * 1e3, 2),
            "march_ms": round(t_march * 1e3, 2)}


def _emit(record):
    """Print one JSON line and flush — a later kill cannot erase it."""
    print(json.dumps(record), flush=True)


class _RegimeTimeout(Exception):
    pass


def _alarm_handler(signum, frame):
    raise _RegimeTimeout("regime wall budget exhausted")


def _deadline():
    return _T_START + float(os.environ.get("BENCH_DEADLINE_SEC", "1500"))


def _run_budgeted(fn):
    """Run fn() under the per-regime SIGALRM budget, bounded by the
    global deadline. Returns (result, None) or (None, error_str)."""
    remaining = _deadline() - time.time()
    if remaining < 60:
        return None, "budget: global deadline reached before start"
    budget = int(min(remaining,
                     float(os.environ.get("BENCH_REGIME_BUDGET", "600"))))
    old = signal.signal(signal.SIGALRM, _alarm_handler)
    signal.alarm(budget)
    try:
        return fn(), None
    except _RegimeTimeout:
        return None, f"budget: exceeded {budget}s regime wall budget"
    except (Exception, SystemExit) as exc:  # noqa: BLE001 — report, go on
        return None, f"{type(exc).__name__}: {exc}"[:300]
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def failed_regimes(record):
    """Names of the regimes (and stage splits) of a merged bench record
    that reported an error."""
    failed = ["headline"] if "error" in record else []
    for name, reg in record.get("secondary", {}).items():
        if "error" in reg:
            failed.append(name)
        elif "error" in reg.get("stages", {}):
            failed.append(f"{name}.stages")
    return failed


def main():
    import sys

    # Pin the phi-phi tables to the shipped medium preset: the pp
    # denominator in BASELINE_MEASURED was measured against the same
    # tables, and load_default() would otherwise pick the largest file
    # in data/, silently changing compiled shapes whenever a
    # full-resolution table was regenerated locally.
    if not int(os.environ.get("BENCH_PP_FULL", "0")):
        medium = pathlib.Path(__file__).parent / "data" / "pp_tables_medium.npz"
        if medium.exists():
            os.environ.setdefault("NUSIPROP_PP_TABLES", str(medium))

    from nusiprop_tpu.utils import profiling

    device = profiling.device_record()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {device}")
    power_limit = profiling.gpu_power_limits()

    from nusiprop_tpu.models.transport import _resolve_march

    nr_headline = bool(int(os.environ.get("BENCH_NON_RESONANT", "0")))
    f32 = int(os.environ.get("BENCH_F32", "1"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    # Non-resonant coupling kept at 1e-3: at g=1e-2 the lowest-mphi scan
    # points cascade-amplify the number flux to ~1e34, beyond float32's
    # range on the f32 marches. The f64 timing is data-independent.
    nr_batch = int(os.environ.get("BENCH_NR_BATCH", "128"))

    if nr_headline:
        cfg = _cfg(True, "auto")
        batch = int(os.environ.get("BENCH_BATCH", str(nr_batch)))
        g0 = 1e-3
    else:
        cfg = _cfg(False, "rank1_f32" if f32 else "rank1",
                   unroll=int(os.environ.get("BENCH_UNROLL", "1")))
        batch = int(os.environ.get("BENCH_BATCH", "1024"))
        g0 = 1e-2

    from nusiprop_tpu.models import grids as _grids
    from nusiprop_tpu.utils import costmodel

    base = {}
    baseline_file = pathlib.Path(__file__).parent / "BASELINE_MEASURED.json"
    if baseline_file.exists():
        base = json.loads(baseline_file.read_text())

    def vs(zsps_val, baseline_key):
        denom = base.get(baseline_key)
        return round(zsps_val / denom, 3) if denom else 0.0

    KEY_S = "serial_cpp_zsteps_per_sec_500bins"
    KEY_NR = "serial_cpp_zsteps_per_sec_500bins_nonresonant"
    KEY_PP = "serial_cpp_zsteps_per_sec_500bins_phiphi"

    def _roofline(rcfg, rbatch, rwall):
        return costmodel.roofline_fields(
            _resolve_march(rcfg), rbatch, rcfg.N_bins_E,
            _grids.n_steps_z(rcfg), rwall, device["kind"],
            phiphi=rcfg.non_resonant and rcfg.phiphi)

    # ---- headline (budgeted too: a cold compile must not eat the
    # whole driver timeout — on overrun, fall through with an error
    # record so the secondaries still report) ----
    def _headline():
        return _time_regime(cfg, batch, g0, reps)

    got, err = _run_budgeted(_headline)
    if err is None:
        zsps, wall = got
    else:
        zsps, wall = 0.0, 0.0

    record = {
        "metric": "redshift-steps/sec at 500 energy bins",
        "value": round(zsps, 3),
        "unit": "z-steps/sec",
        "vs_baseline": vs(zsps, KEY_NR if nr_headline else KEY_S),
        "batch": batch,
        "wall_sec_per_batch": round(wall, 4),
        "device": device,
        "power_limit": power_limit,
        "march": _resolve_march(cfg),
        "non_resonant": nr_headline,
        "secondary": {},
    }
    if err is not None:
        record["error"] = err
    record.update(_roofline(cfg, batch, wall))
    _emit(record)  # headline out NOW; the merged record re-prints last

    secondary = {}
    if bool(int(os.environ.get("BENCH_SECONDARY", "1"))):
        regimes = []
        if not nr_headline:
            regimes.append(("non_resonant", _cfg(True, "auto"), nr_batch,
                            1e-3, KEY_NR, None))
        if bool(int(os.environ.get("BENCH_PHIPHI", "1"))):
            # The reference's full channel set: non_resonant + the
            # nu nu -> phi phi production channel via the interpolation
            # tables (nuSIprop.hpp:166-170). Baseline denominator is the
            # serial C++ engine driven with the same medium-resolution
            # spline tables (measure_baseline.py --only-phiphi).
            import nusiprop_tpu as nu
            from nusiprop_tpu.models import pp_tables as _ppt

            _tables = _ppt.load_default()
            _pp_run = lambda cfg: (
                lambda p: nu.grid_scan(p, cfg, pp_tables=_tables).flux)
            regimes.append(("phiphi", _cfg(True, "auto", phiphi=True),
                            int(os.environ.get("BENCH_PP_BATCH", "64")),
                            1e-3, KEY_PP, _pp_run))
        regimes.append(("s_channel_f64", _cfg(False, "rank1"), 256, 1e-2,
                        KEY_S, None))
        for name, rcfg, rbatch, rg, rkey, rrun in regimes:
            def _regime(rcfg=rcfg, rbatch=rbatch, rg=rg, rrun=rrun):
                return _time_regime(rcfg, rbatch, rg, max(1, reps - 1),
                                    run=rrun(rcfg) if rrun else None)

            got, rerr = _run_budgeted(_regime)
            if rerr is not None:
                secondary[name] = {"error": rerr}
            else:
                rz, rwall = got
                secondary[name] = {
                    "zsteps_per_sec": round(rz, 3),
                    "vs_baseline": vs(rz, rkey),
                    "batch": rbatch,
                    "march": _resolve_march(rcfg),
                }
                secondary[name].update(_roofline(rcfg, rbatch, rwall))
                if name in ("non_resonant", "phiphi"):
                    pp_t = _tables if name == "phiphi" else None
                    stages, serr = _run_budgeted(
                        lambda rcfg=rcfg, rbatch=rbatch, rg=rg, pp_t=pp_t:
                        _stage_split(rcfg, rbatch, rg, pp_tables=pp_t))
                    secondary[name]["stages"] = (
                        stages if serr is None else {"error": serr})

    record["secondary"] = secondary
    _emit(record)
    failed = failed_regimes(record)
    if failed:
        sys.exit(f"bench.py: regimes failed: {failed}")


if __name__ == "__main__":
    main()
