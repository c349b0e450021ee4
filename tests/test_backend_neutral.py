"""The engine's choices read the Config alone, never the backend, and
the measurement entry points refuse to run without a GPU.

These run on the CPU: the march/table policy is checked with
``jax.default_backend`` patched to every platform, so the CPU suite
tests exactly what an accelerator runs.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from nusiprop_tpu.config import Config
from nusiprop_tpu.models import transport
from nusiprop_tpu.utils import costmodel

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H100 = "NVIDIA H100 80GB HBM3"

# (Config fields, expected march, expected f32 quadrature alpha table)
POLICY = [
    (dict(non_resonant=False, phiphi=False), "rank1", False),
    (dict(non_resonant=True, phiphi=False), "trisolve", False),
    (dict(non_resonant=True, phiphi=True), "trisolve", False),
    (dict(non_resonant=True, phiphi=False, N_bins_E=60), "trisolve", False),
    (dict(non_resonant=True, table_dtype="f32"), "trisolve", True),
    (dict(non_resonant=True, march="trisolve", table_dtype="f64"),
     "trisolve", False),
    (dict(non_resonant=False, march="rank1_f32"), "rank1_f32", False),
    (dict(non_resonant=True, march="trisolve_f32"), "trisolve_f32", False),
]


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
@pytest.mark.parametrize("fields,march,f32_alpha", POLICY)
def test_auto_policy_ignores_backend(monkeypatch, backend, fields, march,
                                     f32_alpha):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    kw = dict(N_bins_E=500, lEmin=4.0, lEmax=9.0, zmax=5.0)
    kw.update(fields)
    cfg = Config(**kw)
    assert transport._resolve_march(cfg) == march
    assert transport._use_f32_alpha(cfg) is f32_alpha


@pytest.mark.parametrize("non_resonant", [True, False])
def test_config_rejects_removed_fused_march(non_resonant):
    with pytest.raises(ValueError, match="trisolve_pallas' was removed"):
        Config(non_resonant=non_resonant, march="trisolve_pallas")


def test_trisolve_f32_accepts_f32_tables():
    cfg = Config(non_resonant=True, march="trisolve_f32", table_dtype="f32")
    assert transport._resolve_march(cfg) == "trisolve_f32"


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins; unset, the cache is the fixed
    <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(ROOT / ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, nusiprop_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=dict(env, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == want


# ---- peak table ----------------------------------------------------------

def test_h100_peaks_from_data_sheet():
    pk = costmodel.peaks(H100)
    assert pk["fp64_tensor"] == 67e12 and pk["fp64"] == 34e12
    assert pk["tf32_tensor"] == 495e12 and pk["bf16_tensor"] == 989e12
    assert pk["hbm_bytes"] == 3.35e12


def test_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        costmodel.peaks("Unknown Accelerator")
    with pytest.raises(KeyError):
        costmodel.roofline_fields("rank1_f32", 8, 100, 79, 1.0, "cpu")


@pytest.mark.parametrize("march", ["rank1", "trisolve", "loop"])
def test_f64_marches_report_no_roofline(march):
    assert costmodel.roofline_fields(march, 8, 500, 79, 1.0, H100) == {}


@pytest.mark.parametrize("march,phiphi", [("rank1_f32", False),
                                          ("trisolve_f32", False),
                                          ("trisolve_f32", True)])
def test_f32_marches_report_roofline(march, phiphi):
    f = costmodel.roofline_fields(march, 8, 500, 79, 0.5, H100,
                                  phiphi=phiphi)
    flops, bytes_ = costmodel.regime_model(march, 8, 500, 79, phiphi=phiphi)
    assert f["mfu"] == round(flops / 0.5 / 67e12, 5)
    assert f["hbm_frac"] == round(bytes_ / 0.5 / 3.35e12, 5)


# ---- chip_smoke.py helpers -----------------------------------------------

def test_smoke_deviation_only_near_peak():
    import chip_smoke as cs

    ref = np.array([[1e5, 1.0, 1e-4, 1e-20]])
    got = ref * np.array([[1 + 1e-7, 1 + 2e-7, 1 + 3e-7, 2.0]])
    dev, mask = cs.rel_dev(got, ref)
    assert mask.tolist() == [[True, True, True, False]]
    assert cs.max_dev(got, ref) == pytest.approx(3e-7, rel=1e-6)
    # every spectrum (last axis) has its own peak
    two = np.stack([ref[0], ref[0] * 1e-30])
    assert cs.peak_window(two).tolist() == [[True, True, True, False]] * 2


def test_smoke_deviation_flags_nonfinite_and_shape():
    import chip_smoke as cs

    ref = np.ones((2, 3, 4))
    got = ref.copy()
    got[1, 2, 3] = np.nan
    assert cs.max_dev(got, ref) == np.inf
    with pytest.raises(ValueError, match="shape"):
        cs.rel_dev(np.ones(3), np.ones(4))


def test_smoke_noise_split():
    import chip_smoke as cs

    cf = np.ones((1, 1, 4))
    quad = np.array([[[1.0, 1.0, 2.0, 1.0 + 1e-5]]])  # bin 2: closed form off
    card = cf * np.array([[[1 + 1e-8, 1, 1 + 5e-5, 1]]])
    out = cs.noise_split(card, cf, quad)
    assert out["noise_bins"] == 1 and out["window_bins"] == 4
    assert out["clean_dev"] == pytest.approx(1e-8)
    assert out["noise_dev"] == pytest.approx(5e-5)
    assert out["noise_dev_over_cf_err"] == pytest.approx(1e-4)


def test_smoke_spread_indices():
    import chip_smoke as cs

    idx = cs.spread_indices(1024)
    assert len(idx) == 8 and idx[0] == 0 and idx[-1] == 1023
    assert cs.spread_indices(3).tolist() == [0, 1, 2]


def test_smoke_last_line():
    import chip_smoke as cs

    line = cs.last_line({"platform": "gpu", "kind": H100, "count": 1,
                         "extra": "dropped"})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


def test_smoke_card_options():
    import chip_smoke as cs

    assert cs.phases_for(4) == ("sharded_scan", "eshard")
    assert not set(cs.phases_for(1)) & set(cs.phases_for(4))
    assert set(cs.phases_for(1)) | set(cs.phases_for(4)) == set(cs.PHASES)
    with pytest.raises(ValueError):
        cs.phases_for(2)


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--cards", "4"]),
                                         ("bench.py", [])])
def test_entry_points_refuse_cpu(script, args):
    """Without a GPU the measurement scripts exit non-zero and print no
    result line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / script), *args], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout and '"value"' not in out.stdout
    assert "needs a GPU" in out.stderr


# ---- bench.py ------------------------------------------------------------

def test_bench_failed_regimes():
    import bench

    rec = {"value": 1.0, "secondary": {
        "non_resonant": {"error": "boom"},
        "phiphi": {"zsteps_per_sec": 1.0, "stages": {"error": "x"}},
        "s_channel_f64": {"zsteps_per_sec": 1.0}}}
    assert bench.failed_regimes(rec) == ["non_resonant", "phiphi.stages"]
    assert bench.failed_regimes({"error": "e", "secondary": {}}) == [
        "headline"]


def test_bench_exits_nonzero_on_failed_regime(monkeypatch, capsys):
    import bench
    from nusiprop_tpu.utils import profiling

    monkeypatch.setattr(profiling, "device_record", lambda: {
        "platform": "gpu", "kind": H100, "count": 1})
    monkeypatch.setattr(profiling, "gpu_power_limits",
                        lambda: [f"{H100}, 700.00 W"])

    def fake_time(cfg, batch, g0, reps, run=None):
        if cfg.non_resonant:
            raise RuntimeError("regime failed")
        return 1e6, 0.01

    monkeypatch.setattr(bench, "_time_regime", fake_time)
    monkeypatch.setenv("BENCH_PHIPHI", "0")
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["device"] == {"platform": "gpu", "kind": H100, "count": 1}
    assert "regime failed" in record["secondary"]["non_resonant"]["error"]
    assert record["secondary"]["s_channel_f64"]["march"] == "rank1"
    assert "mfu" in record and "mfu" not in record["secondary"][
        "s_channel_f64"]


# ---- __graft_entry__ -----------------------------------------------------

def test_dryrun_multichip_raises_on_too_few_devices():
    import __graft_entry__ as g

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices"):
        g.dryrun_multichip(n)
