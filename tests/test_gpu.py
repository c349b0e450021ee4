"""Tests that need a GPU (marker ``gpu``): they skip on a machine
without one. Run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Each compares a small scan on the card with the same scan on the CPU in
float64 (the tolerances are chip_smoke.py's, with their reasons there).
"""

import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest

import nusiprop_tpu as nu

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a "
                    "machine with one)")


def _scan(params, cfg, device):
    return np.asarray(nu.grid_scan(cs._to(params, device), cfg).flux_fla)


@pytest.mark.parametrize("non_resonant", [False, True])
def test_auto_march_matches_cpu(gpu, non_resonant):
    cfg = nu.Config(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                    non_resonant=non_resonant, phiphi=False)
    params = nu.param_grid(np.geomspace(1e5, 1e8, 4), [1e-3],
                           mntot=cs.MNTOT, si=2.0, norm=6.0)
    card = _scan(params, cfg, gpu)
    with cs.on_cpu() as cpu:
        ref = _scan(params, cfg, cpu)
    if non_resonant:
        with cs.on_cpu() as cpu:
            quad = _scan(params, dataclasses.replace(cfg, table_dtype="f32"),
                         cpu)
        split = cs.noise_split(card, ref, quad)
        assert split["clean_dev"] <= cs.TOL_F64, split
        assert split["noise_dev"] <= cs.TOL_NOISE, split
    else:
        assert cs.max_dev(card, ref) <= cs.TOL_F64


def test_rank1_f32_matches_f64_on_card(gpu):
    cfg = nu.Config(N_bins_E=500, lEmin=4.0, lEmax=9.0, zmax=5.0,
                    non_resonant=False, phiphi=False)
    params = nu.param_grid(np.geomspace(1e5, 1e8, 16), [1e-2],
                           mntot=cs.MNTOT, si=2.0, norm=6.0)
    f64 = _scan(params, cfg, gpu)
    f32 = _scan(params, dataclasses.replace(cfg, march="rank1_f32"), gpu)
    assert cs.max_dev(f32, f64) <= cs.TOL_F32
