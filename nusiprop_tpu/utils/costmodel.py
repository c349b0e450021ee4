"""Analytic FLOP / device-memory-byte models for the bench regimes
(roofline reporting).

The bench JSON's ``mfu``/``hbm_frac`` fields divide these modeled op
counts by the measured wall and the device's published peaks. The
models count the DOMINANT stages only (alpha-table build, redshift
march, phi-phi spline contraction) with documented per-entry
coefficients, and only for the float32 marches (``rank1_f32``,
``trisolve_f32``): a regime that ran a float64 march reports no
roofline field rather than a wrong one. Launch latency and small tables
are deliberately not modeled — for latency-bound regimes (the
s-channel headline at its tiny per-point op count) the honest reading
is "MFU ~ 0; this regime buys its speed from batching and log-depth
scans, not arithmetic density".

Workload constants (B = batch, NE bins, Nz z-nodes):
  NEXT = NE + Nz - 1 extended bins (nuSIprop.hpp:268-272 ladder)
  NT   = NEXT*(NEXT-1)/2 strict-upper kernel pairs
"""

import math

# Published dense peaks (no sparsity) per device_kind, FLOP/s and
# bytes/s. Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, at
# its full 700 W power limit; a card set to a lower limit cannot hold
# these clocks under load, so report its power limit beside any share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp64_tensor": 67e12,
        "fp64": 34e12,
        "fp32": 67e12,
        "tf32_tensor": 495e12,
        "bf16_tensor": 989e12,
        "hbm_bytes": 3.35e12,
    },
}

# The float32 marches run their matmuls at Precision.HIGHEST, i.e. in
# float32 outside the tensor cores, so their FLOP share is taken
# against the fp32 peak.
_FLOP_PEAK = "fp32"


def peaks(device_kind: str) -> dict:
    """The peak table of ``device_kind``; an unknown device is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add "
            "them to nusiprop_tpu/utils/costmodel.PEAKS with their "
            "source") from None


def _march_f32_rank1(B, NE, Nz):
    """rank1_f32 scan: per z-step ~25 (NE,3) elementwise ops (Sherman-
    Morrison rows) + a log-depth associative scan (~4 flops/compose x
    log2(NE) levels x NE)."""
    flops = (Nz - 1) * B * NE * (25 * 3 + 4 * math.ceil(math.log2(NE)))
    # 7 coefficient rows read + phi carry rw, all f32
    bytes_ = (Nz - 1) * B * NE * 4 * (7 + 6)
    return flops, bytes_


def _march_f32_trisolve(B, NE, Nz, BS=128):
    """trisolve_f32 scan: per z-step the nilpotent Neumann solve
    (transport._nilpotent_solve: NB diagonal BSxBS blocks, ~log2(BS)
    repeated squarings of 2*BS^3 flops each) + the NE^2 window matvec
    and Nmat assembly."""
    NB = -(-NE // BS)
    levels = max(1, math.ceil(math.log2(BS)))
    solve = NB * levels * 2 * (2 * BS ** 3) + (NB * (NB - 1) // 2) * 2 * BS ** 2
    matvec = 2 * 2 * NE * NE          # Nmat assembly + reg matvec
    flops = (Nz - 1) * B * (solve + matvec)
    # Awin read + Nmat write/read per step, f32
    bytes_ = (Nz - 1) * B * (3 * NE * NE * 4)
    return flops, bytes_


# Per-(pair, state) f32 op count of the quadrature alpha build
# (kernels_nr_f32): 81 tensor-channel inner evals (~12 flops) + 27
# q-node transforms (expm1 + weights, ~18) + the separable st factor
# (GL5 x-moments + difference-safe atan series, ~550 incl. the
# Majorana near-resonance su branch). Estimate, not a measurement.
C_ALPHA_F32 = 2000


def _alpha_build_f32(B, NEXT):
    NT = NEXT * (NEXT - 1) // 2
    flops = B * NT * 3 * C_ALPHA_F32
    bytes_ = B * NEXT * NEXT * 4      # scattered output table
    return flops, bytes_


def _pp_build(B, NE, n1=300, n2=300):
    """Separable phi-phi spline contraction (kernels.alpha_pp_grid):
    axis-1 and axis-0 one-hot matmuls + the rank-7 tail contraction."""
    flops = B * 3 * (2 * n1 * n2 * NE + 2 * NE * n1 * NE + 2 * NE * 7 * NE)
    bytes_ = B * 3 * NE * NE * 4 * 2
    return flops, bytes_


def regime_model(march, B, NE, Nz, phiphi=False, pp_shape=None):
    """(model_flops, model_bytes) of one evolve batch on a float32
    march; None for the float64 marches, which are not modeled."""
    NEXT = NE + Nz - 1
    if march == "rank1_f32":
        return _march_f32_rank1(B, NE, Nz)
    if march != "trisolve_f32":
        return None
    f1, b1 = _alpha_build_f32(B, NEXT)
    f2, b2 = _march_f32_trisolve(B, NE, Nz)
    if phiphi:
        n1, n2 = pp_shape if pp_shape else (300, 300)
        f3, b3 = _pp_build(B, NEXT, n1, n2)
        return f1 + f2 + f3, b1 + b2 + b3
    return f1 + f2, b1 + b2


def roofline_fields(march, B, NE, Nz, wall_sec, device_kind, phiphi=False,
                    pp_shape=None):
    """Dict of mfu/hbm fields for the bench JSON: empty for a float64
    march or a non-positive wall; raises for a device without peaks."""
    m = regime_model(march, B, NE, Nz, phiphi=phiphi, pp_shape=pp_shape)
    if m is None or wall_sec <= 0:
        return {}
    pk = peaks(device_kind)
    flops, bytes_ = m
    return {
        "model_tflops": round(flops / wall_sec / 1e12, 4),
        "mfu": round(flops / wall_sec / pk[_FLOP_PEAK], 5),
        "model_gbps": round(bytes_ / wall_sec / 1e9, 2),
        "hbm_frac": round(bytes_ / wall_sec / pk["hbm_bytes"], 5),
    }
