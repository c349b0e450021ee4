"""Float32 non-resonant bin-to-bin (alpha) kernel table
(``table_dtype="f32"``).

The (NE+Nz)^2/2-pair alpha table dominates a non-resonant table build:
with the f64 closed forms every pair evaluates dilogarithm-heavy
antiderivative differences (kernels_nr.py, after
nuSIprop.hpp:1280-1474). This module replaces that build — for the alpha table only; the N-sized Gamma and
alphaTilde tables are ~300x cheaper and stay in f64 — with fixed-order
Gauss-Legendre quadrature of the MATRIX-ELEMENT-LEVEL integrands over
the narrow (2.3% x 2.3%) bin-pair domains, evaluated in float32:

* The doubly-differential integrands are simple rationals with no
  cancellation anywhere: the t/u/tu shapes are the reference's own
  GL-rescue integrands (nuSIprop.hpp:1286-1304; kernels_nr._a_rect_quad),
  and the s-t/s-u interference factorizes through the amplitude product
  M_s M_t* into

      F_st(y, x) = 2 y (x-1) / (x ((x-1)^2 + gr^2) (y-1))
      F_su(y, x) = 2 u (x-1) / (x ((x-1)^2 + gr^2) (u-1)),  u = -x-y

  verified against the f64 closed forms to 1e-12 (Dirac alpha_st = the
  F_st integral / 32 pi; Majorana = (F_st + F_su) integral / 32 pi —
  numerically calibrated against kernels_nr.alpha_st).
* A GL3(^2) rule on a narrow bin-pair domain of these integrands is
  accurate to ~1e-9 relative (degree-5 exactness; the integrands are
  near-polynomial over a 2.3% window) — the reference itself accepts the
  same tensor-GL3 evaluation as its rescue path.
* The only sharp feature is the s-channel resonance factor
  (x-1)/((x-1)^2+gr^2) in F_st/F_su. Where the resonance sits within
  ~20 source-bin widths, the x-integral switches to EXACT moments
  (difference-safe log-ratio / w-atan(w) forms, cf. kernels_f32) against
  a quadratic fit of the smooth cofactor through the GL nodes.
* Cancellation-prone quantities (x-1, bin widths, x+y — which vanishes
  exactly at adjacent bin pairs) are precomputed in float64 and cast,
  exactly as kernels_f32 does for the s-channel.
* The phi-phi channel (spline tables + asymptotic tails) is NOT built
  here; callers add kernels_nr's f64 "pp" channel when phiphi is on.

The returned table is float64 (the trisolve march consumes f64), equal
to kernels.alpha_table(non_resonant=True, channels s+t_u+tu+st) with
~1e-7 f32 round-off; prefactors are applied in the range-safe
(g^2/denom)*g^2 grouping.
"""

import math

import jax.numpy as jnp
import numpy as _np

from nusiprop_tpu.models.kernels import scalar_width, _shift_near_minus1

PI = math.pi
F32 = jnp.float32

# 3-point Gauss-Legendre on [0, 1]: nodes as interval fractions, weights
# summing to 1 (same rule as the reference rescues, aux.hpp:53-54).
_SQ06 = math.sqrt(0.6)
_GL3_C = (0.5 * (1.0 - _SQ06), 0.5, 0.5 * (1.0 + _SQ06))
_GL3_W = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)

# 5-point Gauss-Legendre on [0, 1] (resonance-factor x-integrals: the
# 1/((x-1)^2+gr^2) variation needs the higher order once the pole is
# within a few bin widths; error ~ ((w/2)/dist)^10)
_X5 = 0.5384693101056831
_X9 = 0.9061798459386640
_GL5_C = (0.5 * (1.0 - _X9), 0.5 * (1.0 - _X5), 0.5,
          0.5 * (1.0 + _X5), 0.5 * (1.0 + _X9))
_GL5_W = (0.5 * 0.23692688505618908, 0.5 * 0.47862867049936647, 0.5 * 0.5688888888888889,
          0.5 * 0.47862867049936647, 0.5 * 0.23692688505618908)

# resonance within 2 source-bin widths => exact-moment branch (there the
# s-channel dominates the entry, so the moment branch's O((w/2x)^3)
# cofactor-fit error is immaterial; beyond 2 widths GL5 is ~1e-6)
_T_NEAR = 2.0

# geometric panels per trapezoid segment of the q-sliced tensor
# integrals (resolves the u ~ -1 structure of near-diagonal
# wide-coordinate pairs; see tensor comment). 3 panels measured
# indistinguishable from 5 at the stressed high-coordinate config
# (max table error 2.709e-6 vs f64 closed forms for BOTH — f32
# round-off dominates) while cutting the build ~20%; the scipy-referee
# and flux-level gates (test_kernels_nr_f32) pin the accuracy.
_NPANEL = 3

# matches kernels_nr._COORD_FLOOR zeroing of sub-floor entries
_COORD_FLOOR = 1e-8


def _atandiff32(u, xy):
    """atan(x) - atan(y) for x > y, given u = (x-y)/(1+xy) and xy."""
    return jnp.arctan(u) + jnp.where(xy < -1.0, jnp.float32(PI),
                                     jnp.float32(0.0))


def _logratio32(d_num, den_m, ratio):
    """log(ratio) given the exact log1p argument d_num/den_m == ratio-1."""
    arg = d_num / den_m
    return jnp.where(jnp.abs(arg) < 0.5, jnp.log1p(arg), jnp.log(ratio))


def _dG32(wm, wp, dw, xy_w):
    """G(wp) - G(wm) with G(w) = w - atan(w), difference-safe.

    dw = wp - wm (exact from the f64 bin width). For small |w| the
    direct form cancels (G ~ w^3/3); the series uses homogeneous sums
    S_k = (wp^{k+1}-wm^{k+1})/dw, which are positive-definite for even
    k, so every term is a clean product.
    """
    wms = jnp.clip(wm, -0.55, 0.55)
    wps = jnp.clip(wp, -0.55, 0.55)
    # homogeneous sums S_k = sum_{i+j=k} wp^i wm^j (clamped inputs)
    S1 = wps + wms
    S2 = wps * S1 + wms * wms
    S3 = wps * S2 + wms * wms * wms
    m4 = (wms * wms) * (wms * wms)
    S4 = wps * S3 + m4
    S5 = wps * S4 + m4 * wms
    S6 = wps * S5 + m4 * wms * wms
    S7 = wps * S6 + m4 * wms * wms * wms
    S8 = wps * S7 + m4 * m4
    S9 = wps * S8 + m4 * m4 * wms
    S10 = wps * S9 + m4 * m4 * wms * wms
    S11 = wps * S10 + m4 * m4 * wms * wms * wms
    S12 = wps * S11 + m4 * m4 * m4
    series = dw * (S2 / 3.0 - S4 / 5.0 + S6 / 7.0 - S8 / 9.0
                   + S10 / 11.0 - S12 / 13.0)
    direct = dw - _atandiff32(dw / (1.0 + xy_w), xy_w)
    small = jnp.maximum(jnp.abs(wm), jnp.abs(wp)) < 0.3
    return jnp.where(small, series, direct)


_XI = 2.0 * _GL5_C[4] - 1.0  # outer GL5 node in (x-xc)/hw units


def _x_res_moments(vm, vp, vsum, ds, gr, inv_gr):
    """Exact moments of the resonance factor over the source bin:
    J_k = int ((x-xc)/hw)^k (x-1)/((x-1)^2+gr^2) dx, k = 0..2 —
    the near-branch machinery of the x-resonance integrals. Depends on
    SOURCE-BIN quantities only, so callers evaluate it once per
    (state, column) and pair it with per-pair quadratic cofactor fits
    (c0 J0 + c1 J1 + c2 J2)."""
    gr2 = gr * gr
    den_m = gr2 + vm * vm
    ratio = (gr2 + vp * vp) / den_m
    V1 = 0.5 * _logratio32(ds * vsum, den_m, ratio)
    wm = vm * inv_gr
    wp = vp * inv_gr
    V2 = gr * _dG32(wm, wp, ds * inv_gr, wm * wp)
    V3 = 0.5 * ds * vsum - gr2 * V1
    vc = 0.5 * vsum  # = xc - 1
    hw = 0.5 * ds
    J0 = V1
    J1 = (V2 - vc * V1) / hw
    J2 = (V3 - 2.0 * vc * V2 + vc * vc * V1) / (hw * hw)
    return J0, J1, J2


def _quad_fit(h0, h2, h4):
    """Quadratic through the (outer, center, outer) GL5 nodes."""
    c0 = h2
    c1 = (h4 - h0) / (2.0 * F32(_XI))
    c2 = (h0 + h4 - 2.0 * h2) / (2.0 * F32(_XI * _XI))
    return c0, c1, c2


def _x_res_integral(hs, vm, vp, vsum, ds, gr, inv_gr, near,
                    moments=None):
    """int over the source bin of h(x) * (x-1)/((x-1)^2 + gr^2) dx.

    hs: the smooth cofactor h at the five GL5 x-nodes.
    vm/vp = sm-1 / sp-1 (f64-precomputed, cast), vsum = vm+vp exact,
    ds = bin width, near = pole within _T_NEAR bin widths. Far: GL5 of
    the full integrand. Near: exact moments J0..J2 (_x_res_moments,
    precomputed per column when given) against the quadratic through
    the (outer, center, outer) nodes.
    """
    gr2 = gr * gr

    # ---- far branch: GL5 ----
    far = jnp.zeros_like(hs[0])
    for c, w, h in zip(_GL5_C, _GL5_W, hs):
        v = vm + F32(c) * ds
        far = far + F32(w) * h * v / (v * v + gr2)
    far = far * ds

    # ---- near branch: quadratic h x exact moments ----
    J0, J1, J2 = (moments if moments is not None
                  else _x_res_moments(vm, vp, vsum, ds, gr, inv_gr))
    c0, c1, c2 = _quad_fit(hs[0], hs[2], hs[4])
    moment = c0 * J0 + c1 * J1 + c2 * J2
    return jnp.where(near, moment, far)


def alpha_table_f32(Em, Ep, mn, g, mphi, Wf, *, majorana: bool,
                    raw: bool = False, width_factor=None,
                    cols_block=None):
    """Non-resonant alpha table (s + t/u + tu + st/su channels) in
    native float32.

    Default: returned as the float64 (N, N) strict-upper table the f64
    trisolve march consumes (prefactor applied). ``raw=True`` returns
    ``(table32, pref)`` — the NORMALIZED float32 table plus its float64
    g^4 prefactor — for the float32 trisolve march, which folds the
    prefactor into its range-safe per-node row scales.

    ``Wf=None`` skips the |U|^2 eigenstate reduction and returns the
    per-state (3, N, N) f64 table (kernels.alpha_table per_state
    contract — general non-diagonal couplings); ``width_factor`` scales
    the scalar width by sum(Q) there (evolve_general).

    Matches kernels.alpha_table(..., non_resonant=True, phiphi=False)
    to f32 round-off; the phi-phi channel is added separately by the
    caller (transport.build_tables) in f64 when enabled.

    ``cols_block=(col_offset, C)`` builds ONLY the table's column block
    [col_offset, col_offset+C) — the storage-sharded E' march
    (parallel/eshard) gives each device its own block so no device ever
    materializes the full (N, N) table (SURVEY §5 >=1e4-bin scenario;
    reference workload nuSIprop.hpp:289-291). col_offset may be traced
    (each device derives it from its mesh axis index); C is static.
    Returns the (N, C) block (strict-upper entries; rest zero), shaped
    (3, N, C) for per-state, or ((N, C) f32, pref) for raw.
    """
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:
        ga = ga * width_factor
    N = Em.shape[0]
    if cols_block is not None:
        c0, C = cols_block
        c0 = jnp.asarray(c0, dtype=jnp.int32)
        rows = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None],
                                (N, C)).ravel()
        cols_raw = jnp.broadcast_to(
            c0 + jnp.arange(C, dtype=jnp.int32)[None, :], (N, C)).ravel()
        # strict upper triangle only; clamp out-of-range/invalid pairs
        # to a safe in-range column and zero them at assembly
        valid = (rows < cols_raw) & (cols_raw < N)
        cols = jnp.minimum(cols_raw, N - 1)
    else:
        rows, cols = _np.triu_indices(N, k=1)
        rows = jnp.asarray(rows)
        cols = jnp.asarray(cols)
        valid = None

    # ---- f64 coordinate precompute (cheap elementwise) ----
    # Per-BIN bases first (3, N): every per-pair array is a static
    # gather of these, and everything that depends on only one side of
    # the pair — the st/s-channel resonance x-integrals (source column)
    # and the T_st factor (target row) — is evaluated at the per-bin
    # level and gathered, NOT recomputed per pair: the transcendental
    # resonance machinery is O(N) instead of O(N^2/2) (round 4; the
    # round-2 build evaluated it per pair).
    mn_c = mn[:, None]
    inv_m2 = 1.0 / (mphi * mphi)
    tpb64 = _shift_near_minus1(-2.0 * mn_c * Ep[None, :] * inv_m2)
    tmb64 = _shift_near_minus1(-2.0 * mn_c * Em[None, :] * inv_m2)
    smb64 = 2.0 * mn_c * Em[None, :] * inv_m2
    spb64 = 2.0 * mn_c * Ep[None, :] * inv_m2
    # floored per-bin coordinates (kernels_nr floor semantics)
    tmb_f = jnp.minimum(tmb64, -_COORD_FLOOR)
    tpb_f = jnp.minimum(tpb64, -_COORD_FLOOR)
    smb_f = jnp.maximum(smb64, _COORD_FLOOR)
    spb_f = jnp.maximum(spb64, _COORD_FLOOR)
    dt_r64 = tmb_f - tpb_f                # > 0 (target-bin width in t)
    ds_c64 = spb_f - smb_f                # > 0 (source-bin width in s)
    vm_c64 = smb_f - 1.0
    vp_c64 = spb_f - 1.0
    vsum_c64 = vm_c64 + vp_c64
    gr64 = ga / mphi

    f = lambda a: jnp.asarray(a).astype(F32)
    gr = f(gr64)
    inv_gr = f(1.0 / gr64)
    gr2 = gr * gr
    # per-pair gathers (static indices; traced for cols_block)
    tp_f = tpb_f[:, rows]
    smp_f = smb_f[:, cols]
    if valid is not None:
        # invalid (clamped) pairs: force the well-conditioned
        # adjacent-pair geometry (x+y corner exactly 0) so no NaN can
        # leak through the masked-out entries
        tp_f = jnp.where(valid[None, :], tp_f, -smp_f)
    ok = (-tpb64[:, rows] >= _COORD_FLOOR) & (spb64[:, cols] >= _COORD_FLOOR)
    if valid is not None:
        ok = ok & valid[None, :]
    dt64 = dt_r64[:, rows]
    ds64 = ds_c64[:, cols]
    xy0_64 = smp_f + tp_f                 # x+y at the (xm, tp) corner:
    # exactly 0 for adjacent pairs (Em[col] == Ep[row] on the ladder)
    tp_, dt = f(tp_f), f(dt64)
    smp, ds = f(smp_f), f(ds64)
    xy0 = f(xy0_64)
    vm, vp = f(vm_c64)[:, cols], f(vp_c64)[:, cols]

    dirac_half = 1.0 if majorana else 0.5

    # ---- node grids (separable st factor) ----
    ys = [tp_ + F32(c) * dt for c in _GL3_C]             # y (t) nodes

    # ---- column-level resonance machinery (O(N), gathered per pair) --
    vm_c, vp_c, vsum_c = f(vm_c64), f(vp_c64), f(vsum_c64)
    ds_c = f(ds_c64)
    smb32 = f(smb_f)
    # Is the x-resonance within _T_NEAR source-bin widths of this column?
    crossing = vm_c * vp_c < 0.0
    vmin_r = jnp.where(crossing, 0.0,
                       jnp.minimum(jnp.abs(vm_c), jnp.abs(vp_c)))
    near_c = (vmin_r * vmin_r + gr2) <= (F32(_T_NEAR) * ds_c) ** 2
    J0c, J1c, J2c = _x_res_moments(vm_c, vp_c, vsum_c, ds_c, gr, inv_gr)
    inv_xs5_c = [1.0 / (smb32 + F32(c) * ds_c) for c in _GL5_C]
    X_st_c = _x_res_integral(inv_xs5_c, vm_c, vp_c, vsum_c, ds_c, gr,
                             inv_gr, near_c, moments=(J0c, J1c, J2c))
    near_res = near_c[:, cols]

    # ---- tensor channels: t/u, tu interference, and (far-resonance) su --
    #
    # The u-dependent factors (u = -x-y) have O(1)-scale structure around
    # u ~ -1 while near-diagonal pairs at large coordinates span many
    # units of u IN BOTH bin directions, so no fixed-order rule over the
    # (x, y) rectangle resolves them. The integral is therefore sliced
    # along lines of CONSTANT u: with q = 1 + x + y = 1 - u (q >= 1 on
    # the strict upper triangle) and Delta = q - qA measured from the
    # exact corner qA = 1 + smp + tp,
    #
    #   int dx dy F = int_0^{ds+dt} dDelta  int_{x-slice(Delta)} dx F,
    #
    # where the slice is x-offset in [max(0, Delta-dt), min(ds, Delta)]
    # (a trapezoid: ramp / flat / ramp segments with kinks at
    # min(ds,dt) and max(ds,dt)). The OUTER Delta-integral runs each
    # segment over _NPANEL geometric panels in q (GL5 per panel), which
    # resolves the u-structure; the INNER x-integral of the remaining
    # smooth factors is GL3. All offsets are nonnegative exact-structured
    # products, so u - 1 = -(qA + Delta) and y = tp + (Delta - x_offset)
    # keep full f32 accuracy. For narrow bins everything degenerates to
    # a composite rule on the rectangle.
    #
    # Majorana:  2*(t_term + u_term) + interf   [1/16pi]
    #            + 2*(F_st + F_su)              [1/32pi; F_st separable,
    #                                            F_su in the tensor]
    # Dirac:     t_term [1/16pi] + F_st [1/32pi]
    # per-segment exact f64 bases (cast): segment edges in Delta, the
    # Delta-dt offset base, the mt-Delta base, and the -u corner base
    m1_64 = jnp.minimum(ds64, dt64)
    m2_64 = jnp.maximum(ds64, dt64)
    mt_64 = ds64 + dt64
    zero64 = jnp.zeros_like(ds64)
    segs = []
    for dlo64, dhi64 in ((zero64, m1_64), (m1_64, m2_64), (m2_64, mt_64)):
        segs.append((
            f(dlo64),                    # dlo
            f((dhi64 - dlo64) / (1.0 + xy0_64 + dlo64)),  # q-ratio - 1
            f(1.0 + xy0_64 + dlo64),     # qlo (exact)
            f(dlo64 - dt64),             # d_a: Delta-dt = dD + d_a
            f(mt_64 - dlo64),            # mtref: mt-Delta = mtref - dD
            f(xy0_64 + dlo64),           # mu base: -u = mu0 + dD
        ))
    m1c = f(m1_64)
    zero = jnp.zeros_like(ds)
    acc_tu = jnp.zeros_like(dt)
    acc_su = jnp.zeros_like(dt)
    for dlo, ratm1, qlo, d_a, mtref, mu0 in segs:
        # log-substituted outer integral: int f dq = int f(q) q dxi over
        # xi = ln(q/qlo), GL5 on _NPANEL uniform xi-panels; node weight
        # is wq * lnrho * q_node
        lnrho = jnp.log1p(ratm1) * F32(1.0 / _NPANEL)
        # GL3 per panel: measured identical to GL5 at the stressed
        # high-coordinate config (2.709e-6 max either way, f32
        # round-off bound) — 9 q-nodes per segment instead of 15
        for k in range(_NPANEL):
            for cq, wq in zip(_GL3_C, _GL3_W):
                dD = qlo * jnp.expm1((F32(k) + F32(cq)) * lnrho)
                Delta = dlo + dD
                a = jnp.maximum(zero, dD + d_a)     # x-slice start
                mtmd = mtref - dD                   # mt - Delta
                wx = jnp.maximum(
                    jnp.minimum(jnp.minimum(Delta, mtmd), m1c), 0.0)
                dY = jnp.minimum(dt, Delta)         # Delta - a (exact)
                mu = mu0 + dD                       # = -u, slice-constant
                # u-dependent factors are slice-constant: ONE reciprocal
                # of qv = 1 - u serves u_term, interference and su
                # (the per-x-node divisions dominate the arithmetic of
                # this build; with r = y/(y-1) the integrand is
                # inv_x2 * (2 r^2 + c_i r + 2 c_u) — 3 divisions per
                # node instead of 5-6, same math to 1 ulp)
                inv_qv = 1.0 / (1.0 + mu)
                c_i = (2.0 * mu) * inv_qv           # 2(-u)/(1-u)
                c_u = (mu * inv_qv) * (mu * inv_qv)
                wgt_q = F32(wq) * lnrho * (qlo + dD) * wx
                row_tu = zero
                row_su = zero
                for cx, wxw in zip(_GL3_C, _GL3_W):
                    ofs = a + F32(cx) * wx
                    x = smp + ofs
                    y = tp_ + (dY - F32(cx) * wx)
                    inv_x = 1.0 / x
                    inv_x2 = inv_x * inv_x
                    r = y / (y - 1.0)
                    if majorana:
                        val = inv_x2 * (2.0 * (r * r + c_u) + c_i * r)
                        v_x = vm + ofs              # x - 1 (f64-derived)
                        row_su = row_su + F32(wxw) * (
                            (c_i * v_x) * inv_x / (v_x * v_x + gr2))
                    else:
                        val = inv_x2 * (r * r)
                    row_tu = row_tu + F32(wxw) * val
                acc_tu = acc_tu + wgt_q * row_tu
                acc_su = acc_su + wgt_q * row_su
    ch_tu = acc_tu * F32(1.0 / (16.0 * PI))

    # ---- st (+ su) interference ----
    # F_st factorizes: T_st = int 2y/(y-1) dy (target row, O(N)) x
    # X_st = int (x-1)/(x D) dx (source column, O(N), hoisted above)
    tpb32, dtr32 = f(tpb_f), f(dt_r64)
    T_st_r = jnp.zeros_like(tpb32)
    for wj, cy in zip(_GL3_W, _GL3_C):
        y = tpb32 + F32(cy) * dtr32
        T_st_r = T_st_r + F32(wj) * 2.0 * y / (y - 1.0)
    T_st_r = T_st_r * dtr32
    ch_st = T_st_r[:, rows] * X_st_c[:, cols]
    if majorana:
        # su: near the resonance the tensor's 3-node x-sampling cannot
        # resolve (x-1)/D — use the exact-moment x-integral there (such
        # pairs sit at s ~ 1 where bins are narrow, so the plain GL3
        # y-integral over the 5-node-x cofactor is accurate). The
        # moments J0..J2 are column-only (gathered); per pair only the
        # quadratic cofactor fit through the (outer, center, outer)
        # x-nodes remains — 9 rational evals, no transcendentals.
        J0p, J1p, J2p = J0c[:, cols], J1c[:, cols], J2c[:, cols]
        acc_su_near = jnp.zeros_like(dt)
        for cj, wj in zip(_GL3_C, _GL3_W):
            hs = []
            for ci in (_GL5_C[0], _GL5_C[2], _GL5_C[4]):
                u = -(xy0 + F32(ci) * ds + F32(cj) * dt)
                inv_x = 1.0 / (smp + F32(ci) * ds)
                hs.append(2.0 * u / (u - 1.0) * inv_x)
            c0, c1, c2 = _quad_fit(*hs)
            acc_su_near = acc_su_near + F32(wj) * (
                c0 * J0p + c1 * J1p + c2 * J2p)
        su = jnp.where(near_res, acc_su_near * dt, acc_su)
        ch_st = 2.0 * (ch_st + su)  # dispatcher x2 for Majorana
    ch_st = ch_st * F32(1.0 / (32.0 * PI))

    nr_sum = jnp.where(ok, ch_tu + ch_st, 0.0)

    # ---- s channel (nuSIprop.hpp:1264-1269): separable, UNfloored ----
    # alpha_s/g^4 = dt * Q / (8 pi), Q = R/gr with
    # R = atandiff((sp'-1)/gr, (sm'-1)/gr), Taylor for spp < 1e-5;
    # Q is source-column-only, the width is target-row-only — both
    # evaluated per bin and gathered.
    vm_s, vp_s = f(smb64 - 1.0), f(spb64 - 1.0)
    ds_s = f(spb64 - smb64)
    xw_m = vm_s * inv_gr
    xw_p = vp_s * inv_gr
    xy_s = xw_p * xw_m
    u_s = (ds_s * inv_gr) / (1.0 + xy_s)
    Q_exact = _atandiff32(u_s, xy_s) * inv_gr
    G2 = 1.0 + gr2
    smb_u32 = f(smb64)
    Q_taylor = ((G2 + 2.0 * smb_u32) / (G2 * G2)) * ds_s + ds_s * ds_s / (G2 * G2)
    Q_c = jnp.where(f(spb64) < 1e-5, Q_taylor, Q_exact)
    ch_s = (f(tmb64 - tpb64)[:, rows] * Q_c[:, cols]
            * F32(dirac_half / (8.0 * PI)))

    tot = nr_sum + ch_s
    if valid is not None:
        # the s channel carries no floor mask (reference semantics);
        # zero the clamped out-of-block pairs here
        tot = jnp.where(valid[None, :], tot, 0.0)

    # ---- eigenstate reduction and assembly ----
    g64 = jnp.asarray(g, jnp.float64)
    pref = (g64 * g64) * (g64 * g64)
    if Wf is None:  # per-state (3, N, N) for general couplings
        res_s = (f(1.0 / (2.0 * mn_c)) * tot).astype(jnp.float64) * pref
        if valid is not None:
            return res_s.reshape(3, N, -1)
        out = jnp.zeros((3, N, N), dtype=jnp.float64)
        return out.at[:, rows, cols].set(res_s)
    w_e = f(Wf[:, None] / (2.0 * mn_c))
    res32 = jnp.sum(w_e * tot, axis=0)  # (NT,) f32, normalized by g^4
    if raw:
        if valid is not None:
            return res32.reshape(N, -1), pref
        out32 = jnp.zeros((N, N), dtype=F32)
        return out32.at[rows, cols].set(res32), pref
    res = res32.astype(jnp.float64) * pref
    if valid is not None:
        return res.reshape(N, -1)
    out = jnp.zeros((N, N), dtype=jnp.float64)
    return out.at[rows, cols].set(res)


# ---------------------------------------------------------------------------
# Float32 non-resonant Gamma / alphaTilde tables
# ---------------------------------------------------------------------------

# Taylor coefficients (exact rationals, cast) of the three cancelling
# single-integral shapes, about z = 0 (coefficient of z^n, n >= 1):
#   f_t_u(z) = (z+2)/(z(z+1)) - 2 log1p(z)/z^2        [Gamma t+u,
#       nuSIprop.hpp:799-810 rescue integrand]        c_n = (-1)^(n+1) n/(n+2)
#   f_tu(z)  = 1/z - 2(1+z) log1p(z)/(z^2 (2+z))      [Gamma t-u interf.]
#   h_st(z)  = 2 (z - log1p(z))/z                     [Gamma s-t cofactor:
#       the exact t-integral of 2y/(y-1)]             c_n = 2 (-1)^(n+1)/(n+2)
# Each direct form cancels catastrophically in f32 only for z ~< 0.6
# (worst ~30x amplification at the 0.6 crossover, ~2e-6 relative);
# below, 41 alternating terms reach f32 round-off (0.6^41 ~ 7e-10).
_SERIES_Z = 0.6
_FT_U_COEF = tuple((-1.0) ** (n + 1) * n / (n + 2) for n in range(1, 42))
_HST_COEF = tuple(2.0 * (-1.0) ** (n + 1) / (n + 1) for n in range(1, 42))
# sympy series of f_tu (tests/test_kernels_nr_f32.py re-derives & pins)
_FTU_COEF = (
    0.16666666666666666, -0.16666666666666666, 0.13333333333333333,
    -0.1, 0.07380952380952381, -0.05476190476190476,
    0.04126984126984127, -0.031746031746031744, 0.024963924963924963,
    -0.02005772005772006, 0.016439116439116438, -0.013714063714063715,
    0.011618936618936619, -0.009976134976134976, 0.008664538076302783,
    -0.0076002428943605415, 0.0067240980553674055, -0.005993627975052124,
    0.005377766368478443, -0.004853385348741386, 0.00440297725935093,
    -0.004013082832574016, 0.0036732080829536746, -0.0033750655799383755,
    0.0031120342144706123, -0.002878768429986629, 0.0026709113085893734,
    -0.0024848809416510085, 0.002317709288029805, -0.002166919160143935,
    0.0020304292770416646, -0.0019064802356687823, 0.0017935762522881726,
    -0.00169043891979488, 0.0015959702106481907, -0.001509222658666912,
    0.0014293751619920254, -0.0013557132220216538, 0.0012876127085718024,
    -0.001224526447201116, 0.0011659730796359956,
)


def _series1(z, coeffs):
    """sum_n coeffs[n-1] z^n in Horner form (f32)."""
    acc = jnp.zeros_like(z)
    for c in reversed(coeffs):
        acc = acc * z + F32(c)
    return acc * z


def _f_t_u32(z):
    direct = (z + 2.0) / (z * (z + 1.0)) - 2.0 * jnp.log1p(z) / (z * z)
    zs = jnp.minimum(z, F32(_SERIES_Z))
    return jnp.where(z < _SERIES_Z, _series1(zs, _FT_U_COEF), direct)


def _f_tu32(z):
    direct = (1.0 / z
              - 2.0 * (1.0 + z) * jnp.log1p(z) / (z * z * (2.0 + z)))
    zs = jnp.minimum(z, F32(_SERIES_Z))
    return jnp.where(z < _SERIES_Z, _series1(zs, _FTU_COEF), direct)


def _h_st32(z):
    direct = 2.0 * (z - jnp.log1p(z)) / z
    zs = jnp.minimum(z, F32(_SERIES_Z))
    return jnp.where(z < _SERIES_Z, _series1(zs, _HST_COEF), direct)


def nr_gamma_alphatilde_f32(Em, Ep, mn, g, mphi, Wf, *, majorana: bool,
                            width_factor=None):
    """Non-resonant Gamma and alphaTilde tables in native float32.

    Returns ``(tblG, tblAt)`` float64 (N,) tables covering the s, t/u,
    t-u and s-t/s-u channels — drop-in for the sum of the staged f64
    channel programs (kernels.gamma_table / alphatilde_table with
    channels "s"+"t_u"+"tu"+"st"), with ~f32 round-off. The phi-phi
    channel is NOT built here (caller adds the staged f64 "pp"
    program), and for Dirac the alphaTilde s-t/s-u interference is NOT
    built here either (its closed form does not reduce to the
    F_st matrix-element integral; the caller adds the staged f64 "st"
    alphatilde program — see transport.build_tables).

    Method: the same ladder step as alpha_table_f32 — integrate the
    MATRIX-ELEMENT-LEVEL integrands (the reference's own rescue
    integrands, nuSIprop.hpp:799-810, 985-1005) with fixed-order GL over
    the narrow bins, coordinates precomputed in f64. The three
    cancelling 1-D shapes get 41-term Taylor series below z = 0.6; the
    s-t resonance factor reuses the exact-moment/GL5 x-integral
    machinery (_x_res_moments). Constants verified against the f64
    closed forms channel by channel (tests/test_kernels_nr_f32.py).
    """
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:
        ga = ga * width_factor
    from nusiprop_tpu.models import kernels_f32

    # ---- s channel: reuse the validated normalized f32 builders ----
    tblG_s, tblAt_s, _rho, (pref_G, pref_At, _pr) = (
        kernels_f32.s_channel_tables_f32(Em, Ep, mn, g, mphi, Wf,
                                         majorana=majorana,
                                         width_factor=width_factor))

    mn_c = mn[:, None]
    inv_m2 = 1.0 / (mphi * mphi)
    f = lambda a: jnp.asarray(a).astype(F32)
    gr64 = ga / mphi
    gr = f(gr64)
    inv_gr = f(1.0 / gr64)
    gr2 = gr * gr

    # ---- Gamma: GL3 of the 1-D shapes over [sm, sp] ----
    smb64 = 2.0 * mn_c * Em[None, :] * inv_m2
    spb64 = 2.0 * mn_c * Ep[None, :] * inv_m2
    ok_g = spb64 >= _COORD_FLOOR
    smf64 = jnp.maximum(smb64, _COORD_FLOOR)
    spf64 = jnp.maximum(spb64, _COORD_FLOOR)
    dsg64 = spf64 - smf64
    smg, dsg = f(smf64), f(dsg64)
    acc_tu_g = jnp.zeros_like(smg)
    acc_int_g = jnp.zeros_like(smg)
    for c, w in zip(_GL3_C, _GL3_W):
        z_i = smg + F32(c) * dsg
        acc_tu_g = acc_tu_g + F32(w) * _f_t_u32(z_i)
        acc_int_g = acc_int_g + F32(w) * _f_tu32(z_i)
    # s-t interference: x-resonance integral of the h_st cofactor
    # Gamma_st = (1/32pi) int h_st(x) (x-1)/((x-1)^2 + gr^2) dx
    vmg, vpg = f(smf64 - 1.0), f(spf64 - 1.0)
    vsumg = f((smf64 - 1.0) + (spf64 - 1.0))
    crossing = vmg * vpg < 0.0
    vmin_g = jnp.where(crossing, 0.0,
                       jnp.minimum(jnp.abs(vmg), jnp.abs(vpg)))
    near_g = (vmin_g * vmin_g + gr2) <= (F32(_T_NEAR) * dsg) ** 2
    hs_g = [_h_st32(smg + F32(c) * dsg) for c in _GL5_C]
    # same machinery as the alpha X_st, with h(x) = h_st(x): note NO
    # 1/x here — the Gamma Jacobian differs from the pair measure
    # (verified exactly vs kernels_nr.gamma_st over s in [1e-2, 17],
    # gr in [1e-6, 3e-2])
    X_g = _x_res_integral(hs_g, vmg, vpg, vsumg, dsg, gr, inv_gr, near_g)
    mult_tu = 1.0 if majorana else 0.5
    mult_st = 2.0 if majorana else 1.0
    G_nr = (2.0 * (acc_tu_g * dsg) * F32(1.0 / (16.0 * PI))
            + mult_tu * (acc_int_g * dsg) * F32(1.0 / (16.0 * PI))
            + mult_st * X_g * F32(1.0 / (32.0 * PI)))
    G_nr = jnp.where(ok_g, G_nr, 0.0)

    # ---- alphaTilde: GL3 x GL3 over the same-bin triangle ----
    # y in [tp, tm], x in [-y, -tp] (nuSIprop.hpp:985-1005); exact
    # corner offsets: y_j = tp + cj dt, x-width w_j = cj dt,
    # x_i = -tp - (1-ci) w_j, u_i = -x_i - y_j = -ci w_j (exact).
    tpb64 = _shift_near_minus1(-spb64)
    tmb64 = _shift_near_minus1(-smb64)
    ok_at = -tpb64 >= _COORD_FLOOR
    tmf64 = jnp.minimum(tmb64, -_COORD_FLOOR)
    tpf64 = jnp.minimum(tpb64, -_COORD_FLOOR)
    dtt64 = tmf64 - tpf64
    tp32, dtt = f(tpf64), f(dtt64)
    mtp32 = f(-tpf64)                     # = -tp > 0 (x upper limit)
    at_tu = jnp.zeros_like(tp32)
    at_int = jnp.zeros_like(tp32)
    at_st = jnp.zeros_like(tp32)
    for cj, wj in zip(_GL3_C, _GL3_W):
        y = tp32 + F32(cj) * dtt
        wy = F32(cj) * dtt                # x-slice width (exact)
        ym1 = y - 1.0
        row_t = jnp.zeros_like(tp32)
        row_u = jnp.zeros_like(tp32)
        row_i = jnp.zeros_like(tp32)
        for ci, wi in zip(_GL3_C, _GL3_W):
            x = mtp32 - F32(1.0 - ci) * wy
            u = -F32(ci) * wy
            inv_x2 = 1.0 / (x * x)
            row_t = row_t + F32(wi) * (y * y) * inv_x2 / (ym1 * ym1)
            if majorana:
                row_u = row_u + F32(wi) * (u * u) * inv_x2 / ((u - 1.0) ** 2)
                row_i = row_i + F32(wi) * 2.0 * y * u * inv_x2 / (
                    ym1 * (u - 1.0))
        at_tu = at_tu + F32(wj) * wy * (row_t + row_u)  # x dtt below
        at_int = at_int + F32(wj) * wy * row_i
        if majorana:
            # s-t + s-u over the x-slice [-y, -tp]: exact-moment /
            # GL5 x-resonance integrals per y-node (f64 bases)
            vm_y = f(-(tpf64 + F32(cj) * dtt64) - 1.0)   # (-y) - 1
            vp_y = f(-tpf64 - 1.0)
            vsum_y = vm_y + vp_y
            xm_y = -y                                    # slice start
            crossing_y = vm_y * vp_y < 0.0
            vmin_y = jnp.where(crossing_y, 0.0,
                               jnp.minimum(jnp.abs(vm_y), jnp.abs(vp_y)))
            near_y = (vmin_y * vmin_y + gr2) <= (F32(_T_NEAR) * wy) ** 2
            mom_y = _x_res_moments(vm_y, vp_y, vsum_y, wy, gr, inv_gr)
            hs_st, hs_su = [], []
            for ci in _GL5_C:
                x5 = xm_y + F32(ci) * wy
                u5 = -F32(ci) * wy
                hs_st.append(1.0 / x5)
                hs_su.append(2.0 * u5 / (u5 - 1.0) / x5)
            X_st_y = _x_res_integral(hs_st, vm_y, vp_y, vsum_y, wy, gr,
                                     inv_gr, near_y, moments=mom_y)
            X_su_y = _x_res_integral(hs_su, vm_y, vp_y, vsum_y, wy, gr,
                                     inv_gr, near_y, moments=mom_y)
            at_st = at_st + F32(wj) * (2.0 * y / ym1 * X_st_y + X_su_y)
    # outer y-integral width (the inner x-width wy is already applied)
    at_tu = at_tu * dtt
    at_int = at_int * dtt
    at_st = at_st * dtt
    if majorana:
        At_nr = ((2.0 * at_tu + at_int) * F32(1.0 / (16.0 * PI))
                 + 2.0 * at_st * F32(1.0 / (32.0 * PI)))
    else:
        # Dirac: (1.5 + 0.5)/(32 pi) t-shape; the st closed form does
        # not reduce to the F_st integral — caller adds the f64 program
        At_nr = at_tu * F32(1.0 / (16.0 * PI))
    At_nr = jnp.where(ok_at, At_nr, 0.0)

    # ---- assembly: |U|^2/(2 mn) reduction in f32, f64 prefactors ----
    w_e = f(Wf[:, None] / (2.0 * mn_c))
    G_nr = jnp.sum(w_e * G_nr, axis=0)
    At_nr = jnp.sum(w_e * At_nr, axis=0)
    g64 = jnp.asarray(g, jnp.float64)
    g4 = (g64 * g64) * (g64 * g64)
    tblG = pref_G * tblG_s.astype(jnp.float64) + g4 * G_nr.astype(jnp.float64)
    tblAt = (pref_At * tblAt_s.astype(jnp.float64)
             + g4 * At_nr.astype(jnp.float64))
    return tblG, tblAt
