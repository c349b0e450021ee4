"""Self-interaction kernel tables: absorption Gamma, same-bin regeneration
alphaTilde, and bin-to-bin regeneration alpha.

The reference computes these as ~(NE+Nz)^2/2 scalar calls into ~800 lines
of closed-form channel integrals (nuSIprop.hpp:759-1520). Here each channel
is an elementwise float64 JAX expression evaluated over whole bin-edge
arrays at once: the absorption/same-bin tables are (3, NEXT) evaluations
and the bin-to-bin table is a (3, NEXT, NEXT) evaluation, all fused by XLA
into a single device program — this precompute is the dominant cost of an
evolve() and is embarrassingly parallel, which is exactly what a vector
machine wants.

Channel inventory (per eigenstate, cf. reference lines):
  s                 — resonant Breit-Wigner           (:779-791, :956-970, :1264-1275)
  t + u             — non-resonant                    (:796-816, :975-1069, :1280-1367)
  t-u interference  —                                 (:818-840, :1071-1132, :1369-1425)
  s-t interference  — needs complex dilogarithms      (:842-872, :1134-1186, :1427-1467)
  s-u interference  — = s-t for Majorana, else 0      (:874-878, :1188-1192, :1469-1474)
  phi-phi           — double scalar production        (:880-907, :1194-1213, :1476-1503)

Every closed form carries the reference's Taylor-expansion guards and its
"negative => 3-point Gauss-Legendre rescue" fallbacks, expressed as
compute-both + jnp.where.

Conventions: all dimensionless integration limits are in units of mphi^2,
  splus/sminus   = +2 mn E / mphi^2 (absorption; source bins of alpha)
  tplus/tminus   = -2 mn E / mphi^2 (regeneration target bins)

RANGE SAFETY: every grouping stays inside float32's exponent range
(~1e+/-38), which the f32 paths (and any f64 emulated as float32 pairs)
carry. The reference's literal factor groupings overflow it
(g^4 alone underflows for g < 1e-9; mphi^4/(2 mn) reaches 1e50 for a
floored massless eigenstate). Each channel here therefore returns the
reference value PRE-MULTIPLIED by mphi^2 (Gamma) or mphi^4 (alpha,
alphaTilde) — cancelling those powers symbolically against the channel's
own 1/mphi^k — and prefactors are evaluated in the order
(g^2 / denom) * g^2 so no intermediate leaves the safe range. The table
builders then apply only |U|^2 / (2 mn).
"""

import math

import jax.numpy as jnp
from jax import lax

from nusiprop_tpu.ops import specfun as sf
from nusiprop_tpu.ops.quadrature import GL3_W, GL3_X

PI = math.pi

# Pair-chunk size for the spline-backed pp alpha build (see alpha_table):
# one chunk body is what the compiler sees, so this bounds compiler
# memory; runtime cost is unchanged (elementwise work, same total).
_PP_CHUNK = 8192

# phi-phi alpha build strategy: "grid" evaluates the 3-D spline
# separably over the (state, source-bin) x separation tensor grid that
# the log-uniform energy grid induces (alpha_pp_grid — two small
# matmuls instead of a 64-point gather stencil per pair; the engine's
# path); "pairs" is the general per-query oracle
# (alpha_pp_val per pair). Tests flip this to cross-validate.
_PP_BUILD = "grid"


def scalar_width(g, mphi, majorana: bool):
    """Scalar decay width (nuSIprop.hpp:748-757)."""
    if majorana:
        return g * g * mphi / (16.0 * PI)
    return g * g * mphi / (8.0 * PI)


def _shift_near_minus1(t):
    """Avoid exact division by zero at t == -1 (nuSIprop.hpp:949-954)."""
    return jnp.where(jnp.abs(t + 1.0) < 1e-7, t + t * 1e-6, t)


# ---------------------------------------------------------------------------
# s-channel (resonant) closed forms
# ---------------------------------------------------------------------------

def gamma_s(sm, sp, g, mphi, ga):
    """s-channel absorption integral over one bin (nuSIprop.hpp:779-791).

    Returns mphi^2 * Gamma_s, without the |U|^2 weight and the 1/(2 mn)
    prefactor (see RANGE SAFETY above).
    """
    gr = ga / mphi
    pref = (g * g) / (32.0 * PI * ga) * (g * g)
    logterm = sf.log1p_safe(
        mphi * mphi / (mphi * mphi + ga * ga) * sp * (sp - 2.0)
    ) - sf.log1p_safe(mphi * mphi / (mphi * mphi + ga * ga) * sm * (sm - 2.0))
    d = sp - sm
    taylor = 2.0 * mphi * (
        gr * (1.0 + gr * gr + 2.0 * sm) / (1.0 + gr * gr) ** 2 * d
        + gr / (1.0 + gr * gr) ** 2 * d * d
    )
    exact = 2.0 * mphi * sf.atandiff(mphi * (sp - 1.0) / ga, mphi * (sm - 1.0) / ga)
    core = jnp.where(sp < 1e-5, taylor, exact)
    return pref * (core + ga * logterm)


def alphatilde_s(tm, tp, g, mphi, ga):
    """s-channel same-bin regeneration, times mphi^4 (nuSIprop.hpp:956-965)."""
    gr = ga / mphi
    pref = (g * g) / (16.0 * PI * ga) * (g * g)
    logterm = sf.log1p_safe(
        mphi * mphi / (mphi * mphi + ga * ga) * tp * (tp + 2.0)
    ) - sf.log1p_safe(mphi * mphi / (mphi * mphi + ga * ga) * tm * (tm + 2.0))
    d = tp - tm
    taylor = (
        2.0
        * mphi
        * (1.0 + tm)
        * (
            -(gr * (1.0 + gr * gr - 2.0 * tm) * d) / (1.0 + gr * gr) ** 2
            + gr * d * d / (1.0 + gr * gr) ** 2
        )
    )
    exact = (
        2.0
        * mphi
        * (1.0 + tm)
        * sf.atandiff(mphi * (1.0 + tm) / ga, mphi * (1.0 + tp) / ga)
    )
    core = jnp.where(jnp.abs(tp) < 1e-5, taylor, exact)
    return pref * (core + ga * logterm)


def alpha_s(tm, tp, smp, spp, g, mphi, ga):
    """s-channel bin-to-bin regeneration (nuSIprop.hpp:1264-1269).

    Separable: (tm - tp) from the target bin times a resonance factor of
    the source bin — the basis of the reference's alpha_cum fast path.
    Returns mphi^4 * alpha_s.
    """
    gr = ga / mphi
    pref = (g * g) / (8.0 * PI * ga) * (g * g) * mphi
    d = spp - smp
    taylor = (
        gr * (1.0 + gr * gr + 2.0 * smp) / (1.0 + gr * gr) ** 2 * d
        + gr / (1.0 + gr * gr) ** 2 * d * d
    )
    exact = sf.atandiff(mphi * (spp - 1.0) / ga, mphi * (smp - 1.0) / ga)
    return pref * (tm - tp) * jnp.where(spp < 1e-5, taylor, exact)


# ---------------------------------------------------------------------------
# Table builders
# ---------------------------------------------------------------------------

def gamma_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant, phiphi,
                pp_tables=None, channel="all", width_factor=None):
    """Absorption table: sum_j int_Em^Ep sigma_j dE / |U_f i|^2.

    Em/Ep: (N,) extended bin edges; mn: (3,); Wf: (3,) = |U[flav]|^2.
    Returns (N,). ``channel`` restricts to one contribution ("s" or a
    kernels_nr channel name) so the staged builder can compile each as a
    separate XLA program.
    """
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:  # general couplings: width ~ sum(Q)
        ga = ga * width_factor
    mn_c = mn[:, None]
    sp = 2.0 * mn_c * Ep[None, :] / (mphi * mphi)
    sm = 2.0 * mn_c * Em[None, :] / (mphi * mphi)

    if channel in ("all", "s"):
        tot = gamma_s(sm, sp, g, mphi, ga)
    else:
        tot = jnp.zeros_like(sm)
    if non_resonant and channel != "s":
        from nusiprop_tpu.models import kernels_nr

        tot = tot + kernels_nr.gamma_nonresonant(
            sm, sp, g, mphi, ga, majorana=majorana, phiphi=phiphi,
            pp_tables=pp_tables, channel=channel,
        )
    # channels return mphi^2 * Gamma_ch, so only |U|^2/(2 mn_j) remains
    if Wf is None:  # per-bath-eigenstate table for non-diagonal couplings
        return tot / (2.0 * mn_c)
    return jnp.sum(Wf[:, None] / (2.0 * mn_c) * tot, axis=0)


def alphatilde_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant,
                     phiphi, pp_tables=None, channel="all", width_factor=None):
    """Same-bin regeneration table (N,)."""
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:  # general couplings: width ~ sum(Q)
        ga = ga * width_factor
    mn_c = mn[:, None]
    tp = -2.0 * mn_c * Ep[None, :] / (mphi * mphi)
    tm = -2.0 * mn_c * Em[None, :] / (mphi * mphi)
    tm = _shift_near_minus1(tm)
    tp = _shift_near_minus1(tp)

    if channel in ("all", "s"):
        tot = alphatilde_s(tm, tp, g, mphi, ga)
        if not majorana:
            tot = tot / 2.0  # one of the final Dirac neutrinos is sterile
    else:
        tot = jnp.zeros_like(tm)
    if non_resonant and channel != "s":
        from nusiprop_tpu.models import kernels_nr

        tot = tot + kernels_nr.alphatilde_nonresonant(
            tm, tp, g, mphi, ga, majorana=majorana, phiphi=phiphi,
            pp_tables=pp_tables, channel=channel,
        )
    if Wf is None:
        return tot / (2.0 * mn_c)
    return jnp.sum(Wf[:, None] / (2.0 * mn_c) * tot, axis=0)


def _pairs_chunked(fn, tm, tp, smp, spp):
    """Evaluate ``fn(tm, tp, smp, spp)`` over flattened (3, NT) pair
    coordinates, ``lax.map``'d over fixed ``_PP_CHUNK``-pair blocks when
    NT is large.

    The spline-backed pp program over all N(N-1)/2 pairs fuses a
    64-point 3-D gather stencil with the three Taylor-tail branches; at
    production bin counts that single fused graph is a very large
    compile. lax.map over fixed-size pair chunks compiles ONE chunk body
    and bounds compiler memory;
    elementwise => bitwise-identical (up to fusion-dependent last-ulp
    rounding, see tests/test_staged_tables.py)."""
    NT = tm.shape[-1]
    if NT <= _PP_CHUNK:
        return fn(tm, tp, smp, spp)
    pad = (-NT) % _PP_CHUNK
    K = (NT + pad) // _PP_CHUNK

    def _chunk(c):
        return fn(c[0], c[1], c[2], c[3])

    coords = jnp.stack([
        jnp.pad(a, ((0, 0), (0, pad)), mode="edge")
        .reshape(3, K, _PP_CHUNK).swapaxes(0, 1)
        for a in (tm, tp, smp, spp)], axis=1)      # (K, 4, 3, C)
    tot = lax.map(_chunk, coords)                  # (K, 3, C)
    return tot.swapaxes(0, 1).reshape(3, K * _PP_CHUNK)[:, :NT]


def alpha_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant, phiphi,
                pp_tables=None, channel="all", width_factor=None):
    """Bin-to-bin regeneration table (N, N): rows = target bin, cols =
    source bin, strictly-upper-triangular (source above target), zero
    elsewhere — the march's masked contraction relies on those zeros.
    """
    import numpy as _np

    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:  # general couplings: width ~ sum(Q)
        ga = ga * width_factor
    N = Em.shape[0]
    mn_c = mn[:, None]
    if channel == "pp" and _PP_BUILD == "grid":
        # Separable spline build (alpha_pp_grid docstring); the g^4
        # grouping matches kernels_nr.alpha_pp exactly.
        tot3 = alpha_pp_grid(Em, Ep, mn, mphi, majorana=majorana,
                             pp_tables=pp_tables)          # (3, N, N)
        tot3 = ((g * g) * (g * g)) * tot3
        tot3 = tot3 / (2.0 * mn_c[..., None])
        if Wf is None:
            return tot3
        return jnp.sum(Wf[:, None, None] * tot3, axis=0)
    # Only the strict upper triangle (source bin above target bin) is
    # physical — evaluate the transcendental-heavy channels on the
    # flattened N(N-1)/2 pairs and scatter, HALVING the dominant cost of
    # a non-resonant evolve. Indices are static (shapes fix them).
    rows, cols = _np.triu_indices(N, k=1)
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    # target-bin limits from rows, source-bin limits from cols: (3, NT)
    tp = -2.0 * mn_c * Ep[rows][None, :] / (mphi * mphi)
    tm = -2.0 * mn_c * Em[rows][None, :] / (mphi * mphi)
    tm = _shift_near_minus1(tm)
    tp = _shift_near_minus1(tp)
    spp = 2.0 * mn_c * Ep[cols][None, :] / (mphi * mphi)
    smp = 2.0 * mn_c * Em[cols][None, :] / (mphi * mphi)

    def _tot(tm, tp, smp, spp):
        if channel in ("all", "s"):
            tot = alpha_s(tm, tp, smp, spp, g, mphi, ga)
            if not majorana:
                tot = tot / 2.0
        else:
            tot = jnp.zeros_like(tm)
        if non_resonant and channel != "s":
            from nusiprop_tpu.models import kernels_nr

            tot = tot + kernels_nr.alpha_nonresonant(
                tm, tp, smp, spp, g, mphi, ga, majorana=majorana,
                phiphi=phiphi, pp_tables=pp_tables, channel=channel,
            )
        return tot

    if channel == "pp":
        tot = _pairs_chunked(_tot, tm, tp, smp, spp)
    else:
        tot = _tot(tm, tp, smp, spp)
    tot = tot / (2.0 * mn_c)
    if Wf is None:
        out = jnp.zeros((3, N, N), dtype=tot.dtype)
        return out.at[:, rows, cols].set(tot)
    res = jnp.sum(Wf[:, None] * tot, axis=0)  # (NT,)
    out = jnp.zeros((N, N), dtype=res.dtype)
    return out.at[rows, cols].set(res)


def alpha_pp_grid(Em, Ep, mn, mphi, *, majorana, pp_tables):
    """Normalized phi-phi bin-to-bin channel as a dense (3, N, N)
    strict-upper table (rows = target bin, cols = source bin), WITHOUT
    the g^4 coupling and the 1/(2 mn) weighting — built SEPARABLY.

    The per-pair path (alpha_pp_norm) evaluates a 64-point 3-D spline
    stencil per (target, source) pair: ~N^2/2 x 3 states x batch
    gather-stencils, the dominant op count of a phi-phi evolve. But on
    the engine's log-uniform grids the reference's lookup coordinates
    (nuSIprop.hpp:1483) collapse onto a separable tensor grid:

      * axis 2, log10(delta): delta = Ep'/Em' is the bin-edge ratio —
        ONE value for the whole table (the z-grid coupling trick,
        nuSIprop.hpp:124, requires exactly this log-uniformity);
      * axis 1, n = log(sminus'/|tminus|)/log(delta) * 1.0001: since
        Em[col]/Em[row] = delta^(col-row), n = (col-row) * 1.0001 —
        it depends only on the bin SEPARATION d = 1..N-1;
      * axis 0, sminus' = 2 mn Em[col]/mphi^2: per (state, col).

    So the whole spline table evaluates axis by axis: contract axis 2
    once (4 planes), fold axis 1 into a dense (n1, N-1) matrix with one
    one-hot matmul, fold axis 0 with a second one-hot matmul per
    (state, col) — all matmul work in the table-values dtype — and shear
    the (state, col, separation) result onto (state, row, col) with a
    single O(N^2) gather. The analytic large-s tails
    (kernels_nr.alpha_pp_tail) stay elementwise f64, selected per
    column exactly as alpha_pp_val selects them.

    Fidelity note vs the per-pair path: alpha_pp_val floors |tminus| at
    1e-8 (and applies the near -1 shift) inside its n coordinate, which
    perturbs n for at most the one row per (state, batch point) whose
    |tminus| straddles the floor; the reference itself uses the raw
    coordinates (where n IS d * 1.0001 on its grids,
    xsec/tables_phiphi.py:43-50), so the separable path is the MORE
    faithful one there. Everything else (clamps, edge snapping, |.| on
    the spline value, the s > 4 threshold, the tail regimes, the
    Majorana/Dirac multiplicity) matches per-pair semantics exactly;
    tests/test_pp_grid.py gates grid-vs-pairs at table and flux level.
    """
    from nusiprop_tpu.models import kernels_nr
    from nusiprop_tpu.models.kernels_nr import (_COORD_FLOOR, _floor_s,
                                                _floor_t)

    spl = None if pp_tables is None else pp_tables.alpha
    dt = jnp.float64 if spl is None else spl.values.dtype
    N = Em.shape[0]
    mn_c = mn[:, None]
    smp = 2.0 * mn_c * Em[None, :] / (mphi * mphi)     # (3, N) source
    spp = 2.0 * mn_c * Ep[None, :] / (mphi * mphi)
    tm = _shift_near_minus1(-2.0 * mn_c * Em[None, :] / (mphi * mphi))
    tp = _shift_near_minus1(-2.0 * mn_c * Ep[None, :] / (mphi * mphi))

    idx = jnp.arange(N)
    dmat = idx[None, :] - idx[:, None]                 # (N, N)
    smp_s = jnp.maximum(_floor_s(smp), 4.0 + 1e-12)    # (3, N)
    if spl is None:
        # tables absent: analytic tails everywhere, like alpha_pp_val
        interp_rc = None
        col_spline = jnp.zeros((3, 1, N), dtype=bool)
    else:
        interp_rc, col_spline = _pp_spline_grid(spl, Em, Ep, smp_s, N, dt)

    # ---- analytic tails: rank-5 bilinear matmul contraction ----
    # Broadcasting the elementwise-f64 closed forms over dense
    # (3, N, N) would materialize ~0.5 GB pair intermediates per buffer
    # at batch 64 and 500 bins. The tails factor exactly as row x col bilinear forms; the bases carry every
    # cancellation in f64 and the (3, N, 5) x (3, 5, N) contraction
    # runs in the table dtype (kernels_nr.alpha_pp_tail_bases;
    # f32-vs-elementwise-f64 pinned at round-off by tests/test_pp_grid).
    tm_f = _floor_t(tm)                                # (3, N) target rows
    tp_f = _floor_t(tp)
    spp_s = jnp.maximum(_floor_s(spp), smp_s * (1.0 + 1e-12))
    F_t, H_t = kernels_nr.alpha_pp_tail_bases(tm_f, tp_f, smp_s, spp_s)
    tail = jnp.einsum("srk,skc->src", F_t.astype(dt), H_t.astype(dt),
                      precision=lax.Precision.HIGHEST)

    val = tail if interp_rc is None else jnp.where(col_spline, interp_rc,
                                                   tail)
    ok = ((-tp >= _COORD_FLOOR)[:, :, None]
          & (spp >= _COORD_FLOOR)[:, None, :]
          & (smp > 4.0)[:, None, :]
          & (dmat >= 1)[None, :, :])
    mult = jnp.asarray(8.0 if majorana else 2.0, dt)
    return jnp.where(ok, mult * val, jnp.zeros((), dt))


def _pp_spline_grid(spl, Em, Ep, smp_s, N, dt):
    """Separable 3-D spline evaluation for alpha_pp_grid: returns
    (interp values sheared to (3, row, col), per-column spline-regime
    mask)."""
    # axis 2: one log10(delta) for the whole log-uniform grid
    l10d = jnp.log10(Ep[0] / Em[0])
    k3, p3 = spl.axis_index_weights(2, l10d)           # scalar, (4,)
    n1, n2, n3 = spl.values.shape
    # eval clamps base+3 to n3-1 against a zero 4th weight at the right
    # edge (interp.axis_index_weights docstring); a dynamic_slice can't
    # overhang, so shift the slice start back instead and realign the
    # weights — the dropped overhanging weight is exactly the zero one.
    start = jnp.minimum(k3, n3 - 4)
    o3 = k3 - start                                    # 0 or 1
    V2 = lax.dynamic_slice_in_dim(spl.values, start, 4, axis=2)
    p3s = jnp.zeros(5, dtype=p3.dtype).at[o3 + jnp.arange(4)].set(p3)[:4]
    V2 = jnp.tensordot(V2, p3s.astype(dt), axes=([2], [0]),
                       precision=lax.Precision.HIGHEST)  # (n1, n2)

    # axis 1: n = d * 1.0001 for separations d = 1..N-1, emitted in
    # REVERSED column order (j = N-1-d) with a zero column at j = N-1
    # (d = 0): the matmul below then directly produces the row-reversed
    # layout the gather-free skew needs.
    d = jnp.arange(N - 1, 0, -1, dtype=jnp.float64)
    k2, p2 = spl.axis_index_weights(1, d * 1.0001)     # (N-1,), (4, N-1)
    iota2 = jnp.arange(n2, dtype=jnp.int32)[:, None]
    W2 = jnp.zeros((n2, N), dtype=dt)
    for o in range(4):
        W2 = W2.at[:, :N - 1].add(
            jnp.where(iota2 == (k2 + o)[None, :],
                      p2[o].astype(dt)[None, :], 0.0))
    M = jnp.dot(V2, W2, precision=lax.Precision.HIGHEST)  # (n1, N)

    # axis 0: sminus' per (state, col), same clamp as alpha_pp_val
    k1, p1 = spl.axis_index_weights(0, smp_s)          # (3, N), (4, 3, N)
    iota1 = jnp.arange(n1, dtype=jnp.int32)
    W1 = jnp.zeros((3, N, n1), dtype=dt)
    for o in range(4):
        W1 = W1 + jnp.where(iota1[None, None, :] == (k1 + o)[..., None],
                            p1[o].astype(dt)[..., None], 0.0)
    R = jnp.dot(W1.reshape(3 * N, n1), M,
                precision=lax.Precision.HIGHEST).reshape(3, N, N)
    R = jnp.abs(R)  # |.| on the spline value (nuSIprop.hpp:1483)
    # R[s, c, j] = |spline|(state s, source col c, separation d = N-1-j)

    # skew (state, col, N-1-d) -> (state, row, col) with d = col - row,
    # via pad + reshape only (a 2-index gather here measured ~24 ms of
    # the ~40 ms device cost of this builder at batch 32; the skew is
    # pure data movement XLA lowers to copies):
    #   Out_T[c, r] = R[c, N-1-(c-r)] = flat(pad(R))[c*2N + (N-1) + r-c]
    B = jnp.concatenate([R, jnp.zeros((3, N, N), dtype=dt)], axis=2)
    flat = B.reshape(3, 2 * N * N)
    C = lax.slice_in_dim(flat, N - 1, N - 1 + N * (2 * N - 1), axis=1)
    out_T = C.reshape(3, N, 2 * N - 1)[:, :, :N]       # [state, col, row]
    interp_rc = jnp.swapaxes(out_T, 1, 2)              # [state, row, col]
    col_spline = (smp_s < 1e4)[:, None, :]
    return interp_rc, col_spline


def pp_extrapolation_counts(Em, Ep, mn, mphi, *, pp_tables):
    """Count phi-phi spline evaluations the reference would exit(1) on.

    The reference's interpolator hard-exits when a lookup coordinate
    leaves the table (interp.hpp:354-361); this engine clamps instead
    (documented deviation, MIGRATION.md). ``Config(extrapolation=
    "raise")`` surfaces the difference: this function re-derives the
    exact coordinate grids the phi-phi table builds evaluate —
    alpha_pp_grid's separable (sminus', n, log10 delta) axes
    (nuSIprop.hpp:1483) and alphatilde_pp's (-tplus, log10 delta)
    (nuSIprop.hpp:1199) — and counts the branch-active,
    kinematically-open entries that fall outside the tables. Clamped
    coordinates on inactive entries (tail branch, closed kinematics)
    are NOT extrapolations: the reference never evaluates those either.

    Returns ``(count_alpha, count_alphatilde)`` as on-device scalars.
    The dominant real-world trigger is the log10(delta) axis: the
    shipped tables cover bin ratios delta in [0.005, 0.05] decades, so
    e.g. a 50-bin run over 5 decades (delta = 0.1) would silently clamp
    EVERY pp lookup under the default policy.
    """
    from nusiprop_tpu.models.kernels_nr import _COORD_FLOOR, _floor_s

    N = Em.shape[0]
    mn_c = mn[:, None]
    inv_m2 = 1.0 / (mphi * mphi)
    smp = 2.0 * mn_c * Em[None, :] * inv_m2
    spp = 2.0 * mn_c * Ep[None, :] * inv_m2
    tm = _shift_near_minus1(-smp)
    tp = _shift_near_minus1(-spp)
    l10d = jnp.log10(Ep[0] / Em[0])

    # ---- 3-D alpha spline (alpha_pp_grid coordinates) ----
    idx = jnp.arange(N)
    dmat = (idx[None, :] - idx[:, None]).astype(jnp.float64)
    smp_s = jnp.maximum(_floor_s(smp), 4.0 + 1e-12)
    active = ((-tp >= _COORD_FLOOR)[:, :, None]
              & (spp >= _COORD_FLOOR)[:, None, :]
              & (smp > 4.0)[:, None, :]
              & (dmat >= 1)[None, :, :]
              & (smp_s < 1e4)[:, None, :])       # spline (not tail) branch
    oob_a = pp_tables.alpha.out_of_bounds(
        smp_s[:, None, :], (dmat * 1.0001)[None, :, :],
        jnp.full((1, 1, 1), l10d))
    count_alpha = jnp.sum(active & oob_a)

    # ---- 2-D alphatilde spline (alphatilde_pp coordinates) ----
    mtp = jnp.maximum(-tp, 4.0 + 1e-12)
    active_at = (-tp > 4.0) & (-tp < 1e4) & (-tp >= _COORD_FLOOR)
    oob_at = pp_tables.alphatilde.out_of_bounds(mtp, jnp.log10(tp / tm))
    count_at = jnp.sum(active_at & oob_at)
    return count_alpha, count_at


def alpha_pp_table_norm(Em, Ep, mn, mphi, Wf, *, majorana, pp_tables):
    """NORMALIZED phi-phi alpha channel table: alpha_table(channel="pp")
    WITHOUT the g^4 coupling prefactor, in the spline-values dtype.

    For the float32 march's normalized-table fold (pref = g^4,
    kernels_nr_f32.alpha_table_f32 raw=True): folding the pp channel as
    (g^4 * val) / g^4 would materialize weak-coupling intermediates
    (~1e-60) below float32's exponent range;
    here g^4 never touches the values. With f32-cast tables
    (ops/interp.SplineND.astype) the 64-point 3-D stencil contraction —
    the pp channel's dominant op count — runs in f32
    (kernels_nr.alpha_pp_val), which is also what makes the program
    small enough to compile and run at production bin counts x batch.
    """
    import numpy as _np

    from nusiprop_tpu.models import kernels_nr

    N = Em.shape[0]
    mn_c = mn[:, None]
    if _PP_BUILD == "grid":
        tot3 = alpha_pp_grid(Em, Ep, mn, mphi, majorana=majorana,
                             pp_tables=pp_tables)          # (3, N, N)
        if Wf is None:  # per-state (3, N, N) for general couplings
            return jnp.asarray(1.0 / (2.0 * mn_c[..., None]),
                               tot3.dtype) * tot3
        w_e = jnp.asarray(Wf[:, None, None] / (2.0 * mn_c[..., None]),
                          tot3.dtype)
        return jnp.sum(w_e * tot3, axis=0)                 # (N, N)
    rows, cols = _np.triu_indices(N, k=1)
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    tp = _shift_near_minus1(-2.0 * mn_c * Ep[rows][None, :] / (mphi * mphi))
    tm = _shift_near_minus1(-2.0 * mn_c * Em[rows][None, :] / (mphi * mphi))
    spp = 2.0 * mn_c * Ep[cols][None, :] / (mphi * mphi)
    smp = 2.0 * mn_c * Em[cols][None, :] / (mphi * mphi)

    def _fn(tm, tp, smp, spp):
        return kernels_nr.alpha_pp_norm(
            tm, tp, smp, spp, majorana=majorana, pp_tables=pp_tables)

    tot = _pairs_chunked(_fn, tm, tp, smp, spp)       # (3, NT)
    if Wf is None:  # per-state (3, N, N) for general couplings
        res = jnp.asarray(1.0 / (2.0 * mn_c), tot.dtype) * tot
        out = jnp.zeros((3, N, N), dtype=res.dtype)
        return out.at[:, rows, cols].set(res)
    w_e = jnp.asarray(Wf[:, None] / (2.0 * mn_c), tot.dtype)
    res = jnp.sum(w_e * tot, axis=0)                  # (NT,)
    out = jnp.zeros((N, N), dtype=res.dtype)
    return out.at[rows, cols].set(res)


def alpha_s_rho(Em, Ep, mn, g, mphi, Wf, *, majorana, width_factor=None,
                scaled=False):
    """Source-side factor of the (exactly rank-one) s-channel alpha table.

    alpha_s (nuSIprop.hpp:1264-1269) factorizes as (tm - tp)_target x
    R(source); under the table builder's |U|^2/(2 mn) eigenstate sum the
    mn-dependence of the target factor cancels, so the s-channel-only
    alpha table is exactly

        alpha_table[j, m] = (Ep[j] - Em[j]) * rho[m]      (j < m).

    This is the factorized form of the reference's ``alpha_cum`` O(N)
    fast path (nuSIprop.hpp:261-264, 273-278). rho is recovered from the
    same-bin diagonal evaluation divided by the bin width — exactly how
    the reference's accumulator uses alpha_jj — which keeps the
    near-resonance shift (nuSIprop.hpp:949-954) semantics identical.

    ``scaled=True`` returns rho * 2^100 (exact power of two): the raw
    values sit at ~1e-37 and below — for weak couplings the WHOLE table
    drops under the f32 exponent floor and would flush in storage
    wherever float32's range applies, before any consumer-side rescale can
    act. The transport marches consume the scaled form and pair the
    compensating 2^-100 with the (tiny) accumulation weights.

    Returns (N,) for (N,) bin-edge arrays.
    """
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:  # general couplings: width ~ sum(Q)
        ga = ga * width_factor
    mn_c = mn[:, None]
    tp = -2.0 * mn_c * Ep[None, :] / (mphi * mphi)
    tm = -2.0 * mn_c * Em[None, :] / (mphi * mphi)
    tm = _shift_near_minus1(tm)
    tp = _shift_near_minus1(tp)
    spp = 2.0 * mn_c * Ep[None, :] / (mphi * mphi)
    smp = 2.0 * mn_c * Em[None, :] / (mphi * mphi)
    diag = alpha_s(tm, tp, smp, spp, g, mphi, ga)
    if not majorana:
        diag = diag / 2.0
    if scaled:
        diag = diag * 2.0**100  # exact; lifts storage above the window
    diag = jnp.sum(Wf[:, None] / (2.0 * mn_c) * diag, axis=0)
    return diag / (Ep - Em)
