"""The transport engine: implicit redshift march of the binned flux.

Reference algorithm (nuSIprop.hpp:176-337, Details.pdf p.2): starting from
zero flux at z = zmax, march down in redshift; at each node solve, per
energy bin and mass eigenstate, the implicit-in-z linear system

    M x = Znr / Zdr,   x = flux at the new node

where absorption (Gamma) sits in the denominator Zdr, same-bin
regeneration (alphaTilde) couples the three eigenstates through a 3x3
matrix, and bin-to-bin regeneration (alpha) feeds lower bins from all
higher bins updated earlier in the same sweep (a block back-substitution
in descending energy).

Structure:
  * kernel tables are built ONCE on the extended bin axis (grids.py) as
    fused vectorized programs (kernels.py);
  * per z-node, the window of the extended tables relevant at that
    redshift is a `lax.dynamic_slice` — the grid-coupling trick makes the
    window contiguous;
  * the redshift march is a `lax.scan` over z-nodes;
  * the descending-energy sweep inside a z-node is NOT a sequential loop
    (a 500-step scalar-recurrence chain is pure latency on an
    accelerator).
    Because the per-bin update  x_j = V_j + reg_j * U_j  is affine in the
    scalar regeneration feed  reg_j = sum_{m>j} K[j,m] * (Wf . x_m),
    the whole sweep closes into:
      - s-channel-only ("rank1"): K is exactly rank one, so reg follows a
        scalar affine recurrence solved in log depth with
        `lax.associative_scan` — the parallel form of alpha_cum;
      - general kernels ("trisolve"): y_j = Wf . x_j satisfies one scalar
        strictly-triangular NE x NE linear system per z-node, solved with
        a blocked triangular solve (matrix work instead of a scan chain);
  * everything is a pure function of a PhysicsParams pytree, so parameter
    grids batch with vmap and shard with pjit (parallel/scan.py).
"""

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models import grids, kernels, masses, mixing, sources


# Exact power-of-two rescaling of the regeneration accumulation weight
# (see z_step_rank1): c * 2^100 always pairs with d * 2^-100.
_RSCALE = 2.0 ** 100
_INV_RSCALE = 2.0 ** -100


class EvolveResult(NamedTuple):
    flux: jnp.ndarray      # (3, NE) differential flux, mass basis
    flux_fla: jnp.ndarray  # (3, NE) differential flux, flavor basis (e, mu, tau)
    E_nu: jnp.ndarray      # (NE,) bin centers [eV]
    Emin: jnp.ndarray      # (NE,)
    Emax: jnp.ndarray      # (NE,)
    z: jnp.ndarray         # (Nz,)
    mn: jnp.ndarray        # (3,) mass eigenvalues [eV]
    # (worst_rel_neg, nonfinite_count, tau): default-on cheap health
    # signal from the already-built kernel tables (_table_health) — the
    # always-on spirit of the reference's negative-cross-section
    # screams (nuSIprop.hpp:909-918, 1215-1231, 1505-1516) without a
    # second table build. Consumed by api.Evolver.evolve.
    health: jnp.ndarray = None


def _march_tau(gr, tblG, pref_G=1.0):
    """Order-of-magnitude interaction depth of the march: the largest
    per-z-step absorption optical depth any bin can see,
    max_z[pref * ndfac] * max|Gamma| / min(dE) (the Zdr grouping of
    node_common, upper-bounded over nodes and bins).

    This is the free-streaming gate for the health scream: when tau is
    below round-off of 1.0 the interaction cannot move the flux at all,
    so table negativity is guaranteed round-off noise (the reference's
    per-channel checks normalize by the channel scale (g/mphi)^4 for
    the same reason, nuSIprop.hpp:1215-1231 — a weak-coupling table is
    ALLOWED to be noise). ``pref_G`` rescales normalized-table
    conventions (kernels_f32) back to physical units.
    """
    zn = gr.z[1:]
    zfac = jnp.max((1.0 + zn) * gr.dlogz / sources.get_H(zn)
                   * sources.get_nd(zn) / (1.0 + zn) ** 2)
    g_scale = jnp.max(jnp.abs(tblG)).astype(jnp.float64) * pref_G
    return zfac * g_scale / jnp.min(gr.Emax - gr.Emin)


def _table_health(tables, tau):
    """(worst_rel_neg, nonfinite_count, tau) over the final kernel tables.

    worst_rel_neg = min over tables of (table min / table absmax) — a
    dimensionless negativity measure comparable across the normalized
    f32 and prefactored f64 table conventions. The reference tolerates
    per-channel negativity down to -1e-11 * (g/mphi)^4 (its channel
    scale; nuSIprop.hpp:1215-1231 comment) — api.Evolver applies the
    same -1e-11 relative threshold, gated on ``tau`` (_march_tau): in
    the free-streaming regime the tables are pure round-off noise
    around zero (worst_rel_neg -> -1) yet physically irrelevant, so no
    scream. nonfinite_count counts inf/NaN entries, which the
    reference's screams would also surface.
    """
    worst = jnp.asarray(0.0, jnp.float64)
    bad = jnp.asarray(0.0, jnp.float64)
    for t in tables:
        if t is None:
            continue
        # reduce in the table's OWN dtype (casting a batched (NEXT,
        # NEXT) f32 table to f64 first doubles its device-memory
        # traffic); only the reduced scalars are promoted
        finite = jnp.isfinite(t)
        bad = bad + jnp.sum(~finite).astype(jnp.float64)
        t_ok = jnp.where(finite, t, jnp.zeros((), t.dtype))
        scale = jnp.maximum(jnp.max(jnp.abs(t_ok)),
                            jnp.asarray(1e-30, t.dtype))
        worst = jnp.minimum(worst,
                            (jnp.min(t_ok) / scale).astype(jnp.float64))
    return jnp.stack([worst, bad, jnp.asarray(tau, jnp.float64)])


def _inv3(M):
    """Closed-form 3x3 inverse via the adjugate, batched over any leading
    axes (M: (..., 3, 3))."""
    a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b_ * B + c * C
    adj = jnp.stack([
        jnp.stack([A, -(b_ * i - c * h), b_ * f - c * e], axis=-1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
        jnp.stack([C, -(a * h - b_ * g), a * e - b_ * d], axis=-1),
    ], axis=-2)
    return adj / det[..., None, None]


def _solve3(M, b):
    """Closed-form 3x3 linear solve via the adjugate, batched over any
    leading axes (M: (..., 3, 3), b: (..., 3)). Replaces the reference's
    GSL LU at nuSIprop.hpp:308-313; at 3x3 the explicit inverse is exact
    enough and vectorizes perfectly."""
    a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b_ * B + c * C
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = A * b0 - (b_ * i - c * h) * b1 + (b_ * f - c * e) * b2
    x1 = B * b0 + (a * i - c * g) * b1 - (a * f - c * d) * b2
    x2 = C * b0 - (a * h - b_ * g) * b1 + (a * e - b_ * d) * b2
    return jnp.stack([x0, x1, x2], axis=-1) / det[..., None]


def _source_lum(cfg: Config, z_src, Emin, Emax, si, norm_total):
    """Per-bin source integral at redshift z_src (vector over bins);
    dispatches through the source registry (sources.register_source)."""
    return sources.lum(cfg.source, z_src, Emin, Emax, si, norm_total)


def _resolve_march(cfg: Config) -> str:
    """The march a Config runs. Reads the Config alone, never the
    backend: ``auto`` is the float64 ``trisolve`` march for non-resonant
    configs and the float64 ``rank1`` march otherwise; the f32 marches
    run only when asked for by name."""
    if cfg.march == "auto":
        return "trisolve" if cfg.non_resonant else "rank1"
    if cfg.march in ("rank1", "rank1_f32") and cfg.non_resonant:
        raise ValueError(
            f"march={cfg.march!r} is exact only for the s-channel-only "
            "kernel (non_resonant=False); use 'trisolve' or 'auto'"
        )
    return cfg.march


def _node_affine(pref, zdr, coup, lum, flux, Wf):
    """Shared per-z-node affine reduction of the implicit update.

    Solving the 3x3 system M x = (flux_old + pref*(lum + reg*Wf))/zdr
    for every bin at once gives  x_j = V_j + reg_j * U_j  with
      V = M^-1 (flux_old + pref*lum)/zdr     (NE, 3)
      U = M^-1 (pref * Wf)/zdr               (NE, 3)
    M per bin is I + offdiag(coup * Wf Wf^T / zdr) (nuSIprop.hpp:297-304).

    RANGE SAFETY (the groupings stay inside float32's exponent range):
    pref = (1+z) dlogz / H is ~1e31, so U must not pick up any further large
    factor before it meets the (tiny) regeneration feed — callers multiply
    bin widths into reg, never into U.

    Row-scaling the system by zdr exposes the exact structure
    (diag(d) + coup w w^T) x = r with d_k = zdr_k - coup w_k^2, w = Wf:
    a rank-one update of a diagonal, solved by Sherman-Morrison with a
    few (NE, 3) elementwise ops — no (NE, 3, 3) tensors, which both
    slashes device-memory traffic and cuts the op count. The `loop`
    march keeps the adjugate _solve3 as an independent oracle
    (tests/test_march.py pins them together to 1e-11).
    """
    zdr_t = zdr.T  # (NE, 3)
    d = zdr_t - coup[:, None] * (Wf * Wf)[None, :]
    w_d = Wf[None, :] / d
    wu = jnp.sum(Wf[None, :] * w_d, axis=1)
    s = 1.0 + coup * wu
    rv = flux.T + pref * lum[:, None]
    rv_d = rv / d
    wv = jnp.sum(Wf[None, :] * rv_d, axis=1)
    V = rv_d - (coup * wv / s)[:, None] * w_d
    U = pref * w_d / s[:, None]
    return U, V


def _f32_precond_common(cfg: Config, gr, params: PhysicsParams,
                        norm_total, tblG, tblAt, w):
    """Shared prologue of the two float32 row builders
    (_rank1_f32_rows / _trisolve_f32_rows): per-node prefactors, the
    windowed Γ/α̃ table rows on the extended-index ladder, the
    factorized ladder source integrals (with per-node fallback for
    registered custom sources), and the free-streaming preconditioner.
    Every grouping goes through the ``w`` window hook so the range-
    safety pairings are regression-checked once for BOTH marches
    (tests/test_march.py / test_kernels_nr_f32 window emulators).
    """
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z
    inv_dE = 1.0 / (gr.Emax - gr.Emin)
    steps = jnp.arange(Nz - 1, 0, -1)
    zim = gr.z[steps - 1]
    zi = gr.z[steps]
    ndfac_a = w(sources.get_nd(zim) / (1.0 + zim) ** 2)
    pref_a = w((1.0 + zim) * gr.dlogz / sources.get_H(zim))

    idx = (steps - 1)[:, None] + jnp.arange(NE)[None, :]
    G_w = w(tblG[idx] * ndfac_a[:, None])
    At_w = w(tblAt[idx] * ndfac_a[:, None])

    # Source integrals over the edge ladder where the source factorizes
    # (one antiderivative eval per extended edge instead of per
    # (node, bin) — for dsnb the polylog sweep is parameter-independent);
    # registered custom sources fall back to the per-node evaluation.
    kk = jnp.arange(NE + Nz, dtype=jnp.float64)
    edges = 10.0 ** (cfg.lEmin + (cfg.lEmax - cfg.lEmin) * kk / NE)
    lum_a = sources.lum_rows_extended(cfg.source, edges, zi, idx + 1,
                                      params.si, norm_total)
    if lum_a is None:
        lum_a = jax.vmap(
            lambda zz: _source_lum(cfg, zz, gr.Emin, gr.Emax, params.si,
                                   norm_total))(zi)
    lum_a = w(lum_a)

    # free-streaming preconditioner (counts after each node), floored
    src_counts = w(pref_a[:, None] * lum_a)
    S = w(jnp.cumsum(src_counts, axis=0))
    N0 = jnp.max(S)
    S = jnp.maximum(w(S / N0), 1e-15)
    S_old = jnp.concatenate([jnp.zeros((1, NE)), S[:-1]], axis=0)
    N0S = w(N0 * S)
    return (steps, idx, inv_dE, ndfac_a, pref_a, G_w, At_w,
            src_counts, S, S_old, N0, N0S)


def _rank1_f32_rows(cfg: Config, gr, params: PhysicsParams, norm_total,
                    tblG, tblAt, rho_ext, dE_ext, window=None, prefs=None):
    """Per-z-node coefficient rows for the float32 march, plus the
    free-streaming preconditioner scale of the final node.

    Precondition the flux by the free-streaming solution: with
    S(t, j) = cumulative source counts (floored; any positive array is a
    valid preconditioner) and phi = F / (N0 S), every march variable
    becomes an O(1)-ish ratio, so the whole sweep can run in f32 while
    the kernel tables and all coefficient rows here are built in float64
    and only then cast.

    RANGE SAFETY: every grouping keeps its intermediate inside float32's
    exponent range, so the rows survive an f64 emulated as float32 pairs
    (where anything below ~1.2e-38 flushes to zero SILENTLY) as well as
    the final cast. rho*ndfac alone sits at
    1e-40..1e-53 (it killed regeneration before the _RSCALE pairing
    below), and pref*d_w ~ 1e39 would overflow. Every grouping therefore
    pairs a small factor with a large one first. ``window`` is a hook
    applied after each grouping step — identity in production; the test
    suite passes a float32-window flush emulator so these pairings are
    regression-checked at full f64 precision
    (tests/test_march.py::test_f32_rows_survive_narrow_exponent_window).
    """
    w = window if window is not None else (lambda x: x)
    # Normalized f32 tables (kernels_f32) come with f64 scalar
    # prefactors; folding them into the per-node scalars here keeps the
    # small-with-large pairing discipline (1.0 multiplies are exact
    # no-ops for the f64-table path).
    pG, pAt, prho = prefs if prefs is not None else (1.0, 1.0, 1.0)
    f32 = jnp.float32
    (steps, idx, inv_dE, ndfac_a, pref_a, G_w, At_w,
     src_counts, S, S_old, N0, N0S) = _f32_precond_common(
        cfg, gr, params, norm_total, tblG, tblAt, w)
    prefG_a = w(pref_a * pG)
    prefAt_a = w(pref_a * pAt)
    # carry the exact 2^100 scale through the CF grouping; it cancels
    # only after the compensating (N0*S) factor has lifted the magnitude
    rho_w = w(rho_ext[idx] * w(ndfac_a[:, None] * (prho * _RSCALE)))
    d_w = dE_ext[idx]

    rows = dict(
        PG=w(w(prefG_a[:, None] * G_w) * inv_dE[None, :]),
        PAt=w(w(prefAt_a[:, None] * At_w) * inv_dE[None, :]),
        CO=w(w(At_w * inv_dE[None, :]) * pAt),
        R0=w(S_old / S),                             # fs carry ratio
        S0=w(src_counts / N0S),                      # source in phi
        CF=w(w(w(rho_w * inv_dE[None, :]) * N0S) * _INV_RSCALE),  # cum wt
        PD=w(pref_a[:, None] * w(d_w / N0S)),        # reg scale
    )
    xs = tuple(rows[k].astype(f32)
               for k in ("PG", "PAt", "CO", "R0", "S0", "CF", "PD"))
    return xs, w(N0 * S[-1])


def _rank1_f32_scan(xs, Wf, NE: int, unroll: int = 1):
    """The float32 redshift march over precomputed coefficient rows.

    Exactness is by construction (same affine recurrence as rank1); the
    cost is f32 round-off (~1e-5 after 78 steps, vs the 1e-3 physical
    gate) and flushing of flux components below ~1e-38 of the LOCAL
    free-streaming scale. Returns preconditioned flux phi (3, NE) f32.
    """
    f32 = jnp.float32
    Wf32 = Wf.astype(f32)
    Wf232 = Wf32 * Wf32

    def step(phi, xs_i):
        PG, PAt, CO, R0, S0, CF, PD = xs_i
        zdr_t = 1.0 + (PG[:, None] * Wf32[None, :]
                       - PAt[:, None] * Wf232[None, :])  # (NE, 3)
        # The 3x3 implicit system, row-scaled by zdr, is exactly
        #   (diag(d) + c w w^T) x = r,  d_k = zdr_k - c W_k^2, w = W,
        # a rank-one update of a diagonal: Sherman-Morrison solves it
        # with a handful of (NE, 3) elementwise ops and two k-
        # reductions — no (NE, 3, 3) tensors materialize.
        d = zdr_t - CO[:, None] * Wf232[None, :]
        w_d = Wf32[None, :] / d                     # w/d  (NE, 3)
        wu = jnp.sum(Wf32[None, :] * w_d, axis=1)   # w . (w/d)  (NE,)
        s = 1.0 + CO * wu
        rv = phi.T * R0[:, None] + S0[:, None]      # raw numerator
        rv_d = rv / d
        wv = jnp.sum(Wf32[None, :] * rv_d, axis=1)  # w . (rv/d)
        V = rv_d - (CO * wv / s)[:, None] * w_d
        U = w_d / s[:, None]   # SM collapses: (I - c/s w_d w^T) w_d
        # w . x = (w . r/d) / s  exactly under Sherman-Morrison
        a = 1.0 + (CF * PD) * (wu / s)
        b = CF * (wv / s)
        # Closing this recurrence via suffix cumulants instead —
        # cum_j = A_{j+1} sum_{m>j} b_m/A_m with A = exp(log1p(a-1) @
        # tril_ones), two matmuls per z-node — is ~7x noisier (the
        # exp/log round-trip), so the associative scan stays.
        a_r = jnp.flip(a, axis=0)
        b_r = jnp.flip(b, axis=0)

        def compose(lo, hi):
            al, bl = lo
            ah, bh = hi
            return ah * al, ah * bl + bh

        _, B_inc = lax.associative_scan(compose, (a_r, b_r), axis=0)
        cum = jnp.flip(jnp.concatenate(
            [jnp.zeros_like(B_inc[:1]), B_inc[:-1]], axis=0), axis=0)
        x = V + (cum * PD)[:, None] * U
        return x.T, None

    phi0 = jnp.zeros((3, NE), dtype=f32)
    phi, _ = lax.scan(step, phi0, xs, unroll=unroll)
    return phi


def _trisolve_f32_rows(cfg: Config, gr, params: PhysicsParams, norm_total,
                       tblG, tblAt, pref_A, window=None):
    """Per-z-node coefficient rows for the float32 GENERAL-KERNEL
    march (march='trisolve_f32'), plus the preconditioner scale.

    Same free-streaming preconditioning and window discipline as
    _rank1_f32_rows (see its docstring); instead of the rank-one CF/PD
    pair it emits, per node,
      CS[m] = pref_A * ndfac / dE_m * N0*S[m]   (source-column scale)
      PT[j] = pref_z / (N0*S[j])                (target-row scale)
    so the in-scan triangular system is
      T = I - diag(PT * wu/s) (A32win * CS),   A32win the f32 window of
    the NORMALIZED alpha table (kernels_nr_f32 raw=True; pref_A = g^4).
    """
    w = window if window is not None else (lambda x: x)
    f32 = jnp.float32
    (steps, idx, inv_dE, ndfac_a, pref_a, G_w, At_w,
     src_counts, S, S_old, N0, N0S) = _f32_precond_common(
        cfg, gr, params, norm_total, tblG, tblAt, w)

    # RANGE SAFETY groupings: pref_A (g^4, down to ~1e-24) pairs with
    # N0S (large) BEFORE meeting ndfac/dE (small); pref_a (~1e31) meets
    # 1/N0S (small) directly.
    nd_dE = w(ndfac_a[:, None] * inv_dE[None, :])
    rows = dict(
        PG=w(w(pref_a[:, None] * G_w) * inv_dE[None, :]),
        PAt=w(w(pref_a[:, None] * At_w) * inv_dE[None, :]),
        CO=w(At_w * inv_dE[None, :]),
        R0=w(S_old / S),
        S0=w(src_counts / N0S),
        CS=w(w(pref_A * N0S) * nd_dE),
        PT=w(pref_a[:, None] / N0S),
    )
    xs = tuple(rows[k].astype(f32)
               for k in ("PG", "PAt", "CO", "R0", "S0", "CS", "PT"))
    return xs + (steps,), w(N0 * S[-1])


_SOLVE_BS = 128  # diagonal-block size of the nilpotent solver


def _nilpotent_solve(N, q):
    """x = (I - N)^{-1} q for strictly-upper-triangular f32 N.

    XLA's batched ``triangular_solve`` is bound by the latency of its
    length-NE substitution chain. But the march matrix is I minus a
    NILPOTENT non-negative N, so the inverse is the terminating Neumann
    product (I-N)^{-1} = prod_j (I+N^(2^j)) — log-depth matmuls instead
    of a substitution chain.

    Structure: the diagonal _SOLVE_BS blocks are EXPLICITLY inverted all
    at once — one stacked (NB, BS, BS) product-doubling chain, 2 batched
    matmuls per level — and the block back-substitution then runs one
    full-width row-block matvec + one inverse apply per block (~20 ops
    per solve, as (batch*NB, BS, BS) matmuls). Accuracy is unchanged:
    every entry of N is non-negative, so all Neumann sums are
    cancellation-free. Matmuls force Precision.HIGHEST: a reduced-
    precision f32 matmul (bf16 passes, or TF32 on a GPU) costs ~3e-4
    accuracy.
    """
    hi = lax.Precision.HIGHEST
    NE = q.shape[-1]
    BS = min(_SOLVE_BS, NE)
    NB = -(-NE // BS)
    pad = NB * BS - NE
    if pad:
        N = jnp.pad(N, ((0, pad), (0, pad)))
        q = jnp.pad(q, (0, pad))
    NP = NB * BS

    # stacked diagonal blocks (NB, BS, BS): one reshape/transpose + a
    # static diagonal take, not NB dynamic slices
    blocks = N.reshape(NB, BS, NB, BS).transpose(0, 2, 1, 3)
    Nd = blocks[jnp.arange(NB), jnp.arange(NB)]

    # (I - Nd)^{-1} explicitly, via product doubling: after each level
    # B = prod_{j<=J} (I + Nd^(2^j)) with P = Nd^(2^(J+1)); Nd^BS = 0
    # and 2*k_last >= BS covers every power < BS.
    B = jnp.eye(BS, dtype=N.dtype)[None] + Nd
    P = Nd
    k = 1
    while 2 * k < BS:
        P = jnp.einsum("bij,bjk->bik", P, P, precision=hi)
        B = B + jnp.einsum("bij,bjk->bik", P, B, precision=hi)
        k *= 2

    # back-substitution, one full-width row-block matvec per block
    # (columns left of the diagonal block are zero, later blocks of x
    # are already solved, the block's own columns hit x = 0)
    x = jnp.zeros(NP, dtype=N.dtype)
    for b in range(NB - 1, -1, -1):
        lo = b * BS
        r = q[lo:lo + BS] + jnp.einsum(
            "ij,j->i", N[lo:lo + BS, :], x, precision=hi)
        x = x.at[lo:lo + BS].set(
            jnp.einsum("ij,j->i", B[b], r, precision=hi))
    return x[:NE] if pad else x


def _trisolve_f32_scan(xs, A32ext, Wf, NE: int, unroll: int = 1):
    """Float32 general-kernel march: per z-node one f32 triangular
    solve against the windowed normalized alpha table. Returns
    preconditioned flux phi (3, NE)."""
    f32 = jnp.float32
    Wf32 = Wf.astype(f32)
    Wf232 = Wf32 * Wf32

    def step(phi, xs_i):
        PG, PAt, CO, R0, S0, CS, PT, i = xs_i
        zdr_t = 1.0 + (PG[:, None] * Wf32[None, :]
                       - PAt[:, None] * Wf232[None, :])
        d = zdr_t - CO[:, None] * Wf232[None, :]
        w_d = Wf32[None, :] / d
        wu = jnp.sum(Wf32[None, :] * w_d, axis=1)
        s = 1.0 + CO * wu
        rv = phi.T * R0[:, None] + S0[:, None]
        rv_d = rv / d
        wv = jnp.sum(Wf32[None, :] * rv_d, axis=1)
        V = rv_d - (CO * wv / s)[:, None] * w_d
        U = w_d / s[:, None]
        qv = wv / s                       # Wf . V under Sherman-Morrison

        Awin = lax.dynamic_slice(A32ext, (i - 1, i - 1), (NE, NE))
        pu = PT * (wu / s)                # Wf . U, target-scaled
        # K̂ = Awin·diag(CS) is never formed: the system matrix is
        # I - Nmat with Nmat fused elementwise from Awin (row scale pu,
        # col scale CS) — strictly upper, non-negative, nilpotent —
        # solved by the log-depth Neumann-product solver instead of
        # XLA's latency-bound substitution; and K̂@y associates as
        # Awin@(CS·y) (same products and summation order).
        Nmat = pu[:, None] * (CS[None, :] * Awin)
        y = _nilpotent_solve(Nmat, qv)
        reg = PT * jnp.einsum("ij,j->i", Awin, CS * y,
                              precision=lax.Precision.HIGHEST)
        x = V + reg[:, None] * U
        return x.T, None

    phi0 = jnp.zeros((3, NE), dtype=f32)
    phi, _ = lax.scan(step, phi0, xs, unroll=unroll)
    return phi


def _channels(cfg: Config):
    """Channel decomposition used by the staged table builder."""
    if not cfg.non_resonant:
        return ("s",)
    ch = ["s", "t_u", "tu", "st"]
    if cfg.phiphi:
        ch.append("pp")
    return tuple(ch)


def _use_f32_alpha(cfg: Config, allow_f32_march: bool = False) -> bool:
    """Whether the non-resonant alpha table uses the float32
    quadrature build (kernels_nr_f32) instead of the f64 closed forms.

    Only when asked for with table_dtype="f32" (on a non-resonant
    trisolve config; ``allow_f32_march`` admits trisolve_f32 too). The
    quadrature build is MORE accurate than the closed forms at
    sub-resonance pairs, where the f64 antiderivative differences
    cancel to pure round-off noise up to ~1e9x the true value (positive
    noise evades the reference's negative-only rescue; see the
    kernels_nr_f32 docstring and tests/test_kernels_nr_f32.py's scipy
    referee); its GL3 error scales as (bin width)^6, ~3e-6 at 0.05
    decades per bin.
    """
    if not cfg.non_resonant or cfg.table_dtype != "f32":
        return False
    ok_marches = (("trisolve", "trisolve_f32") if allow_f32_march
                  else ("trisolve",))
    return _resolve_march(cfg) in ok_marches


def _pp_f32(pp_tables):
    """phi-phi tables with the 3-D alpha spline values cast to f32: the
    64-point stencil contraction — the dominant op count of the pp
    channel build — then runs in f32 (ops/interp.SplineND.astype; ~1e-7
    relative round-off against the ~1e-3 physics gate). The cheap O(N) 2-D alphatilde spline stays f64.
    """
    if pp_tables is None:
        return None
    return pp_tables._replace(
        alpha=pp_tables.alpha.astype(jnp.float32))


@lru_cache(maxsize=None)
def _pp_norm_builder_jit(cfg: Config, batched: bool):
    """Normalized (g^4-free) f32 pp alpha channel for the trisolve_f32
    table fold (kernels.alpha_pp_table_norm docstring)."""
    def build(params, pp_tables):
        gr = grids.build(cfg)
        Wf = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
        return kernels.alpha_pp_table_norm(
            gr.Emin_ext, gr.Emax_ext, mn, params.mphi, Wf,
            majorana=cfg.majorana, pp_tables=pp_tables)

    if batched:
        build = jax.vmap(build, in_axes=(0, None))
    return jax.jit(build)


@lru_cache(maxsize=None)
def _gt_f32_builder_jit(cfg: Config, batched: bool):
    """Float32 non-resonant Gamma + alphaTilde builder (one XLA
    program for both tables; kernels_nr_f32.nr_gamma_alphatilde_f32)."""
    from nusiprop_tpu.models import kernels_nr_f32

    def build(params):
        gr = grids.build(cfg)
        Wf = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
        return kernels_nr_f32.nr_gamma_alphatilde_f32(
            gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
            majorana=cfg.majorana)

    if batched:
        build = jax.vmap(build)
    return jax.jit(build)


@lru_cache(maxsize=None)
def _alpha_f32_builder_jit(cfg: Config, batched: bool, raw: bool = False,
                           per_state: bool = False):
    from nusiprop_tpu.models import kernels_nr_f32

    def build(params, *wf_arg):
        # width_factor threaded ONLY for per_state (general-coupling)
        # builds, like _channel_builder_jit: keeps the diagonal
        # program's persistent-compile-cache entries stable.
        gr = grids.build(cfg)
        Wf = (None if per_state
              else jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav])
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
        kw = {"width_factor": wf_arg[0]} if per_state else {}
        return kernels_nr_f32.alpha_table_f32(
            gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
            majorana=cfg.majorana, raw=raw, **kw)

    if batched:
        build = jax.vmap(build, in_axes=(0, None) if per_state else (0,))
    return jax.jit(build)


@lru_cache(maxsize=None)
def _channel_builder_jit(cfg: Config, table: str, channel: str,
                         batched: bool, per_state: bool = False):
    fn = {"gamma": kernels.gamma_table,
          "alphatilde": kernels.alphatilde_table,
          "alpha": kernels.alpha_table}[table]

    def build(params, pp_tables, *wf_arg):
        # width_factor is threaded ONLY for per_state (general-coupling)
        # builds: keeping the diagonal program signature free of the
        # extra parameter keeps its persistent-compile-cache entries
        # stable (a signature change invalidates every cached channel).
        gr = grids.build(cfg)
        Wf = (None if per_state
              else jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))[cfg.flav])
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
        kw = {"width_factor": wf_arg[0]} if per_state else {}
        return fn(gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
                  majorana=cfg.majorana, non_resonant=cfg.non_resonant,
                  phiphi=cfg.phiphi, pp_tables=pp_tables, channel=channel,
                  **kw)

    if batched:
        in_axes = (0, None, None) if per_state else (0, None)
        build = jax.vmap(build, in_axes=in_axes)
    return jax.jit(build)


def build_tables(params: PhysicsParams, cfg: Config, pp_tables=None,
                 batched: bool = False, per_state: bool = False,
                 width_factor=1.0):
    """Kernel tables (tblG, tblAt, tblA) built channel-by-channel as
    SEPARATE XLA programs.

    The monolithic non-resonant table graph (7 channels x dilog-heavy
    closed forms) is one very large compile; each per-channel program is
    a modest compile and caches independently in the persistent
    compilation cache. Pure staging — the summed tables
    match the in-graph build to float64 round-off (association of the
    channel sum differs at ~1 ulp).

    per_state=True skips the |U|^2 eigenstate reduction (tables keep the
    leading bath-eigenstate axis) for non-diagonal flavor couplings;
    width_factor scales the scalar width by sum(Q) (evolve_general).
    """
    args = ((jnp.asarray(width_factor, dtype=jnp.float64),) if per_state
            else ())
    # per_state (general couplings) has no f32 march, but the f32
    # quadrature table build still applies whenever the all-f32
    # conditions hold (incl. when auto would resolve to trisolve_f32)
    use_f32_alpha = _use_f32_alpha(cfg, allow_f32_march=per_state)
    use_f32_march = not per_state and _resolve_march(cfg) == "trisolve_f32"
    # Gamma/alphaTilde join the f32 ladder under the same conditions
    # as the alpha table: one small f32 program replaces the staged f64
    # channel programs. Dirac keeps the alphaTilde s-t/s-u interference
    # as a staged f64 program (nr_gamma_alphatilde_f32 docstring);
    # phi-phi channels stay f64.
    use_f32_gt = (not per_state
                  and (use_f32_march
                       or _use_f32_alpha(cfg, allow_f32_march=True)))
    gt32 = None
    out = []
    for table in ("gamma", "alphatilde", "alpha"):
        if table in ("gamma", "alphatilde") and use_f32_gt:
            if gt32 is None:
                gt32 = _gt_f32_builder_jit(cfg, batched)(params)
            acc = gt32[0] if table == "gamma" else gt32[1]
            extra = []
            if table == "alphatilde" and not cfg.majorana:
                extra.append("st")
            if cfg.phiphi:
                extra.append("pp")
            for ch in extra:
                acc = acc + _channel_builder_jit(
                    cfg, table, ch, batched, per_state)(
                        params, pp_tables, *args)
            out.append(acc)
            continue
        if table == "alpha" and use_f32_march:
            # float32 march consumes the NORMALIZED f32 table + pref
            a32, pref = _alpha_f32_builder_jit(cfg, batched, True)(params)
            if cfg.phiphi:
                # g^4-free f32 fold: pref IS g^4, so the pp channel
                # joins normalized — no weak-coupling g^4*val
                # intermediate below float32's exponent range, and
                # the stencil contraction runs in f32 (_pp_f32).
                a32 = a32 + _pp_norm_builder_jit(cfg, batched)(
                    params, _pp_f32(pp_tables))
            out.append((a32, pref))
            continue
        if table == "alpha" and use_f32_alpha:
            # float32 quadrature build covers s+t_u+tu+st in one
            # cheap program; the spline-backed pp channel keeps its f64
            # join but contracts the stencil in f32 (_pp_f32)
            acc = _alpha_f32_builder_jit(cfg, batched,
                                         per_state=per_state)(params, *args)
            if cfg.phiphi:
                acc = acc + _channel_builder_jit(
                    cfg, table, "pp", batched, per_state)(
                        params, _pp_f32(pp_tables), *args)
            out.append(acc)
            continue
        acc = None
        for ch in _channels(cfg):
            t = _channel_builder_jit(cfg, table, ch, batched, per_state)(
                params, pp_tables, *args)
            acc = t if acc is None else acc + t
        out.append(acc)
    return tuple(out)


def evolve_core(params: PhysicsParams, cfg: Config, pp_tables=None,
                tables=None) -> EvolveResult:
    """Pure-function evolve; jit with cfg static (see `evolve`).

    ``tables``: optional precomputed (tblG, tblAt, tblA) from
    build_tables — passed as traced args so the march compiles as a
    small program independent of the kernel-table graphs.
    """
    gr = grids.build(cfg)
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z
    march = _resolve_march(cfg)

    Wsq = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))  # (3, 3)
    Wf = Wsq[cfg.flav]  # (3,)
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)

    tbl_prefs = None
    A32ext = pref_A = None
    rho_ext = tblA = None
    if tables is not None:
        if march in ("rank1", "rank1_f32"):
            raise ValueError("precomputed tables require march='trisolve' "
                             "or 'loop' (rank1 uses the factorized alpha)")
        if march == "trisolve_f32":
            tblG, tblAt, (A32ext, pref_A) = tables
            tblA = None
        else:
            tblG, tblAt, tblA = tables
    elif march == "trisolve_f32":
        # Delegate to build_tables — the staged builders inline under an
        # outer jit, and the (A32ext, pref_A) normalized-table contract
        # (incl. the pp-channel fold) then has exactly one spelling.
        tblG, tblAt, (A32ext, pref_A) = build_tables(
            params, cfg, pp_tables=pp_tables)
        tblA = None
    elif march == "rank1_f32" and cfg.table_dtype in ("auto", "f32"):
        # Float32 s-channel table build (kernels_f32): the dominant
        # cost of the headline evolve drops an order of magnitude; the
        # normalized tables come with f64 scalar prefactors applied
        # inside the (window-safe) f64 row groupings below.
        from nusiprop_tpu.models import kernels_f32

        tblG, tblAt, rho_ext, tbl_prefs = kernels_f32.s_channel_tables_f32(
            gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
            majorana=cfg.majorana)
        dE_ext = gr.Emax_ext - gr.Emin_ext
        tblA = None
    else:
        kw = dict(
            majorana=cfg.majorana,
            non_resonant=cfg.non_resonant,
            phiphi=cfg.phiphi,
            pp_tables=pp_tables,
        )
        tblG = kernels.gamma_table(gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf, **kw)
        tblAt = kernels.alphatilde_table(gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf, **kw)
        if march == "trisolve" and _use_f32_alpha(cfg):
            from nusiprop_tpu.models import kernels_nr_f32

            tblA = kernels_nr_f32.alpha_table_f32(
                gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
                majorana=cfg.majorana)
            if cfg.phiphi:
                kw_pp = dict(kw, pp_tables=_pp_f32(pp_tables))
                tblA = tblA + kernels.alpha_table(
                    gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi,
                    Wf, channel="pp", **kw_pp)
        elif march in ("rank1", "rank1_f32"):
            # Rank-one factorization of the alpha table: no (NEXT, NEXT)
            # materialization at all. Stored pre-scaled by 2^100 so the
            # weak-coupling table (raw values down to ~1e-50) stays
            # inside float32's exponent range in storage; the
            # consumers pair the exact 2^-100 with the bin widths.
            rho_ext = kernels.alpha_s_rho(
                gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
                majorana=cfg.majorana, scaled=True,
            )
            tbl_prefs = (1.0, 1.0, _INV_RSCALE)
            dE_ext = gr.Emax_ext - gr.Emin_ext
            tblA = None
        else:
            tblA = kernels.alpha_table(gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf, **kw)

    dE = gr.Emax - gr.Emin
    inv_dE = 1.0 / dE
    dlogz = gr.dlogz
    z = gr.z
    Wf2 = Wf * Wf
    eye3 = jnp.eye(3, dtype=jnp.float64)
    offd_mask = 1.0 - eye3
    WfWf = jnp.outer(Wf, Wf)

    def node_common(flux, i, lum):
        """Per-z-node quantities shared by all march implementations.

        ``lum`` (the per-bin source integral at this node) is precomputed
        for ALL nodes before the scan: inside the scan it would evaluate
        the source's polylogarithm chains as 78 sequential latency-bound
        steps; outside it is one vectorized (Nz, NE) call.
        """
        zim = z[i - 1]
        ndfac = sources.get_nd(zim) / (1.0 + zim) ** 2
        pref = (1.0 + zim) * dlogz / sources.get_H(zim)

        # Window of the extended tables active at this z-node: entry j-1
        # of the window equals extended entry j+i-2 (nuSIprop.hpp:268-272).
        G_i = lax.dynamic_slice(tblG, (i - 1,), (NE,)) * ndfac
        At_i = lax.dynamic_slice(tblAt, (i - 1,), (NE,)) * ndfac

        # Zdr[k, j] (nuSIprop.hpp:294)
        Zdr = 1.0 + pref * (
            G_i[None, :] * Wf[:, None] - At_i[None, :] * Wf2[:, None]
        ) * inv_dE[None, :]
        coup = At_i * inv_dE  # same-bin eigenstate coupling (NE,)
        return ndfac, pref, Zdr, coup

    def z_step_loop(flux, xs_i):
        """Reference-shaped descending-bin scan (cross-validation oracle)."""
        i, lum = xs_i
        ndfac, pref, Zdr, coup = node_common(flux, i, lum)
        A_i = lax.dynamic_slice(tblA, (i - 1, i - 1), (NE, NE)) * ndfac

        def j_step(flx, j):
            jm = j - 1
            arow = A_i[jm]  # strictly-triangular zeros mask m < j
            s_l = (flx * inv_dE[None, :]) @ arow  # (3,), sum over source bins
            reg = jnp.dot(Wf, s_l)
            src = pref * (lum[jm] + reg * Wf)  # (3,)
            zdr = Zdr[:, jm]
            rhs = (flx[:, jm] + src) / zdr
            M = eye3 + offd_mask * (coup[jm] * WfWf / zdr[:, None])
            x = _solve3(M, rhs)
            return flx.at[:, jm].set(x), None

        flux, _ = lax.scan(j_step, flux, jnp.arange(NE, 0, -1))
        return flux, None

    def z_step_rank1(flux, xs_i):
        """s-channel-only sweep in log depth.

        alpha[j, m] = dE_ext[j'] * rho_ext[m'] (exactly; kernels.alpha_s_rho)
        so the regeneration feed reg_j = d_j * cum_j with the scalar
        cum_j = sum_{m>j} c_m * (Wf . x_m) accumulated over already-updated
        higher bins. Since x_m = V_m + cum_m * U_m is affine in cum, cum
        obeys cum_{j} = a_{j+1} cum_{j+1} + b_{j+1}: a scalar affine
        recurrence — an `associative_scan` in processing (descending-bin)
        order replaces the 500-step sequential chain.
        """
        i, lum = xs_i
        ndfac, pref, Zdr, coup = node_common(flux, i, lum)
        # RANGE SAFETY: the raw accumulation weight rho*nd/dE sits around
        # 1e-37 (and the raw rho TABLE itself under ~1e-38 for weak
        # couplings) — at the floor of the f32 exponent range, where an
        # f64 emulated as float32 pairs flushes entries to zero and
        # silently kills regeneration. rho_ext is therefore STORED
        # pre-scaled by 2^100 (kernels.alpha_s_rho(scaled=True)); every
        # use pairs c (scaled up) with d (scaled down), so CPU f64
        # results are bit-identical.
        d_w = lax.dynamic_slice(dE_ext, (i - 1,), (NE,)) * _INV_RSCALE
        rho_w = lax.dynamic_slice(rho_ext, (i - 1,), (NE,)) * ndfac

        U, V = _node_affine(pref, Zdr, coup, lum, flux, Wf)
        c_w = rho_w * inv_dE  # accumulation weight of each source bin
        # d_w (target-bin width) multiplies the tiny c_w/cum factors, NOT
        # U, whose pref ~ 1e31 would overflow float32's range.
        a = 1.0 + (c_w * d_w) * (U @ Wf)
        b = c_w * (V @ Wf)

        # Processing order is descending bin index: flip, prefix-compose
        # the affine maps s -> a*s + b, and read off the state *before*
        # each step (exclusive scan).
        a_r = jnp.flip(a, axis=0)
        b_r = jnp.flip(b, axis=0)

        def compose(lo, hi):
            al, bl = lo
            ah, bh = hi
            return ah * al, ah * bl + bh

        _, B_inc = lax.associative_scan(compose, (a_r, b_r), axis=0)
        cum_r = jnp.concatenate([jnp.zeros_like(B_inc[:1]), B_inc[:-1]], axis=0)
        cum = jnp.flip(cum_r, axis=0)  # (NE,) state seen by each bin

        x = V + (cum * d_w)[:, None] * U
        return x.T, None

    def z_step_trisolve(flux, xs_i):
        """General-kernel sweep as one scalar triangular solve.

        With y_j = Wf . x_j and K[j,m] = alpha[j,m]/dE_m (strictly upper
        triangular), the back-substitution closes into
            (I - diag(pu) K) y = qv,   pu_j = Wf.U_j, qv_j = Wf.V_j,
        a unit-diagonal upper-triangular NE x NE system — one blocked
        triangular solve per z-node instead of an NE-step scan chain.
        """
        i, lum = xs_i
        ndfac, pref, Zdr, coup = node_common(flux, i, lum)
        A_i = lax.dynamic_slice(tblA, (i - 1, i - 1), (NE, NE)) * ndfac

        U, V = _node_affine(pref, Zdr, coup, lum, flux, Wf)
        K = A_i * inv_dE[None, :]
        pu = U @ Wf
        qv = V @ Wf
        T = jnp.eye(NE, dtype=flux.dtype) - pu[:, None] * K
        y = jax.scipy.linalg.solve_triangular(
            T, qv, lower=False, unit_diagonal=True
        )
        reg = K @ y
        x = V + reg[:, None] * U
        return x.T, None

    if march == "rank1_f32":
        xs, scale = _rank1_f32_rows(cfg, gr, params, norm_total,
                                    tblG, tblAt, rho_ext, dE_ext,
                                    prefs=tbl_prefs)
        phi = _rank1_f32_scan(xs, Wf, NE, unroll=cfg.march_unroll)
        # back to counts in f64 (the last node's preconditioner scale)
        flux = phi.astype(jnp.float64) * scale[None, :]
    elif march == "trisolve_f32":
        xs, scale = _trisolve_f32_rows(cfg, gr, params, norm_total,
                                       tblG, tblAt, pref_A)
        phi = _trisolve_f32_scan(xs, A32ext, Wf, NE,
                                 unroll=cfg.march_unroll)
        flux = phi.astype(jnp.float64) * scale[None, :]
    else:
        z_step = {"loop": z_step_loop, "rank1": z_step_rank1,
                  "trisolve": z_step_trisolve}[march]
        flux0 = jnp.zeros((3, NE), dtype=jnp.float64)
        steps = jnp.arange(Nz - 1, 0, -1)
        lum_all = jax.vmap(
            lambda zz: _source_lum(cfg, zz, gr.Emin, gr.Emax, params.si,
                                   norm_total))(z[steps])
        flux, _ = lax.scan(z_step, flux0, (steps, lum_all))

    flux = flux * inv_dE[None, :]          # counts -> differential flux
    flux_fla = Wsq @ flux                  # mass -> flavor basis

    return EvolveResult(
        flux=flux,
        flux_fla=flux_fla,
        E_nu=gr.E_nu,
        Emin=gr.Emin,
        Emax=gr.Emax,
        z=z,
        mn=mn,
        health=_table_health(
            [tblG, tblAt, A32ext, tblA, rho_ext],
            _march_tau(gr, tblG,
                       tbl_prefs[0] if tbl_prefs is not None else 1.0)),
    )


@lru_cache(maxsize=None)
def _jitted_evolve(cfg: Config):
    return jax.jit(lambda p: evolve_core(p, cfg))


@lru_cache(maxsize=None)
def _jitted_march_with_tables(cfg: Config):
    return jax.jit(lambda p, t: evolve_core(p, cfg, tables=t))


@lru_cache(maxsize=None)
def _jitted_evolve_with_pp(cfg: Config):
    return jax.jit(lambda p, t: evolve_core(p, cfg, pp_tables=t))


@lru_cache(maxsize=None)
def _jitted_pp_extrap_counts(cfg: Config):
    def run(params, pp_tables):
        gr = grids.build(cfg)
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
        ca, cat = kernels.pp_extrapolation_counts(
            gr.Emin_ext, gr.Emax_ext, mn, params.mphi,
            pp_tables=pp_tables)
        return jnp.stack([ca, cat])

    return jax.jit(run)


def check_pp_extrapolation(params: PhysicsParams, cfg: Config, pp_tables):
    """Enforce ``Config(extrapolation="raise")``: count the phi-phi
    spline lookups that leave the tables (the reference exits there,
    interp.hpp:354-361) on-device, raise host-side if any fired. No-op
    when the config has no phi-phi spline path."""
    if pp_tables is None or not (cfg.phiphi and cfg.non_resonant):
        return
    counts = _jitted_pp_extrap_counts(cfg)(params, pp_tables)
    ca, cat = int(counts[0]), int(counts[1])
    if ca or cat:
        raise RuntimeError(
            f"phi-phi table extrapolation: {ca} alpha and {cat} "
            "alphaTilde lookups fall outside the loaded tables (the "
            "reference would exit(1) here, interp.hpp:354-361). Likely "
            "cause: the bin ratio (log10 delta = "
            f"{(cfg.lEmax - cfg.lEmin) / cfg.N_bins_E:.4g} decades) or "
            "energy window is outside the table axes. Regenerate wider "
            "tables (tools/make_tables.py) or use "
            "Config(extrapolation='clamp') to accept clamping.")


def evolve(params: PhysicsParams, cfg: Config, pp_tables=None) -> EvolveResult:
    """Evolve the flux; compiled once per Config, cached across params.

    Non-resonant configurations build the kernel tables with the staged
    per-channel programs (build_tables) and feed them to a small jitted
    march — one monolithic program is one very large compile.
    """
    if cfg.extrapolation == "raise":
        check_pp_extrapolation(params, cfg, pp_tables)
    if _resolve_march(cfg) not in ("rank1", "rank1_f32"):
        tables = build_tables(params, cfg, pp_tables=pp_tables)
        return _jitted_march_with_tables(cfg)(params, tables)
    if pp_tables is not None:
        # tables are arrays (pytree) — jit them as traced args (cached
        # per Config: a fresh jit object here would retrace every call)
        return _jitted_evolve_with_pp(cfg)(params, pp_tables)
    return _jitted_evolve(cfg)(params)


# ---------------------------------------------------------------------------
# Non-diagonal flavor-space interactions (BASELINE.json config 5)
# ---------------------------------------------------------------------------

def _march_general(params: PhysicsParams, Q, tables, cfg: Config) -> EvolveResult:
    """Implicit march for a general mass-basis coupling matrix.

    Q[i, j] = |g_ij|^2 / g^2 (symmetric, non-negative): the squared
    coupling of mass eigenstates (i, j) to the scalar relative to the
    overall scale params.g. The reference's flavor-diagonal case is the
    rank-one Q = w w^T with w = |U[flav, :]|^2 (nuSIprop.hpp structure);
    here Q is arbitrary, which covers e.g. couplings to several flavors
    or direct mass-basis textures.

    Structure (derivation in docs/DESIGN.md): absorption of eigenstate k
    on bath j weights as Q[k, j]; regeneration nu_l + bath -> phi ->
    nu_k + nu_n weights as (Q-contracted table over the bath) x branching
    B_k = sum_n Q[k, n] / sum(Q). The per-bin update stays affine in ONE
    scalar regeneration feed, so the sweep still closes into a scalar
    triangular solve.
    """
    gr = grids.build(cfg)
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z

    Wsq = jnp.asarray(mixing.pmns_sq(cfg.normal_ordering))
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)

    tblG_s, tblAt_s, tblA_s = tables          # (3, NEXT), (3, NEXT), (3, NEXT, NEXT)
    # Each 2->2 process carries |g_prod|^2 x (sum over decay pairs |g|^2)
    # = g^4 Q_prod * sum(Q) * branching — the channel closed forms supply
    # g^4, so the contraction weight is Q * sum(Q). (Diagonal reference
    # case: sum(Q) = (sum|U_f|^2)^2 = 1, invisible there. Verified by the
    # exact rescaling invariance g -> sqrt(c) g  <=>  Q -> c Q,
    # tests/test_general_coupling.py.)
    sumQ = jnp.sum(Q)
    Qs = Q * sumQ
    Geff = Qs @ tblG_s                        # (3, NEXT): absorption of k
    Ateff = Qs @ tblAt_s                      # (3, NEXT): regen, in-state l
    Aeff = jnp.einsum("lb,bjm->ljm", Qs, tblA_s)  # (3, NE_ext, NE_ext)
    B = jnp.sum(Q, axis=1) / sumQ             # decay branching to state k

    dE = gr.Emax - gr.Emin
    inv_dE = 1.0 / dE
    dlogz = gr.dlogz
    z = gr.z
    offd_mask = 1.0 - jnp.eye(3, dtype=jnp.float64)
    eyeNE = jnp.eye(NE, dtype=jnp.float64)

    def z_step(flux, xs_i):
        i, lum = xs_i
        zim = z[i - 1]
        ndfac = sources.get_nd(zim) / (1.0 + zim) ** 2
        pref = (1.0 + zim) * dlogz / sources.get_H(zim)

        G_i = lax.dynamic_slice(Geff, (0, i - 1), (3, NE)) * ndfac
        At_i = lax.dynamic_slice(Ateff, (0, i - 1), (3, NE)) * ndfac
        A_i = lax.dynamic_slice(Aeff, (0, i - 1, i - 1), (3, NE, NE)) * ndfac

        # Zdr[k, j]: absorption minus self-regeneration (nuSIprop.hpp:294
        # with Wf_k -> B_k, Wf-weighted tables -> Q-contracted tables)
        Zdr = 1.0 + pref * (G_i - B[:, None] * At_i) * inv_dE[None, :]
        zdr_t = Zdr.T  # (NE, 3)

        # M[j, k, l] = delta_kl + offd * B_k At_i[l, j] / dE_j / Zdr[k, j]
        M = jnp.eye(3, dtype=jnp.float64)[None] + offd_mask[None] * (
            B[None, :, None] * At_i.T[:, None, :] * inv_dE[:, None, None]
            / zdr_t[:, :, None]
        )
        Minv = _inv3(M)  # (NE, 3, 3)
        U = jnp.einsum("jkl,jl->jk", Minv, pref * B[None, :] / zdr_t)
        V = jnp.einsum("jkl,jl->jk", Minv,
                       (flux.T + pref * lum[:, None]) / zdr_t)

        # scalar feed r_j = sum_{m>j} sum_l x[l, m] Aeff[l, j, m] / dE_m,
        # x = V + r U  ->  (I - Ku) r = Kv 1  (strict upper triangular)
        K = A_i * inv_dE[None, None, :]            # (3, NE, NE)
        Ku = jnp.einsum("ml,ljm->jm", U, K)        # (NE, NE)
        Kv = jnp.einsum("ml,ljm->jm", V, K)
        rv = jnp.sum(Kv, axis=1)
        T = eyeNE - Ku
        r = jax.scipy.linalg.solve_triangular(T, rv, lower=False,
                                              unit_diagonal=True)
        x = V + r[:, None] * U
        return x.T, None

    flux0 = jnp.zeros((3, NE), dtype=jnp.float64)
    steps = jnp.arange(Nz - 1, 0, -1)
    # source integrals precomputed outside the scan (cf. the diagonal
    # marches: in-scan polylog chains are latency-bound)
    lum_all = jax.vmap(
        lambda zz: _source_lum(cfg, zz, gr.Emin, gr.Emax, params.si,
                               norm_total))(z[steps])
    flux, _ = lax.scan(z_step, flux0, (steps, lum_all))

    flux = flux * inv_dE[None, :]
    flux_fla = Wsq @ flux

    return EvolveResult(flux=flux, flux_fla=flux_fla, E_nu=gr.E_nu,
                        Emin=gr.Emin, Emax=gr.Emax, z=z, mn=mn,
                        health=_table_health([Geff, Ateff, Aeff],
                                             _march_tau(gr, Geff)))


@lru_cache(maxsize=None)
def _jitted_general_march(cfg: Config):
    return jax.jit(lambda p, q, t: _march_general(p, q, t, cfg))


def evolve_general(params: PhysicsParams, Q, cfg: Config,
                   pp_tables=None) -> EvolveResult:
    """Evolve with a non-diagonal mass-basis coupling matrix Q.

    Q[i, j] = |g_ij|^2 / params.g^2. The scalar decay width scales with
    sum(Q) (all open decay channels). Reduces exactly to `evolve` when
    Q = w w^T with w = |U[cfg.flav]|^2 (tests/test_general_coupling.py).
    """
    Q = jnp.asarray(Q, dtype=jnp.float64)
    if Q.shape != (3, 3):
        raise ValueError(f"Q must be (3, 3), got {Q.shape}")
    if cfg.extrapolation == "raise":
        check_pp_extrapolation(params, cfg, pp_tables)
    width_factor = jnp.sum(Q)
    tables = build_tables(params, cfg, pp_tables=pp_tables, per_state=True,
                          width_factor=width_factor)
    return _jitted_general_march(cfg)(params, Q, tables)


def check_energy_conservation(params: PhysicsParams, cfg: Config,
                              pp_tables=None, return_result=False):
    """(E_int - E_FS)/E_FS (nuSIprop.hpp:339-357).

    Faithful to the reference fork: the free-streaming energy E_FS uses
    the *power-law* source forms regardless of the active source model.

    With ``return_result=True``, returns ``(drift, EvolveResult)`` so
    callers that also want the evolved flux pay for one evolve, not two.
    """
    gr = grids.build(cfg)
    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    E_FS = sources.energy_fs(cfg.lEmin, cfg.lEmax, params.si, norm_total,
                             gr.zmax_eff)
    res = evolve(params, cfg, pp_tables=pp_tables)
    logw = jnp.log(res.Emax) - jnp.log(res.Emin)
    E_int = jnp.sum(logw[None, :] * res.E_nu[None, :] ** 2 * res.flux)
    drift = (E_int - E_FS) / E_FS
    if return_result:
        return drift, res
    return drift
