"""Offline phi-phi table generation — an on-device redesign of the
reference pipeline (xsec/funcs.c + xsec/tables_phiphi.py).

The reference computes ~1e8 adaptive scipy dblquads over a C integrand
(months of single-core time at full resolution; the resulting .bin files
are distributed out-of-band, README.md:52). Here the integrand is a pure
JAX closed form (``primitive``) and every table entry is a fixed-order
composite Gauss-Legendre double integral with analytic kink-splitting at
the kinematic boundary curve s = -t^2/(1+t); the whole grid evaluates as
batched device programs (lax.map sub-chunked so the compiler sees a
bounded body). The FULL reference-resolution pair (5000x100 alphatilde
+ 1000x1000x100 alpha = 1.005e8 entries) regenerates with
``--preset full --chunk 131072`` (3h08m on one CPU core; the reference
distributes its tables out-of-band rather than regenerate).
Validation: tools/validate_full_tables.py.

Usage:
  python tools/make_tables.py --out data/pp_tables_small.npz --preset small
  python tools/make_tables.py --out data/pp_tables.npz            # full res
  python tools/make_tables.py --out tbl.npz --bin-dir xsec/       # also .bin

Accuracy is validated against scipy.integrate.dblquad of the same
integrand on sampled entries (tests/test_pp_tables.py).
"""

import argparse
import math
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


PI = math.pi


# ---------------------------------------------------------------------------
# Integrand (transcription target: xsec/funcs.c:12-39)
# ---------------------------------------------------------------------------

def _primitive_np(tau, s):
    """int dtau/(-tau) dsigma/dtau for nu nu -> phi phi (funcs.c:12-19),
    numpy version for the scipy cross-check oracle."""
    return (1 / (1 + tau) + 1 / ((s - 1) * (s - 1 + tau))
            + (-((s - 1) ** 2 * (4 + (s - 3) * s) * np.log(-1 - tau))
               + (s - 2) * s ** 3 * np.log(-tau)
               + (-4 + s * (9 + (s - 5) * s)) * np.log(s - 1 + tau))
            / ((s - 2) * (s - 1) ** 2)) / (64.0 * PI * s * s)


def dsigma_np(sbar, tbar):
    """dsigma integrated over the tau window (funcs.c:21-39)."""
    rt = np.sqrt(max(sbar - 4.0, 0.0))
    rs = np.sqrt(sbar)
    tau_hi = -1.0 - 0.25 * (rs - rt) ** 2
    tau_lo = -1.0 - 0.25 * (rs + rt) ** 2
    upper = min(tbar, tau_hi)
    if upper < tau_lo:
        return 0.0
    return _primitive_np(upper, sbar) - _primitive_np(tau_lo, sbar)


# ---------------------------------------------------------------------------
# JAX quadrature engine
# ---------------------------------------------------------------------------

def _jax_fns():
    import jax
    import jax.numpy as jnp

    def primitive(tau, s):
        l1 = jnp.log(jnp.maximum(-1.0 - tau, 1e-300))
        l2 = jnp.log(jnp.maximum(-tau, 1e-300))
        l3 = jnp.log(jnp.maximum(s - 1.0 + tau, 1e-300))
        sm1 = s - 1.0
        return (1.0 / (1.0 + tau) + 1.0 / (sm1 * (sm1 + tau))
                + (-(sm1 * sm1 * (4.0 + (s - 3.0) * s) * l1)
                   + (s - 2.0) * s ** 3 * l2
                   + (-4.0 + s * (9.0 + (s - 5.0) * s)) * l3)
                / ((s - 2.0) * sm1 * sm1)) / (64.0 * PI * s * s)

    def dsigma(sbar, tbar):
        rt = jnp.sqrt(jnp.maximum(sbar - 4.0, 0.0))
        rs = jnp.sqrt(sbar)
        tau_hi = -1.0 - 0.25 * (rs - rt) ** 2
        tau_lo = -1.0 - 0.25 * (rs + rt) ** 2
        upper = jnp.minimum(tbar, tau_hi)
        val = primitive(upper, sbar) - primitive(tau_lo, sbar)
        return jnp.where(upper > tau_lo, val, 0.0)

    def gl_nodes(n):
        x, w = np.polynomial.legendre.leggauss(n)
        return jnp.asarray(x), jnp.asarray(w)

    XT, WT = gl_nodes(16)   # outer tbar nodes per segment
    XS, WS = gl_nodes(24)   # inner sbar nodes per segment

    # unit-interval nodes for the boundary-clustered segments
    US = 0.5 * (XS + 1.0)
    WUS = 0.5 * WS

    def s_integral(tbar, lo, hi):
        """int_lo^hi dsbar dsigma(sbar, tbar), split at the kinematic
        boundary s* = -t^2/(1+t) where the tau window opens/closes.

        Just above the boundary the integrand has an O(1)-wide shoulder
        (the tau window is [tau_-, t] with tau_-(s) ~ -s sweeping past t)
        while the segment can be O(T) wide, so the upper segment uses a
        cubic node-clustering substitution s = s* + (hi - s*) u^3."""
        s_split = jnp.where(tbar < -1.0, -tbar * tbar / (1.0 + tbar), lo)
        mid = jnp.clip(s_split, lo, hi)

        def seg(a, b):
            h, m = (b - a) * 0.5, (b + a) * 0.5
            vals = dsigma(h[..., None] * XS + m[..., None], tbar[..., None])
            return h * jnp.sum(vals * WS, axis=-1)

        def seg_clustered(a, b):
            h = b - a
            u = US
            s = a[..., None] + h[..., None] * u ** 3
            vals = dsigma(s, tbar[..., None])
            return h * jnp.sum(vals * 3.0 * u * u * WUS, axis=-1)

        return seg(lo, mid) + seg_clustered(mid, hi)

    def alphatilde_entry(T, log10d):
        """One alphatilde table entry: T = |tbar_plus|
        (tables_phiphi.py:24-37)."""
        delta = 10.0 ** log10d
        t_plus = -T
        t_minus = t_plus / delta
        # the s-window [s*(t), T] closes at |t| = R: split the t-integral
        R = 0.5 * (T + jnp.sqrt(jnp.maximum(T * T - 4.0 * T, 0.0)))
        t_knee = jnp.clip(-R, t_plus, t_minus)

        def t_seg(a, b):
            h, m = (b - a) * 0.5, (b + a) * 0.5
            t = h[..., None] * XT + m[..., None]
            lo = jnp.clip(-t * t / (1.0 + t), None,
                          T * jnp.ones_like(t))
            inner = s_integral(t, lo, T * jnp.ones_like(t))
            return h * jnp.sum(inner * WT, axis=-1)

        return t_seg(t_plus, t_knee) + t_seg(t_knee, t_minus)

    def alpha_entry(S, n, log10d):
        """One alpha table entry (tables_phiphi.py:43-59)."""
        delta = 10.0 ** log10d
        s_min = S / delta
        t_minus = -s_min / delta ** n
        t_plus = t_minus * delta
        lo = jnp.maximum(s_min, 4.0)
        hi = S

        def t_seg(a, b):
            h, m = (b - a) * 0.5, (b + a) * 0.5
            t = h[..., None] * XT + m[..., None]
            inner = s_integral(t, lo[..., None] * jnp.ones_like(t),
                               hi[..., None] * jnp.ones_like(t))
            return h * jnp.sum(inner * WT, axis=-1)

        # kink candidates in t: where the boundary curve crosses lo or hi
        def root(X):
            disc = jnp.sqrt(jnp.maximum(X * X - 4.0 * X, 0.0))
            return -(X + disc) * 0.5  # large-|t| branch of s*(t) = X

        c1 = jnp.clip(root(lo), t_plus, t_minus)
        c2 = jnp.clip(root(hi), t_plus, t_minus)
        a_ = jnp.minimum(c1, c2)
        b_ = jnp.maximum(c1, c2)
        return (t_seg(t_plus, a_) + t_seg(a_, b_) + t_seg(b_, t_minus))

    return alphatilde_entry, alpha_entry


def generate(nt=5000, nd=100, ns=1000, nn=1000, chunk=20000,
             progress=True):
    """Generate both tables at the given resolution. Returns
    (at_tplus, at_log10d, at_values, a_splus, a_n, a_log10d, a_values)."""
    import jax
    import jax.numpy as jnp

    alphatilde_entry, alpha_entry = _jax_fns()

    at_tplus = np.geomspace(4.0, 1e4, nt)          # |tbar_plus| ascending
    at_log10d = np.linspace(0.005, 0.05, nd)
    a_splus = np.geomspace(4.0, 1e4, ns)
    a_n = np.linspace(1.0, 1000.0, nn)
    a_log10d = np.linspace(0.005, 0.05, nd)

    # Sub-chunk size the COMPILER sees: the jitted program lax.map's
    # over (chunk // SUB) bodies of SUB entries each, so compile time
    # and compiler memory are bounded by SUB while the host loop still
    # dispatches `chunk` entries per call (amortizing per-call dispatch
    # latency). A flat vmap over a whole 32k-256k-entry chunk of f64
    # quadrature is a very large compile.
    SUB = 4096

    def run_grid(fn, coords, total):
        flat = [c.reshape(-1) for c in np.meshgrid(*coords, indexing="ij")]
        out = np.empty(total, dtype=np.float64)
        eff_chunk = max(SUB, (chunk // SUB) * SUB)
        K = eff_chunk // SUB

        @jax.jit
        def fj(*args):
            stacked = jnp.stack(
                [a.reshape(K, SUB) for a in args], axis=1)  # (K, n_in, SUB)
            return jax.lax.map(
                lambda rows: jax.vmap(fn)(*[rows[i] for i in
                                            range(len(args))]),
                stacked).reshape(-1)

        n_done = 0
        while n_done < total:
            n = min(eff_chunk, total - n_done)
            args = [jnp.asarray(f[n_done:n_done + n]) for f in flat]
            # pad the last chunk so one compiled shape serves all chunks
            if n < eff_chunk:
                args = [jnp.pad(a, (0, eff_chunk - n)) for a in args]
            vals = np.asarray(fj(*args))[:n]
            out[n_done:n_done + n] = vals
            n_done += n
            if progress and (n_done // eff_chunk) % 50 == 0:
                print(f"  {n_done}/{total}", file=sys.stderr, flush=True)
        return out

    print(f"alphatilde table: {nt} x {nd}", file=sys.stderr)
    at_values = run_grid(alphatilde_entry, [at_tplus, at_log10d],
                         nt * nd).reshape(nt, nd)

    print(f"alpha table: {ns} x {nn} x {nd}", file=sys.stderr)
    a_values = run_grid(alpha_entry, [a_splus, a_n, a_log10d],
                        ns * nn * nd).reshape(ns, nn, nd)
    a_values[a_values < 1e-37] = 0.0   # tables_phiphi.py:56-57

    return at_tplus, at_log10d, at_values, a_splus, a_n, a_log10d, a_values


PRESETS = {
    "full": dict(nt=5000, nd=100, ns=1000, nn=1000),      # reference res
    "medium": dict(nt=1000, nd=50, ns=300, nn=300),
    "small": dict(nt=200, nd=20, ns=60, nn=60),           # tests/demos
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help=".npz output path")
    ap.add_argument("--preset", default="full", choices=sorted(PRESETS))
    ap.add_argument("--bin-dir", default=None,
                    help="also write reference-format .bin files here")
    ap.add_argument("--chunk", type=int, default=20000)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import nusiprop_tpu  # noqa: F401  (enables x64)
    from nusiprop_tpu.models import pp_tables

    res = generate(chunk=args.chunk, **PRESETS[args.preset])
    pp_tables.save_npz(args.out, *res)
    print(f"wrote {args.out}", file=sys.stderr)
    if args.bin_dir:
        import os
        at_path = os.path.join(args.bin_dir, "alphatilde_phiphi.bin")
        a_path = os.path.join(args.bin_dir, "alpha_phiphi.bin")
        pp_tables.save_binary(at_path, a_path, *res)
        print(f"wrote {at_path}, {a_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
