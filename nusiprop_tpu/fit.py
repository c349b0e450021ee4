"""Gradient-based parameter inference on the evolved spectrum.

A capability the serial C++ reference cannot offer: the whole engine
— kernel tables (dilogarithm chains included), the mass-spectrum
solve, the implicit ``lax.scan`` redshift march and its per-step
solves — is one pure JAX program, so ``jax.grad`` differentiates the
map (mphi, g, mntot, si, norm) → flux exactly. Reverse-mode agrees
with central finite differences to ~8 significant digits at a
strong-coupling test point (tests/test_grad.py).

The reference's exclusion-contour workflow rasterizes a dense (g,
mphi) grid of forward evolves (test.py:76-83, nuSIprop.pyx:60-90);
with gradients, likelihood maximization or contour following needs
orders of magnitude fewer evolves — and each gradient costs ~2-3
forward evolves via XLA reverse-mode, batched over a `vmap`'d
multi-start exactly like `parallel.scan.grid_scan` batches forward
scans.

Only the float64 marches are differentiated: the f32 marches are for
forward scans; fits care about accuracy of the gradient direction, and
the f64 evolve at fit-sized grids (<=100 bins) is fast everywhere.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models import transport

# positive, decades-spanning parameters are optimized in log10
_LOG_FIELDS = frozenset({"mphi", "g", "norm"})
_ALL_FIELDS = ("mphi", "g", "mntot", "si", "norm")


def _pack(params: PhysicsParams, fields):
    x = {}
    for k in fields:
        v = getattr(params, k)
        x[k] = jnp.log10(v) if k in _LOG_FIELDS else jnp.asarray(v)
    return x


def _unpack(x, base: PhysicsParams) -> PhysicsParams:
    upd = {k: (10.0 ** v if k in _LOG_FIELDS else v) for k, v in x.items()}
    return dataclasses.replace(base, **upd)


def _require_differentiable_march(cfg: Config):
    """fit()/fisher() differentiate the float64 marches only; the f32
    marches (march='rank1_f32'/'trisolve_f32') would silently put ~1e-5
    round-off into the Jacobian — fatal for near-singular Fisher
    analysis."""
    march = transport._resolve_march(cfg)
    if march not in ("rank1", "trisolve", "loop"):
        raise ValueError(
            f"gradient-based inference differentiates the float64 marches, "
            f"not the f32 march {march!r}; use march='auto' (or "
            f"'rank1'/'trisolve'/'loop')")


def spectral_loss(flux_fla, target_fla, floor_rel=1e-12):
    """Mean squared log-flux residual over bins above ``floor_rel`` of
    the target peak (the flux spans ~60 decades; a linear residual
    would see only the peak bin)."""
    pk = jnp.max(target_fla)
    floor = pk * floor_rel
    lf = jnp.log(jnp.maximum(flux_fla, floor))
    lt = jnp.log(jnp.maximum(target_fla, floor))
    w = (target_fla > floor).astype(lf.dtype)
    return jnp.sum(w * (lf - lt) ** 2) / jnp.sum(w)


def fisher(cfg: Config, params: PhysicsParams, fit_fields=("g", "mphi"),
           *, sigma=0.1, floor_rel=1e-12, pp_tables=None):
    """Fisher information (and covariance) of the physics parameters
    in log10 space, treating each gated bin of the log flavor
    spectrum as an independent Gaussian measurement with std ``sigma``
    (dex). Forward-mode Jacobian of the whole evolve — a few columns,
    one per fit field.

    Returns ``(F, cov)``, both (len(fit_fields), len(fit_fields)) in
    the order of ``fit_fields``. A near-singular F diagnoses a
    degeneracy ridge (e.g. the sub-resonance g/mphi direction,
    examples/run_fit.py); ``cov`` then carries huge variances along it
    — inspect eigenvectors of F rather than marginal errors.
    """
    bad = set(fit_fields) - set(_ALL_FIELDS)
    if bad:
        raise ValueError(f"unknown fit fields {sorted(bad)}")
    _require_differentiable_march(cfg)
    x0 = _pack(params, fit_fields)

    @jax.jit
    def jac(x0):
        def masked_logflux(x):
            p = _unpack(x, params)
            f = transport.evolve(p, cfg, pp_tables=pp_tables).flux_fla
            pk = jnp.max(jax.lax.stop_gradient(f))
            gate = jax.lax.stop_gradient(f) > pk * floor_rel
            lf = jnp.log10(jnp.maximum(f, pk * floor_rel))
            return jnp.where(gate, lf, 0.0)

        return jax.jacfwd(masked_logflux)(x0)

    J = jac(x0)  # dict: field -> (3, N_bins_E)
    Jm = jnp.stack([J[k].ravel() for k in fit_fields], axis=-1)
    F = (Jm.T @ Jm) / (sigma * sigma)
    return F, jnp.linalg.inv(F)


class FitResult(NamedTuple):
    params: PhysicsParams   # best-loss parameters seen
    loss: jax.Array         # loss at ``params``
    history: jax.Array      # (steps,) loss per step


def fit(cfg: Config, target_fla, init: PhysicsParams,
        fit_fields=("g",), *, steps=100, learning_rate=0.05,
        optimizer=None, pp_tables=None, floor_rel=1e-12) -> FitResult:
    """Recover physics parameters whose evolved flavor flux matches
    ``target_fla`` (3, N_bins_E), by Adam on the log-spectrum residual.

    ``fit_fields`` selects which of (mphi, g, mntot, si, norm) to
    optimize (mphi/g/norm move in log10 space); the rest stay at their
    ``init`` values. The whole optimization — evolve, loss, gradient,
    Adam update — runs as ONE compiled ``lax.scan``.

    Multi-start: pass an ``init`` with batched leaves (leading axis S,
    e.g. from ``param_grid`` / ``stack_params``, the same idiom as
    ``grid_scan``) and all S optimizations run as one ``vmap``'d
    program; the best-loss start is returned.
    """
    import optax

    bad = set(fit_fields) - set(_ALL_FIELDS)
    if bad:
        raise ValueError(f"unknown fit fields {sorted(bad)}")
    _require_differentiable_march(cfg)

    target = jnp.asarray(target_fla, dtype=jnp.float64)
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)

    ndims = {k: jnp.ndim(getattr(init, k)) for k in _ALL_FIELDS}
    batched = any(n >= 1 for n in ndims.values())
    if batched and sorted(set(ndims.values())) != [1]:
        raise ValueError(
            "multi-start init must batch EVERY PhysicsParams leaf with "
            f"one common leading axis (stack_params/param_grid do); got "
            f"ndims {ndims}")
    scalar_init = (jax.tree.map(lambda v: jnp.asarray(v)[0], init)
                   if batched else init)
    if batched:
        # only the FIT fields may differ across starts; frozen fields
        # are taken from start 0, so divergent values would be silent
        import numpy as np

        for k in _ALL_FIELDS:
            if k in fit_fields:
                continue
            v = np.asarray(getattr(init, k))
            if v.ndim and not (v == v.reshape(-1)[0]).all():
                raise ValueError(
                    f"multi-start: non-fit field {k!r} varies across "
                    "starts; add it to fit_fields or make it uniform")

    def loss_of(x):
        p = _unpack(x, scalar_init)
        res = transport.evolve(p, cfg, pp_tables=pp_tables)
        return spectral_loss(res.flux_fla, target, floor_rel)

    x0 = _pack(init, fit_fields)

    @jax.jit
    def run(x0):
        def step(carry, _):
            x, opt_state, best_x, best_loss = carry
            loss, grads = jax.value_and_grad(loss_of)(x)
            better = loss < best_loss
            best_x = jax.tree.map(
                lambda b, c: jnp.where(better, c, b), best_x, x)
            best_loss = jnp.where(better, loss, best_loss)
            updates, opt_state = opt.update(grads, opt_state, x)
            x = optax.apply_updates(x, updates)
            return (x, opt_state, best_x, best_loss), loss

        carry0 = (x0, opt.init(x0), x0, jnp.asarray(jnp.inf, jnp.float64))
        (x, _, best_x, best_loss), history = jax.lax.scan(
            step, carry0, None, length=steps)
        # the final iterate may beat every recorded best
        final_loss = loss_of(x)
        better = final_loss < best_loss
        best_x = jax.tree.map(lambda b, c: jnp.where(better, c, b), best_x, x)
        best_loss = jnp.where(better, final_loss, best_loss)
        return best_x, best_loss, history

    if batched:
        best_x, best_loss, history = jax.jit(jax.vmap(run))(x0)
        i = jnp.argmin(best_loss)
        best_x = jax.tree.map(lambda v: v[i], best_x)
        return FitResult(_unpack(best_x, scalar_init), best_loss[i],
                         history[i])
    best_x, best_loss, history = run(x0)
    return FitResult(_unpack(best_x, scalar_init), best_loss, history)
