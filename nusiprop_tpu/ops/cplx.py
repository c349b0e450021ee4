"""Complex arithmetic as explicit (re, im) float64 pairs.

Not every XLA backend supports complex dtypes (C64/C128 element types),
but the s-t interference kernels need complex dilogarithms
(nuSIprop.hpp:842-872, 1134-1186, 1427-1467). This module provides a
minimal complex type built from two float64 arrays so those channels
compile on any backend; on CPU it produces bit-identical results to complex128
for the operations used here.

``Cx`` is a NamedTuple (hence a pytree) with operator overloads; real
scalars/arrays broadcast in naturally. Signed zeros of the imaginary
part follow IEEE semantics through ``angle``/``log`` exactly like C's
``double _Complex``, which several closed forms rely on (see
kernels_nr.py notes).
"""

from typing import NamedTuple

import jax.numpy as jnp

__all__ = ["Cx", "cx", "angle", "log", "where", "conj", "cabs"]


def _lift(v):
    """Promote a real scalar/array to a Cx with +0.0 imaginary part."""
    if isinstance(v, Cx):
        return v
    v = jnp.asarray(v, dtype=jnp.float64)
    return Cx(v, jnp.zeros_like(v))


class Cx(NamedTuple):
    re: jnp.ndarray
    im: jnp.ndarray

    # -- arithmetic ---------------------------------------------------
    def __add__(self, o):
        o = _lift(o)
        return Cx(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __neg__(self):
        return Cx(-self.re, -self.im)

    def __sub__(self, o):
        o = _lift(o)
        return Cx(self.re - o.re, self.im - o.im)

    def __rsub__(self, o):
        return _lift(o).__sub__(self)

    def __mul__(self, o):
        if not isinstance(o, Cx):
            o = jnp.asarray(o, dtype=jnp.float64)
            return Cx(self.re * o, self.im * o)
        return Cx(self.re * o.re - self.im * o.im,
                  self.re * o.im + self.im * o.re)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, Cx):
            o = jnp.asarray(o, dtype=jnp.float64)
            return Cx(self.re / o, self.im / o)
        d = o.re * o.re + o.im * o.im
        return Cx((self.re * o.re + self.im * o.im) / d,
                  (self.im * o.re - self.re * o.im) / d)

    def __rtruediv__(self, o):
        return _lift(o).__truediv__(self)


def cx(re, im=0.0):
    re = jnp.asarray(re, dtype=jnp.float64)
    im = jnp.asarray(im, dtype=jnp.float64)
    return Cx(*jnp.broadcast_arrays(re, im))


def conj(z: Cx) -> Cx:
    return Cx(z.re, -z.im)


def cabs(z: Cx):
    return jnp.hypot(z.re, z.im)


def angle(z: Cx):
    """arg(z) via atan2 — IEEE signed-zero semantics, like C's carg."""
    return jnp.arctan2(z.im, z.re)


def log(z: Cx) -> Cx:
    """Principal-branch complex log: ln|z| + i*atan2(im, re)."""
    return Cx(0.5 * jnp.log(z.re * z.re + z.im * z.im), angle(z))


def where(cond, a: Cx, b: Cx) -> Cx:
    return Cx(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))
