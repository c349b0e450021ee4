"""Neutrino mass spectrum from the total mass and the measured splittings.

The reference finds the lightest mass as a root of a quartic polynomial via
GSL (aux.hpp:12-50). Here we solve the *monotone* constraint directly:

    NO: f(mL) = mL + sqrt(mL^2 + dm21) + sqrt(mL^2 + dm31) - mntot
    IO: f(mL) = mL + sqrt(mL^2 - dm32) + sqrt(mL^2 - dm32 - dm21) - mntot

f is strictly increasing in mL, so a fixed-iteration bisection on
[0, mntot] is exact to machine precision, branch-free, jittable and
vmappable — no polynomial root selection logic needed.

If ``mntot`` is at (or numerically below) the minimal sum allowed by the
splittings, the root clamps to ~0; we floor the resulting masses at
MN_FLOOR so downstream kernels (which divide by each mass but whose
integrands are proportional to it) evaluate their finite massless limit
instead of 0/0. The reference instead exits with an error below the
minimum (aux.hpp:48-49) and relies on the quartic solver returning a tiny
positive root in the exactly-critical case used by the golden config.
"""

import jax.numpy as jnp
from jax import lax

from nusiprop_tpu import constants

# Floor applied to each mass eigenvalue [eV]. Kernel contributions of an
# eigenstate scale as mn * f(mn * E) / mn -> finite as mn -> 0, and for
# mn < ~1e-8 the evaluated limit is flat to >10 significant digits, so
# the floor only removes the 0/0. The value keeps 1/(2*mn) factors well
# inside float32's exponent range (~1e+/-38), which the f32 paths
# carry.
MN_FLOOR = 1e-12

N_BISECT = 200  # mntot * 2^-200: bisection exact to the last float64 bit


def lightest_mass(mntot, dmq21, dmq_at):
    """Smallest neutrino mass (cf. nuSIaux::getmL, aux.hpp:12-50)."""
    mntot = jnp.asarray(mntot, dtype=jnp.float64)

    def total(mL):
        return jnp.where(
            dmq_at > 0,
            mL + jnp.sqrt(mL * mL + dmq21) + jnp.sqrt(mL * mL + jnp.abs(dmq_at)),
            mL
            + jnp.sqrt(mL * mL + jnp.abs(dmq_at))
            + jnp.sqrt(mL * mL + jnp.abs(dmq_at) - dmq21),
        )

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        go_right = total(mid) < mntot
        return jnp.where(go_right, mid, lo), jnp.where(go_right, hi, mid)

    lo, hi = lax.fori_loop(
        0, N_BISECT, body, (jnp.zeros_like(mntot), mntot)
    )
    return 0.5 * (lo + hi)


def mass_spectrum(mntot, normal_ordering: bool):
    """The three mass eigenvalues (ascending in the usual convention).

    Mirrors nuSIprop.hpp:184-203: NuFIT 5.0 splittings, NO uses dm31,
    IO uses dm32 (negative).
    """
    if normal_ordering:
        dmq_at = constants.DMQ31_NO
        mL = lightest_mass(mntot, constants.DMQ21, dmq_at)
        mn = jnp.stack(
            [
                mL,
                jnp.sqrt(constants.DMQ21 + mL * mL),
                jnp.sqrt(dmq_at + mL * mL),
            ]
        )
    else:
        dmq_at = constants.DMQ32_IO
        mL = lightest_mass(mntot, constants.DMQ21, dmq_at)
        m2 = jnp.sqrt(mL * mL - dmq_at)
        m1 = jnp.sqrt(m2 * m2 - constants.DMQ21)
        mn = jnp.stack([m1, m2, mL])
    return jnp.maximum(mn, MN_FLOOR)
