"""Cosmology and injected-source models.

Two source models are provided (matching the reference fork, which ships
the upstream power-law source commented out and a DSNB source active):

* ``dsnb``     — Diffuse Supernova Neutrino Background: Fermi-Dirac
                 spectrum at T = 6 MeV integrated analytically with
                 polylogarithms, weighted by the core-collapse supernova
                 rate R_SN(z) (nuSIprop.hpp:607-662). Note this source is
                 *not* scaled by norm_total in the reference fork — the
                 ``norm``/``si`` parameters do not affect the DSNB flux.
* ``powerlaw`` — upstream (E/E0)^-si spectrum with SFR redshift evolution
                 (nuSIprop.hpp:648-657), scaled by
                 norm_total = norm / flux_FS_E0.

The free-streaming normalization/energy audit integrals always use the
power-law forms, reproducing the reference's behavior exactly
(nuSIprop.hpp:666-744).
"""

import math

import jax.numpy as jnp

from nusiprop_tpu import constants
from nusiprop_tpu.ops import specfun as sf
from nusiprop_tpu.ops.quadrature import gl3_segmented

PI4 = math.pi**4


def get_nd(z):
    """CnuB number density per mass eigenstate [eV^3] (nuSIprop.hpp:573-580)."""
    return constants.ND_COEFF * (1.0 + z) ** 3


def get_H(z):
    """Hubble parameter [eV] (nuSIprop.hpp:582-589)."""
    return constants.H_COEFF * jnp.sqrt(
        constants.OMEGA_L + constants.OMEGA_M * (1.0 + z) ** 3
    )


def get_SFR(z):
    """Star formation rate, Yuksel et al. 0804.4008 (nuSIprop.hpp:591-605)."""
    zp1 = 1.0 + z
    return (
        zp1 ** (-34.0) + (zp1 / 5161.0) ** 3.0 + (zp1 / 9.06) ** 35.0
    ) ** (-0.1)


def rsn(z):
    """Core-collapse supernova rate (nuSIprop.hpp:607-616)."""
    return get_SFR(z) * constants.RSN_PER_MSUN / constants.M_SOLAR_1E64EV


def dndE_fd(E):
    """Fermi-Dirac DSNB spectral shape (nuSIprop.hpp:618-626)."""
    T = constants.T_DSNB
    return (
        constants.ETOT_DSNB
        * 120.0
        * E**2
        / (42.0 * PI4 * T**4 * (jnp.exp(E / T) + 1.0))
    )


def lum_int_fd(z, E):
    """Antiderivative of the redshifted FD spectrum (nuSIprop.hpp:638-646)."""
    T = constants.T_DSNB
    u = E * (1.0 + z) / T
    x = -jnp.exp(-u)
    # NOTE: log(exp(-u) + 1), NOT log1p(exp(-u)). The reference evaluates
    # this in plain double arithmetic (nuSIprop.hpp:645), where the +1
    # absorbs exp(-u) entirely for u >~ 36.7; the golden output's
    # high-energy tail embeds that rounding, so we reproduce it exactly.
    return (constants.ETOT_DSNB * 120.0 / (42.0 * PI4 * T**2)) * (
        -E * E * (1.0 + z) * jnp.log(-x + 1.0) / T
        + 2.0 * E * sf.li2(x)
        + 2.0 * T * sf.li3(x) / (1.0 + z)
    )


def lum_dsnb(z, Em, Ep):
    """int_Em^Ep L(z, E(1+z)) dE for the DSNB source (nuSIprop.hpp:659-662)."""
    return (lum_int_fd(z, Ep) - lum_int_fd(z, Em)) * rsn(z)


def lum_powerlaw(z, Em, Ep, si, norm_total):
    """Upstream power-law x SFR source (nuSIprop.hpp:648-657)."""
    E0 = constants.E0_PIVOT
    return (
        norm_total
        / 3.0
        * get_SFR(z)
        * (
            Ep * (Ep / E0 * (1.0 + z)) ** (-si)
            - Em * (Em / E0 * (1.0 + z)) ** (-si)
        )
        / (1.0 - si)
    )


def flux_fs_e0(si, zmax_eff):
    """Free-streaming flux at the pivot energy (nuSIprop.hpp:666-692).

    100-segment 3-point GL of (1+z)^-si SFR(z)/H(z) over [0, zmax_eff].
    Note zmax_eff is the last grid node z[-1], which slightly exceeds the
    requested zmax because the z grid is locked to the bin ratio
    (nuSIprop.hpp:128 reassigns the member).
    """

    def f(z):
        return (1.0 + z) ** (-si) * get_SFR(z) / get_H(z)

    return gl3_segmented(f, 0.0, zmax_eff, constants.N_INTEG_Z)


def lum_times_E(z, Em, Ep, si, norm_total):
    """int E L(z, E(1+z)) dE, power-law source (nuSIprop.hpp:731-744).

    Keeps the reference's Taylor guard at si ~= 2 (roundoff control) —
    including its linearized form.
    """
    E0 = constants.E0_PIVOT
    pref = norm_total * get_SFR(z) * (E0 / (1.0 + z)) ** si
    lp, lm = jnp.log(Ep), jnp.log(Em)
    near2 = jnp.abs(si - 2.0) < 1e-5
    safe_pow = jnp.where(near2, 1.0, 2.0 - si)
    taylor = lp - lm + (2.0 - si) / 2.0 * (lp * lp - lm * lm)
    exact = (Ep ** (2.0 - si) - Em ** (2.0 - si)) / safe_pow
    return pref * jnp.where(near2, taylor, exact)


def energy_fs(lEmin, lEmax, si, norm_total, zmax_eff):
    """Total free-streaming energy (nuSIprop.hpp:694-729)."""
    Em = 10.0**lEmin
    Ep = 10.0**lEmax

    def f(z):
        return lum_times_E(z, Em, Ep, si, norm_total) / get_H(z)

    return gl3_segmented(f, 0.0, zmax_eff, constants.N_INTEG_Z)


def lum_rows_extended(name, edges, zi, jdx, si, norm_total):
    """All per-(z-node, bin) source integrals from ONE edge-ladder sweep.

    The grid-coupling trick (grids.py) makes every redshifted bin edge
    land exactly on the extended log-uniform edge ladder:
    ``E_j (1+z[i]) = edges[j + i]``. Both built-in sources factorize over
    it —

    * dsnb:  lum_int_fd(z, E) = lum_int_fd(0, E(1+z)) / (1+z), so the
      polylogarithm antiderivative is evaluated once per edge
      (parameter-independent!) instead of once per (node, bin):
      O(NE+Nz) special-function calls instead of O(NE*Nz).
    * powerlaw:  E (E(1+z)/E0)^-si = E0 (E(1+z)/E0)^(1-si) / (1+z),
      one pow per edge per parameter point.

    ``edges``: (K,) ladder; ``zi``: (T,) node redshifts; ``jdx``: (T, NE)
    int index of each bin's LOWER edge on the ladder (upper edge is
    jdx+1). Returns (T, NE) bin integrals, or None when ``name`` is a
    registered custom source (caller falls back to the per-node path).
    The (E0-relative) groupings keep every intermediate inside float32's
    exponent range for si <= ~4.
    """
    if name == "dsnb":
        F0 = lum_int_fd(0.0, edges)
        dF = F0[1:] - F0[:-1]
        pref = rsn(zi) / (1.0 + zi)
        return pref[:, None] * dF[jdx]
    if name == "powerlaw":
        p = (edges / constants.E0_PIVOT) ** (1.0 - si)
        dP = p[1:] - p[:-1]
        pref = (norm_total / 3.0) * get_SFR(zi) * (
            constants.E0_PIVOT / (1.0 - si)) / (1.0 + zi)
        return pref[:, None] * dP[jdx]
    return None


# ---------------------------------------------------------------------------
# Source registry (generalized sources beyond the reference's two models)
# ---------------------------------------------------------------------------

# name -> fn(z, Em, Ep, si, norm_total) returning the per-bin source
# integral int_Em^Ep L(z, E(1+z)) dE. Must be jittable (pure jnp).
_REGISTRY = {
    "dsnb": lambda z, Em, Ep, si, norm_total: lum_dsnb(z, Em, Ep),
    "powerlaw": lum_powerlaw,
}


def register_source(name: str, fn) -> None:
    """Register a custom injected-source model.

    ``fn(z, Em, Ep, si, norm_total) -> (NE,)`` must be a pure, jittable
    function of JAX arrays: the per-bin integral of the comoving source
    luminosity over [Em, Ep] at redshift z (the reference hardcodes its
    two models at nuSIprop.hpp:638-662; here any redshift evolution or
    spectral shape plugs in and inherits batching/sharding for free).
    After registering, pass ``source=name`` to Config/Evolver.
    """
    if name in ("dsnb", "powerlaw"):
        raise ValueError(f"cannot override built-in source {name!r}")
    if not callable(fn):
        raise TypeError("source fn must be callable")
    _REGISTRY[name] = fn


def source_names():
    return tuple(sorted(_REGISTRY))


def lum(name: str, z, Em, Ep, si, norm_total):
    """Evaluate a registered source's per-bin integral."""
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown source {name!r}; registered: {source_names()}"
        ) from None
    return fn(z, Em, Ep, si, norm_total)
