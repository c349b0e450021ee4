"""Configuration and parameter pytrees.

The 14-parameter constructor of the reference (nuSIprop.hpp:61-68) splits
naturally into two halves for a JAX engine:

* ``Config`` — static, hashable settings that fix array shapes and compiled
  branches (bin counts, orderings, channel toggles). Passed as a static
  argument to jit; each distinct Config compiles once.
* ``PhysicsParams`` — the five runtime-mutable physics parameters
  (nuSIprop.hpp:173-174). A registered pytree: vmap/pjit batch over them,
  which is how parameter-grid scans become one batched launch.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


MARCHES = ("auto", "rank1", "rank1_f32", "trisolve", "trisolve_f32", "loop")


@dataclasses.dataclass(frozen=True)
class Config:
    """Static run configuration (reference ctor optional args).

    Defaults mirror the reference *Python* wrapper defaults
    (nuSIprop.pyx:47-52), including ``phiphi=True``. The reference C++
    ctor defaults differ in exactly that flag (phiphi=False,
    nuSIprop.hpp:65); use ``Config.cpp_defaults()`` for those. Note the
    reference pyx docstring also claims lEmin default 13 while its code
    default is 12 (SURVEY.md §5); we follow the code.
    """

    majorana: bool = True
    non_resonant: bool = True
    normal_ordering: bool = True
    N_bins_E: int = 300
    lEmin: float = 12.0
    lEmax: float = 17.0
    zmax: float = 5.0
    flav: int = 2
    phiphi: bool = True
    # Source model: "dsnb" is the active source of the reference fork
    # (Fermi-Dirac spectrum weighted by the core-collapse SN rate,
    # nuSIprop.hpp:659-662); "powerlaw" is the upstream SFR power-law
    # source (nuSIprop.hpp:648-657, commented out there).
    source: str = "dsnb"
    # March implementation for the per-z energy sweep. The policy reads
    # this Config alone (transport._resolve_march), never the backend,
    # so the CPU tests run exactly what an accelerator runs:
    #   "auto"     — "trisolve" for non-resonant configs, "rank1"
    #                otherwise (both float64);
    #   "rank1"    — O(NE) associative-scan sweep exploiting the exact
    #                rank-one structure of the s-channel alpha kernel
    #                (the reference's alpha_cum fast path,
    #                nuSIprop.hpp:261-264, 273-278);
    #   "rank1_f32" — rank1 preconditioned by the free-streaming
    #                solution and run in float32; ~1e-5 round-off vs
    #                rank1;
    #   "trisolve" — the sweep as one scalar triangular solve (general
    #                kernels, f64);
    #   "trisolve_f32" — trisolve preconditioned by the free-streaming
    #                solution and run in float32 against the normalized
    #                f32 alpha table (non-resonant configs);
    #   "loop"     — literal descending-bin lax.scan (reference-shaped;
    #                kept as the cross-validation oracle).
    march: str = "auto"
    # lax.scan unroll factor for the z march (rank1_f32 path): >1 lets
    # XLA fuse consecutive z-steps, cutting per-step launch latency on
    # the latency-bound small-batch regime. Exact same arithmetic.
    march_unroll: int = 1
    # Kernel-table build precision:
    #   "auto" — the builders of the march's own precision: the float64
    #            closed forms (kernels.py/kernels_nr.py) for the f64
    #            marches, the float32 builds (kernels_f32 /
    #            kernels_nr_f32) for rank1_f32 and trisolve_f32;
    #   "f64"  — the float64 builders;
    #   "f32"  — the float32 builds: the s-channel closed forms in f32
    #            for march='rank1_f32', the matrix-element quadrature
    #            alpha table (kernels_nr_f32) for non-resonant configs.
    #            The quadrature build is more accurate than the f64
    #            closed forms at their cancellation-dominated
    #            sub-resonance entries (module docstrings and
    #            docs/DESIGN.md).
    table_dtype: str = "auto"
    # Out-of-table phi-phi spline lookups: the reference hard-exits
    # (interp.hpp:354-361); this engine clamps by default (documented
    # deviation, MIGRATION.md — clamping keeps long batched scans
    # alive). "raise" restores the reference's strictness: evolve()
    # counts branch-active out-of-table lookups on-device
    # (kernels.pp_extrapolation_counts) and raises host-side if any
    # fired — catching e.g. a bin ratio outside the tables' [0.005,
    # 0.05]-decade delta axis, which the default policy would silently
    # clamp in a production exclusion contour.
    extrapolation: str = "clamp"

    @classmethod
    def cpp_defaults(cls, **kw) -> "Config":
        """Defaults of the C++ constructor (nuSIprop.hpp:61-68)."""
        base = dict(phiphi=False)
        base.update(kw)
        return cls(**base)

    def __post_init__(self):
        if self.flav not in (0, 1, 2):
            raise ValueError(f"flav must be 0, 1 or 2, got {self.flav}")
        from nusiprop_tpu.models import sources as _sources

        if self.source not in _sources.source_names():
            raise ValueError(
                f"unknown source model {self.source!r}; registered: "
                f"{_sources.source_names()} (add your own with "
                "sources.register_source)")
        if self.march == "trisolve_pallas":
            raise ValueError(
                "march='trisolve_pallas' was removed with its fused kernel; "
                "use march='trisolve_f32' (the same float32 tables and "
                "rows) or 'auto'")
        if self.march not in MARCHES:
            raise ValueError(f"unknown march mode {self.march!r}; "
                             f"choose one of {MARCHES}")
        if self.march == "trisolve_f32" and not self.non_resonant:
            raise ValueError(
                "march='trisolve_f32' is a non-resonant march; "
                "s-channel-only configs use march='rank1_f32'")
        if self.march_unroll < 1:
            raise ValueError("march_unroll must be >= 1")
        if self.table_dtype not in ("auto", "f64", "f32"):
            raise ValueError(f"unknown table_dtype {self.table_dtype!r}")
        if (self.table_dtype == "f32" and self.march != "rank1_f32"
                and not (self.non_resonant and self.march
                         in ("auto", "trisolve", "trisolve_f32"))):
            raise ValueError(
                "table_dtype='f32' requires march='rank1_f32' (s-channel "
                "configs) or a non-resonant trisolve/trisolve_f32/auto "
                "config (the f32 alpha-table build)")
        if self.extrapolation not in ("clamp", "raise"):
            raise ValueError(
                f"unknown extrapolation policy {self.extrapolation!r}; "
                "use 'clamp' (engine default) or 'raise' (reference-"
                "strict, interp.hpp:354-361)")
        if self.N_bins_E < 2:
            raise ValueError("need at least 2 energy bins")
        if self.lEmax <= self.lEmin:
            raise ValueError("lEmax must exceed lEmin")


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PhysicsParams:
    """Runtime-mutable physics parameters (nuSIprop.hpp:173-174).

    All leaves are JAX scalars (or batched arrays of a common shape when
    used under vmap):
      mphi  — mediator mass [eV]
      g     — Yukawa coupling
      mntot — sum of neutrino masses [eV]
      si    — spectral index of the injected power-law flux
      norm  — free-streaming flux normalization at 100 TeV
    """

    mphi: jax.Array
    g: jax.Array
    mntot: jax.Array
    si: jax.Array
    norm: jax.Array

    @classmethod
    def create(cls, mphi, g, mntot, si, norm=1.0) -> "PhysicsParams":
        as_f64 = lambda v: jnp.asarray(v, dtype=jnp.float64)
        return cls(as_f64(mphi), as_f64(g), as_f64(mntot), as_f64(si), as_f64(norm))
