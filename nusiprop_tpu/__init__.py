"""nusiprop_tpu — a neutrino self-interaction cascade engine in JAX.

Evolves an astrophysical neutrino flux from redshift ``zmax`` to ``z=0`` in
the presence of scalar neutrino self-interactions with the cosmic neutrino
background, matching the physics of the reference C++ implementation
(quarkquartet/nuSIprop; arXiv:2107.13568) as array programs: every kernel
table is a vectorized JAX program, the redshift march is a
``jax.lax.scan``, and parameter-grid scans batch via ``vmap`` and shard
over device meshes via ``jax.sharding``.

The engine requires float64 (the evolved flux spans ~60 decades); importing
this package enables JAX x64 mode.
"""

import pathlib as _pathlib

import jax as _jax

# The physics requires float64: the golden-configuration flux spans
# 1e11 .. 1e-57 (cf. reference output/data_massless.txt), far beyond
# float32 range.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR
# itself; when it is unset, the cache lives at one fixed path inside
# the checkout (listed in .gitignore). The path is part of the cache's
# key, so a directory that moved would never hit.
CACHE_DIR = _pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"

if _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))

from nusiprop_tpu.api import Evolver, pyprop
from nusiprop_tpu.models.sources import register_source
from nusiprop_tpu.config import Config, PhysicsParams
from nusiprop_tpu.models.diagnostics import KernelAudit, audit_kernels
from nusiprop_tpu.models.mixing import flavor_coupling_to_Q
from nusiprop_tpu.models.transport import (
    EvolveResult,
    check_energy_conservation,
    evolve,
    evolve_general,
)
from nusiprop_tpu.fit import FitResult, fisher, fit, spectral_loss
from nusiprop_tpu.parallel.scan import (
    checkpointed_grid_scan,
    grid_scan,
    param_grid,
    sharded_grid_scan,
    stack_params,
)

__version__ = "0.1.0"

__all__ = [
    "Evolver",
    "KernelAudit",
    "audit_kernels",
    "register_source",
    "evolve_general",
    "flavor_coupling_to_Q",
    "pyprop",
    "EvolveResult",
    "Config",
    "PhysicsParams",
    "evolve",
    "check_energy_conservation",
    "FitResult",
    "fisher",
    "fit",
    "spectral_loss",
    "checkpointed_grid_scan",
    "grid_scan",
    "param_grid",
    "sharded_grid_scan",
    "stack_params",
]
