"""Test configuration: the CPU with 8 virtual devices, float64 enabled.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count=8). The platform is the CPU unless
JAX_PLATFORMS says otherwise: tests marked ``gpu`` need a card and are
run on one with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``
(they skip elsewhere); ``python chip_smoke.py`` checks the main path
there.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Set at the config level too (works as long as no backend has been
# initialized yet).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# No persistent compilation cache under pytest: XLA:CPU entries are
# machine code whose cache key does not cover the host's CPU features,
# so an entry written on another host can carry instructions this one
# lacks (seen as cpu_aot_loader feature-mismatch errors and crashes
# inside cache loads). CPU test compiles are cheap; correctness beats
# cache warmth here.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402

# Pin the phi-phi tables to the shipped medium resolution for tests:
# pp_tables.load_default() prefers the largest file in data/, and a
# locally regenerated full-resolution table (800 MB; see
# tools/make_tables.py) would add minutes of load time per test module
# without changing any gated result (medium-vs-full flux delta 1.5e-5,
# ~70x inside the physics gate — tools/validate_full_tables.py).
_MEDIUM = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "pp_tables_medium.npz")
if os.path.exists(_MEDIUM) and "NUSIPROP_PP_TABLES" not in os.environ:
    os.environ["NUSIPROP_PP_TABLES"] = _MEDIUM


@pytest.fixture(autouse=True, scope="module")
def _clear_jit_caches_between_modules():
    """Release compiled executables after each test module.

    A full-suite run compiles many hundreds of XLA:CPU executables into
    one process; on some hosts LLVM's JIT eventually segfaults inside a
    later compile (observed: Fatal Python error in
    jax/_src/compiler.py backend_compile_and_load at ~test 286 of 293,
    reproducible across runs, while every module passes in isolation —
    i.e. accumulated JIT state, not any single program, is the trigger).
    Dropping the caches at module boundaries bounds resident compiled
    code; modules rarely share jitted shapes, so the recompile cost is
    noise against the suite's runtime.
    """
    yield
    jax.clear_caches()
    # lru_cache-held closures (transport/scan jit wrappers) pin their
    # executables; clear the library-level memoizers too.
    from nusiprop_tpu.models import transport
    from nusiprop_tpu.parallel import scan as pscan

    for mod in (transport, pscan):
        for name in dir(mod):
            fn = getattr(mod, name)
            if hasattr(fn, "cache_clear"):
                fn.cache_clear()
