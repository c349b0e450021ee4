"""Lightweight profiling helpers.

The reference has no tracing or timing at all (SURVEY.md §5); these
are: a wall-clock timer fenced with ``jax.block_until_ready``, a context
manager around ``jax.profiler`` traces viewable in TensorBoard/Perfetto,
and the device record every measurement is printed with.
"""

import contextlib
import subprocess
import time

import jax


class Timer:
    """Wall-clock timer that fences device work: ``stop(x)`` waits for
    ``x`` (any pytree of arrays) with ``jax.block_until_ready`` before
    reading the clock, so a lap never measures just the enqueue."""

    def __init__(self):
        self.laps = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence_on=None):
        if fence_on is not None:
            jax.block_until_ready(fence_on)
        lap = time.perf_counter() - self._t0
        self.laps.append(lap)
        return lap

    @property
    def best(self):
        return min(self.laps) if self.laps else float("nan")

    @property
    def mean(self):
        return sum(self.laps) / len(self.laps) if self.laps else float("nan")


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a jax.profiler trace of the enclosed block.

    View with ``tensorboard --logdir <log_dir>`` or upload the contained
    .trace.json.gz to Perfetto.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_record() -> dict:
    """{"platform", "kind", "count"} of the default backend's devices,
    as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_power_limits() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi prints
    them. A card set below its maximum power runs slower under load, so
    every timing is reported beside these lines."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]
