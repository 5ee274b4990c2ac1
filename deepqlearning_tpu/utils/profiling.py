"""Profiling and debug hooks.

Reference has none built in (SURVEY.md §5.1 — dev-time ``@btime`` only);
here we expose ``jax.profiler`` traces and a NaN-check switch as first-class
utilities.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard / Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def enable_nan_checks(enabled: bool = True):
    """Debug-NaN mode (SURVEY.md §5.2): every jitted output is checked."""
    jax.config.update("jax_debug_nans", enabled)


def require_gpu():
    """Return ``jax.devices()[0]`` if it is an NVIDIA GPU, else raise.

    Every timing path calls this first: a time taken on another backend is
    never reported under a device metric's name, and nothing falls back.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"this measurement needs an NVIDIA GPU; JAX's first device is "
            f"{dev.platform!r} ({dev.device_kind})"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of every card, as ``nvidia-smi`` reports them.

    A child process that never touches JAX, so it holds no device memory.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def time_calls(fn, x, reps: int):
    """Call ``x = fn(x)`` ``reps`` times after two warm-up calls, each call
    ending in ``jax.block_until_ready`` on its whole output.

    Returns ``(x, seconds)``: the last output and the per-call wall times.
    ``fn`` may donate its argument; the output is threaded back in. Two
    warm-up calls, because an output can differ in type from the first
    input (a weakly typed scalar comes back strongly typed), and the call
    that retraces for it must not land in the timed reps.
    """
    for _ in range(2):
        x = jax.block_until_ready(fn(x))
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x = jax.block_until_ready(fn(x))
        secs.append(time.perf_counter() - t0)
    return x, secs


class StepTimer:
    """Cheap wall-clock EMA of host-loop segment times for the logger."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema = None
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema
            )
        self._last = now
        return self.ema
