"""Small shared utilities.

`Stopwatch` reproduces the reference's Optimization::Util::Stopwatch
tick/tock chrono wrapper (Optimization/Util/Stopwatch.h:15-29) — the timer
behind every reported time in the reference driver (dist_pgo.cpp:496-521).
`tock(sync=...)` first waits for the given device arrays, because JAX
dispatch returns before the device has finished.
"""

from __future__ import annotations

import os
import time

import jax


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry-point script.

    The cache lives in $JAX_COMPILATION_CACHE_DIR when that is set, else in
    `.jax_cache` at the root of this checkout (a fixed path, so a rerun in
    the same checkout finds its entries). Returns the directory. Importing
    the library sets no cache; only the scripts call this."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


class Stopwatch:
    """tick()/tock() wall-clock timer; tock returns seconds since tick."""

    def __init__(self):
        self._t0 = None

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock(self, sync=None) -> float:
        if sync is not None:
            jax.block_until_ready(sync)
        if self._t0 is None:
            raise RuntimeError("tock() before tick()")
        return time.perf_counter() - self._t0
