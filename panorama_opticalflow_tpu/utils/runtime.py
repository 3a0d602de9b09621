"""Runtime initialisation: logging, crash handlers, timers, device setup.

Counterpart of the reference's initOpticalFlow (CPU/util.cpp:48-120):
glog -> Python logging, the terminate-handler + 12 signal handlers with
backtrace() stack dumps -> faulthandler on the same fatal signals, wall
timers -> perf_counter, and additionally a persistent XLA compilation
cache.
"""

from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import signal
import time

log = logging.getLogger("panostitch")


def init_runtime(verbose: bool = True, compilation_cache: bool = True) -> None:
    """Install logging, fatal-signal stack dumps, and the XLA compile
    cache.  Safe to call more than once."""
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    faulthandler.enable()
    # the reference registers SIGABRT/SIGBUS/SIGFPE/SIGILL/SIGINT/SIGQUIT/
    # SIGSEGV/SIGTERM... (CPU/util.cpp:103-119); faulthandler covers the
    # fatal ones, register the rest for a stack dump without exiting.
    for sig in (signal.SIGTERM, signal.SIGQUIT):
        with contextlib.suppress((OSError, ValueError, RuntimeError)):
            faulthandler.register(sig, chain=True)
    if compilation_cache:
        cache_dir = compilation_cache_dir()
        if cache_dir is not None:
            import jax

            jax.config.update("jax_compilation_cache_dir", cache_dir)
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              1.0)


def compilation_cache_dir() -> str | None:
    """Where init_runtime puts the persistent compile cache: nowhere
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that variable
    itself), otherwise the fixed ``<repo>/.cache/xla`` -- a fixed path,
    because the path is part of the cache key."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".cache", "xla")


def time_call(fn, *args, iters: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` over ``iters`` warm calls,
    each ending in ``block_until_ready`` (the first, compiling call is
    not counted)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return sorted(times)[len(times) // 2]


class StageTimer:
    """Per-part and total wall timing (CPU/main.cpp:62,103-108), plus
    jax.profiler hooks when PANOSTITCH_TRACE_DIR is set."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        trace_dir = os.environ.get("PANOSTITCH_TRACE_DIR")
        ctx = contextlib.nullcontext()
        if trace_dir:
            import jax

            ctx = jax.profiler.trace(os.path.join(trace_dir, name))
        t = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t
        self.stages.append((name, dt))
        log.info("%s finished! RUNTIME (sec) = %.3f", name, dt)

    def total(self) -> float:
        dt = time.perf_counter() - self.t0
        log.info("TotalRunTime (sec) = %.3f", dt)
        return dt
