"""Observability: stage timing, progress reporting, device profiling.

The reference logs `training user_cpu_secs=` / `basecalling user_cpu_secs=`
(nanocall.cpp:580-581,867-868) and prints `Processed N reads in S seconds`
progress from its thread pool (nanocall.cpp:576-579,862-866).  This module
provides the equivalents plus JAX/XLA device profiling (xprof traces) in
place of the reference's gprof build types (src/CMakeLists.txt:163-164).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time

log = logging.getLogger("nanocall")

# hpptools logger levels (logger.hpp, used via --log; nanocall.cpp:911-912):
# error > warning > info > debug > debug1 > debug2.  debug1/debug2 map to
# custom python levels below DEBUG so `--log debug2` reveals more than
# `--log debug`.
DEBUG1 = 9
DEBUG2 = 8
logging.addLevelName(DEBUG1, "DEBUG1")
logging.addLevelName(DEBUG2, "DEBUG2")
LOG_LEVELS = {
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "debug1": DEBUG1,
    "debug2": DEBUG2,
}


def set_levels_from_options(specs, default=logging.INFO) -> int:
    """Reference --log semantics (Logger::set_levels_from_options,
    nanocall.cpp:911-912): each spec is either `<level>` (sets the default
    level) or `<facility>:<level>` (sets that facility's logger only, e.g.
    `--log Fast5_Summary:debug`).  Returns the default level; facility
    loggers are configured as a side effect."""
    root_level = default
    for spec in specs:
        if ":" in spec:
            fac, _, lvl = spec.partition(":")
            if lvl not in LOG_LEVELS:
                raise SystemExit(f"unknown log level: {lvl!r} (in {spec!r})")
            logging.getLogger(fac).setLevel(LOG_LEVELS[lvl])
        else:
            if spec not in LOG_LEVELS:
                raise SystemExit(f"unknown log level: {spec!r}")
            root_level = LOG_LEVELS[spec]
    return root_level


# -- per-read failure context (global_assert.hpp:21-25) ---------------------
#
# The reference keeps a thread-local context string ("processing read X")
# that ASSERT prints on failure (set per work item, nanocall.cpp:295,624).
# Equivalent here: a contextvar (thread- and task-safe) set around
# each read's host-side work; any exception escaping the block gets the
# context attached as a __notes__ line, and handlers can query it.

import contextvars

_read_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "read_ctx", default=""
)


def current_read() -> str:
    """The read-id context of the current thread/task ('' if none)."""
    return _read_ctx.get()


@contextlib.contextmanager
def read_context(read_id: str):
    """Tag this thread's work with a read id; exceptions escaping the block
    carry `processing read [<id>]` as an exception note (the reference's
    global_assert thread-local message, global_assert.hpp:21-25)."""
    token = _read_ctx.set(read_id)
    try:
        yield
    except Exception as e:
        if hasattr(e, "add_note"):  # PEP 678, python >= 3.11
            e.add_note(f"processing read [{read_id}]")
        raise
    finally:
        _read_ctx.reset(token)


class StageTimer:
    """Wall + process-CPU timing per pipeline stage."""

    def __init__(self):
        self.stages: dict[str, dict] = {}
        # free-form work counters published by pipeline drivers (e.g. the
        # EM driver's device event-round count, for roofline accounting)
        self.counters: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        w0, c0 = time.time(), time.process_time()
        try:
            yield
        finally:
            rec = self.stages.setdefault(name, {"wall_s": 0.0, "cpu_s": 0.0})
            rec["wall_s"] += time.time() - w0
            rec["cpu_s"] += time.process_time() - c0
            log.info(
                "%s wall_secs=%.1f user_cpu_secs=%.1f",
                name, rec["wall_s"], rec["cpu_s"],
            )

    def summary(self) -> dict:
        return dict(self.stages)


class Progress:
    """Counter with periodic stderr reporting, matching the reference's
    `Processed N reads in S seconds` lines."""

    def __init__(self, what: str = "reads", interval_s: float = 2.0,
                 stream=None):
        self.what = what
        self.interval_s = interval_s
        self.count = 0
        self.t0 = time.time()
        self._last = 0.0
        self.stream = stream if stream is not None else sys.stderr
        self._lock = threading.Lock()  # add() is called from fetch workers

    def add(self, n: int = 1) -> None:
        with self._lock:  # count AND interval check: two workers passing
            # the check together would emit interleaved lines
            self.count += n
            now = time.time()
            if now - self._last < self.interval_s:
                return
            self._last = now
            count = self.count
        self.stream.write(
            f"Processed {count:6d} {self.what} in "
            f"{int(now - self.t0):6d} seconds\r"
        )
        self.stream.flush()

    def finish(self) -> None:
        self.stream.write(
            f"Processed {self.count:6d} {self.what} in "
            f"{int(time.time() - self.t0):6d} seconds\n"
        )
        self.stream.flush()


# Fixed, inside the checkout: the cache only hits when every process of a
# deployment looks in the same directory.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Persist compiled XLA programs across processes.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, this sets
    nothing.  Otherwise the cache goes to CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def gpu_info() -> dict:
    """The device JAX computes on, with the card's name and power limit as
    `nvidia-smi` reports them.  A measurement names its device and never
    falls back to the CPU: exits non-zero when JAX's device is no GPU."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX computes on {dev.platform!r} ({dev.device_kind}); "
            f"this runs on the card only"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    name, limit = (x.strip() for x in smi[0].split(",", 1))
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "gpu_name": name,
        "power_limit_w": float(limit.split()[0]) if limit[:1].isdigit()
        else None,
        "nvidia_smi": smi,
    }


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """JAX profiler trace (view with xprof/tensorboard); no-op if dir empty."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("device trace written to %s", trace_dir)
