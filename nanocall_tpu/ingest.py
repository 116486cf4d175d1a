"""Parallel read ingestion: summarize + event filtering in worker processes.

The per-read host work (h5py parsing, abasic/hairpin island detection, event
filtering, initial moment-matching scaling — Fast5_Summary.hpp:138-319) is
GIL-bound numpy/h5py (~5 ms/read), so at e2e scale the streamed pipeline's
critical path is host ingest, not device EM (which overlaps it).  Threads
don't help — h5py holds the GIL on page-cached files and a thread pool is a
measured 3x regression (read_pipeline.summarize_many) — but fork()ed worker
processes do.

Workers are jax-free: read_pipeline/fast5_io import only numpy + h5py, and
the pool is created on first use, which in every flow precedes the first
device dispatch, so the fork carries no live device-client threads.  The one
exception is coordinator'd multi-host runs, where
jax.distributed.initialize spawns gRPC client threads up front — the CLI
calls ensure_pool() BEFORE it so the fork still happens single-threaded.
Results stream back in file order so the EM dispatcher can consume them
as they arrive (device chunks overlap later files' ingest).

This is the batched pipeline's stand-in for the reference's thread-pool ingest
overlap (pfor in train_reads, nanocall.cpp:282-290): there, per-read
summarize cost hides inside the per-read worker threads; here, summarize
feeds *batched* device EM, so it gets its own process pool ahead of the
dispatcher instead.
"""

from __future__ import annotations

import collections
import logging
import os

from . import read_pipeline

log = logging.getLogger("nanocall")

_executor = None
_executor_workers = 0

# files per task: large enough to amortize the (models, cfg) pickle per
# task, small enough to stream results back promptly
_CHUNK = 8


def auto_workers() -> int:
    n = os.cpu_count() or 1
    return max(1, min(n - 1, 6))


def _resolve_workers(workers: int) -> int:
    return auto_workers() if workers < 0 else workers


def _get_executor(workers: int):
    global _executor, _executor_workers
    if _executor is not None and _executor_workers == workers:
        return _executor
    if _executor is not None:
        _executor.shutdown(wait=False, cancel_futures=True)
        _executor = None
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    _executor = ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("fork")
    )
    _executor_workers = workers
    return _executor


def _discard_executor() -> None:
    """Drop a failed pool so the NEXT ingest_stream rebuilds it instead of
    getting the same broken executor back from the cache (a
    BrokenProcessPool raises on every later submit — without this, one
    OOM-killed worker would degrade every subsequent call in the process
    to serial ingestion)."""
    global _executor, _executor_workers
    if _executor is not None:
        _executor.shutdown(wait=False, cancel_futures=True)
    _executor = None
    _executor_workers = 0


def ensure_pool(workers: int = -1) -> None:
    """Pre-create the fork pool while the process is still single-threaded.

    Call BEFORE anything that spawns background threads (in particular
    jax.distributed.initialize's gRPC client threads — forking after
    those start is fork-unsafe).  The normal single-host flows need no
    explicit call: their first pool use precedes the first device
    dispatch anyway."""
    workers = _resolve_workers(workers)
    if workers > 1:
        try:
            pool = _get_executor(workers)
            # ProcessPoolExecutor forks workers lazily at first submit(),
            # not at construction — constructing the executor alone would
            # leave the actual fork() to happen later, after gRPC threads
            # exist.  Run one trivial task per worker and wait, so every
            # worker process exists before we return.
            list(pool.map(_warm_task, range(workers)))
        except Exception as e:  # pool is an optimization, never fatal
            log.warning("ingest pool pre-create failed (%s)", e)
            _discard_executor()


def _warm_task(_i):
    """Trivial picklable task used to force eager worker fork (ensure_pool)."""
    return os.getpid()


def _worker_chunk(paths, models, cfg):
    return [
        read_pipeline.summarize(p, models, cfg, return_events=True)
        for p in paths
    ]


def ingest_stream(files, models, cfg):
    """Yield (summary, per-strand events) per fast5 file, in file order.

    With cfg.ingest_workers > 1 (default: auto), files are summarized by a
    persistent fork pool; any pool failure falls back to in-process
    ingestion for the remaining files (per-read errors never surface here —
    summarize catches them and returns num_ed_events == 0, matching
    Fast5_Summary.hpp:311-315 semantics)."""
    workers = _resolve_workers(cfg.ingest_workers)
    if workers <= 1 or len(files) <= _CHUNK:
        for p in files:
            yield read_pipeline.summarize(p, models, cfg, return_events=True)
        return
    chunks = [files[i : i + _CHUNK] for i in range(0, len(files), _CHUNK)]
    done = 0
    # bounded in-flight window: enough chunks to keep every worker busy
    # while the consumer drains, WITHOUT buffering the whole dataset's
    # event arrays in parent RAM (submitting everything up front made peak
    # RSS scale with the run size; the consumer is usually the slow side)
    window = workers * 4
    next_ci = 0
    futs: "collections.deque" = collections.deque()
    try:
        pool = _get_executor(workers)
        while next_ci < len(chunks) and len(futs) < window:
            futs.append(pool.submit(_worker_chunk, chunks[next_ci], models, cfg))
            next_ci += 1
    except Exception as e:
        log.warning("ingest pool unavailable (%s); ingesting in-process", e)
        _discard_executor()
        futs.clear()
        next_ci = len(chunks)
    while futs:
        fut = futs.popleft()
        try:
            results = fut.result()
        except Exception as e:
            log.warning(
                "ingest pool failed (%s); ingesting remaining %d files "
                "in-process", e, len(files) - done,
            )
            for f2 in futs:
                f2.cancel()
            _discard_executor()
            futs.clear()
            break
        del fut  # release the Future's result reference promptly
        try:
            while next_ci < len(chunks) and len(futs) < window:
                futs.append(
                    pool.submit(_worker_chunk, chunks[next_ci], models, cfg)
                )
                next_ci += 1
        except Exception as e:
            log.warning(
                "ingest submit failed (%s); finishing in-process", e
            )
            _discard_executor()
            next_ci = len(chunks)
        for r in results:
            done += 1
            yield r
    for p in files[done:]:
        yield read_pipeline.summarize(p, models, cfg, return_events=True)


def shutdown() -> None:
    """Tear down the worker pool (tests / process exit hygiene)."""
    global _executor
    if _executor is not None:
        _executor.shutdown(wait=False, cancel_futures=True)
        _executor = None
