"""Multi-host execution: file sharding + output merging.

Pod-scale streaming (SURVEY.md §7, BASELINE.json config 5): each host
process runs the full pipeline over its shard of the input fast5 files
(reads are independent — pure data parallelism over DCN-free work), writes
a shard FASTA, and host 0 merges shards in global input order so the final
FASTA matches a single-host run ordering (the reference's ordered-chunk
contract, nanocall.cpp:859-861).

Per-host device parallelism (DataSharder over local devices) composes
underneath; no cross-host collectives are required for basecalling, and EM
statistics reduce per-read (SURVEY.md §2.10).
"""

from __future__ import annotations

import os

import jax


def init_distributed(coordinator: str, num_processes: int, process_id: int) -> None:
    """Initialize JAX multi-process runtime (call before any jax op)."""
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def partition_files(files: list, process_id: int, num_processes: int) -> list:
    """Contiguous partition of the input file list for one host.

    Contiguous (not round-robin) so each shard's FASTA is a contiguous run
    of the global input order and the merge is a simple concatenation.
    """
    n = len(files)
    per = (n + num_processes - 1) // num_processes
    return files[process_id * per : (process_id + 1) * per]


def shard_output_path(output: str, process_id: int, num_processes: int) -> str:
    if num_processes <= 1:
        return output
    base = output or "out.fa"
    return f"{base}.shard{process_id:04d}"


def remove_stale_shard(output: str, process_id: int,
                       num_processes: int) -> None:
    """Unlink this host's shard path at run START.

    The coordinator-less merge treats shard EXISTENCE as completeness, so
    a shard left by a previous failed run must not be mistakable for this
    run's output: each host clears its own target before doing any work
    (a host that crashes mid-run then leaves no shard, and the merge
    fails loudly instead of silently concatenating stale basecalls).
    A host that never launches at all still leaves its old shard behind —
    use --coordinator (barrier'd runs) when that matters."""
    path = shard_output_path(output, process_id, num_processes)
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def merge_shards(output: str, num_processes: int, cleanup: bool = True) -> None:
    """Concatenate shard FASTAs into the final output (host 0 only).

    A missing shard raises rather than silently truncating the merged
    output — a host that produced no shard means the run is incomplete
    (empty inputs still write an empty shard file)."""
    shards = [
        shard_output_path(output, pid, num_processes)
        for pid in range(num_processes)
    ]
    missing = [s for s in shards if not os.path.exists(s)]
    if missing:
        raise FileNotFoundError(
            f"cannot merge {output}: missing shard(s) {missing} — did every "
            f"host finish its run?"
        )
    import shutil

    # write-then-rename, shards deleted only AFTER the rename: an IO
    # failure mid-merge (disk full, transient NFS error) must neither
    # destroy shards that were already copied nor leave a truncated file
    # under the final name (the same exists-means-complete contract the
    # per-shard writers keep, cli.py write-then-rename)
    tmp = output + ".tmp"
    try:
        with open(tmp, "wb") as out:
            for shard in shards:
                with open(shard, "rb") as fh:
                    shutil.copyfileobj(fh, out)  # constant memory per shard
        os.replace(tmp, output)
    except BaseException:
        # a failed merge (disk full, IO error) must not leave a partial
        # .tmp behind — shards stay, the tmp goes, the caller retries
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    if cleanup:
        for shard in shards:
            os.remove(shard)


def barrier(name: str = "nanocall") -> None:
    """Cross-host synchronization point."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
