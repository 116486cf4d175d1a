"""nanocall_tpu: a nanopore HMM basecalling framework in JAX, run on GPUs.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
CPU basecaller nanocall (mateidavid/nanocall): fast5 event ingestion, 6-mer
pore models, a 4096-state stay/step/skip HMM, per-read EM training of
pore-model scaling and transition parameters, strand/hairpin detection, and
batched Viterbi decoding to FASTA, data-parallel over a device mesh.
"""

def _tune_allocator() -> None:
    """Keep large numpy buffers on the glibc heap instead of fresh mmaps.

    This kernel zeroes newly-mapped pages at ~5-10 MB/s (measured: a first
    np.ones of 16 MB costs 0.75-3 s, 100 MB costs 18 s), and glibc munmaps
    freed allocations above the mmap threshold, so EVERY large numpy
    allocation re-pays that first-touch cost — seconds per event-pool
    staging buffer in the pipeline.  Raising the mmap/trim thresholds makes
    the heap grow once to its high-water mark and be reused, after which
    large allocations take milliseconds."""
    import ctypes
    import sys

    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD = 1 GB
        libc.mallopt(-1, 2047 << 20)  # M_TRIM_THRESHOLD (int32 max-ish)
    except Exception:  # non-glibc platforms: best-effort no-op
        pass


_tune_allocator()


def __getattr__(name):
    # lazy git-describe version stamping (src/get-dir-version parity)
    if name == "__version__":
        from .version import get_version

        return get_version()
    raise AttributeError(name)
