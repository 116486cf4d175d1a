"""Enumeration of the pipeline's compiled-program shape budget.

Every new program shape costs a compile, so the dispatch drivers are
designed to emit tensors only from small quantized shape ladders
(batching.make_buckets quant rungs, pow2 pool/bank arities).  The budget
was sized for the previous accelerator, whose compiles took minutes per
shape; compile time per shape on the H100 is not yet measured.  This module is the single enumeration of that budget:

- tools/warm_cache.py executes the enumeration once per machine (over
  the production-common length buckets and, in full mode, every pool
  rung) so standard production runs never pay a mid-pipeline compile --
  workloads off the warmed slice (length buckets < 2048, sharded
  align > 1 runs) compile their shapes on first contact and amortize
  through the persistent cache;
- tests/test_shapes.py sweeps the REAL driver sizing functions
  (_DecodeDriver._full_batch, _EMDriver._full_batch, make_buckets,
  EventPool pow2 quantization) over adversarial workload sizes and
  asserts every shape they can produce is listed here — a tripwire for
  changes that silently mint new compiled shapes (one un-warmed shape
  stalls a run mid-pipeline for its compile).

The reference has no analogue: its C++ inner loops take any (n_events,
4096) extent (Viterbi.hpp:44-99).  Shape quantization is the compiled
program's replacement for that flexibility.
"""

from __future__ import annotations

from . import batching, kmer
from .config import Config

# Backpointer HBM budget for decode buckets (consumed by basecall.py's
# drivers).  The compiled decode program's peak HBM is ~2.5x the bp
# tensor (XLA keeps the forward scan's ys buffer plus the traceback
# scan's input copy).  4GB was sized for the previous accelerator's 16 GB
# of HBM; it is safe on an 80 GB H100 and not re-tuned there.
BP_MEM_BUDGET = 4 << 30

#: pow2 pool-row arities (EventPool._finalize: Pq = next_pow2(rows)).
#: The ladder is unbounded in principle -- a run with >1024 strands in
#: one length bucket compiles the next pow2 once (persistent-cached,
#: logarithmically many shapes in workload size); 1024 covers the
#: standard 512-read 2D workload (~768 strands + growth headroom), so
#: warm_cache pre-warms through it.
POOL_RUNGS = (8, 16, 32, 64, 128, 256, 512, 1024)

#: quantized batch rungs below the cap (make_buckets default quant) and
#: the score-chunk extension (basecall._DecodeDriver._flush)
PATH_QUANT = (8, 64)
SCORE_QUANT = (8, 64, 256, 1024)


def length_rungs(max_events: int, min_bucket: int = batching.MIN_BUCKET):
    """Every padded bucket length reachable for reads up to max_events
    (batching.bucket_length's ladder: pow2 to 2048, then 2048-multiples)."""
    out = []
    t = min_bucket
    while t <= 2048:
        out.append(t)
        t *= 2
    t = 4096
    top = batching.bucket_length(max(max_events, 1), min_bucket)
    while t <= top:
        out.append(t)
        t += 2048
    return out


def _floor_align(b: int, align: int) -> int:
    return max(align, (b // align) * align) if align > 1 else b


def path_bp_budget(T: int) -> int:
    """Backpointer-byte budget for a with_path GROUPED decode chunk at
    bucket T.  Below TCHUNK_MIN_T the full-scan program's ~2.5x peak
    model applies (BP_MEM_BUDGET).  At or above it, dispatch selects the
    chunked-time program (ops.hmm.viterbi_decode_grouped_tchunk), whose
    peak is ~(1 + 1.5/C)x of the bp bytes — holding the same
    2.5x*BP_MEM_BUDGET peak allowance, the admissible bp bytes grow
    ~2-2.5x, and with them the long-read batch."""
    if T >= batching.TCHUNK_MIN_T:
        C = -(-T // batching.tchunk_len(T))
        return int(BP_MEM_BUDGET * 2.5 / (1 + 1.5 / C))
    return BP_MEM_BUDGET


def path_chunk_batches(cfg: Config, T: int, align: int = 1):
    """Every batch size a path-decode chunk can run at for bucket T:
    the full-chunk cap (_DecodeDriver._full_batch with_path=True, using
    the chunked-program budget for long buckets) plus the leftover quant
    rungs below it (_flush -> make_buckets quant, which keeps the
    conservative BP_MEM_BUDGET cap) and the sparse-kind cap (sparse
    chunks always run the full-scan generic kernel)."""
    n = kmer.n_states(cfg.kmer_size)
    cap = batching.batch_size_for(T, cfg.bucket_max_batch,
                                  path_bp_budget(T), n)
    legacy = batching.batch_size_for(T, cfg.bucket_max_batch, BP_MEM_BUDGET, n)
    rungs = {q for q in PATH_QUANT if q <= cap} | {cap, legacy}
    return sorted({_floor_align(b, align) for b in rungs})


def score_chunk_batches(cfg: Config, T: int, align: int = 1):
    """Every batch size a score-only chunk can run at for bucket T.

    With score_max_batch=0 (default) score chunks share the path ladder;
    otherwise the cap comes from the no-backpointer memory model snapped
    to SCORE_QUANT, and leftovers use the same rung set
    (_DecodeDriver._full_batch/_flush with_path=False)."""
    if not cfg.score_max_batch:
        return path_chunk_batches(cfg, T, align)
    cap = batching.batch_size_for(
        T, cfg.score_max_batch, BP_MEM_BUDGET, 1, bytes_per_cell=60
    )
    cap = max(q for q in SCORE_QUANT if q <= max(cap, 8))
    cap = _floor_align(cap, align)
    rungs = {q for q in SCORE_QUANT if q <= cap} | {cap}
    return sorted({_floor_align(b, align) for b in rungs})


def decode_chunk_shapes(cfg: Config, Ts, pool_rungs=None, align: int = 1):
    """(T, B, P, with_path) for every grouped-kernel pooled decode chunk
    program the driver can dispatch over the given length buckets.

    P is the pow2 pool arity; production pairs a chunk only with its own
    T-bucket's pool, whose arity is the pow2 cover of that bucket's
    strand count -- all rungs up to the workload's cover are reachable
    because the pool finalizes incrementally during ingest."""
    if pool_rungs is None:
        pool_rungs = POOL_RUNGS
    out = []
    for T in Ts:
        for wp, batches in (
            (True, path_chunk_batches(cfg, T, align)),
            (False, score_chunk_batches(cfg, T, align)),
        ):
            for B in batches:
                for P in pool_rungs:
                    out.append((T, B, P, wp))
    return out


def train_chunk_batches(cfg: Config, T: int | None = None, align: int = 1,
                        with_trans_table: bool = False):
    """Every EM group-batch size G for a training bucket (quant {8, 64}
    + the memory-capped full chunk; _EMDriver._full_batch /
    finish-phase bucketing).  T defaults to the bucket of the standard
    scaling subsequence length (scaling_num_events / 2)."""
    if T is None:
        T = batching.bucket_length(max(1, cfg.scaling_num_events // 2))
    n = kmer.n_states(cfg.kmer_size)
    # fused streaming round materializes only alphas (16 B/cell);
    # --trans forces the legacy round with a doubled E-step (96) — must
    # mirror basecall._EMDriver._bytes_per_cell
    bpc = 96 if with_trans_table else 16
    cap = batching.batch_size_for(T, cfg.train_group_batch, BP_MEM_BUDGET, n,
                                  bytes_per_cell=bpc)
    rungs = {q for q in PATH_QUANT if q <= cap} | {cap}
    return sorted({_floor_align(b, align) for b in rungs})
