"""Bucketed batching of variable-length decode/training work.

Reads (and their per-model decode candidates) vary from tens to 100k
events.  To keep XLA compilation cached and the device fed, tasks are grouped
into power-of-two length buckets; each bucket runs with a fixed batch size
(padded with dummy zero-length elements), so the total number of compiled
(T, B) shapes stays small.
"""

from __future__ import annotations

import math


MIN_BUCKET = 128


def bucket_length(n_events: int, min_bucket: int = MIN_BUCKET) -> int:
    """Padded bucket length: power of two up to 2048, then multiples of
    2048 (pure powers of two waste up to 2x compute on long reads; the
    persistent compilation cache makes the larger shape set cheap)."""
    n = max(n_events, 1)
    if n <= 2048:
        return max(min_bucket, 1 << math.ceil(math.log2(n)))
    return ((n + 2047) // 2048) * 2048


#: chunked-time decode engages for buckets past this length (the 2.5x
#: full-scan HBM peak starts forfeiting real batch there; below it the
#: full-scan program's cap already reaches bucket_max_batch)
TCHUNK_MIN_T = 32768


TCHUNK_LEN = 8192


def tchunk_len(T: int) -> int:
    """Chunk length for the chunked-time decode program
    (ops.hmm.viterbi_decode_grouped_tchunk) at bucket T.  Fixed at
    TCHUNK_LEN (the last chunk is simply shorter — the program loops
    chunks statically, no divisibility constraint): large enough that
    per-chunk scan overhead is noise, small
    enough that the one-live-chunk traceback copy stays a minor term of
    the HBM peak.  T itself when the bucket is short enough that
    chunking buys nothing."""
    return T if T <= TCHUNK_LEN else TCHUNK_LEN


def batch_size_for(T: int, max_batch: int, mem_budget_bytes: int, n_states: int,
                   bytes_per_cell: int = 1) -> int:
    """Cap the bucket batch size so the dominant DP tensor stays within
    budget.  bytes_per_cell is the HBM cost per (T x n_states) cell PER
    BATCH ROW: 1 for decode (uint8 backpointers); EM training rows cost
    4 seqs x 3 float32 tensors (alpha+beta+em) = 48."""
    by_mem = max(1, mem_budget_bytes // (T * n_states * bytes_per_cell))
    return max(1, min(max_batch, by_mem))


def make_buckets(lengths, max_batch: int, mem_budget_bytes: int, n_states: int,
                 align: int = 1, bytes_per_cell: int = 1,
                 quant: tuple = (8, 64)):
    """Group task indices into (T, [chunks of indices]) buckets.

    Returns list of (padded_T, batch_size, [index_chunks]); every chunk has
    exactly batch_size slots (the caller pads short chunks with dummies).
    `align` rounds the batch size up to a multiple (e.g. the data-parallel
    device count, so each shard gets equal work).  `bytes_per_cell` is
    forwarded to batch_size_for (1 for decode backpointers; 48 for EM
    rows' alpha+beta+em tensors).  `quant` is the ladder of allowed batch
    sizes below the cap — a tiny set of shapes: every shape costs a
    compile, so shape stability beats padding waste (the persistent
    cache then amortizes fully); callers with a large cap
    (score-only chunks) pass extra rungs so a small tail is not padded
    to the full cap.
    """
    groups: dict[int, list[int]] = {}
    for i, L in enumerate(lengths):
        groups.setdefault(bucket_length(L), []).append(i)
    out = []
    for T in sorted(groups):
        idxs = groups[T]
        cap = batch_size_for(T, max_batch, mem_budget_bytes, n_states,
                             bytes_per_cell)
        need = min(cap, len(idxs))
        for q in quant:
            if need <= q <= cap:
                B = q
                break
        else:
            B = cap
        if align > 1:
            # round DOWN to a multiple of align: rounding up let B exceed
            # both max_batch and the backpointer-memory cap (e.g. a mem
            # cap of 10 with align=8 became 16 — a 1.6x budget overshoot).
            # align > cap is unavoidable (every shard needs a slot), so
            # floor at align itself.
            B = max(align, (B // align) * align)
        chunks = [idxs[i : i + B] for i in range(0, len(idxs), B)]
        out.append((T, B, chunks))
    return out
