"""Bucket/chunk sizing: the HBM budget models for decode and EM chunks."""

import numpy as np

from nanocall_tpu import batching
from nanocall_tpu.basecall import BP_MEM_BUDGET, _EMDriver
from nanocall_tpu.config import Config


def test_decode_batch_cap_by_backpointer_budget():
    # B*T*n uint8 <= budget
    B = batching.batch_size_for(8192, 1 << 30, BP_MEM_BUDGET, 4096)
    assert B * 8192 * 4096 <= BP_MEM_BUDGET
    assert batching.batch_size_for(128, 64, BP_MEM_BUDGET, 4096) == 64  # cap
    assert batching.batch_size_for(1 << 40, 64, BP_MEM_BUDGET, 4096) == 1


def test_em_chunk_sized_by_fwbw_tensors_not_backpointers():
    """EM rows materialize the fused round's alphas (4 seqs x 1 float32
    tensor = 16 B/cell; the legacy --trans path costs 96).  A large
    --scaling-num-events must shrink the group count so that tensor stays
    within budget, instead of OOMing (the old sizing used the decode
    path's 1 B/cell and kept G=128 at any T)."""
    drv = _EMDriver([], {}, Config(scaling_num_events=4096))
    G = drv._full_batch(2048)
    assert G * 4 * 2048 * 4096 * 4 <= BP_MEM_BUDGET
    assert G < 128
    # --trans (legacy materialized round + doubled E-step) sizes 6x
    # smaller chunks at the same bucket
    drv_tr = _EMDriver([], {}, Config(scaling_num_events=4096))
    drv_tr.default_ops = object()  # non-None marks the loaded-table path
    assert drv_tr._full_batch(2048) <= max(1, G // 6)
    # the default workload shape is unchanged (compiled-shape stability):
    # scaling_num_events=200 -> T bucket 128 -> full 128-group chunks
    assert _EMDriver([], {}, Config())._full_batch(128) == 128


def test_make_buckets_chunks_are_uniform():
    lengths = [100, 120, 4000, 4100, 4096, 90]
    out = batching.make_buckets(lengths, 64, BP_MEM_BUDGET, 4096)
    seen = set()
    for T, B, chunks in out:
        for c in chunks:
            assert 0 < len(c) <= B  # the caller pads short chunks to B
            seen.update(c)
        assert all(batching.bucket_length(lengths[i]) == T
                   for c in chunks for i in c)
    assert seen == set(range(len(lengths)))


def test_align_never_exceeds_memory_cap():
    """Sharded (align > 1) batch sizes round DOWN to a multiple of align:
    rounding up let B exceed both --bucket-max-batch and the backpointer
    budget (mem cap 10, align 8 used to yield 16 — a 1.6x HBM overshoot at
    the 100k-event shape)."""
    T = batching.bucket_length(100_000)
    cap = batching.batch_size_for(T, 12, BP_MEM_BUDGET, 4096)
    assert cap == 10
    (bT, bB, chunks), = batching.make_buckets(
        [100_000] * 12, 12, BP_MEM_BUDGET, 4096, align=8)
    assert bB == 8  # floor(10 / 8) * 8, within both caps
    # align itself is the floor when align > cap (every shard needs a slot)
    (_, bB2, _), = batching.make_buckets(
        [100_000], 12, BP_MEM_BUDGET, 4096, align=16)
    assert bB2 == 16


def test_long_read_bucket_math():
    """Bucket math at the reference's 100k-event cap (nanocall.cpp:65):
    T quantizes to the next 2048 multiple and the HBM budget caps the
    batch at 8 rows (3.3 GiB of backpointers fits the 4 GiB budget)."""
    from nanocall_tpu.basecall import BP_MEM_BUDGET

    T = batching.bucket_length(100_000)
    assert T == 100_352
    B = batching.batch_size_for(T, 256, BP_MEM_BUDGET, 4096)
    assert B == 10  # cap; make_buckets quantizes need=1 -> 8
    (bT, bB, chunks), = batching.make_buckets([100_000], 256, BP_MEM_BUDGET,
                                              4096)
    assert (bT, bB) == (100_352, 8)
    assert 8 * bT * 4096 <= BP_MEM_BUDGET
