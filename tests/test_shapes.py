"""The compiled-shape budget: every (T, B, P) the dispatch drivers can
emit must come from nanocall_tpu/shapes.py's enumeration.

Every new program shape costs a compile, so tools/warm_cache.py
pre-executes the enumeration and these tests are the tripwire for changes
that silently mint new shapes (one un-warmed pool arity stalls a run
mid-pipeline for its compile)."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from nanocall_tpu import batching, shapes, transitions
from nanocall_tpu.basecall import _DecodeDriver, _EMDriver, EventPool
from nanocall_tpu.config import Config


def _decode_driver(cfg, default_transitions=None):
    # num_shards=1 -> align=1 (the CPU suite exposes 8 virtual devices,
    # which would otherwise activate the sharder); align > 1 is covered
    # explicitly below
    return _DecodeDriver([], {}, cfg, default_transitions=default_transitions)


class _FakeTask:
    def __init__(self, L):
        self.ev = np.zeros(L, np.float32)


def test_length_rungs_cover_bucket_length():
    rungs = set(shapes.length_rungs(100_000))
    for L in [1, 100, 128, 129, 2047, 2048, 2049, 4096, 8191, 8192, 8193,
              50_000, 99_999, 100_000]:
        assert batching.bucket_length(L) in rungs
    assert max(rungs) == batching.bucket_length(100_000) == 100_352


CFGS = [
    Config(num_shards=1),
    Config(num_shards=1, score_max_batch=1024),
    Config(num_shards=1, bucket_max_batch=64),
]


@pytest.mark.parametrize("cfg", CFGS, ids=["default", "score1024", "small"])
def test_decode_full_batch_in_ladder(cfg):
    drv = _decode_driver(cfg)
    for T in shapes.length_rungs(100_000):
        assert drv._full_batch(T, with_path=True) in \
            shapes.path_chunk_batches(cfg, T)
        assert drv._full_batch(T, with_path=False) in \
            shapes.score_chunk_batches(cfg, T)


@pytest.mark.parametrize("cfg", CFGS, ids=["default", "score1024", "small"])
@pytest.mark.parametrize("with_path", [True, False])
def test_flush_shapes_in_ladder(cfg, with_path):
    """Drive the REAL _DecodeDriver._flush over adversarial leftover queue
    sizes and lengths; every dispatched (T, B) must be in the ladder."""
    drv = _decode_driver(cfg)
    seen = []
    drv._dispatch = lambda sub, T, B, kind, wp: seen.append((T, B, wp))
    ladder = (shapes.path_chunk_batches if with_path
              else shapes.score_chunk_batches)
    for qlen in [1, 2, 7, 8, 9, 63, 64, 65, 127, 128, 129, 255, 257, 1025]:
        for L in [50, 2048, 4100, 8192, 99_999]:
            T = batching.bucket_length(L)
            drv.queue = {(T, False, with_path): [_FakeTask(L)] * qlen}
            seen.clear()
            drv._flush(with_path)
            assert seen, f"flush dispatched nothing qlen={qlen} L={L}"
            for sT, sB, swp in seen:
                assert swp is with_path and sT == T
                assert sB in ladder(cfg, T), (
                    f"unenumerated flush shape T={sT} B={sB} wp={swp} "
                    f"qlen={qlen} (ladder {ladder(cfg, T)})"
                )


@settings(max_examples=80, deadline=None)
@given(
    bmb=st.sampled_from([16, 64, 256, 1000]),
    smb=st.sampled_from([0, 64, 700, 1024, 4096]),
    align=st.sampled_from([1, 2, 3, 8]),
    L=st.sampled_from([50, 2048, 8000, 99_999]),
    qlen=st.integers(1, 300),
    wp=st.booleans(),
)
def test_flush_shapes_in_ladder_randomized(bmb, smb, align, L, qlen, wp):
    """Hypothesis sweep over batching configs, shard aligns, lengths, and
    queue sizes: the real _flush/_full_batch may only ever emit enumerated
    shapes (odd --bucket-max-batch/--score-max-batch values must snap into
    the ladder, not mint per-config shapes)."""
    cfg = Config(num_shards=1, bucket_max_batch=bmb, score_max_batch=smb)
    drv = _decode_driver(cfg)
    drv.align = align
    seen = []
    drv._dispatch = lambda sub, T, B, kind, w: seen.append((T, B))
    T = batching.bucket_length(L)
    drv.queue = {(T, False, wp): [_FakeTask(L)] * qlen}
    drv._flush(wp)
    ladder = (shapes.path_chunk_batches if wp
              else shapes.score_chunk_batches)
    assert seen
    for sT, sB in seen:
        assert sB in ladder(cfg, sT, align=align), (
            f"unenumerated shape T={sT} B={sB} cfg=({bmb},{smb}) "
            f"align={align} qlen={qlen} wp={wp}")
    assert drv._full_batch(T, with_path=wp) in ladder(cfg, T, align=align)


def test_flush_shapes_respect_align():
    """Sharded runs floor every batch to a device multiple; the aligned
    ladder must cover those too."""
    cfg = Config()  # num_shards=0 -> all 8 virtual devices, align=8
    drv = _decode_driver(cfg)
    assert drv.align == 8
    seen = []
    drv._dispatch = lambda sub, T, B, kind, wp: seen.append((T, B))
    for qlen in [1, 9, 65, 129]:
        drv.queue = {(8192, False, True): [_FakeTask(8000)] * qlen}
        seen.clear()
        drv._flush(True)
        for sT, sB in seen:
            assert sB % 8 == 0 or sB == 8
            assert sB in shapes.path_chunk_batches(cfg, sT, align=8)


def test_em_full_batch_in_ladder():
    for cfg in (Config(), Config(scaling_num_events=4096)):
        drv = _EMDriver([], {}, cfg)
        for T in (128, 256, 2048):
            assert drv._full_batch(T) in shapes.train_chunk_batches(cfg, T)


def test_em_full_batch_with_trans_table_in_ladder():
    """A loaded --trans table doubles the E-step footprint (both kernels
    computed); the enumeration must track _bytes_per_cell."""
    table = transitions.sparse_from_pairs(
        transitions.structured_to_pairs(transitions.build_structured()), 6)
    cfg = Config(scaling_num_events=4096)
    drv = _EMDriver([], {}, cfg, default_transitions=table)
    assert drv._bytes_per_cell() == 96
    for T in (128, 2048):
        assert drv._full_batch(T) in shapes.train_chunk_batches(
            cfg, T, with_trans_table=True)


class _FakeEv:
    def __init__(self, L):
        self.mean = np.full(L, 60.0, np.float32)
        self.stdv = np.ones(L, np.float32)
        self.start = np.zeros(L, np.float32)
        self._L = L

    def __len__(self):
        return self._L


def test_pool_arity_is_pow2_rung():
    """EventPool device arrays quantize their row count to a pow2 --
    logarithmically many compiled gather shapes in workload size -- and
    the standard 512-read 2D workload's arity (1024) is in POOL_RUNGS
    (so warm_cache pre-warms it)."""
    pool = EventPool()
    T = 128
    added = 0
    for k in [1, 7, 9, 100, 600, 768]:
        while added < k:
            pool.add(added, added % 2, _FakeEv(97))
            added += 1
        pool.upload_now()
        a = pool._arena[T]
        P = np.asarray(pool._dev[T]["mean"]).shape[0]
        # arity = pow2 cover of the arena row count (which exceeds the
        # add count by a few quantized-tail padding holes per finalize)
        assert P == max(8, 1 << (a["count"] - 1).bit_length()), (k, P)
        assert a["count"] < k + 8 * 8  # holes stay bounded
        assert P in shapes.POOL_RUNGS
    assert P == 1024  # the 512-read 2D workload lands here
    assert (8192, 128, 1024, True) in shapes.decode_chunk_shapes(
        Config(num_shards=1), [8192])


def test_warm_cache_enumeration_contains_production_chunks():
    """The exact chunk shapes the standard benchmarks dispatch."""
    cfg = Config(num_shards=1)
    got = set(shapes.decode_chunk_shapes(cfg, [4096, 8192]))
    # headline decode bench: B=128 x T=8192 path chunks
    assert (8192, 128, 1024, True) in got
    assert (8192, 128, 512, True) in got
    # score pass + leftovers
    assert (8192, 128, 1024, False) in got
    assert (8192, 8, 1024, True) in got and (8192, 64, 1024, True) in got
    # T=4096 cap is the 256 full chunk
    assert (4096, 256, 512, True) in got
