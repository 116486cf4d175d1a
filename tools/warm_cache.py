#!/usr/bin/env python
"""Warm the persistent compile cache by EXECUTING the standard kernel shapes.

Each new program shape compiles on first use.  This runs each standard
pipeline program once on tiny data, with the persistent cache on
(observe.enable_compilation_cache), so later runs start fast.

Shapes are derived from the SAME sizing functions production uses
(batching.batch_size_for with basecall.BP_MEM_BUDGET), and the fused
production chunk program (basecall._decode_chunk_pooled) is executed in
addition to the direct decode entry point the bench uses.

Run once per machine: python tools/warm_cache.py [--quick]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax.numpy as jnp  # noqa: E402

    from nanocall_tpu import basecall, kmer, train  # noqa: E402
    from nanocall_tpu.models import load_builtin_models  # noqa: E402
    from nanocall_tpu.observe import enable_compilation_cache  # noqa: E402
    from nanocall_tpu.ops import hmm  # noqa: E402

    enable_compilation_cache()
    models = load_builtin_models("r73")
    m = models["r73.t.006"]
    n = kmer.n_states(6)
    rng = np.random.default_rng(0)

    def bank_of(B):
        return {
            "level_mean": np.tile(m.level_mean, (4, 1)),
            "level_stdv": np.tile(m.level_stdv, (4, 1)),
            "sd_mean": np.tile(m.sd_mean, (4, 1)),
            "sd_lambda": np.tile(m.sd_lambda, (4, 1)),
        }

    def run_decode(B, T, with_path):
        """The bench/direct entry point (viterbi_decode_grouped)."""
        t0 = time.time()
        gt = hmm.make_grouped_trans_device(
            np.full(B, 0.1, np.float32), np.full(B, 0.3, np.float32), K=6
        )
        params = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (B, 1))
        model = hmm.make_scaled_model_arrays(bank_of(B), np.zeros(B, np.int32),
                                             params)
        stdv = rng.uniform(0.5, 1.5, (B, T)).astype(np.float32)
        ev = {"mean": rng.uniform(40, 90, (B, T)).astype(np.float32),
              "stdv": stdv, "log_stdv": np.log(stdv),
              "length": np.full(B, T, np.int32)}
        # compact_path tracks with_path exactly as production's dispatch
        # (basecall.py _decode_chunk / _dispatch_decode_chunk) and the
        # bench do — a non-compact warm would compile a program the
        # pipeline never runs
        out = hmm.viterbi_decode_grouped(gt, model, ev, with_path=with_path,
                                         compact_path=with_path)
        np.asarray(out["logp"])
        print(f"decode B={B} T={T} path={with_path}: {time.time()-t0:.0f}s",
              flush=True)

    def run_chunk(B, T, P, with_path):
        """The fused production chunk program (basecall._decode_chunk_pooled,
        pool gather + compact paths).  P = pooled row count (pow2)."""
        t0 = time.time()
        pool = {
            "mean": jnp.asarray(rng.uniform(40, 90, (P, T)).astype(np.float32)),
            "stdv": jnp.asarray(np.ones((P, T), np.float32)),
            "start": jnp.asarray(
                np.tile(np.cumsum(np.full(T, 0.02, np.float32)), (P, 1))),
        }
        idx = np.arange(B, dtype=np.int32) % P
        bank = {k: jnp.asarray(v) for k, v in bank_of(B).items()}
        params = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (B, 1))
        out = basecall._decode_chunk_pooled(
            pool["mean"], pool["stdv"], pool["start"], idx,
            jnp.zeros(B, jnp.float32), bank, np.zeros(B, np.int32),
            params, np.full((B, 2), [0.1, 0.3], np.float32),
            np.full(B, T, np.int32), K=6, with_path=with_path,
        )
        np.asarray(out["logp"])
        print(f"chunk B={B} T={T} P={P} path={with_path}: {time.time()-t0:.0f}s",
              flush=True)

    def run_train(G, drift):
        t0 = time.time()
        S, T = 4, 128
        stdv = rng.uniform(0.5, 1.5, (G, S, T)).astype(np.float32)
        ev = {"mean": rng.uniform(40, 90, (G, S, T)).astype(np.float32),
              "stdv": stdv, "log_stdv": np.log(stdv),
              "start": np.cumsum(np.full((G, S, T), .02, np.float32), -1),
              "length": np.full((G, S), T, np.int32),
              "strand": np.tile(np.array([0, 0, 1, 1], np.int32), (G, 1)),
              "valid": np.ones((G, S), bool)}
        mdl = {
            "level_mean": np.tile(m.level_mean, (4, 2, 1)),
            "level_stdv": np.tile(m.level_stdv, (4, 2, 1)),
            "sd_mean": np.tile(m.sd_mean, (4, 2, 1)),
            "sd_lambda": np.tile(m.sd_lambda, (4, 2, 1)),
            "model_idx": np.zeros(G, np.int32),
        }
        pm0 = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (G, 1))
        st0 = np.tile(np.array([.1, .3], np.float32), (G, 2, 1))
        # match production static args: phase 2's static loop bound is
        # caps.max() = 20 (any double-strand group in the chunk) or 10
        # (all-single-strand chunk) — distinct compiled programs — and
        # phase 1 runs everyone with round_limit=cfg.em_phase1_rounds
        # (caps only affect traced values, so one phase-1 program per
        # (G, drift) covers both strand modes)
        from nanocall_tpu.config import Config

        for ds in (True, False):
            cfg = train.EMConfig(max_rounds=10, double_strand=ds,
                                 train_drift=drift)
            train.run_em(ev, mdl, pm0, st0, cfg)
        train.run_em(ev, mdl, pm0, st0, cfg,
                     round_limit=Config().em_phase1_rounds)
        print(f"train G={G} drift={drift}: {time.time()-t0:.0f}s", flush=True)

    # decode shapes: the exact ladder production can dispatch is
    # enumerated by nanocall_tpu/shapes.py (pinned to the drivers by
    # tests/test_shapes.py).  Full mode covers the production-common
    # length buckets x every pool rung (a small bucket of a mixed
    # workload can pair any batch rung with a small pool arity, and an
    # un-warmed arity stalls the pipeline for its compile).
    # NOT warmed, by design: length buckets < 2048 and sharded
    # (--num-shards > 1) batch floors — off-slice shapes compile on
    # first contact and persist in the cache like everything else.
    from nanocall_tpu import shapes
    from nanocall_tpu.config import Config

    cfg = Config()
    Ts = [4096] if args.quick else [2048, 4096, 6144, 8192, 10240]
    Ps = (256,) if args.quick else shapes.POOL_RUNGS
    done_decode = set()
    for T, B, P, wp in shapes.decode_chunk_shapes(cfg, Ts, pool_rungs=Ps):
        if args.quick and B != max(
            shapes.path_chunk_batches(cfg, T)
        ):
            continue
        if (T, B, wp) not in done_decode:
            done_decode.add((T, B, wp))
            run_decode(B, T, wp)
        run_chunk(B, T, P, wp)
    # training chunk batch sizes: shapes.train_chunk_batches -> {8, 64,
    # cap=128}; leftovers/stragglers hit 64 and 8
    Gs = shapes.train_chunk_batches(cfg)
    run_train(max(Gs), True)
    if not args.quick:
        run_train(max(Gs), False)
        for G in Gs[:-1]:
            run_train(G, True)
    # the bench's MFU roofline chain (op-count-matched FMA scan)
    if not args.quick:
        from nanocall_tpu import roofline

        t0 = time.time()
        k = max(8, round(
            roofline.grouped_forward_ops_per_event(n)["total"] / (2 * n)))
        roofline.measure_fma_peak(128, n, T=8192, k=k, n_iter=1)
        print(f"fma chain k={k}: {time.time()-t0:.0f}s", flush=True)
    print("cache warm done")


if __name__ == "__main__":
    main()
