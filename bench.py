#!/usr/bin/env python
"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: Viterbi decode throughput (events/s) on one GPU — forward scan +
traceback + host base-sequence assembly over a realistic batched workload
(B reads x T events, 4096-state R7.3 model), versus a 4-core CPU baseline
derived from the REAL compiled reference run-viterbi's measured single-core
rate (tools/baseline_spotcheck.py; see BASELINE.md).  Every JSON line names
the device it ran on; without a GPU the harness exits non-zero.

Usage: python bench.py [--reads N] [--events T] [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# 4 cores x 4,136 events/s: the REAL compiled reference run-viterbi's
# measured single-core rate (tools/baseline_spotcheck.py; near-linear to 2
# cores), the stronger of the two baselines — the 8-thread stand-in
# (baseline/cpu_nanocall.cpp, re-measure with --cpu) does 14.0k aggregate.
# See BASELINE.md "Round-2 baseline spot-check".
CPU_BASELINE_EVENTS_PER_S = 16500.0


def sample_walk_events(pm, B: int, T: int, rng, p_stay=0.1, p_skip=0.3,
                       noise=1.0):
    """Generative (B, T) walk through the stay/step/skip chain, emitting
    from the pore model — the bench workload shares the generative process
    of the accuracy runs (nanocall_tpu.simulate is the single source of
    truth) instead of uniform noise."""
    from nanocall_tpu import simulate
    from nanocall_tpu.pore_model import PoreModelParams

    n = pm.level_mean.shape[0]
    K = int(round(np.log(n) / np.log(4)))
    states = simulate.sample_state_walk_batch(B, T, K, p_stay, p_skip, rng)
    mean, stdv = simulate._emit(
        pm, states, PoreModelParams(), np.zeros((B, 1)), rng, noise
    )
    return mean.astype(np.float32), stdv.astype(np.float32)


def measure_cpu(reads: int, events: int, events_file: str = "") -> float:
    exe = os.path.join(REPO, "baseline", "cpu_nanocall")
    if not os.path.exists(exe):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-pthread",
             "-o", exe, exe + ".cpp"],
            check=True,
        )
    args = [exe, str(reads), str(events), "8"]
    if events_file:
        args.append(events_file)
    out = subprocess.run(args, capture_output=True, text=True, check=True)
    return float(json.loads(out.stdout)["events_per_s"])


def measure_decode(B: int, T: int, n_iter: int = 4, reps: int = 5,
                   spacing_s: float = 2.0, with_mfu: bool = True) -> dict:
    """Decode benchmark: `reps` independent windows, each measuring (1) the
    pipelined wall-clock ms/batch (the headline path: fetch + host assembly
    overlapped on worker threads), (2) device ms/batch (n_iter back-to-back
    dispatches, then block_until_ready on all of them), and (3) an
    op-count-matched FMA-peak scan at the same shape (the device-health
    control, taken in the SAME window as the decode reps it
    contextualizes)."""
    import jax

    from nanocall_tpu.observe import enable_compilation_cache

    enable_compilation_cache()

    from nanocall_tpu import transitions
    from nanocall_tpu.models import load_builtin_models
    from nanocall_tpu.ops import hmm

    models = load_builtin_models("r73")
    pm = models["r73.t.006"]
    tp = transitions.TransitionParams()
    # per-read device-built tables + device-scaled models from a one-copy
    # bank: the same program shape as production's _decode_chunk_pooled
    # (basecall.py)
    gt = hmm.make_grouped_trans_device(
        np.full(B, tp.p_stay, np.float32), np.full(B, tp.p_skip, np.float32),
        K=6)
    rng = np.random.default_rng(0)
    bank = {
        "level_mean": pm.level_mean[None].astype(np.float32),
        "level_stdv": pm.level_stdv[None].astype(np.float32),
        "sd_mean": pm.sd_mean[None].astype(np.float32),
        "sd_lambda": pm.sd_lambda[None].astype(np.float32),
    }
    params = np.zeros((B, 6), np.float32)
    params[:, [0, 3, 4, 5]] = 1.0  # identity {scale, var, scale_sd, var_sd}
    model = hmm.make_scaled_model_arrays(bank, np.zeros(B, np.int32), params)
    # model-generated signal (the accuracy runs' generative process), not
    # uniform noise: device timing and accuracy share a workload shape
    mean, stdv = sample_walk_events(pm, B, T, rng)
    ev = {
        "mean": mean,
        "stdv": stdv,
        "log_stdv": np.log(stdv),
        "length": np.full(B, T, np.int32),
    }
    ev = {k: jax.device_put(v) for k, v in ev.items()}
    # warm up (compile); compact_path matches the production decode
    # (basecall.py: uint8 codes fetch + native path reconstruction)
    out = hmm.viterbi_decode_grouped(gt, model, ev, compact_path=True)
    codes0 = np.asarray(out["codes"])
    path00 = np.asarray(out["path0"])
    from concurrent.futures import ThreadPoolExecutor

    from nanocall_tpu import native

    def assemble(path0, codes):
        seqs = []
        for b in range(B):
            path = native.path_from_packed_codes(int(path0[b]), codes[b], T, 6)
            seqs.append(native.moves_and_base_seq(path, 6))
        return seqs

    # measured isolated once, for the breakdown line (not the headline)
    t1 = time.perf_counter()
    assemble(path00, codes0)
    host_dt = time.perf_counter() - t1

    def fetch_and_assemble(out):
        return assemble(np.asarray(out["path0"]), np.asarray(out["codes"]))

    # pipelined steady state, exactly as the production decode path runs:
    # all batches dispatched up front (async), fetched + assembled on
    # worker threads (fetches overlap the later batches' device work;
    # ctypes assembly releases the GIL).  Measured as `reps` independent
    # time-spaced windows; the headline is the BEST window, and every
    # window carries its own device-only ms and FMA peak.
    n = int(pm.level_mean.shape[0])
    if with_mfu:
        from nanocall_tpu import roofline

        # op-count-matched chain: same per-step work as the grouped forward
        fma_k = max(8, round(
            roofline.grouped_forward_ops_per_event(n)["total"] / (2 * n)))
        roofline.measure_fma_peak(B, n, T=T, k=fma_k, n_iter=1)  # warm
    windows = []
    for w in range(reps):
        if w:
            time.sleep(spacing_s)
        # (1) pipelined wall clock — the headline path
        t0 = time.perf_counter()
        outs = [hmm.viterbi_decode_grouped(gt, model, ev, compact_path=True)
                for _ in range(n_iter)]
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(fetch_and_assemble, out) for out in outs]
            seqs = [f.result() for f in futs]
        assert len(seqs) == n_iter and all(s for s in seqs)
        wall_ms = (time.perf_counter() - t0) / n_iter * 1e3
        # (2) device-only: back-to-back dispatches, no result fetch
        t0 = time.perf_counter()
        outs2 = [hmm.viterbi_decode_grouped(gt, model, ev, compact_path=True)
                 for _ in range(n_iter)]
        jax.block_until_ready(outs2)
        dev_ms = (time.perf_counter() - t0) / n_iter * 1e3
        win = {"wall_ms": round(wall_ms, 1), "device_ms": round(dev_ms, 1)}
        # (3) device-health control in the same window
        if with_mfu:
            fma_peak, _ = roofline.measure_fma_peak(
                B, n, T=T, k=fma_k, n_iter=2)
            win["fma_peak_teraops"] = round(fma_peak / 1e12, 2)
        windows.append(win)
    wall = sorted(w["wall_ms"] for w in windows)
    best_ms = wall[0]
    median_ms = wall[len(wall) // 2]
    best_dev_ms = min(w["device_ms"] for w in windows)
    res = {
        "events_per_s": B * T / (best_ms / 1e3),
        "batch_ms": best_ms,
        "median_batch_ms": median_ms,
        "median_events_per_s": B * T / (median_ms / 1e3),
        "device_ms_per_batch": best_dev_ms,
        "device_only_events_per_s": B * T / (best_dev_ms / 1e3),
        "rep_ms_per_batch": [w["wall_ms"] for w in windows],
        "windows": windows,
        "host_assembly_ms": host_dt * 1e3,
        "reads_per_s": B / (best_ms / 1e3),
        "n_states": n,
    }
    if with_mfu:
        peaks = sorted(w["fma_peak_teraops"] for w in windows)
        res["fma_peak_teraops_median"] = peaks[len(peaks) // 2]
        res["fma_k"] = fma_k
    return res


def measure_em(G: int = 128, S: int = 4, T: int = 128, rounds: int = 8,
               n_iter: int = 3, reps: int = 3, with_mfu: bool = True) -> dict:
    """EM training-kernel benchmark: run_em_device at the production
    phase-1 program shape (G=128 groups x S=4 seqs x T=128 events,
    n=4096 states, max_rounds=8 — the exact program the 512-read e2e
    dispatches), forced to run exactly `rounds` while_loop iterations by
    per-group caps, timed device-only (back-to-back dispatches, then
    block_until_ready).  Reports event-rounds/s through train_one_round and
    the roofline verdict (ops + HBM-bytes ceilings, binding resource) —
    the decode bench's MFU accounting, for the e2e-dominant stage.
    Ref: Parameter_Trainer.hpp:99-222 (the E-step the kernel replaces),
    nanocall.cpp:367-426 (the stopping rules in the loop body)."""
    import jax

    from nanocall_tpu import kmer, roofline, train
    from nanocall_tpu.config import Config
    from nanocall_tpu.models import load_builtin_models
    from nanocall_tpu.observe import enable_compilation_cache

    enable_compilation_cache()
    cfg = Config(pore="r73").apply_pore_preset()
    models = load_builtin_models("r73")
    n = kmer.n_states(cfg.kmer_size)
    rng = np.random.default_rng(7)
    # realistic per-sequence events from the generative walk (template
    # model for strand 0 / complement for strand 1, like a 2D candidate)
    mean_t, stdv_t = sample_walk_events(models["r73.t.006"], G * 2, T, rng)
    mean_c, stdv_c = sample_walk_events(models["r73.c.p1.006"], G * 2, T, rng)
    mean = np.stack(
        [mean_t[:G], mean_t[G:], mean_c[:G], mean_c[G:]], axis=1)
    stdv = np.stack(
        [stdv_t[:G], stdv_t[G:], stdv_c[:G], stdv_c[G:]], axis=1)
    start = np.cumsum(np.full((G, S, T), 0.01, np.float32), axis=-1)
    ev = {
        "mean": mean, "stdv": stdv,
        "log_stdv": np.log(stdv),
        "start": start,
        "length": np.full((G, S), T, np.int32),
        "strand": np.broadcast_to(
            np.array([0, 0, 1, 1], np.int32), (G, S)).copy(),
        "valid": np.ones((G, S), bool),
    }
    mdl = {
        k: np.ones((4, 2, n), np.float32)
        for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")
    }
    for st, name in ((0, "r73.t.006"), (1, "r73.c.p1.006")):
        pm = models[name]
        mdl["level_mean"][0, st] = pm.level_mean
        mdl["level_stdv"][0, st] = pm.level_stdv
        mdl["sd_mean"][0, st] = pm.sd_mean
        mdl["sd_lambda"][0, st] = pm.sd_lambda
    mdl["model_idx"] = np.zeros(G, np.int32)
    pm0 = np.zeros((G, 6), np.float32)
    pm0[:, [0, 3, 4, 5]] = 1.0
    pm0[:, 0] = 1.02  # slightly off-identity so every round has real work
    pm0[:, 1] = 0.1
    st0 = np.full((G, 2, 2), [cfg.pr_stay, cfg.pr_skip], np.float32)
    em_cfg = train.EMConfig(
        max_rounds=rounds, min_progress=-1e30,  # never freeze on progress
        train_drift=bool(cfg.train_drift), K=cfg.kmer_size,
    )
    caps = np.full(G, rounds, np.int32)

    def dispatch():
        return train.run_em(ev, mdl, pm0, st0, em_cfg, caps=caps,
                            fetch=False, round_limit=rounds)

    out = dispatch()  # compile + warm
    pm_f, _, _, rds, frozen = train.fetch_em_result(out)
    # the work model requires the loop to have run all `rounds` iterations
    # (caps freeze each group at exactly `rounds` accepted rounds; the
    # all-frozen early exit would only fire if every group regressed)
    iters_run = int(rds.max())
    assert iters_run == rounds, f"loop ran {iters_run} != {rounds} rounds"
    rep_ms = []
    for r in range(reps):
        if r:
            time.sleep(1.0)
        t0 = time.perf_counter()
        outs = [dispatch() for _ in range(n_iter)]
        jax.block_until_ready(outs)
        rep_ms.append(
            (time.perf_counter() - t0) * 1e3 / (n_iter * rounds))
    best_round_ms = min(rep_ms)
    ev_per_round_s = G * S * T / (best_round_ms / 1e3)
    res = {
        "G": G, "S": S, "T": T, "rounds": rounds,
        "ms_per_round": round(best_round_ms, 2),
        "rep_ms_per_round": [round(r, 2) for r in rep_ms],
        "event_rounds_per_s": round(ev_per_round_s),
    }
    fma_peak = None
    if with_mfu:
        # op-count-matched FMA chain at the E-step's own scan shape
        # ((G*S, n) carry, T steps x rounds to give the chain enough work)
        k = max(8, round(
            roofline.fwbw_grouped_fwd_ops_per_event(n)["total"] / (2 * n)))
        fma_peak, _ = roofline.measure_fma_peak(
            G * S, n, T=T * rounds, k=k, n_iter=2, reduce_out=True)
        res["fma_peak_teraops"] = round(fma_peak / 1e12, 2)
    rep = roofline.em_mfu_report(
        ev_per_round_s, n, roofline.peak_for(jax.devices()[0].device_kind),
        fma_peak_ops_per_s=fma_peak)
    res["mfu"] = {
        "ops_per_event_round": rep["ops_per_event_round"]["total"],
        "ops_breakdown": {
            k: v for k, v in rep["ops_per_event_round"].items()
            if k not in ("total",)
        },
        "hbm_bytes_per_event_round": rep["hbm_bytes_per_event_round"],
        "achieved_teraops": round(rep["achieved_ops_per_s"] / 1e12, 2),
        "achieved_hbm_GBps": round(
            rep["achieved_hbm_bytes_per_s"] / 1e9, 1),
        "mfu_vs_fma_peak": round(rep["mfu_vs_fma_peak"], 3),
        "hbm_utilization_vs_spec": round(
            rep["hbm_utilization_vs_spec"], 3),
        "ceiling_events_per_s_compute": round(
            rep["ceiling_events_per_s_compute"]),
        "ceiling_events_per_s_hbm": round(rep["ceiling_events_per_s_hbm"]),
        "binding_resource": rep["binding_resource"],
    }
    return res


def measure_e2e(n_reads: int, n_events: int, train: bool,
                n_passes: int = 3) -> dict:
    """Full pipeline (simulated fast5 -> FASTA) wall-clock reads/s."""
    import tempfile

    import jax

    from nanocall_tpu import basecall, read_pipeline, simulate
    from nanocall_tpu.config import Config
    from nanocall_tpu.models import load_builtin_models
    from nanocall_tpu.observe import enable_compilation_cache

    enable_compilation_cache()
    models = load_builtin_models("r73")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        for i in range(n_reads):
            simulate.write_sim_fast5(
                os.path.join(d, f"r{i}.fast5"), models, "r73.t.006",
                "r73.c.p1.006" if i % 2 else None, n_events, rng,
                read_id=f"r{i}", noise_scale=0.7,
            )
        cfg = Config(pore="r73", train=train).apply_pore_preset()
        files = read_pipeline.init_files([d])

        from nanocall_tpu.observe import StageTimer

        def run_once():
            t0 = time.perf_counter()
            # fully overlapped pipeline (basecall.run_pipeline): ingest
            # overlaps EM, decode dispatch overlaps phase-2 straggler EM,
            # winner path decodes dispatch as scores land
            timer = StageTimer()
            summaries, results = basecall.run_pipeline(
                files, models, cfg, timer=timer
            )
            stages = timer.summary()
            last_counters.update(timer.counters)
            t_train = stages.get("training",
                                 stages.get("init_reads", {})).get("wall_s", 0.0)
            return summaries, results, t_train, time.perf_counter() - t0

        last_counters = {}

        # pass 1 compiles every program shape (set-up time); the next
        # n_passes are steady-state measurements and the MEDIAN is the
        # headline (the min and the full spread are reported in "detail";
        # the CPU baseline was a single plain pass, so comparing its value
        # against a median, not a min, keeps vs_baseline symmetric)
        t0 = time.perf_counter()
        run_once()
        warm_s = time.perf_counter() - t0
        n_passes = max(1, n_passes)
        passes = sorted([run_once() for _ in range(n_passes)],
                        key=lambda p: p[3])
        all_dt = sorted(round(p[3], 1) for p in passes)
        # len//2 is the true median for odd N; for even N it takes the
        # SLOWER middle pass (conservative, never best-case-as-median)
        summaries, results, t_train, dt = passes[len(passes) // 2]
        total_events = sum(s.num_ed_events for s in summaries)
    em = {}
    if train and last_counters.get("em_event_rounds"):
        # EM-stage roofline context (exact device work from the driver's
        # per-bucket iteration accounting; see bench.py --em for the
        # isolated kernel measurement against the same ceilings)
        from nanocall_tpu import kmer as kmer_mod, roofline

        n = kmer_mod.n_states(6)
        er = last_counters["em_event_rounds"]
        rep = roofline.em_mfu_report(
            er / max(t_train, 1e-9), n,
            roofline.peak_for(jax.devices()[0].device_kind))
        em = {
            "em_event_rounds": er,
            "em_bucket_iters": last_counters.get("em_bucket_iters"),
            # LOWER bound on the EM stage's device rate: the denominator
            # (the 'training' stage wall) also covers overlapped ingest +
            # packing + fetches, so the true device rate is higher — run
            # `bench.py --em` for the isolated kernel number
            "em_event_rounds_per_train_stage_s": round(
                er / max(t_train, 1e-9)),
            "em_ceiling_events_per_s_hbm": round(
                rep["ceiling_events_per_s_hbm"]),
            "em_stage_fraction_of_hbm_ceiling": round(
                (er / max(t_train, 1e-9))
                / rep["ceiling_events_per_s_hbm"], 3),
        }
    return {
        **em,
        "reads_per_s": round(n_reads / dt, 2),
        "events_per_s": round(total_events / dt),
        "seconds": round(dt, 1),
        "all_pass_seconds": all_dt,
        "min_pass_seconds": all_dt[0],
        "min_pass_events_per_s": round(total_events / passes[0][3]),
        "pass_spread_seconds": round(all_dt[-1] - all_dt[0], 1),
        "warmup_compile_s": round(warm_s, 1),
        "ingest_train_s": round(t_train, 1),
        "basecall_s": round(dt - t_train, 1),
        "n_seqs": len(results),
    }


def main():
    ap = argparse.ArgumentParser()
    # B=128 x T=8192 (1M events/chunk): the production decode chunk shape,
    # chosen on the previous accelerator and not re-measured on the H100;
    # 8k events is also the realistic R7.3 template length
    ap.add_argument("--reads", type=int, default=128)
    ap.add_argument("--events", type=int, default=8192)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="re-measure CPU baseline")
    ap.add_argument("--e2e", action="store_true",
                    help="benchmark the full fast5->FASTA pipeline instead")
    ap.add_argument("--em", action="store_true",
                    help="benchmark the EM training kernel (run_em_device "
                         "at the production phase-1 shape) + its roofline")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--passes", type=int, default=3,
                    help="steady-state e2e passes (median reported)")
    ap.add_argument("--no-mfu", action="store_true",
                    help="skip the MFU/roofline accounting (one extra "
                         "compiled shape: the same-shape FMA-peak scan)")
    ap.add_argument("--debug", action="store_true",
                    help="debug logging (sub-stage pack/fetch timers)")
    args = ap.parse_args()
    from nanocall_tpu.observe import gpu_info

    device = gpu_info()  # exits non-zero without a GPU: never falls back
    if args.debug:
        import logging

        logging.basicConfig(
            level=logging.DEBUG,
            format="%(relativeCreated)8.0fms %(name)s: %(levelname)s: %(message)s",
        )
        logging.getLogger("jax").setLevel(logging.WARNING)

    if args.em:
        res = measure_em(with_mfu=not args.no_mfu)
        print(json.dumps({
            "device": device,
            "metric": "em_train_event_rounds_per_s",
            "value": res["event_rounds_per_s"],
            "unit": "event-rounds/s",
            # vs_baseline here = fraction of the binding roofline ceiling
            "vs_baseline": round(
                res["event_rounds_per_s"]
                / res["mfu"]["ceiling_events_per_s_"
                             + res["mfu"]["binding_resource"]], 3),
            "detail": res,
        }))
        return

    if args.e2e:
        res = measure_e2e(args.reads, args.events, train=not args.no_train,
                          n_passes=args.passes)
        cpu = CPU_BASELINE_EVENTS_PER_S
        print(json.dumps({
            "device": device,
            "metric": "e2e_pipeline_events_per_s",
            "value": round(res["events_per_s"]),
            "unit": "events/s",
            "vs_baseline": round(res["events_per_s"] / cpu, 2),
            "detail": res,
        }))
        return

    B, T = args.reads, args.events
    if args.quick:
        B, T = 32, 1024

    cpu = CPU_BASELINE_EVENTS_PER_S
    if args.cpu:
        # same generative workload on both sides (apples-to-apples; the
        # C++ inner loop is data-independent, but measure it anyway)
        import tempfile

        from nanocall_tpu.models import load_builtin_models

        pm = load_builtin_models("r73")["r73.t.006"]
        Bc, Tc = min(B, 16), min(T, 2048)
        mean, stdv = sample_walk_events(pm, Bc, Tc, np.random.default_rng(0))
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
            np.stack([mean, stdv], axis=-1).astype("<f4").tofile(f)
            ev_path = f.name
        try:
            cpu = measure_cpu(Bc, Tc, ev_path)
        finally:
            os.unlink(ev_path)
        print(f"cpu baseline: {cpu:,.0f} events/s", file=sys.stderr)

    # n_iter=8: the steady-state pipeline depth.  The production decode
    # streams ~20 chunks per 512-read run, so per-batch cost is the
    # steady-state slope, not the ramp of a shallow pipeline.
    res = measure_decode(B, T, n_iter=3 if args.quick else 8,
                         reps=2 if args.quick else 5,
                         with_mfu=not args.no_mfu)
    detail = {
        "B": B,
        "T": T,
        "pipelined_ms_per_batch": round(res["batch_ms"], 1),
        "median_ms_per_batch": round(res["median_batch_ms"], 1),
        "median_events_per_s": round(res["median_events_per_s"]),
        "device_ms_per_batch": round(res["device_ms_per_batch"], 1),
        "device_only_events_per_s": round(res["device_only_events_per_s"]),
        "rep_ms_per_batch": res["rep_ms_per_batch"],
        "windows": res["windows"],
        "host_assembly_ms": round(res["host_assembly_ms"], 1),
        "reads_per_s": round(res["reads_per_s"], 1),
        "cpu_baseline_events_per_s": cpu,
    }
    if not args.no_mfu:
        # MFU / roofline accounting (nanocall_tpu/roofline.py): itemized
        # ops-per-event model of the grouped forward + traceback, vs (a) a
        # MEASURED FMA peak at the recursion's own scan shape — sampled in
        # the SAME windows as the decode reps (detail.windows[*]
        # .fma_peak_teraops), median used here — and (b) the device's
        # published float32 peak.  Every count cites the kernel expression
        # it tallies.
        from nanocall_tpu import roofline

        n = res["n_states"]
        fma_peak = res["fma_peak_teraops_median"] * 1e12
        rep = roofline.mfu_report(
            B, T, n, res["batch_ms"] / 1e3,
            roofline.peak_for(device["device_kind"]),
            fma_peak_ops_per_s=fma_peak)
        detail["mfu"] = {
            "ops_per_event_per_row": rep["ops_per_event_per_row"]["total"],
            "ops_breakdown": {
                k: v for k, v in rep["ops_per_event_per_row"].items()
                if k != "total"
            },
            "achieved_teraops": round(rep["achieved_ops_per_s"] / 1e12, 2),
            "measured_fma_peak_teraops": round(fma_peak / 1e12, 2),
            "fma_peak_teraops_per_window": [
                w.get("fma_peak_teraops") for w in res["windows"]
            ],
            "mfu_vs_measured_fma_peak": round(
                rep["mfu_vs_measured_fma_peak"], 3),
            "mfu_vs_fp32_spec": round(rep["mfu_vs_fp32_spec"], 3),
        }
    print(
        json.dumps(
            {
                "device": device,
                "metric": "viterbi_decode_events_per_s",
                "value": round(res["events_per_s"]),
                "unit": "events/s",
                "vs_baseline": round(res["events_per_s"] / cpu, 2),
                "detail": detail,
            }
        )
    )


if __name__ == "__main__":
    main()
