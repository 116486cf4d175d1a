#!/usr/bin/env python
"""Run the basecaller's device programs on an NVIDIA GPU and check them.

    python chip_smoke.py             # one card: phases 1-4
    python chip_smoke.py --chips 4   # four cards: the multi-device paths only

One process drives the card: a JAX process reserves most of the card's
memory when it starts, so nothing here starts a second one.

1. Device: the card's name and power limit, JAX's platform, kind and count,
   the versions, XLA_FLAGS, the compile-cache directory, the native host
   library and whether h5py is installed.
2. Numerics at full width (n = 4096 states, K = 6) on walks drawn from the
   generative process: the GPU decode against the same jitted program on
   the CPU and against tests/oracle.py, the chunked-time decoder against
   the full scan, and one EM dispatch against the CPU, with a control
   the EM comparison must reject.
3. The dev-tool entry points end to end (`python -m nanocall_tpu.tools
   run-viterbi` and `run-fwbw`, called in-process) on simulated reads of
   the CLI's default preset r9: 64 reads of 8192 events per strand, half
   of them 2-strand, and 2 reads of 40000 events; one cold and one warm
   pass, then the GPU's output against the CPU's on 8 strands.  The fast5
   CLI is not driven: its reader needs h5py.  Runs before phase 2, so
   the device's peak bytes it prints are its own.
4. Profiler: device traces of phase 3's decode, one production decode
   chunk (B=128, T=8192) and one EM dispatch (G=128, S=4, T=128), each
   reduced to its GPU plane's busiest operations.

--chips 4 runs only what exists across cards: the data-parallel decode
chunk against one card, EM buckets placed whole on each card (as the
pipeline places them) against the same buckets on one card, and the
sequence-parallel decoder against the single-device kernel.

Every failed check raises, so the script exits non-zero; without a GPU it
exits non-zero before any work.  The last line of stdout is one JSON
object: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import io
import json
import os
import platform
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

from nanocall_tpu import (  # noqa: E402
    events as events_mod, native, observe, pore_model, simulate, tools,
    train, transitions,
)
from nanocall_tpu.config import Config  # noqa: E402
from nanocall_tpu.models import load_builtin_models  # noqa: E402
from nanocall_tpu.observe import gpu_info  # noqa: E402
from nanocall_tpu.ops import hmm  # noqa: E402

K = 6
DEVICE_PLANE = "/device:GPU"  # profiler plane name prefix of the card

# Tolerances, each printed beside the comparison it governs.
LOGP_RTOL = 1e-5
LOGP_WHY = ("float32 sums of ~16k emission and transition terms: the GPU "
            "may contract a*b+c into one FMA where the CPU rounds twice")
EM_RTOL = 1e-4
EM_WHY = ("EM reduces over S*T*n = 2M cells per group; the GPU sums in "
          "another order than the CPU")
# The 3x3 weighted least-squares solve for scale/shift/drift is
# ill-conditioned on 128-event windows: moving every event mean by one
# float32 ulp moves shift and drift by ~4e-3 of their range on the CPU
# alone.  So each trained parameter is held to EM_SPREAD_FACTOR times that
# one-ulp spread, measured in the same run.  The spread is the EM
# trajectory's rounding-noise floor, not a slope: on an H100, inputs moved
# by 2 to 16 ulps read 0.8-2.0 spreads and the GPU against the CPU 0.7-1.5
# (G=16, seeds 5-7), while inputs rounded to bfloat16 read 18-188, and
# phase 2(d) requires that control to be rejected.
EM_SPREAD_FACTOR = 4
# run-fwbw variants: (extra flags, rtol, reason)
FWBW_CHECKS = (
    (["--custom-fwbw"], 1e-4,
     "per-step normalized sums, taken in another order on the GPU"),
    ([], 1e-2,
     "log-space alpha+beta-lpd cancel at |lpd| ~ 4e4 nats, where one "
     "float32 ulp is 4e-3: a one-ulp input change moves these posteriors "
     "by 4e-3 on the CPU alone"),
)
IDENT_BASES = 1000


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def walk_batch(pm, B: int, T: int, seed: int) -> dict:
    """(B, T) events drawn from the generative process, the workload of
    bench.py (its sample_walk_events)."""
    from bench import sample_walk_events

    mean, stdv = sample_walk_events(pm, B, T, np.random.default_rng(seed))
    return {"mean": mean, "stdv": stdv, "log_stdv": np.log(stdv),
            "length": np.full(B, T, np.int32)}


def decode(gt, model, ev, device, tc: int | None = None) -> dict:
    """Grouped Viterbi decode with compact codes, as production runs it, on
    `device`; returns host arrays."""
    args = jax.device_put((gt, model, ev), device)
    if tc:
        out = hmm.viterbi_decode_grouped_tchunk(*args, Tc=tc,
                                                compact_path=True)
    else:
        out = hmm.viterbi_decode_grouped(*args, compact_path=True)
    return jax.device_get(out)


def paths_of(out: dict, T: int) -> list:
    return [native.path_from_packed_codes(int(p0), codes, T, K)
            for p0, codes in zip(out["path0"], out["codes"])]


def path_logp(path, pm_arrays, mean, stdv, M) -> float:
    """log Pr of one state path and its events as the CPU decode program
    accumulates it: float32, uniform start, then per event (alpha +
    transition) + emission, with the decode's own emission expression
    (hmm.log_emission, evaluated by numpy at the path's states) and the
    transition log-probabilities of the dense matrix M."""
    lm, ls, sm, slam = (np.asarray(a, np.float32)[path][:, None]
                        for a in pm_arrays)
    m = hmm.ModelArrays(lm, ls, np.log(ls), sm, slam, np.log(slam))
    em = hmm.log_emission(m, mean, stdv, np.log(stdv))[:, 0]
    tr = M[path[:-1], path[1:]].astype(np.float32)
    acc = em[0] - np.float32(np.log(len(pm_arrays[0])))
    for e, t in zip(em[1:], tr):
        acc = (acc + t) + e
    return float(acc)


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def compare_paths(paths_a, paths_b, score, rtol: float) -> int:
    """Return how many rows differ as near-ties: paths that differ but
    whose scores score(path, row) agree within rtol.  Raises on a row whose
    paths differ by more."""
    ties = 0
    for row, (pa, pb) in enumerate(zip(paths_a, paths_b, strict=True)):
        if np.array_equal(pa, pb):
            continue
        sa, sb = score(pa, row), score(pb, row)
        check(rel_err(sa, sb) <= rtol,
              f"row {row}: paths differ at {int(np.sum(pa != pb))} events "
              f"and score {sa!r} vs {sb!r} (rtol {rtol})")
        ties += 1
    return ties


def column_diff(a, b):
    """Per parameter (column): the largest absolute difference of two
    (G, ...) parameter tables, and the column's largest magnitude."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return np.abs(a - b).max(axis=0), np.abs(b).max(axis=0)


def em_inputs(models, G: int, S: int, T: int, seed: int):
    """A (G, S, T) EM batch of 2-strand candidates (template model for
    strands 0-1, complement for 2-3), walks from the generative process,
    started slightly off the identity scaling so every round has work."""
    t_name, c_name = "r73.t.006", "r73.c.p1.006"
    ev_t = walk_batch(models[t_name], G * 2, T, seed)
    ev_c = walk_batch(models[c_name], G * 2, T, seed + 1)
    ev = {
        k: np.stack([ev_t[k][:G], ev_t[k][G:], ev_c[k][:G], ev_c[k][G:]],
                    axis=1)
        for k in ("mean", "stdv", "log_stdv")
    }
    ev["start"] = np.cumsum(np.full((G, S, T), 0.01, np.float32), axis=-1)
    ev["length"] = np.full((G, S), T, np.int32)
    ev["strand"] = np.tile(np.array([0, 0, 1, 1], np.int32), (G, 1))
    ev["valid"] = np.ones((G, S), bool)
    n = models[t_name].level_mean.shape[0]
    mdl = {k: np.ones((4, 2, n), np.float32)
           for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")}
    for st, name in ((0, t_name), (1, c_name)):
        for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda"):
            mdl[k][0, st] = getattr(models[name], k)
    mdl["model_idx"] = np.zeros(G, np.int32)
    pm0 = np.tile(np.array([1.02, 0.1, 0, 1, 1, 1], np.float32), (G, 1))
    st0 = np.full((G, 2, 2), [0.1, 0.3], np.float32)
    return ev, mdl, pm0, st0


def em_ulp_spread(args, cfg, device) -> tuple:
    """How far run_em's (pm, st) move, per parameter, when every event
    mean moves up by one float32 ulp: the EM trajectory's own
    amplification of rounding, on `device`."""
    ev, mdl, pm0, st0 = args
    ev2 = dict(ev, mean=np.nextafter(ev["mean"], np.float32(np.inf)))
    with jax.default_device(device):
        a = train.run_em(ev, mdl, pm0, st0, cfg)
        b = train.run_em(ev2, mdl, pm0, st0, cfg)
    return column_diff(a[0], b[0])[0], column_diff(a[1], b[1])[0]


def compare_em(res_a, res_b, spread, label: str) -> float:
    """Round counts identical, fit within EM_RTOL, and each trained
    parameter within EM_SPREAD_FACTOR times its one-ulp spread (or
    EM_RTOL of its range, whichever is larger).  Prints the readings
    first, then raises naming every check that failed; returns the
    largest |diff| / one-ulp spread."""
    fails, worst = [], 0.0
    n_rounds = int(np.sum(res_a[3] != res_b[3]))
    if n_rounds:
        fails.append(f"round counts differ in {n_rounds} groups")
    e_fit = max(rel_err(a, b) for a, b in zip(res_a[2], res_b[2]))
    if e_fit > EM_RTOL:
        fails.append(f"fit differs by {e_fit:.3g} > {EM_RTOL}")
    for name, i in (("pm", 0), ("st", 1)):
        diff, mag = column_diff(res_a[i], res_b[i])
        ratio = diff / np.maximum(spread[i], 1e-30)
        worst = max(worst, float(ratio.max()))
        say(f"    {name}: max |diff| per parameter {diff.tolist()}; one-ulp "
            f"spread {spread[i].tolist()}; |diff| / spread "
            f"{[round(float(r), 3) for r in ratio]}")
        if np.any(diff > np.maximum(EM_SPREAD_FACTOR * spread[i],
                                    EM_RTOL * mag)):
            fails.append(f"{name} differs by up to {ratio.max():.3g} one-ulp "
                         f"spreads > {EM_SPREAD_FACTOR}")
    check(not fails, f"{label}: " + "; ".join(fails))
    say(f"  {label}: round counts identical (per group "
        f"{res_a[3].min()}-{res_a[3].max()}); fit rel err {e_fit:.3g} <= "
        f"{EM_RTOL} ({EM_WHY}); parameters within {worst:.3g} one-ulp spreads "
        f"<= {EM_SPREAD_FACTOR} (or {EM_RTOL} x range)")
    return worst


def rejection(fn) -> str:
    """The AssertionError message of a check that must fail; raises if
    fn() passes."""
    try:
        fn()
    except AssertionError as e:
        return str(e)
    raise AssertionError("a control passed a check it must fail")


# ---------------------------------------------------------------------------
# phase 1


def phase_device() -> dict:
    info = gpu_info()
    say("== phase 1: device")
    for line in info["nvidia_smi"]:
        say(f"  nvidia-smi: {line}")
    import jaxlib

    say(f"  jax: platform {info['platform']}, kind {info['device_kind']}, "
        f"count {info['count']}; JAX_PLATFORMS="
        f"{os.environ.get('JAX_PLATFORMS', '')!r}")
    say(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}, python "
        f"{platform.python_version()}, XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}")
    observe.enable_compilation_cache()
    say(f"  compile cache: {jax.config.jax_compilation_cache_dir}")
    say(f"  native host library: "
        f"{'active' if native.available() else 'numpy fallbacks'}")
    try:
        import h5py  # noqa: F401

        say("  h5py: installed (fast5 input available)")
    except ImportError:
        say("  h5py: not installed (fast5 input unavailable)")
    return info


# ---------------------------------------------------------------------------
# phase 2


def phase_numerics(gpu, cpu, B=8, T=8192, T_oracle=512, n_oracle=2,
                   T_long=40960, G=16) -> None:
    import oracle

    say("== phase 2: numerics at full width")
    models = load_builtin_models("r73")
    pm = models["r73.t.006"]
    pm_arrays = pm.state_arrays()
    n = pm.level_mean.shape[0]
    tp = transitions.TransitionParams()
    gt = hmm.make_grouped_trans(tp, K)
    model = hmm.make_model_arrays(*pm_arrays)
    M = oracle.dense_logp(transitions.build_structured(tp, K), K)

    # (b)'s oracle is slow float64 numpy: start it first, off the main thread
    ev_o = walk_batch(pm, n_oracle, T_oracle, seed=2)
    pool = ThreadPoolExecutor(n_oracle)
    futs = [
        pool.submit(lambda b: oracle.viterbi(M, oracle.emissions(
            pm_arrays, events_mod.EventSequence(
                ev_o["mean"][b], ev_o["stdv"][b], np.zeros(T_oracle),
                np.zeros(T_oracle))))[0], b)
        for b in range(n_oracle)
    ]

    # (a) GPU against the same jitted program on the CPU
    ev = walk_batch(pm, B, T, seed=1)
    t0 = time.perf_counter()
    out_g = decode(gt, model, ev, gpu)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_c = decode(gt, model, ev, cpu)
    t_c = time.perf_counter() - t0
    e_logp = max(rel_err(a, b) for a, b in zip(out_g["logp"], out_c["logp"]))
    check(e_logp <= LOGP_RTOL, f"decode logp differs by {e_logp}")
    pg, pc = paths_of(out_g, T), paths_of(out_c, T)

    def score(p, row):
        return path_logp(p, pm_arrays, ev["mean"][row], ev["stdv"][row], M)

    e_self = rel_err(score(pc[0], 0), float(out_c["logp"][0]))
    check(e_self <= LOGP_RTOL, f"path scoring disagrees with the CPU "
          f"decode's logp by {e_self}")
    ties = compare_paths(pg, pc, score, LOGP_RTOL)
    say(f"  (a) decode B={B} T={T} n={n}, GPU vs CPU program: logp rel err "
        f"{e_logp:.3g} <= {LOGP_RTOL} ({LOGP_WHY}); paths identical in "
        f"{B - ties}/{B} rows, near-ties {ties} (scores within {LOGP_RTOL})"
        f"; GPU {t_g:.1f} s, CPU {t_c:.1f} s, compile included")

    # (c) chunked-time decoder (long reads) against the full scan
    from nanocall_tpu import batching

    ev_l = walk_batch(pm, 2, T_long, seed=4)
    tc = batching.tchunk_len(T_long)
    out_f = decode(gt, model, ev_l, gpu)
    out_t = decode(gt, model, ev_l, gpu, tc=tc)
    for k in ("path0", "codes", "logp"):
        check(np.array_equal(out_f[k], out_t[k]),
              f"chunked-time decode differs from the full scan in {k}")
    say(f"  (c) chunked-time decode (Tc={tc}) vs full scan on the GPU, B=2 "
        f"T={T_long}: bit-identical path0, codes and logp")

    # (d) one EM dispatch, GPU against CPU
    cfg = train.EMConfig(train_drift=True, K=K)
    args = em_inputs(models, G, 4, 128, seed=5)
    with jax.default_device(gpu):
        res_g = train.run_em(*args, cfg)
    with jax.default_device(cpu):
        res_c = train.run_em(*args, cfg)
    spread = em_ulp_spread(args, cfg, cpu)
    compare_em(res_g, res_c, spread,
               f"(d) EM run_em G={G} S=4 T=128 n={n}, GPU vs CPU")
    # control: a lower-precision data path on the GPU must fail the same
    # comparison, on its parameter bound and not only on round counts
    ev = args[0]
    bf16 = {k: ev[k].astype(jax.numpy.bfloat16).astype(np.float32)
            for k in ("mean", "stdv")}
    bf16["log_stdv"] = np.log(bf16["stdv"])
    with jax.default_device(gpu):
        res_x = train.run_em(dict(ev, **bf16), *args[1:], cfg)
    msg = rejection(lambda: compare_em(
        res_x, res_c, spread, "control: event levels rounded to bfloat16"))
    check("spreads >" in msg, f"bfloat16 control passed the parameter "
          f"bound: {msg}")
    say(f"  (d) {msg}: rejected")

    # (b) GPU against the literal transcription of the reference loops,
    # collected last: the oracle threads ran beside (a), (c) and (d)
    out_o = decode(gt, model, ev_o, gpu)
    po = paths_of(out_o, T_oracle)
    for b, fut in enumerate(futs):
        ref = fut.result()
        check(np.array_equal(po[b], ref),
              f"oracle row {b}: path differs at "
              f"{int(np.sum(po[b] != ref))} of {T_oracle} events")
    pool.shutdown()
    say(f"  (b) decode vs tests/oracle.py (float64 dense Viterbi) on "
        f"{n_oracle} reads, n={n}, T={T_oracle}: paths identical")


# ---------------------------------------------------------------------------
# phase 3


def run_tool(argv) -> str:
    """One dev-tool invocation (`python -m nanocall_tpu.tools ...`),
    in-process; returns its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tools.main(argv)
    check(rc == 0, f"tools {argv[0]} exited {rc}")
    return buf.getvalue()


def write_reads(workdir: str, cfg: Config, n_reads: int, n_events: int,
                n_long: int, long_events: int, seed: int) -> list:
    """Simulate reads under the preset's models and write the dev tools'
    TSV inputs.  Returns one (events, model, transitions, truth, n_events)
    tuple per strand."""
    models = load_builtin_models(cfg.pore)
    t_name, c_name = f"{cfg.pore}.t.007", f"{cfg.pore}.c.p1.007"
    paths = {}
    for name in (t_name, c_name):
        paths[name] = os.path.join(workdir, f"{name}.model.tsv")
        pore_model.save_tsv(models[name], paths[name])
    trans = os.path.join(workdir, "trans.tsv")
    run_tool(["compute-state-transitions", "--fast", "-t", str(cfg.pr_stay),
              "-k", str(cfg.pr_skip), "-o", trans])
    rng = np.random.default_rng(seed)
    hairpin = 8
    strands = []
    specs = [(n_events, i % 2 == 1) for i in range(n_reads)]
    specs += [(long_events, False)] * n_long
    for i, (T, two) in enumerate(specs):
        mean, stdv, start, length, truth = simulate.simulate_read(
            models, t_name, c_name if two else None, T, rng,
            hairpin_len=hairpin, noise_scale=0.7)
        core = T * (2 if two else 1) + (hairpin if two else 0)
        lo = (len(mean) - core) // 2  # the simulator pads both ends alike
        for st, name in enumerate((t_name, c_name)[: 1 + two]):
            a = lo + st * (T + hairpin)
            sl = slice(a, a + T)
            ev_path = os.path.join(workdir, f"r{i}.{st}.events.tsv")
            events_mod.save_tsv(events_mod.EventSequence(
                mean[sl], stdv[sl], start[sl], length[sl]), ev_path)
            strands.append((ev_path, paths[name], trans,
                            truth.base_seqs[st], T))
    return strands


def viterbi_pass(strands) -> list:
    return [run_tool(["run-viterbi", "-p", m, "-s", tr, "-e", e]).strip()
            for e, m, tr, _, _ in strands]


def fwbw_posteriors(strand, flags) -> dict:
    e, m, tr, _, _ = strand
    out = run_tool(["run-fwbw", "-p", m, "-s", tr, "-e", e, *flags])
    return {k: float(v) for k, v in
            (line.split("\t") for line in out.splitlines())}


def compare_posteriors(a: dict, b: dict, rtol: float) -> None:
    """Same k-mers at or above run-fwbw's 0.1 cut, and the same posterior
    within rtol; a k-mer on one side only must sit at the cut."""
    for kmer_s in a.keys() | b.keys():
        pa, pb = a.get(kmer_s, 0.1), b.get(kmer_s, 0.1)
        check(rel_err(pa, pb) <= rtol,
              f"posterior of {kmer_s}: {a.get(kmer_s)} vs {b.get(kmer_s)}")


def phase_tools(gpu, cpu, device_line: str, n_reads=64, n_events=8192,
                n_long=2, long_events=40000, n_cpu=8, seed=3) -> dict:
    say("== phase 3: dev tools end to end (run-viterbi, run-fwbw)")
    cfg = Config().apply_pore_preset()  # the CLI's defaults: preset r9
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        strands = write_reads(workdir, cfg, n_reads, n_events, n_long,
                              long_events, seed)
        n_ev = sum(s[4] for s in strands)
        say(f"  simulated {n_reads + n_long} reads of preset {cfg.pore} -> "
            f"{len(strands)} strands, {n_ev} events, in "
            f"{time.perf_counter() - t0:.1f} s (set-up)")
        runs = {}
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            seqs = viterbi_pass(strands)
            wall = time.perf_counter() - t0
            # the process's peak so far: phase 3 is its first device work
            stats = gpu.memory_stats()
            peak = stats["peak_bytes_in_use"] if stats else "not available"
            runs[label] = {"wall_s": wall, "events_per_s": n_ev / wall,
                           "peak_bytes_in_use": peak, "seqs": seqs}
            say(f"  {label} pass: {wall:.2f} s, {n_ev / wall:.0f} events/s, "
                f"peak_bytes_in_use {peak} (process peak, phase 3 first) on "
                f"{device_line}")
        seqs = runs["warm"]["seqs"]
        check(seqs == runs["cold"]["seqs"], "cold and warm passes differ")
        empty = sum(not s for s in seqs)
        check(len(seqs) == len(strands) and not empty,
              f"{len(seqs)} records for {len(strands)} strands, "
              f"{empty} empty")
        # difflib is quadratic: score each strand's first IDENT_BASES bases
        ident = [simulate.identity(s[:IDENT_BASES], st[3][:IDENT_BASES])
                 for s, st in zip(seqs, strands) if st[4] == n_events]
        say(f"  {len(seqs)} records for {len(strands)} strands, none empty; "
            f"identity to the simulated truth (simulate.identity, first "
            f"{IDENT_BASES} bases) over the {len(ident)} {n_events}-event "
            f"strands: mean {np.mean(ident):.4f}, min {np.min(ident):.4f}")

        subset = [s for s in strands if s[4] == n_events][:n_cpu]
        with jax.default_device(cpu):
            seqs_cpu = viterbi_pass(subset)
        same = sum(a == b for a, b in zip(seqs[:n_cpu], seqs_cpu))
        check(same == len(subset),
              f"run-viterbi GPU vs CPU: {same}/{len(subset)} byte-identical")
        say(f"  run-viterbi GPU vs CPU on {len(subset)} strands: "
            f"{same}/{len(subset)} byte-identical")
        for flags, rtol, why in FWBW_CHECKS:
            for s in subset:
                post_g = fwbw_posteriors(s, flags)
                with jax.default_device(cpu):
                    post_c = fwbw_posteriors(s, flags)
                compare_posteriors(post_g, post_c, rtol)
            say(f"  run-fwbw {' '.join(flags)} GPU vs CPU on {len(subset)} "
                f"strands: same k-mers, posteriors within {rtol} ({why})")

        traced = strands[:2]
        runs["trace"] = trace_summary(
            f"run-viterbi on {len(traced)} strands of T={n_events}",
            lambda: viterbi_pass(traced))
    return runs


# ---------------------------------------------------------------------------
# phase 4


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def reduce_trace(xplane_path: str) -> dict:
    """Planes, GPU device busy time and the heaviest device operations of
    one profiler trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    planes = [p.name for p in pd.planes]
    totals, counts, spans = collections.Counter(), collections.Counter(), []
    for p in pd.planes:
        if not p.name.startswith(DEVICE_PLANE):
            continue
        for line in p.lines:
            for e in line.events:
                totals[e.name] += e.duration_ns
                counts[e.name] += 1
                spans.append((e.start_ns, e.end_ns))
    return {
        "planes": planes,
        "gpu_planes": [p for p in planes if p.startswith(DEVICE_PLANE)],
        "busy_ns": busy_ns(spans),
        "window_ns": (max(b for _, b in spans) - min(a for a, _ in spans)
                      if spans else 0),
        "n_ops": sum(counts.values()),
        "top": [(name, ns, counts[name]) for name, ns in totals.most_common(5)],
    }


def trace_summary(label: str, fn) -> dict:
    """Trace fn() with observe.device_trace (the CLI's --trace-dir) and
    print the reduction; the trace must hold a GPU device plane."""
    with tempfile.TemporaryDirectory() as d:
        with observe.device_trace(d):
            fn()
        found = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                          recursive=True)
        check(found, f"{label}: no .xplane.pb under {d}")
        red = reduce_trace(found[0])
    check(red["gpu_planes"], f"{label}: no GPU device plane in "
          f"{red['planes']}")
    say(f"  trace of {label}: planes {red['planes']}")
    say(f"    device busy {red['busy_ns'] / 1e6:.3f} ms of a "
        f"{red['window_ns'] / 1e6:.3f} ms device window, {red['n_ops']} "
        f"device operations; heaviest:")
    for name, ns, cnt in red["top"]:
        say(f"      {ns / 1e6:10.3f} ms  x{cnt:<7d} {name}")
    return red


def phase_profile(B=128, T=8192, G=128) -> dict:
    from nanocall_tpu import basecall

    say("== phase 4: profiler (GPU device plane)")
    models = load_builtin_models("r73")
    pm = models["r73.t.006"]
    ev = walk_batch(pm, B, T, seed=6)
    args = (
        ev["mean"], ev["stdv"],
        np.cumsum(np.full((B, T), 0.01, np.float32), axis=-1),
        np.arange(B, dtype=np.int32), np.zeros(B, np.float32),
        {k: getattr(pm, k)[None].astype(np.float32)
         for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")},
        np.zeros(B, np.int32),
        np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (B, 1)),
        np.full((B, 2), [0.1, 0.3], np.float32), ev["length"],
    )

    def chunk():
        jax.block_until_ready(
            basecall._decode_chunk_pooled(*args, K=K, with_path=True))

    chunk()  # compile outside the trace
    out = {"decode_chunk": trace_summary(
        f"one production decode chunk B={B} T={T}", chunk)}
    out["decode_chunk"]["ops_per_step"] = out["decode_chunk"]["n_ops"] / T
    say(f"    {out['decode_chunk']['ops_per_step']:.2f} device operations "
        f"per scan step")

    rounds = 8
    em_args = em_inputs(models, G, 4, 128, seed=7)
    cfg = train.EMConfig(max_rounds=rounds, min_progress=-1e30, K=K)
    caps = np.full(G, rounds, np.int32)

    def em():
        res = train.run_em(*em_args, cfg, caps=caps, round_limit=rounds)
        check(int(res[3].max()) == rounds, "EM ran fewer rounds than asked")

    em()
    out["em"] = trace_summary(
        f"one EM dispatch G={G} S=4 T=128, {rounds} rounds", em)
    say(f"    {out['em']['busy_ns'] / rounds / 1e6:.3f} ms device busy per "
        f"EM round")
    return out


# ---------------------------------------------------------------------------
# --chips 4


def phase_multi(n: int, B=128, T=8192, G=128, B_sp=8) -> None:
    from jax.sharding import Mesh

    from nanocall_tpu.parallel import seqpar
    from nanocall_tpu.parallel.mesh import DataSharder

    devs = jax.devices()
    check(len(devs) >= n, f"need {n} devices, have {len(devs)}")
    say(f"== multi-device paths on {n} devices")
    models = load_builtin_models("r9")
    pm = models["r9.t.007"]

    # data-parallel decode chunk, as basecall._dispatch_decode_chunk shards
    # it, against one device; then the assembled base sequences
    ev = walk_batch(pm, B, T, seed=8)
    rng = np.random.default_rng(9)
    stp = np.stack([rng.uniform(0.05, 0.15, B), rng.uniform(0.2, 0.35, B)],
                   axis=1).astype(np.float32)
    gt = hmm.make_grouped_trans_device(stp[:, 0], stp[:, 1], K=K)
    bank = {k: getattr(pm, k)[None].astype(np.float32)
            for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")}
    params = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (B, 1))
    model = hmm.make_scaled_model_arrays(bank, np.zeros(B, np.int32), params)
    sharder = DataSharder(n)
    check(sharder.active and sharder.n == n, f"DataSharder({n}) inactive")
    out_s = jax.device_get(hmm.viterbi_decode_grouped(
        *sharder.shard((gt, model, ev), B), compact_path=True))
    out_1 = decode(gt, model, ev, devs[0])
    for k in ("path0", "codes", "logp"):
        check(np.array_equal(out_s[k], out_1[k]),
              f"{n}-way sharded decode differs from one device in {k}")
    seqs_s = [native.moves_and_base_seq(p, K)[1] for p in paths_of(out_s, T)]
    seqs_1 = [native.moves_and_base_seq(p, K)[1] for p in paths_of(out_1, T)]
    check(seqs_s == seqs_1, "sharded base sequences differ")
    say(f"  decode chunk B={B} T={T} over DataSharder({n}) vs one device: "
        f"bit-identical path0, codes and logp; {B} base sequences "
        f"byte-equal")

    # EM: one free-stopping bucket per device, placed whole and
    # round-robin as the pipeline's EM driver places them, against the same
    # buckets on one device; bucket 0 (seed 10) has groups that stop a round
    # apart when it is split G/n per card
    r73 = load_builtin_models("r73")
    buckets = [em_inputs(r73, G, 4, 128, seed=10 + i) for i in range(n)]
    free = train.EMConfig(K=K)
    outs = [train.run_em(*b, free, device=sharder.device(i), fetch=False)
            for i, b in enumerate(buckets)]
    placed = [d for o in outs for d in o[0].devices()]
    check(placed == devs[:n], f"EM buckets ran on {placed}")
    res_n = [train.fetch_em_result(o) for o in outs]
    for i, b in enumerate(buckets):
        res_1 = train.run_em(*b, free, device=devs[0])
        for name, a, c in zip(("pm", "st", "fit", "rounds", "frozen"),
                              res_n[i], res_1):
            check(np.array_equal(a, c), f"EM bucket {i} on device {i} "
                  f"differs from device 0 in {name}")
    say(f"  EM, {n} buckets G={G} S=4 T=128 with free stopping, one per "
        f"device vs all on one device: bit-identical parameters, fits and "
        f"round counts (rounds {min(int(r[3].min()) for r in res_n)}-"
        f"{max(int(r[3].max()) for r in res_n)})")

    # sequence-parallel decode: time axis over n devices
    ev = walk_batch(pm, B_sp, T, seed=11)
    ev["length"][1] = T - 5
    gt = hmm.make_grouped_trans(transitions.TransitionParams(), K)
    model = hmm.make_model_arrays(*pm.state_arrays())
    ref = jax.device_get(hmm.viterbi_decode_grouped(
        *jax.device_put((gt, model, ev), devs[0])))
    mesh = Mesh(np.array(devs[:n]), ("data",))
    out = jax.device_get(seqpar.viterbi_decode_seqpar(gt, model, ev, mesh))
    for k in ("path", "logp"):
        check(np.array_equal(out[k], ref[k]),
              f"seqpar over {n} devices differs in {k}")
    say(f"  seqpar B={B_sp} T={T} over a {n}-device mesh vs the single-device "
        f"grouped kernel: bit-identical paths and logp")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    info = phase_device()
    device_line = (f"{info['gpu_name']} at a {info['power_limit_w']} W "
                   f"power limit")
    if args.chips > 1:
        phase_multi(args.chips)
    else:
        gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
        phase_tools(gpu, cpu, device_line)  # first: its peak is its own
        phase_numerics(gpu, cpu)
        phase_profile()
    say(f"total {time.perf_counter() - t_start:.1f} s on {device_line}")
    for line in info["nvidia_smi"]:
        say(line)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["device_kind"],
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
