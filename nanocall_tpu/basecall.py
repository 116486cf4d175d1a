"""Pipeline orchestration: batched training and basecalling over reads.

Accelerator rebuild of train_reads / basecall_reads
(nanocall.cpp:275-582,593-869).  Where the reference loops a thread pool
over reads, this module gathers work across ALL reads into flat task lists,
buckets them by length, and runs the DP kernels batched on device:

  training:  (read, candidate-model) groups -> train.run_em buckets
  basecall:  (read, strand, candidate-model) decode tasks -> Viterbi buckets

Results are scattered back into per-read state; FASTA output is emitted in
input order (matching the reference's ordered chunk flushing,
nanocall.cpp:859-861).
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import jax
import numpy as np

from . import batching, events as events_mod, kmer, read_pipeline, train, transitions
from .config import Config
from .ops import hmm
from .pore_model import PoreModelParams
# the HBM budget and batch-quant ladders live in shapes.py — the single
# enumeration of every compiled shape the drivers below may emit
from .shapes import BP_MEM_BUDGET, SCORE_QUANT
from .transitions import TransitionParams

log = logging.getLogger("nanocall")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainGroup:
    read_idx: int
    key: tuple  # (name0, name1) candidate key
    seqs: list  # [(EventSequence, strand)]
    model_names: tuple  # (name for strand 0, name for strand 1)
    joint: bool


def _candidate_model_lists(summary, models, cfg, evs):
    """Per-strand candidate model names (nanocall.cpp:300-323)."""
    model_list = [[], []]
    for st in (0, 1):
        if len(evs[st]) < cfg.min_ed_events:
            continue
        pref = summary.preferred_model.get(st)
        if pref:
            model_list[st] = [pref]
        else:
            model_list[st] = [
                name for name, m in models.items() if m.strand in (st, 2)
            ]
    return model_list


def _train_subseqs(ev, num_events: int):
    """The two training subsequences: first and last num_events/2 events
    (nanocall.cpp:327-338)."""
    n = min(num_events, len(ev))
    h = n // 2
    first = events_mod.EventSequence(
        mean=ev.mean[:h], stdv=ev.stdv[:h], start=ev.start[:h], length=ev.length[:h]
    )
    last = events_mod.EventSequence(
        mean=ev.mean[len(ev) - h :],
        stdv=ev.stdv[len(ev) - h :],
        start=ev.start[len(ev) - h :],
        length=ev.length[len(ev) - h :],
    )
    return [first, last]


def _read_train_groups(ridx, s, models, cfg, evs):
    """One read's (read, candidate) training groups."""
    groups = []
    model_list = _candidate_model_lists(s, models, cfg, evs)
    sub = {
        st: _train_subseqs(evs[st], cfg.scaling_num_events)
        for st in (0, 1)
        if len(evs[st]) >= cfg.min_ed_events
    }
    if s.scale_strands_together:
        seqs = [(e, st) for st in (0, 1) for e in sub.get(st, [])]
        for m0 in model_list[0]:
            for m1 in model_list[1]:
                groups.append(
                    TrainGroup(
                        read_idx=ridx, key=(m0, m1), seqs=seqs,
                        model_names=(m0, m1), joint=True,
                    )
                )
    else:
        for st in (0, 1):
            if st not in sub:
                continue
            for m in model_list[st]:
                key = (m, "") if st == 0 else ("", m)
                groups.append(
                    TrainGroup(
                        read_idx=ridx, key=key, seqs=[(e, st) for e in sub[st]],
                        model_names=(m, m), joint=False,
                    )
                )
    return groups


def build_train_groups(summaries, models, cfg, ev_pool=None):
    """Expand reads into (read, candidate) training groups.  With ev_pool,
    per-read events fill (and come from) the pool's cache so the decode
    stage never re-reads the fast5."""
    groups = []
    for ridx, s in enumerate(summaries):
        if s.num_ed_events == 0:
            continue
        if ev_pool is not None:
            evs = ev_pool.load(summaries, ridx, cfg)
        else:
            evs = read_pipeline.load_events(s, cfg)
        groups.extend(_read_train_groups(ridx, s, models, cfg, evs))
    return groups


def _dump_group_training_data(grp, summary, models, cfg: Config, out_dir):
    """Write the reference's DUMP_TRAINING_DATA TSVs for one (read,
    candidate) group (Parameter_Trainer.hpp:157-221): per training
    subsequence k, emissions.k.tab (T x n log emission of the
    drift-corrected events under the scaled candidate model),
    transitions.k.tab (dense n x n log transition table, -1000 filler for
    absent transitions), and fw.k.tab / bw.k.tab (the forward-backward
    alpha/beta matrices) — the offline-numerics debugging bundle."""
    import io
    import os

    params = summary.pm_params[grp.key]
    stp = summary.st_params[grp.key]
    _, to_idx, _, _ = transitions._slot_maps(cfg.kmer_size)
    dense_cache = {}  # formatted dense table bytes per (p_stay, p_skip)

    def dense_bytes(table):
        key = (table.params.p_stay, table.params.p_skip)
        if key not in dense_cache:
            # n x n rows are the -1000 filler except <= 21 real neighbours:
            # format only those (np.savetxt on 4096^2 values takes ~30 s)
            n = table.n_states
            filler = ["-1000"] * n
            out = io.StringIO()
            for i in range(n):
                row = filler.copy()
                for k in range(to_idx.shape[0]):
                    v = table.to_logp[k, i]
                    if np.isfinite(v):
                        row[to_idx[k, i]] = "%g" % v
                out.write("\t".join(row))
                out.write("\n")
            dense_cache[key] = out.getvalue().encode()
        return dense_cache[key]

    for k, (ev, strand) in enumerate(grp.seqs):
        pm = models[grp.model_names[strand]].scaled(params)
        table = transitions.build_structured(stp[strand], cfg.kmer_size)
        ops = hmm.make_trans_ops(table)
        model = hmm.make_model_arrays(*pm.state_arrays())
        batch = events_mod.pad_batch(
            [ev], drifts=np.asarray([params.drift], np.float32)
        )
        out = hmm.fwbw(ops, model, batch, keep_emissions=True)
        T = len(ev)

        def save(name, mat):
            np.savetxt(os.path.join(out_dir, f"{name}.{k}.tab"),
                       np.asarray(mat), fmt="%g", delimiter="\t")

        save("emissions", np.asarray(out["em"])[0, :T])
        with open(os.path.join(out_dir, f"transitions.{k}.tab"), "wb") as fh:
            # chunked: one >50MB write() measures ~40x slower than 1MB
            # chunks on this filesystem
            mv = memoryview(dense_bytes(table))
            for off in range(0, len(mv), 1 << 20):
                fh.write(mv[off:off + (1 << 20)])
        save("fw", np.asarray(out["alpha"])[0, :T])
        save("bw", np.asarray(out["beta"])[0, :T])


def dump_training_data(summaries, models, cfg: Config, out_dir="."):
    """DUMP_TRAINING_DATA parity: dump the first trainable read's first
    candidate group's training-round inputs as TSVs, then stop (the
    reference abort()s after dumping, Parameter_Trainer.hpp:220).  Returns
    the dumped group, or None if no read can train."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    for ridx, s in enumerate(summaries):
        if s.num_ed_events == 0:
            continue
        evs = read_pipeline.load_events(s, cfg)
        groups = _read_train_groups(ridx, s, models, cfg, evs)
        if not groups:
            continue
        grp = groups[0]
        _dump_group_training_data(grp, s, models, cfg, out_dir)
        log.info(
            "dumped training data for read [%s] model [%s] (%d subsequences)"
            " to [%s]",
            s.read_id, "+".join(n for n in grp.key if n), len(grp.seqs),
            out_dir,
        )
        return grp
    return None


def pack_train_batch(groups, summaries, models, cfg, pad_T=None, pad_G=None):
    """Pack TrainGroups into the arrays consumed by train.train_one_round.

    S is always padded to 4 (2 subsequences x 2 strands) so single- and
    double-strand workloads share one compiled training shape."""
    n = kmer.n_states(cfg.kmer_size)
    G = pad_G or len(groups)
    S = max(4, max(len(g.seqs) for g in groups))
    T = pad_T or max(len(e) for g in groups for e, _ in g.seqs)
    ev = {
        "mean": np.ones((G, S, T), np.float32),
        "stdv": np.ones((G, S, T), np.float32),
        "log_stdv": np.zeros((G, S, T), np.float32),
        "start": np.zeros((G, S, T), np.float32),
        "length": np.zeros((G, S), np.int32),
        "strand": np.zeros((G, S), np.int32),
        "valid": np.zeros((G, S), bool),
    }
    # model BANK: one (M, 2, n) entry per distinct model-name pair, with a
    # per-group index gathered on device (train_one_round) — uploads each
    # model once per bucket instead of once per group
    pair_ids: dict = {}
    model_idx = np.zeros(G, np.int32)
    pm0 = np.zeros((G, 6), np.float32)
    pm0[:, [0, 3, 4, 5]] = 1.0  # identity params for padded groups
    st0 = np.full((G, 2, 2), [cfg.pr_stay, cfg.pr_skip], np.float32)
    for g, grp in enumerate(groups):
        s_sum = summaries[grp.read_idx]
        for si, (e, st) in enumerate(grp.seqs):
            L = len(e)
            ev["mean"][g, si, :L] = e.mean
            ev["stdv"][g, si, :L] = e.stdv
            ev["log_stdv"][g, si, :L] = e.log_stdv
            ev["start"][g, si, :L] = e.start
            ev["length"][g, si] = L
            ev["strand"][g, si] = st
            ev["valid"][g, si] = True
        model_idx[g] = pair_ids.setdefault(grp.model_names, len(pair_ids))
        pm0[g] = s_sum.pm_params[grp.key].as_array()
        st0[g] = [p.as_array() for p in s_sum.st_params[grp.key]]
    # pad the bank arity to a pow2 ladder (shape stability across buckets:
    # an exact count would mint a compiled shape per distinct chunk
    # composition once runs carry > 4 candidate model pairs)
    M = max(4, 1 << (len(pair_ids) - 1).bit_length()) if pair_ids else 4
    mdl = {
        k: np.ones((M, 2, n), np.float32)
        for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")
    }
    for names, mi in pair_ids.items():
        for st in (0, 1):
            m = models[names[st]]
            mdl["level_mean"][mi, st] = m.level_mean
            mdl["level_stdv"][mi, st] = m.level_stdv
            mdl["sd_mean"][mi, st] = m.sd_mean
            mdl["sd_lambda"][mi, st] = m.sd_lambda
    mdl["model_idx"] = model_idx
    return ev, mdl, pm0, st0


class _EMDriver:
    """Incremental EM dispatcher: accepts TrainGroups as they are built
    (streamed per read or all at once), dispatches a device chunk whenever a
    length bucket fills, and finish()es with the two-phase fetch/repack.

    Two-phase EM (cfg.em_phase1_rounds): a chunk's device time is
    max(rounds) over its G groups, so pass 1 runs EVERY group a few rounds
    and pass 2 repacks only the still-unconverged stragglers (usually a
    small fraction) into fresh chunks and resumes their exact per-group
    carry (train.run_em state0) — trajectory-identical to one uninterrupted
    run.  Chunk membership never affects a group's trajectory (per-group
    masked stopping), so streamed and staged feeding give identical
    results."""

    def __init__(self, summaries, models, cfg: Config,
                 default_transitions=None):
        self.summaries = summaries  # live list; may grow between add()s
        self.models = models
        self.cfg = cfg
        self.em_cfg = train.EMConfig(
            max_rounds=cfg.scaling_max_rounds,
            min_progress=cfg.scaling_min_progress,
            train_drift=bool(cfg.train_drift),
            train_scaling=cfg.train_scaling,
            train_transitions=cfg.train_transitions,
            K=cfg.kmer_size,
        )
        # a FILE-loaded default table (--trans): the reference E-steps
        # under it whenever st params are default — incl. round 1 of every
        # candidate (Parameter_Trainer.hpp:117-133); generated defaults
        # are represented exactly by the grouped tables, so only the
        # loaded case routes through the generic kernel (train_one_round
        # default_ops)
        if isinstance(default_transitions, transitions.SparseTransitions):
            self.default_ops = hmm.make_trans_ops(default_transitions)
            self.default_priors = np.array(
                [cfg.pr_stay, cfg.pr_skip], np.float32)
        else:
            self.default_ops = None
            self.default_priors = None
        from .parallel.mesh import DataSharder

        self.sharder = DataSharder(cfg.num_shards or None)
        self.phase1 = cfg.em_phase1_rounds or None
        self.pending = []  # (sub_groups, T, out_dev)
        self.queue: dict[int, list] = {}  # T -> groups awaiting a full chunk
        self.n_groups = 0
        self.n_stragglers = 0
        # device-work accounting for the EM roofline (bench.py --e2e /
        # roofline.em_mfu_report): every while_loop iteration E-steps the
        # FULL (G, S, T) batch regardless of per-group frozen flags, so
        # device event-rounds = loop iterations x G x S x T per dispatch
        self._meta: list = []  # (G, S, T, rounds0, limit) in dispatch order
        self._meta_i = 0
        self.work_event_rounds = 0
        self.work_bucket_iters: list = []
        import time as _time

        self._t0 = _time.time()

    def _bytes_per_cell(self) -> int:
        # Default path = the FUSED streaming round: only the alphas are
        # materialized as float32 (G*S, T, n) — 4 seqs x 1 tensor x 4 B
        # = 16 bytes per cell per group (train._fused_bwd_mstats).  A
        # --trans loaded table forces the legacy materialize-then-reduce
        # round (alpha+beta+em = 48) AND doubles the E-step (both
        # kernels computed, selected per sequence) = 96.
        return 96 if self.default_ops is not None else 16

    def _full_batch(self, T: int) -> int:
        # At the default scaling_num_events (T<=128 bucket) this still
        # yields the full 128-group chunk; large --scaling-num-events
        # shrink G instead of OOMing the chip.
        return batching.batch_size_for(
            T, self.cfg.train_group_batch, BP_MEM_BUDGET,
            kmer.n_states(self.cfg.kmer_size),
            bytes_per_cell=self._bytes_per_cell(),
        )

    def _dispatch(self, sub_groups, pad_T, pad_B, states, limit):
        real_flags = [g.joint for g in sub_groups]
        # per-candidate round caps (nanocall.cpp:420 vs :536): joint
        # candidates get 2x max_rounds, single-strand 1x, independently
        # within a mixed chunk; padding rows inherit the chunk max so
        # they never raise the static loop bound on their own
        joint_flags = real_flags + [any(real_flags)] * (pad_B - len(sub_groups))
        caps = self.em_cfg.caps(joint_flags)
        ev, mdl, pm0, st0 = pack_train_batch(
            sub_groups, self.summaries, self.models, self.cfg,
            pad_T=pad_T, pad_G=pad_B,
        )
        fit0 = np.full(pad_B, -np.inf, np.float32)
        frozen0 = np.arange(pad_B) >= len(sub_groups)  # padding starts frozen
        rounds0 = np.zeros(pad_B, np.int32)
        for gi, st in enumerate(states):
            if st is not None:
                fit0[gi], _, rounds0[gi] = st
        self._meta.append((pad_B, ev["mean"].shape[1], pad_T,
                           rounds0.copy(), limit))
        return train.run_em(
            ev, mdl, pm0, st0, self.em_cfg, caps=caps, fetch=False,
            state0=(fit0, frozen0, rounds0), round_limit=limit,
            # --num-shards: whole buckets, round-robin over the devices
            device=self.sharder.device(len(self._meta) - 1),
            default_ops=self.default_ops,
            default_priors=self.default_priors,
        )

    def _account(self, rounds) -> None:
        """Tally one fetched bucket's device work.  Loop iterations are
        reconstructed from the per-group round deltas: a group that froze
        by regression/singularity/no-progress ran one body past its last
        accepted round, so iters = max(delta) + 1 (clipped by the round
        limit; exact to within one iteration when the slowest group hit
        its cap on its final body)."""
        G, S, T, rounds0, limit = self._meta[self._meta_i]
        self._meta_i += 1
        delta = np.asarray(rounds, np.int64) - rounds0
        iters = int(delta.max()) + 1 if delta.size else 0
        if limit is not None:
            iters = min(iters, int(limit))
        self.work_bucket_iters.append(iters)
        self.work_event_rounds += iters * G * S * T

    def _scatter(self, grp, pm_row, st_row, fit_g, rounds_g, final):
        s = self.summaries[grp.read_idx]
        from .observe import read_context

        # per-read failure context (global_assert.hpp:21-25, set at
        # nanocall.cpp:295)
        with read_context(s.read_id):
            s.pm_params[grp.key] = PoreModelParams.from_array(pm_row)
            s.st_params[grp.key] = [
                TransitionParams(float(st_row[st, 0]), float(st_row[st, 1]))
                for st in (0, 1)
            ]
            if final:
                s.fits[grp.key] = float(fit_g)
                log.info(
                    "scaling_result read [%s] model [%s] pm_params [%s] "
                    "fit [%g] rounds [%d]",
                    s.read_id, "+".join(n for n in grp.key if n),
                    s.pm_params[grp.key], fit_g, rounds_g,
                )

    def add(self, groups) -> None:
        """Queue groups; dispatch any length bucket that reaches a full
        chunk (device EM of chunk N overlaps host ingestion/packing of
        chunk N+1 — pfor-style overlap, nanocall.cpp:859-861, expressed as
        async dispatch)."""
        self.n_groups += len(groups)
        for g in groups:
            T = batching.bucket_length(max(len(e) for e, _ in g.seqs))
            q = self.queue.setdefault(T, [])
            q.append(g)
            B = self._full_batch(T)
            if len(q) >= B:
                sub = q[:B]
                del q[:B]
                out_dev = self._dispatch(sub, T, B, [None] * B, self.phase1)
                self.pending.append((sub, T, out_dev))

    def _flush(self) -> None:
        """Dispatch the leftover partial chunks (same {8, 64, cap} batch
        quantization as the staged path's make_buckets)."""
        for T in sorted(self.queue):
            rest = self.queue[T]
            if not rest:
                continue
            buckets = batching.make_buckets(
                [T] * len(rest), self.cfg.train_group_batch, BP_MEM_BUDGET,
                kmer.n_states(self.cfg.kmer_size),
                bytes_per_cell=self._bytes_per_cell(),
            )
            for bT, B, chunks in buckets:
                for chunk in chunks:
                    sub = [rest[i] for i in chunk]
                    out_dev = self._dispatch(sub, bT, B, [None] * len(sub),
                                             self.phase1)
                    self.pending.append((sub, bT, out_dev))
            rest.clear()

    def finish_phase1(self) -> list:
        """Flush, fetch phase 1 in dispatch order, scatter, and DISPATCH
        (async) the phase-2 straggler chunks.  Returns the read indices
        whose every candidate group is already final — those reads can
        begin decode (score-pass packing/dispatch) while phase-2 EM runs
        on device; per-read model selection has been applied to them.

        The returned list plus finish_phase2()'s covers every trained read
        exactly once."""
        import time as _time

        self._flush()
        self.pending2 = []
        self._straggler_reads = []
        if not self.pending:
            return []
        # fetch + scatter in dispatch order; one device_get across every
        # bucket (one host round trip instead of one per array)
        t_fetch0 = _time.time()
        fetched = jax.device_get([out for _, _, out in self.pending])
        leftovers = []  # (group, (fit, frozen, rounds) carry, T)
        # per-read non-final group counts -> decode readiness
        left_of: dict[int, int] = {}
        for sub, T, _ in self.pending:
            for grp in sub:
                left_of[grp.read_idx] = left_of.get(grp.read_idx, 0) + 1
        for (sub, T, _), out_host in zip(self.pending, fetched):
            pm_f, st_f, fit, rounds, frozen = train.fetch_em_result(out_host)
            self._account(rounds)
            for gi, grp in enumerate(sub):
                final = bool(frozen[gi]) or self.phase1 is None
                self._scatter(grp, pm_f[gi], st_f[gi], fit[gi], rounds[gi],
                              final=final)
                if final:
                    left_of[grp.read_idx] -= 1
                else:
                    leftovers.append((grp, (fit[gi], False, rounds[gi]), T))
        self.n_stragglers = len(leftovers)
        self._t_fetch0 = t_fetch0
        self._t_p1 = _time.time()
        if leftovers:
            buckets2 = batching.make_buckets(
                [T for _, _, T in leftovers], self.cfg.train_group_batch,
                BP_MEM_BUDGET, kmer.n_states(self.cfg.kmer_size),
                bytes_per_cell=self._bytes_per_cell(),
            )
            for T, B, chunks in buckets2:
                for chunk in chunks:
                    entries = [leftovers[i] for i in chunk]
                    sub = [e[0] for e in entries]
                    out_dev = self._dispatch(sub, T, B,
                                             [e[1] for e in entries], None)
                    self.pending2.append((sub, out_dev))
        self._straggler_reads = sorted(
            r for r, c in left_of.items() if c > 0
        )
        ready = sorted(r for r, c in left_of.items() if c == 0)
        for r in ready:
            _select_read_models(self.summaries[r], self.cfg)
        return ready

    def finish_phase2(self) -> list:
        """Fetch the phase-2 straggler results dispatched by
        finish_phase1(), scatter, and return the newly ready read indices
        (model selection applied)."""
        import time as _time

        if self.pending2:
            fetched2 = jax.device_get([o for _, o in self.pending2])
            for (sub, _), out_host in zip(self.pending2, fetched2):
                pm_f, st_f, fit, rounds, frozen = train.fetch_em_result(
                    out_host)
                self._account(rounds)
                for gi, grp in enumerate(sub):
                    self._scatter(grp, pm_f[gi], st_f[gi], fit[gi],
                                  rounds[gi], final=True)
        if self.pending:
            log.debug(
                "train_pass groups=%d buckets=%d stragglers=%d "
                "ingest_dispatch_s=%.2f p1_fetch_s=%.2f p2_s=%.2f",
                self.n_groups, len(self.pending), self.n_stragglers,
                self._t_fetch0 - self._t0, self._t_p1 - self._t_fetch0,
                _time.time() - self._t_p1,
            )
        ready = self._straggler_reads
        for r in ready:
            _select_read_models(self.summaries[r], self.cfg)
        return ready

    def finish(self) -> None:
        """Flush, fetch phase 1, repack + run stragglers (phase 2), scatter
        results, and run model selection — the non-overlapped form
        (finish_phase1 + finish_phase2 back to back; the overlapped
        pipeline interleaves decode dispatch between the two)."""
        self.finish_phase1()
        self.finish_phase2()


def train_reads(summaries, models, cfg: Config, ev_pool=None,
                default_transitions=None) -> None:
    """Run EM training for all reads (train_reads, nanocall.cpp:275-582),
    updating summaries in place (pm_params, st_params, fits,
    preferred_model).

    With ev_pool, the decode stage's event pool is uploaded before the EM
    chunks are dispatched (the transfers then sit ahead of the EM queue
    instead of contending with it — see EventPool)."""
    groups = build_train_groups(summaries, models, cfg, ev_pool=ev_pool)
    if not groups:
        return
    if ev_pool is not None:
        ev_pool.prefetch(summaries, cfg)
    driver = _EMDriver(summaries, models, cfg, default_transitions)
    driver.add(groups)
    driver.finish()


def summarize_and_train(files, models, cfg: Config, ev_pool=None,
                        train_enabled=None, default_transitions=None) -> list:
    """Streamed ingest + training: summarize each fast5, load its events,
    expand its candidate groups, and dispatch EM device chunks as length
    buckets fill — so the host-side read ingestion (fast5 parsing, event
    filtering, packing) overlaps the EM device time instead of serializing
    in front of it (the reference's overlapped pfor chunks,
    nanocall.cpp:859-861, lifted to the whole summarize+train stage).

    Returns summaries in file order.  Identical results to
    summarize_many + train_reads (chunk membership does not affect EM
    trajectories; tested by test_pipeline.py)."""
    if train_enabled is None:
        train_enabled = cfg.train
    summaries: list = []
    driver = (_EMDriver(summaries, models, cfg, default_transitions)
              if train_enabled else None)
    _stream_ingest(files, models, cfg, summaries, ev_pool, driver)
    if driver is not None:
        driver.finish()
    return summaries


def _stream_ingest(files, models, cfg: Config, summaries, ev_pool, driver,
                   untrained=None) -> None:
    """Shared streamed-ingest loop (summarize_and_train + run_pipeline):
    append each read's summary, seed the event pool's per-read cache (the
    fast5 is read exactly once per read; decodable strands register as
    they appear, mirroring EventPool.prefetch's expansion), and feed the
    EM driver's length buckets.  `untrained`, if given, collects reads
    that are decodable but produced zero training groups.  Ends by
    dispatching the pool's tail upload (most rows are already in flight
    from the incremental block dispatches)."""
    from . import ingest

    for s, evs in ingest.ingest_stream(files, models, cfg):
        summaries.append(s)
        log.info("summary: [%s num_ed_events=%d]", s.base_file_name,
                 s.num_ed_events)
        if s.num_ed_events == 0:
            continue
        ridx = len(summaries) - 1
        if ev_pool is not None:
            ev_pool.events[ridx] = evs
            for st in (0, 1):
                if s.scale_strands_together or len(evs[st]) >= cfg.min_ed_events:
                    ev_pool.add(ridx, st, evs[st])
        if driver is not None:
            groups = _read_train_groups(ridx, s, models, cfg, evs)
            if groups:
                driver.add(groups)
            elif untrained is not None:
                # a read can be decodable yet have no training work (e.g.
                # joint scaling with one strand filtered below
                # min_ed_events -> empty candidate product): it must still
                # basecall from its initial params, like the staged flow's
                # basecall_reads over ALL summaries
                untrained.append(ridx)
    if ev_pool is not None:
        ev_pool.upload_now()


def run_pipeline(files, models, cfg: Config, default_transitions=None,
                 timer=None):
    """Fully pipelined ingest -> EM training -> decode:

      1. fork-pool ingest streams reads in; EM chunks dispatch as length
         buckets fill (host parsing overlaps EM device time);
      2. after phase-1 EM, ~90%% of reads' candidate groups are final
         (config.py em_phase1_rounds histogram): those reads' decode
         score/path chunks are packed and dispatched BEHIND the phase-2
         straggler EM chunks on the device queue, so straggler training
         and decode overlap instead of serializing;
      3. winners path-decode per bucket as their contest's scores land
         (_DecodeDriver), not after the full score pass.

    Returns (summaries, results).  Output-identical to
    summarize_and_train + basecall_reads (chunk membership affects neither
    EM trajectories nor per-task decode results; pinned by
    test_overlapped_pipeline_matches_staged and the FASTA goldens).

    `timer` (observe.StageTimer) gets a "training" stage ending when
    phase-2 EM results are fetched and a "basecalling" stage for the
    remainder — approximate attribution, since the stages genuinely
    overlap."""
    import contextlib

    ev_pool = EventPool() if cfg.basecall else None
    summaries: list = []
    driver = (_EMDriver(summaries, models, cfg, default_transitions)
              if cfg.train else None)
    untrained: list = []  # decodable reads with zero training groups
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext()
    )
    with stage("training" if cfg.train else "init_reads"):
        _stream_ingest(files, models, cfg, summaries, ev_pool, driver,
                       untrained=untrained)
        if not cfg.basecall:
            if driver is not None:
                driver.finish()
                if timer is not None:
                    timer.counters["em_event_rounds"] = \
                        driver.work_event_rounds
                    timer.counters["em_bucket_iters"] = \
                        driver.work_bucket_iters
            return summaries, []
        # overlap mode: decode chunks DISPATCH while phase-2 EM runs, but
        # their FETCHES wait until the phase-2 results are in, so the
        # host link carries one direction of traffic at a time
        # (Config.overlap_decode; chosen on the previous accelerator, not
        # re-measured on the H100)
        dec = _DecodeDriver(summaries, models, cfg, default_transitions,
                            ev_pool=ev_pool,
                            defer_fetch=cfg.overlap_decode)
        if driver is not None:
            ready = driver.finish_phase1() + untrained
            if not cfg.overlap_decode:
                ready += driver.finish_phase2()
            for ridx in sorted(ready):
                dec.add_read(ridx)
            if cfg.overlap_decode:
                for ridx in driver.finish_phase2():
                    dec.add_read(ridx)
                dec.start_fetches()
        else:
            for ridx in range(len(summaries)):
                dec.add_read(ridx)
    with stage("basecalling"):
        winners = dec.finish()
        results = select_and_assemble(winners, summaries, cfg)
    if timer is not None and driver is not None:
        # device-work counters for the EM roofline (bench.py --e2e)
        timer.counters["em_event_rounds"] = driver.work_event_rounds
        timer.counters["em_bucket_iters"] = driver.work_bucket_iters
    return summaries, results


def _select_read_models(s, cfg: Config) -> None:
    """Best-model selection for ONE read after its training is final
    (nanocall.cpp:437-459,552-570): pick the highest-fit candidate if it
    beats every other by scaling_select_threshold."""
    thr = cfg.scaling_select_threshold
    if not (thr < np.inf) or not s.fits:
        return
    joint_keys = [k for k in s.fits if k[0] and k[1]]
    if joint_keys:
        best = max(joint_keys, key=lambda k: s.fits[k])
        if all(
            k == best or s.fits[k] + thr < s.fits[best] for k in joint_keys
        ):
            s.preferred_model[2] = best
            log.info(
                "selected_model read [%s] strand [2] model [%s]",
                s.read_id, "+".join(best),
            )
    else:
        for st in (0, 1):
            keys = [k for k in s.fits if k[st] and not k[1 - st]]
            if not keys:
                continue
            best = max(keys, key=lambda k: s.fits[k])
            if all(k == best or s.fits[k] + thr < s.fits[best] for k in keys):
                s.preferred_model[st] = best[st]
                log.info(
                    "selected_model read [%s] strand [%d] model [%s]",
                    s.read_id, st, best[st],
                )


# ---------------------------------------------------------------------------
# basecalling
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeTask:
    read_idx: int
    strand: int
    key: tuple  # candidate key into pm_params/st_params
    model_name: str
    ev: events_mod.EventSequence  # uncorrected events for this strand
    # results
    logp: float = -np.inf
    path: np.ndarray | None = None


def _read_decode_tasks(ridx, s, cfg, evs) -> list:
    """One read's per-(strand, candidate) Viterbi tasks
    (nanocall.cpp:692-855)."""
    tasks = []
    if s.scale_strands_together:
        pref = s.preferred_model.get(2)
        if pref:
            sublist = [pref]
        else:
            sublist = [k for k in s.pm_params if k[0] and k[1]]
        for key in sublist:
            for st in (0, 1):
                tasks.append(
                    DecodeTask(
                        read_idx=ridx, strand=st, key=key,
                        model_name=key[st], ev=evs[st],
                    )
                )
    else:
        for st in (0, 1):
            if len(evs[st]) < cfg.min_ed_events:
                continue
            pref = s.preferred_model.get(st)
            if pref:
                keys = [(pref, "") if st == 0 else ("", pref)]
            else:
                keys = [k for k in s.pm_params if k[st] and not k[1 - st]]
            for key in keys:
                tasks.append(
                    DecodeTask(
                        read_idx=ridx, strand=st, key=key,
                        model_name=key[st], ev=evs[st],
                    )
                )
    return tasks


def build_decode_tasks(summaries, models, cfg, ev_pool=None) -> tuple[list, dict]:
    """Expand reads into per-(strand, candidate) Viterbi tasks
    (nanocall.cpp:692-855).  With ev_pool, per-read events come from (and
    fill) the pool's cache, so a prefetched pool means no fast5 re-read."""
    tasks = []
    read_events = {}
    for ridx, s in enumerate(summaries):
        if s.num_ed_events == 0:
            continue
        if ev_pool is not None:
            evs = ev_pool.load(summaries, ridx, cfg)
        else:
            evs = read_pipeline.load_events(s, cfg)
        read_events[ridx] = evs
        tasks.extend(_read_decode_tasks(ridx, s, cfg, evs))
    return tasks, read_events


class EventPool:
    """Per-bucket device-resident event arrays, indexed by (read_idx,
    strand), shipped to the device INCREMENTALLY in row blocks.

    Each host->device transfer costs bandwidth and a dispatch, so the
    pool (a) uploads each strand's events exactly ONCE, shared across
    candidate models and the score/path decode passes, (b) keeps
    log_stdv off the link (computed on device from stdv), (c) lets chunk
    programs take (pool, row-index vector) arguments instead of B per-row
    arrays, (d) DISPATCHES each UPLOAD_BLOCK rows as soon as ingest fills
    them, so the multi-MB transfers start during read ingestion instead
    of queuing behind it, and (e) generates the pow2 batch-padding rows
    ON DEVICE (jnp.full) instead of shipping constant padding (up to 25
    MB of the bench workload's ~100 MB was padding).  The block shipping
    was designed for the previous accelerator's slow host link; it is not
    re-measured on the H100.

    Dispatched blocks are views of append-only arena rows (rows < uploaded
    never mutate; numpy view refcounts keep replaced grow() buffers alive
    until the async transfer drains), and they persist on device — a late
    add() after finalize ships only the NEW rows and re-concatenates on
    device, never re-uploading the pool.  The (Pq, T) pool arrays are
    assembled by one tiny device-side concatenate whose shapes the
    persistent compilation cache amortizes like every other program here.

    Also the single loader/cache of per-read decode events (load()), so
    the fast5 is re-read once per read, not once per consumer."""

    UPLOAD_BLOCK = 128  # rows per incremental device_put (~4 MB/field at T=8192)

    def __init__(self):
        self.events: dict = {}  # read_idx -> [EventSequence x2]
        # T -> {mean/stdv/start: (cap, T) arrays, index: {(ridx, strand): row},
        #       count, uploaded}
        self._arena: dict = {}
        self._blocks: dict = {}  # T -> {field: [device block arrays]}
        self._dev: dict = {}  # T -> {field: (Pq, T) device array, _index, _rows}

    def load(self, summaries, ridx, cfg):
        if ridx not in self.events:
            self.events[ridx] = read_pipeline.load_events(summaries[ridx], cfg)
        return self.events[ridx]

    @staticmethod
    def _alloc(cap: int, T: int) -> dict:
        # row tails pre-filled (mean/stdv 1, start 0) at allocation, so
        # add() only writes each row's real prefix
        return {
            "mean": np.ones((cap, T), np.float32),
            "stdv": np.ones((cap, T), np.float32),
            "start": np.zeros((cap, T), np.float32),
        }

    def _grow(self, a: dict, T: int, cap: int) -> None:
        bufs = self._alloc(cap, T)
        n = a["count"]
        for k, buf in bufs.items():
            buf[:n] = a[k][:n]
            a[k] = buf

    def add(self, ridx, strand, ev) -> None:
        """Register a strand's events, copying the row into the host arena
        immediately (idempotent), and dispatch a device block whenever
        UPLOAD_BLOCK new rows have accumulated.

        The row copy (and the arena's growth first-touch) happens HERE,
        during the ingest loop, so first-touch page faults and host
        stacking overlap ingest instead of the transfers."""
        T = batching.bucket_length(len(ev))
        a = self._arena.get(T)
        if a is None:
            a = {**self._alloc(8, T), "index": {}, "count": 0, "uploaded": 0}
            self._arena[T] = a
        key = (ridx, strand)
        if key in a["index"]:
            return
        # never write a row index the device may already hold: _finalize
        # ships the tail QUANTIZED (a few prefilled padding rows), so a
        # post-finalize add skips past those shipped rows (the skipped
        # indices stay padding — harmless holes, masked by length)
        i = max(a["count"], a["uploaded"])
        while i >= a["mean"].shape[0]:
            self._grow(a, T, a["mean"].shape[0] * 2)
        L = len(ev)
        a["mean"][i, :L] = ev.mean
        a["stdv"][i, :L] = ev.stdv
        a["start"][i, :L] = ev.start
        a["index"][key] = i
        a["count"] = i + 1
        if a["count"] - a["uploaded"] >= self.UPLOAD_BLOCK:
            self._dispatch_rows(T, a["count"])

    def _dispatch_rows(self, T: int, upto: int) -> None:
        """device_put rows [uploaded, upto) as one block per field (async;
        views of append-only arena rows)."""
        import time as _time

        a = self._arena[T]
        lo = a["uploaded"]
        if upto <= lo:
            return
        t0 = _time.time()
        blocks = self._blocks.setdefault(
            T, {"mean": [], "stdv": [], "start": []}
        )
        for f in ("mean", "stdv", "start"):
            blocks[f].append(jax.device_put(a[f][lo:upto]))
        a["uploaded"] = upto
        self._dev.pop(T, None)  # any previous concat is stale
        log.debug("pool_block T=%d rows=[%d,%d) dispatch_s=%.3f",
                  T, lo, upto, _time.time() - t0)

    def _finalize(self, T: int) -> None:
        """Assemble the (Pq, T) device arrays.

        Small buckets (no block was dispatched during ingest) upload as
        ONE device_put of the pow2-padded arena slice — zero compiled
        programs, like the pre-block design.  Big buckets dispatch the
        tail rows QUANTIZED to a {8,16,32,64,128}-row ladder (shipping at
        most a few prefilled padding rows) and concatenate on device with
        a device-generated pow2 pad block, so every concat operand shape
        comes from a small fixed set — an arbitrary tail size would mint
        a fresh compiled concat per distinct per-bucket row count."""
        import jax.numpy as jnp

        a = self._arena[T]
        P = a["count"]
        if P == 0 or (T in self._dev and self._dev[T]["_rows"] == P):
            return
        Pq = max(8, 1 << (P - 1).bit_length())
        dev = {"_index": dict(a["index"]), "_rows": P}
        if a["uploaded"] == 0:
            # no blocks in flight: single direct upload (no concat program)
            if Pq > a["mean"].shape[0]:
                self._grow(a, T, Pq)
            for f in ("mean", "stdv", "start"):
                self._blocks.setdefault(
                    T, {"mean": [], "stdv": [], "start": []}
                )[f].append(jax.device_put(a[f][:Pq]))
                dev[f] = self._blocks[T][f][-1]
            a["uploaded"] = Pq
            self._dev[T] = dev
            log.debug("pool_finalize T=%d P=%d Pq=%d direct", T, P, Pq)
            return
        tail = P - a["uploaded"]
        if tail > 0:
            # quantize the tail block shape (rows beyond P are prefilled
            # padding, so shipping them is content-identical to the
            # device-generated pad)
            rung = next(q for q in (8, 16, 32, 64, 128) if q >= tail)
            upto = min(a["uploaded"] + rung, Pq)
            while upto > a["mean"].shape[0]:
                self._grow(a, T, a["mean"].shape[0] * 2)
            self._dispatch_rows(T, upto)
        dev_rows = a["uploaded"]
        for f in ("mean", "stdv", "start"):
            bs = list(self._blocks[T][f])
            if Pq > dev_rows:
                fill = 0.0 if f == "start" else 1.0
                bs.append(jnp.full((Pq - dev_rows, a[f].shape[1]), fill,
                                   jnp.float32))
            dev[f] = jnp.concatenate(bs, axis=0) if len(bs) > 1 else bs[0]
        self._dev[T] = dev
        log.debug("pool_finalize T=%d P=%d Pq=%d blocks=%d",
                  T, P, Pq, len(self._blocks[T]["mean"]))

    def prefetch(self, summaries, cfg) -> None:
        """Register every decodable strand (mirrors build_decode_tasks'
        event expansion); block uploads dispatch as rows accumulate."""
        import time as _time

        t0 = _time.time()
        for ridx, s in enumerate(summaries):
            if s.num_ed_events == 0:
                continue
            evs = self.load(summaries, ridx, cfg)
            for st in (0, 1):
                if s.scale_strands_together or len(evs[st]) >= cfg.min_ed_events:
                    self.add(ridx, st, evs[st])
        t1 = _time.time()
        self.upload_now()
        log.debug("pool_prefetch load_s=%.2f stack_dispatch_s=%.2f",
                  t1 - t0, _time.time() - t1)

    def upload_now(self) -> None:
        """Dispatch any not-yet-uploaded tail rows and assemble the device
        pool arrays (async; most rows are already in flight from add())."""
        for T in self._arena:
            self._finalize(T)

    def bucket(self, tasks, T):
        """(pool device arrays, (B,) row indices) for a chunk's tasks;
        uploads any rows not yet registered (inline fallback path — ships
        only the NEW rows, reusing the already-uploaded device blocks)."""
        arena_index = self._arena.get(T, {}).get("index", {})
        missing = [
            t for t in tasks if (t.read_idx, t.strand) not in arena_index
        ]
        for t in missing:
            self.add(t.read_idx, t.strand, t.ev)
        a = self._arena[T]
        if T not in self._dev or self._dev[T]["_rows"] != a["count"]:
            self._finalize(T)
        dev = self._dev[T]
        idx = np.array(
            [dev["_index"][(t.read_idx, t.strand)] for t in tasks], np.int32
        )
        return dev, idx


def _pooled_ev_batch(pool_mean, pool_stdv, pool_start, idx, drifts, lengths):
    """Gather a chunk's rows from the event pool and apply drift correction
    (Event.hpp:77-84), producing the ev_batch dict the decode kernels
    consume.  Pure jnp ops with no data-dependent control flow, so it runs
    identically TRACED (inside _decode_chunk_pooled's jit) and EAGER (the
    sparse / sharded branches) — the single point of truth for the
    pool-gather + drift sequence all three decode dispatch branches share
    (round 1's two semantic bugs were exactly branch-drift here)."""
    import jax.numpy as jnp

    mean = pool_mean[idx]
    stdv = pool_stdv[idx]
    start = pool_start[idx]
    return {
        "mean": mean - drifts[:, None] * start,
        "stdv": stdv,
        "log_stdv": jnp.log(stdv),
        "length": lengths,
    }


@functools.partial(jax.jit, static_argnames=("K", "with_path", "Tc"))
def _decode_chunk_pooled(pool_mean, pool_stdv, pool_start, idx, drifts, bank,
                         model_idx, pm_params, stp, lengths, K=6,
                         with_path=True, Tc=None):
    """One fused device dispatch per decode chunk: gather the chunk's rows
    from the event pool, apply drift correction, build grouped tables and
    scaled model arrays on device, and run the Viterbi decode.

    Tc (static): when set, run the chunked-time decode program instead of
    the full scan — bit-identical output (incl. the compact code bytes)
    with a ~(1 + 1.5/C)x HBM peak instead of ~2.5x, which is what admits
    the larger long-bucket batches of shapes.path_bp_budget."""
    gt = hmm.make_grouped_trans_device.__wrapped__(stp[:, 0], stp[:, 1], K)
    model = hmm.make_scaled_model_arrays.__wrapped__(bank, model_idx, pm_params)
    ev_batch = _pooled_ev_batch(pool_mean, pool_stdv, pool_start, idx,
                                drifts, lengths)
    if Tc:
        return hmm.viterbi_decode_grouped_tchunk.__wrapped__(
            gt, model, ev_batch, Tc=Tc, with_path=with_path,
            compact_path=with_path,
        )
    return hmm.viterbi_decode_grouped.__wrapped__(
        gt, model, ev_batch, with_path=with_path,
        compact_path=with_path,  # 0.75 B/event path fetch
    )


def _dispatch_decode_chunk(sub, T, Bc, summaries, models, cfg: Config,
                           sharder, sparse_ops, sparse_chunk: bool,
                           with_path: bool, ev_pool):
    """Pack one decode chunk (Bc slots, padded) and dispatch it (async).
    Returns the on-device output tree."""
    import jax.numpy as jnp

    n = kmer.n_states(cfg.kmer_size)
    length = np.zeros(Bc, np.int32)
    drifts = np.zeros(Bc, np.float32)
    pm_params = np.zeros((Bc, 6), np.float32)
    pm_params[:, [0, 3, 4, 5]] = 1.0
    model_idx = np.zeros(Bc, np.int32)
    name_ids: dict = {}
    stp = np.full((Bc, 2), [0.1, 0.3], np.float64)
    for bi, t in enumerate(sub):
        s = summaries[t.read_idx]
        params = s.pm_params[t.key]
        pm = models[t.model_name]
        L = len(t.ev)
        if L and abs(
            float(np.mean(t.ev.mean))
            - (pm.mean() * params.scale + params.shift)
        ) > 5.0:
            # scaling sanity warning (nanocall.cpp:673-683)
            log.warning(
                "means_apart read [%s] strand [%d] model [%s] "
                "model_mean=[%g] events_mean=[%g]",
                s.read_id, t.strand, t.model_name,
                pm.mean() * params.scale + params.shift,
                float(np.mean(t.ev.mean)),
            )
        model_idx[bi] = name_ids.setdefault(t.model_name, len(name_ids))
        pm_params[bi] = params.as_array()
        drifts[bi] = params.drift
        length[bi] = L
        sp = s.st_params[t.key][t.strand]
        stp[bi] = [sp.p_stay, sp.p_skip]
    # model bank: each distinct model uploads once; scaling happens
    # on device (hmm.make_scaled_model_arrays).  Arity padded to a pow2
    # ladder: shape stability across chunk compositions (> 4 models)
    M = max(4, 1 << (len(name_ids) - 1).bit_length()) if name_ids else 4
    bank = {
        k: np.ones((M, n), np.float32)
        for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")
    }
    for name, mi in name_ids.items():
        pm = models[name]
        bank["level_mean"][mi] = pm.level_mean
        bank["level_stdv"][mi] = pm.level_stdv
        bank["sd_mean"][mi] = pm.sd_mean
        bank["sd_lambda"][mi] = pm.sd_lambda
    # chunk rows come from the event pool: idx selects each task's
    # (read, strand) row; padding slots reuse row 0 (masked by
    # length=0, exactly like the old all-ones pad row)
    pool_dev, idx = ev_pool.bucket(sub, T)
    idx = np.concatenate([idx, np.zeros(Bc - len(sub), np.int32)])
    # The three dispatch branches (sparse / sharded-grouped /
    # fused-grouped) share _pooled_ev_batch and
    # make_scaled_model_arrays as the single point of truth for
    # the pool-gather + drift + model assembly sequence; the fused
    # branch stays one jitted program (one compiled shape per chunk
    # shape) by tracing the same helpers.
    # tests/test_pipeline.py::test_decode_branches_agree pins the
    # three outputs equal on a shared workload.
    if sparse_chunk:
        model = hmm.make_scaled_model_arrays(bank, model_idx, pm_params)
        ev_batch = _pooled_ev_batch(
            pool_dev["mean"], pool_dev["stdv"], pool_dev["start"],
            jnp.asarray(idx), jnp.asarray(drifts), length,
        )
        model, ev_batch = sharder.shard((model, ev_batch), Bc)
        return hmm.viterbi_decode(
            sparse_ops, model, ev_batch, with_path=with_path
        )
    # Long with_path buckets select the chunked-time program (bounded
    # traceback layout-copy -> bigger batch within the HBM budget; the
    # batch cap in _full_batch/shapes.path_bp_budget assumes this, so the
    # two MUST stay in sync).  Bit-identical output incl. compact codes.
    tc = (batching.tchunk_len(T)
          if with_path and T >= batching.TCHUNK_MIN_T else None)
    if sharder.active:
        # multi-device: gather rows, then shard the batch over the
        # 'data' mesh axis
        gt = hmm.make_grouped_trans_device(
            stp[:, 0].astype(np.float32), stp[:, 1].astype(np.float32),
            K=cfg.kmer_size,
        )
        model = hmm.make_scaled_model_arrays(
            {k: jnp.asarray(v) for k, v in bank.items()},
            model_idx, pm_params,
        )
        ev_batch = _pooled_ev_batch(
            pool_dev["mean"], pool_dev["stdv"], pool_dev["start"],
            jnp.asarray(idx), jnp.asarray(drifts), length,
        )
        gt, model, ev_batch = sharder.shard((gt, model, ev_batch), Bc)
        if tc:
            return hmm.viterbi_decode_grouped_tchunk(
                gt, model, ev_batch, Tc=tc, with_path=with_path,
                compact_path=with_path,
            )
        return hmm.viterbi_decode_grouped(
            gt, model, ev_batch, with_path=with_path,
            compact_path=with_path,
        )
    # grouped fast path, fully fused: pool gather + device-side
    # drift correction + table/model construction + decode in
    # ONE dispatch per chunk
    return _decode_chunk_pooled(
        pool_dev["mean"], pool_dev["stdv"], pool_dev["start"],
        idx, jnp.asarray(drifts),
        {k: jnp.asarray(v) for k, v in bank.items()},
        model_idx, pm_params,
        stp.astype(np.float32), length,
        K=cfg.kmer_size, with_path=with_path, Tc=tc,
    )


def _finish_decode_chunk(sub, out, with_path: bool, cfg: Config,
                         progress=None) -> None:
    """Fetch one dispatched chunk's results and fill task.logp (and
    task.path when with_path).  Runs on worker threads: fetch round trips
    overlap each other and later chunks' device work (device chunks
    complete in dispatch order, so workers drain in pipeline order)."""
    import time as _time

    from . import native

    t_w0 = _time.time()
    out = jax.device_get(out)
    t_w1 = _time.time()
    logps = out["logp"]
    compact = with_path and "codes" in out
    paths = out.get("path") if with_path else None
    for bi, t in enumerate(sub):
        t.logp = float(logps[bi])
        if compact:
            # reconstruct the state path from the bit-packed compact
            # device encoding (exact; native scalar loop, releases the
            # GIL); an eventless task has an empty path, not [path0]
            L = len(t.ev)
            if L == 0:
                t.path = np.zeros(0, np.int32)
            else:
                t.path = native.path_from_packed_codes(
                    int(out["path0"][bi]), out["codes"][bi], L,
                    cfg.kmer_size,
                )
        elif with_path:
            # copy: a view would pin the whole (B, T) chunk array
            t.path = paths[bi, : len(t.ev)].copy()
    if progress is not None:
        progress.add(len(sub))
    log.debug("decode_chunk real=%d fetch_s=%.3f host_s=%.3f",
              len(sub), t_w1 - t_w0, _time.time() - t_w1)


def pick_winners(tasks, summaries) -> list:
    """Best-scoring candidate per read: joint (double-strand) candidates by
    summed strand log-prob (nanocall.cpp:725-748), single-strand per strand
    (nanocall.cpp:819-835).  Requires task.logp filled."""
    by_read: dict[int, list[DecodeTask]] = {}
    for t in tasks:
        by_read.setdefault(t.read_idx, []).append(t)
    winners = []
    for ridx in sorted(by_read):
        s = summaries[ridx]
        rtasks = by_read[ridx]
        if s.scale_strands_together:
            cands: dict[tuple, dict[int, DecodeTask]] = {}
            for t in rtasks:
                cands.setdefault(t.key, {})[t.strand] = t
            best_key = max(
                cands, key=lambda k: sum(t.logp for t in cands[k].values())
            )
            for st in (0, 1):
                if st in cands[best_key]:
                    winners.append(cands[best_key][st])
        else:
            for st in (0, 1):
                st_tasks = [t for t in rtasks if t.strand == st]
                if st_tasks:
                    winners.append(max(st_tasks, key=lambda t: t.logp))
    return winners


class _DecodeDriver:
    """Incremental decode dispatcher: accepts reads' decode tasks as their
    training finishes, dispatches score chunks (contested candidates,
    forward-only — XLA drops the backpointers) and path chunks (winners,
    full traceback) whenever a length bucket fills, and drains completions
    in dispatch order — winners path-decode as their contest's scores land
    instead of after the whole score pass, and straggler EM (phase 2)
    overlaps decode packing/dispatch on the device queue (the reference's
    fully overlapped pfor flushing, nanocall.cpp:611-619,859-861, lifted
    to the whole train->decode pipeline).

    Chunk membership never affects a task's result (each task's decode is
    independent; test_per_file_runs_concat_to_directory_run), so the
    incremental feeding is output-identical to the staged two-pass flow.

    Tasks with default (untrained) transition params and a file-loaded
    custom table (--trans, nanocall.cpp:651-661) decode via the general
    sparse kernel; everything else uses the grouped fast path (queues are
    keyed by (length bucket, kind, pass))."""

    def __init__(self, summaries, models, cfg: Config,
                 default_transitions=None, ev_pool=None, progress=None,
                 defer_fetch: bool = False):
        from concurrent.futures import ThreadPoolExecutor

        from .observe import Progress
        from .parallel.mesh import DataSharder

        self.summaries = summaries
        self.models = models
        self.cfg = cfg
        self.ev_pool = ev_pool if ev_pool is not None else EventPool()
        self.use_sparse = isinstance(
            default_transitions, transitions.SparseTransitions
        )
        self.sparse_ops = (
            hmm.make_trans_ops(default_transitions) if self.use_sparse else None
        )
        self.sharder = DataSharder(cfg.num_shards or None)
        self.align = self.sharder.n if self.sharder.active else 1
        self.progress = progress or Progress("decode tasks")
        self.n = kmer.n_states(cfg.kmer_size)
        self.queue: dict = {}  # (T, sparse_kind, with_path) -> [tasks]
        self.fifo: list = []  # (sub, with_path) in dispatch order
        self.fetches: dict = {}  # fifo index -> Future
        self.drained = 0
        self.contests: dict = {}  # gkey -> {"left": int, "tasks": []}
        self.winners: list = []
        self._fpool = ThreadPoolExecutor(4)
        # defer_fetch: dispatch chunks but hold their fetch submissions
        # until start_fetches() — lets decode DISPATCH overlap straggler
        # EM while keeping the host link free of decode download traffic
        # until the EM/pool transfers drain (Config.overlap_decode)
        self._defer = defer_fetch
        self._deferred: list = []  # (i, sub, out, with_path)

    def _is_sparse(self, t) -> bool:
        if not self.use_sparse:
            return False
        sp = self.summaries[t.read_idx].st_params[t.key][t.strand]
        return sp.is_default(
            transitions.TransitionParams(self.cfg.pr_stay, self.cfg.pr_skip)
        )

    def _full_batch(self, T: int, with_path: bool = True,
                    sparse_kind: bool = False) -> int:
        if with_path or not self.cfg.score_max_batch:
            # score chunks default to the path cap: bigger score chunks
            # were slower end-to-end on the previous accelerator (coarser
            # granularity delays the first winners' path dispatch;
            # Config.score_max_batch); not re-measured on the H100
            # Grouped long-bucket PATH chunks dispatch the chunked-time
            # program, whose smaller HBM peak admits a larger batch
            # (shapes.path_bp_budget).  Sparse chunks keep the full-scan
            # generic kernel and its conservative budget — and so do
            # score chunks sharing this branch (score_max_batch=0): they
            # run the forward-only program (no bp tensor either way), so
            # the cap is a granularity heuristic, and enlarging it would
            # re-create the slower-end-to-end coarseness above.
            from .shapes import path_bp_budget

            budget = (path_bp_budget(T)
                      if with_path and not sparse_kind else BP_MEM_BUDGET)
            cap = batching.batch_size_for(
                T, self.cfg.bucket_max_batch, budget, self.n
            )
        else:
            # score-only chunks hold no backpointers: cap by the gathered
            # input rows + scan workspace (~60 B per (row, event)) instead
            # of the path budget's T x n_states bytes; snap to the shape
            # ladder so odd memory caps don't mint new compile shapes
            cap = batching.batch_size_for(
                T, self.cfg.score_max_batch, BP_MEM_BUDGET, 1,
                bytes_per_cell=60,
            )
            cap = max(q for q in SCORE_QUANT if q <= max(cap, 8))
        # round DOWN to a multiple of align (floor align): rounding up let
        # a sharded batch exceed the backpointer HBM budget (cap 10 with
        # align 8 became 16 — same bug class fixed in batching.make_buckets)
        return max(self.align, (cap // self.align) * self.align)

    def add_tasks(self, tasks) -> None:
        """Register tasks (whole reads' worth): uncontested candidates are
        winners outright and go straight to the path queue; contested ones
        queue for the score pass with per-group completion counters."""
        groups: dict = {}
        for t in tasks:
            s = self.summaries[t.read_idx]
            gk = (t.read_idx,
                  None if s.scale_strands_together else t.strand)
            groups.setdefault(gk, []).append(t)
        for gk, gtasks in groups.items():
            if len({t.key for t in gtasks}) == 1:
                self.winners.extend(gtasks)
                self._enqueue(gtasks, with_path=True)
            else:
                self.contests[gk] = {"left": len(gtasks), "tasks": gtasks}
                self._enqueue(gtasks, with_path=False)
        self._pump()

    def add_read(self, ridx: int) -> None:
        """Build and register one trained read's decode tasks (events from
        the pool cache — no fast5 re-read)."""
        s = self.summaries[ridx]
        if s.num_ed_events == 0:
            return
        evs = self.ev_pool.load(self.summaries, ridx, self.cfg)
        self.add_tasks(_read_decode_tasks(ridx, s, self.cfg, evs))

    def _enqueue(self, tasks, with_path: bool) -> None:
        for t in tasks:
            T = batching.bucket_length(len(t.ev))
            key = (T, self._is_sparse(t), with_path)
            self.queue.setdefault(key, []).append(t)

    def _pump(self) -> None:
        """Dispatch every queue whose length reaches a full chunk."""
        for (T, kind, wp), q in self.queue.items():
            B = self._full_batch(T, with_path=wp, sparse_kind=kind)
            while len(q) >= B:
                sub = q[:B]
                del q[:B]
                self._dispatch(sub, T, B, kind, wp)

    def _dispatch(self, sub, T, B, sparse_kind, with_path) -> None:
        out = _dispatch_decode_chunk(
            sub, T, B, self.summaries, self.models, self.cfg, self.sharder,
            self.sparse_ops, sparse_kind, with_path, self.ev_pool,
        )
        i = len(self.fifo)
        self.fifo.append((sub, with_path))
        if self._defer:
            self._deferred.append((i, sub, out, with_path))
            return
        # fetch + host assembly start on a worker immediately: round trips
        # overlap each other and later chunks' device work
        self.fetches[i] = self._fpool.submit(
            _finish_decode_chunk, sub, out, with_path, self.cfg,
            self.progress,
        )

    def start_fetches(self) -> None:
        """Submit the deferred fetches (defer_fetch mode) and stop
        deferring for subsequent dispatches."""
        self._defer = False
        for i, sub, out, wp in self._deferred:
            self.fetches[i] = self._fpool.submit(
                _finish_decode_chunk, sub, out, wp, self.cfg, self.progress,
            )
        self._deferred.clear()

    def _flush(self, with_path: bool) -> None:
        """Dispatch the leftover partial chunks of one pass ({8, 64, cap}
        batch quantization; score chunks use the larger no-backpointer
        cap)."""
        for (T, kind, wp), q in list(self.queue.items()):
            if wp is not with_path or not q:
                continue
            if wp or not self.cfg.score_max_batch:
                buckets = batching.make_buckets(
                    [len(t.ev) for t in q], self.cfg.bucket_max_batch,
                    BP_MEM_BUDGET, self.n, align=self.align,
                )
            else:
                # cap = the SAME ladder-snapped, align-floored size the
                # full-chunk path uses (_full_batch), and the same rung
                # set — a leftover must never mint a compiled shape the
                # full chunks don't already have (an unsnapped mem cap
                # like 700 would)
                cap = self._full_batch(T, with_path=False)
                buckets = batching.make_buckets(
                    [len(t.ev) for t in q], cap,
                    BP_MEM_BUDGET, 1, align=self.align, bytes_per_cell=60,
                    quant=SCORE_QUANT,
                )
            for bT, B, chunks in buckets:
                for chunk in chunks:
                    self._dispatch([q[i] for i in chunk], bT, B, kind, wp)
            q.clear()

    def _on_scored(self, sub) -> None:
        """Score results landed for these tasks: resolve any contests that
        are now fully scored and queue their winners for path decode."""
        done_groups = []
        for t in sub:
            s = self.summaries[t.read_idx]
            gk = (t.read_idx, None if s.scale_strands_together else t.strand)
            c = self.contests[gk]
            c["left"] -= 1
            if c["left"] == 0:
                done_groups.append(gk)
        for gk in done_groups:
            c = self.contests.pop(gk)
            w = pick_winners(c["tasks"], self.summaries)
            self.winners.extend(w)
            self._enqueue(w, with_path=True)
        if done_groups:
            self._pump()

    def _drain(self) -> None:
        """Process completions in dispatch order; score completions feed
        the path queues (and may dispatch more chunks, which this loop then
        also drains)."""
        while self.drained < len(self.fifo):
            i = self.drained
            self.fetches.pop(i).result()
            sub, wp = self.fifo[i]
            self.fifo[i] = None  # drop refs
            if not wp:
                self._on_scored(sub)
            self.drained += 1

    def finish(self) -> list:
        """Flush both passes, drain everything, and return the winner tasks
        (paths filled) — same contract as the old two-pass flow."""
        try:
            self.start_fetches()
            self._flush(with_path=False)
            self._drain()  # resolves all contests; dispatches path chunks
            assert not self.contests, "unscored contest groups remain"
            self._flush(with_path=True)
            self._drain()
        finally:
            self._fpool.shutdown()
        self.progress.finish()
        return self.winners


def run_decode_tasks(tasks, summaries, models, cfg: Config,
                     default_transitions=None, ev_pool=None) -> list:
    """Execute Viterbi tasks: score-only forward over contested candidates,
    full decode with traceback for each winner — incrementally pipelined
    (winner path chunks dispatch as their contest's scores land; see
    _DecodeDriver).  Returns the winner tasks (with paths filled)."""
    driver = _DecodeDriver(summaries, models, cfg, default_transitions,
                           ev_pool=ev_pool)
    driver.add_tasks(tasks)
    return driver.finish()


@dataclasses.dataclass
class BasecallResult:
    read_idx: int
    strand: int
    seq_name: str
    base_seq: str
    model_name: str
    key: tuple
    logp: float
    path: np.ndarray
    moves: np.ndarray
    ev: events_mod.EventSequence


def select_and_assemble(winners, summaries, cfg: Config) -> list:
    """Assemble base sequences for the winning tasks (as chosen by
    pick_winners), record preferred models, and return results ordered by
    (read, strand)."""
    from .observe import read_context

    results = []
    for t in sorted(winners, key=lambda t: (t.read_idx, t.strand)):
        s = summaries[t.read_idx]
        with read_context(s.read_id):
            if s.scale_strands_together:
                s.preferred_model[2] = t.key
            s.preferred_model[t.strand] = t.model_name
            from . import native

            moves, base_seq = native.moves_and_base_seq(t.path, cfg.kmer_size)
            seq_name = f"{s.read_id}:{s.base_file_name}:{t.strand}"
            log.info(
                "best_model read [%s] strand [%d] model [%s] log_path_prob [%g]",
                s.read_id, t.strand, t.model_name, t.logp,
            )
            results.append(
                BasecallResult(
                    read_idx=t.read_idx, strand=t.strand, seq_name=seq_name,
                    base_seq=base_seq, model_name=t.model_name, key=t.key,
                    logp=t.logp, path=t.path, moves=moves, ev=t.ev,
                )
            )
    return results


def basecall_reads(summaries, models, cfg: Config, default_transitions=None,
                   ev_pool=None) -> list:
    """Full basecall stage; returns BasecallResults in input order.

    Pass the EventPool prefetched during train_reads so event uploads have
    already overlapped EM device time; without one, the pool is built
    inline (--no-train / resume flows)."""
    if ev_pool is None:
        ev_pool = EventPool()
    tasks, _ = build_decode_tasks(summaries, models, cfg, ev_pool=ev_pool)
    if not tasks:
        return []
    winners = run_decode_tasks(tasks, summaries, models, cfg,
                               default_transitions, ev_pool=ev_pool)
    return select_and_assemble(winners, summaries, cfg)
