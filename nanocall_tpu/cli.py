"""Command-line interface: `python -m nanocall_tpu ...`.

Mirrors the reference binary's flag surface (nanocall.cpp:50-95) with
argparse.  Dev tools (run-viterbi, run-fwbw, compute-state-transitions,
compute-scaled-pore-model) live in tools.py as subcommands.
"""

from __future__ import annotations

import argparse
import logging
import sys

from . import basecall, output, pore_model, read_pipeline, transitions
from .config import Config
from .models import load_builtin_models

log = logging.getLogger("nanocall")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanocall-tpu",
        description="Call bases in Oxford Nanopore reads (JAX, on a GPU or the CPU).",
    )
    from .version import get_version

    p.add_argument("--version", action="version", version=get_version())
    p.add_argument("inputs", nargs="+", help="directories, fast5 files, or fofn files ('-' = stdin)")
    p.add_argument("--ed-group", default="", help="EventDetection group to use")
    p.add_argument("--chunk-size", type=int, default=1,
                   help="(accepted for CLI parity; device bucketing replaces thread chunking)")
    p.add_argument("--log", action="append", default=[], help="log level")
    p.add_argument("--stats", dest="stats_fn", default="", help="stats TSV output")
    p.add_argument("--train-drift", default="", choices=["", "0", "1"])
    p.add_argument("--trim-ed-hp-end", type=int, default=50)
    p.add_argument("--trim-ed-hp-start", type=int, default=50)
    p.add_argument("--trim-ed-sq-end", type=int, default=50)
    p.add_argument("--trim-ed-sq-start", type=int, default=50)
    p.add_argument("--max-ed-events", type=int, default=100000)
    p.add_argument("--min-ed-events", type=int, default=10)
    p.add_argument("--fasta-line-width", type=int, default=80)
    p.add_argument("--scaling-select-threshold", type=float, default=20.0)
    p.add_argument("--scaling-min-progress", type=float, default=1.0)
    p.add_argument("--scaling-max-rounds", type=int, default=10)
    p.add_argument("--scaling-num-events", type=int, default=200)
    p.add_argument("--1d", dest="template_only", action="store_true",
                   help="interpret entire read as 1D template only")
    p.add_argument("--single-strand-scaling", action="store_true")
    p.add_argument("--double-strand-scaling", action="store_true")
    p.add_argument("--no-train-transitions", action="store_true")
    p.add_argument("--no-train-scaling", action="store_true")
    p.add_argument("--train", action="store_true")
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--basecall", action="store_true")
    p.add_argument("--no-basecall", action="store_true")
    p.add_argument("--pr-skip", type=float, default=0.3)
    p.add_argument("--pr-stay", type=float, default=0.1)
    p.add_argument("-s", "--trans", dest="trans_fn", default="")
    p.add_argument("--model-fofn", default="")
    p.add_argument("-m", "--model", action="append", default=[],
                   help="custom pore model 'strand:file' (0=template, 1=complement, 2=both)")
    p.add_argument("--pore", default="r9", choices=["r73", "r9"])
    p.add_argument("--write-fast5", action="store_true")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-t", "--threads", type=int, default=-1,
                   help="host ingest worker processes (default: auto; device "
                   "parallelism handles the DP compute either way)")
    p.add_argument("--batch", type=int, default=256, help="decode bucket batch size")
    p.add_argument("--trace-dir", default="", help="write a JAX profiler trace here")
    p.add_argument("--resume-stats", default="",
                   help="resume from a --stats TSV of a previous run (skips training)")
    p.add_argument("--dump-training-data", default="", metavar="DIR",
                   help="debug: dump the first candidate's training-round "
                   "inputs (emissions/transitions/fw/bw TSVs) to DIR and "
                   "exit (the reference's DUMP_TRAINING_DATA hook)")
    # multi-host execution
    p.add_argument("--coordinator", default="",
                   help="multi-host coordinator address host:port")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    return p


def config_from_args(args) -> Config:
    cfg = Config(
        pore=args.pore,
        model_files=args.model,
        model_fofn=args.model_fofn,
        trans_file=args.trans_fn,
        pr_stay=args.pr_stay,
        pr_skip=args.pr_skip,
        ed_group=args.ed_group,
        min_ed_events=args.min_ed_events,
        max_ed_events=args.max_ed_events,
        trim_ed_sq_start=args.trim_ed_sq_start,
        trim_ed_sq_end=args.trim_ed_sq_end,
        trim_ed_hp_start=args.trim_ed_hp_start,
        trim_ed_hp_end=args.trim_ed_hp_end,
        scaling_select_threshold=args.scaling_select_threshold,
        scaling_min_progress=args.scaling_min_progress,
        scaling_max_rounds=args.scaling_max_rounds,
        scaling_num_events=args.scaling_num_events,
        template_only=args.template_only,
        output=args.output,
        write_fast5=args.write_fast5,
        fasta_line_width=args.fasta_line_width,
        stats_fn=args.stats_fn,
        bucket_max_batch=args.batch,
        ingest_workers=args.threads,
    )
    # train/basecall flag resolution (nanocall.cpp:995-1021)
    if args.train and args.no_train:
        raise SystemExit("either --train or --no-train may be used, but not both")
    cfg.train = not args.no_train
    if args.basecall and args.no_basecall:
        raise SystemExit("either --basecall or --no-basecall may be used, but not both")
    cfg.basecall = not args.no_basecall
    cfg.train_scaling = not args.no_train_scaling
    cfg.train_transitions = not args.no_train_transitions
    # strand-scaling flags are only resolved (and conflict-checked) when
    # scaling training is active (nanocall.cpp:1023-1038)
    if cfg.train and cfg.train_scaling:
        if args.single_strand_scaling and args.double_strand_scaling:
            raise SystemExit(
                "either --single-strand-scaling or --double-strand-scaling may be used, but not both"
            )
        cfg.double_strand_scaling = not args.single_strand_scaling
    else:
        cfg.double_strand_scaling = args.double_strand_scaling
    if args.scaling_select_threshold < 0.0:
        raise SystemExit(
            f"invalid scaling_select_threshold: {args.scaling_select_threshold}"
        )
    if args.scaling_min_progress < 0.0:
        raise SystemExit(
            f"invalid scaling_min_progress: {args.scaling_min_progress}"
        )
    if args.train_drift:
        cfg.train_drift = args.train_drift == "1"
    cfg.apply_pore_preset()
    if cfg.output and cfg.write_fast5:
        raise SystemExit(
            "output may be written to fast5 files or to a single output file, but not both"
        )
    return cfg


def init_models(cfg: Config) -> dict:
    """Load user or builtin pore models (init_models, nanocall.cpp:97-178)."""
    specs = []
    for s in cfg.model_files:
        specs.append(s)
    if cfg.model_fofn:
        from .util import zopen

        with zopen(cfg.model_fofn) as fh:
            specs += [line.strip() for line in fh if line.strip()]
    models = {}
    if specs:
        by_strand = {0: [], 1: [], 2: []}
        for s in specs:
            if len(s) < 3 or s[0] not in "012" or s[1] != ":":
                raise SystemExit(
                    f'could not parse model name: "{s}"; format should be "[0|1|2]:<file>"'
                )
            by_strand[int(s[0])].append(s[2:])
        if not by_strand[2] and (bool(by_strand[0]) != bool(by_strand[1])):
            raise SystemExit(
                "models were specified for only one strand; give models for both strands, or for neither"
            )
        for st in (0, 1, 2):
            for path in by_strand[st]:
                pm = pore_model.load_tsv(path, K=cfg.kmer_size, strand=st, name=path)
                # keyed by file path, later strands overwriting earlier —
                # REFERENCE PARITY (nanocall.cpp:137-152 keys its dict by
                # the path string the same way), so `-m 0:x -m 1:x` keeps
                # only the strand-1 entry there too; use strand 2 or two
                # files for a shared model
                models[path] = pm
                log.info("loaded model [%s] for strand [%d] statistics "
                         "[mean=%g, stdv=%g]", path, st, pm.mean(), pm.stdv())
    else:
        models = load_builtin_models(cfg.pore, cfg.kmer_size)
        if not models:
            raise SystemExit(f"no builtin models found for pore [{cfg.pore}]")
        for name, pm in models.items():
            log.info("loaded builtin model [%s] for strand [%d]", name, pm.strand)
    # lexicographic name order: the reference's Pore_Model_Dict is a
    # std::map, so candidate enumeration / tie-breaks / stats rows follow
    # sorted names regardless of -m / fofn specification order
    return dict(sorted(models.items()))


def init_transitions(cfg: Config):
    """Default transition table (init_transitions, nanocall.cpp:180-193)."""
    if cfg.trans_file:
        st = transitions.load_tsv(cfg.trans_file, cfg.kmer_size)
        log.info("loaded state transitions from [%s]", cfg.trans_file)
        return st
    st = transitions.build_structured(
        transitions.TransitionParams(cfg.pr_stay, cfg.pr_skip), cfg.kmer_size
    )
    log.info("init_state_transitions pr_skip=[%g], pr_stay=[%g]", cfg.pr_skip, cfg.pr_stay)
    return st


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .observe import set_levels_from_options

    level = set_levels_from_options(args.log)
    logging.basicConfig(level=level, format="%(name)s: %(levelname)s: %(message)s")
    cfg = config_from_args(args)

    # resolved-option echo lines (nanocall.cpp:913-916,930-932,972-991,
    # 1060-1078): structured key=value INFO lines meant for grep/awk
    from .version import get_version

    log.info("program: nanocall-tpu")
    log.info("version: %s", get_version())
    # getOrigArgv() includes the program name (nanocall.cpp:915)
    prog = sys.argv[0] if argv is None else "nanocall-tpu"
    log.info("args: %s", " ".join([prog] + list(argv if argv is not None else sys.argv[1:])))
    from .ingest import _resolve_workers

    log.info("num_threads=%d", _resolve_workers(args.threads))
    log.info("eventdetection_group=%s", cfg.ed_group or "smallest")
    log.info(
        "ed_event_trimming:  sq_start=%d sq_end=%d hp_start=%d hp_end=%d",
        *cfg.trim_margins,
    )
    if not cfg.template_only:
        log.info(
            "hairpin_detection: abasic_level_top_percent=%g "
            "abasic_level_top_offset=%g hairpin_island_window_size=%d "
            "hairpin_island_window_load=%d",
            cfg.abasic_level_top_percent, cfg.abasic_level_top_offset,
            cfg.hairpin_island_window_size, cfg.hairpin_island_window_load,
        )
    else:
        log.info("hairpin_detection: disabled")
    log.info("train=%d", cfg.train)
    if cfg.train:
        log.info("train_scaling=%d", cfg.train_scaling)
        log.info("train_transitions=%d", cfg.train_transitions)
        if cfg.train_scaling:
            log.info("double_strands_scaling=%d", cfg.double_strand_scaling)
            log.info("scaling_num_events=%d", cfg.scaling_num_events)
            log.info("scaling_max_rounds=%d", cfg.scaling_max_rounds)
            log.info("scaling_min_progress=%g", cfg.scaling_min_progress)
            log.info("scaling_select_threshold=%g", cfg.scaling_select_threshold)
            log.info("train_drift=%d", bool(cfg.train_drift))
    log.info("basecall=%d", cfg.basecall)

    from .observe import enable_compilation_cache
    from .parallel import multihost

    enable_compilation_cache()
    multi = args.num_hosts > 1
    if multi and args.coordinator:
        # fork the ingest pool BEFORE jax.distributed spawns its gRPC
        # client threads: forking a multithreaded process is fork-unsafe
        # (a worker could inherit a lock held mid-operation and wedge)
        from . import ingest

        ingest.ensure_pool(cfg.ingest_workers)
        multihost.init_distributed(args.coordinator, args.num_hosts, args.host_id)

    models = init_models(cfg)
    default_transitions = init_transitions(cfg)
    files = read_pipeline.init_files(args.inputs)
    if not files:
        raise SystemExit("no fast5 files to process")
    if multi:
        files = multihost.partition_files(files, args.host_id, args.num_hosts)
        # clear this host's stale shard BEFORE any work: the merge treats
        # shard existence as completeness, so a leftover from a previous
        # failed run must not satisfy it
        multihost.remove_stale_shard(args.output or "out.fa", args.host_id,
                                     args.num_hosts)
        cfg.output = multihost.shard_output_path(
            args.output or "out.fa", args.host_id, args.num_hosts
        )
        log.info("host %d/%d: %d files -> %s",
                 args.host_id, args.num_hosts, len(files), cfg.output)
    for f in files:
        log.info("adding input file [%s]", f)

    if args.dump_training_data:
        import os

        os.makedirs(args.dump_training_data, exist_ok=True)
        summaries = [read_pipeline.summarize(f, models, cfg) for f in files]
        grp = basecall.dump_training_data(
            summaries, models, cfg, args.dump_training_data
        )
        if grp is None:
            raise SystemExit("no trainable read to dump")
        return 0

    from .observe import StageTimer, device_trace

    timer = StageTimer()
    if not args.resume_stats:
        # fully pipelined ingest -> EM -> decode: host ingestion overlaps
        # EM device time, ready reads' decode chunks dispatch behind the
        # phase-2 straggler EM, winners path-decode as scores land
        with device_trace(args.trace_dir):
            summaries, results = basecall.run_pipeline(
                files, models, cfg, default_transitions, timer=timer
            )
    else:
        # resume flow: trained params load from the stats TSV between the
        # summarize and decode stages, so the stages stay separate — but
        # --trace-dir must span BOTH stages (a trace that stops before
        # decode would silently omit the very work being profiled)
        ev_pool = basecall.EventPool() if cfg.basecall else None
        with device_trace(args.trace_dir):
            with timer.stage("init_reads"):
                summaries = basecall.summarize_and_train(
                    files, models, cfg, ev_pool=ev_pool, train_enabled=False
                )
            n = output.apply_resume(
                summaries, output.load_stats(args.resume_stats),
                transitions.TransitionParams(cfg.pr_stay, cfg.pr_skip),
            )
            log.info("resumed trained parameters for %d reads from [%s]",
                     n, args.resume_stats)
            if cfg.basecall:
                with timer.stage("basecalling"):
                    results = basecall.basecall_reads(
                        summaries, models, cfg, default_transitions,
                        ev_pool=ev_pool
                    )

    if cfg.basecall:
        if cfg.write_fast5:
            output.write_results_fast5(results, summaries, models, cfg)
        elif cfg.output:
            # write-then-rename: the file exists only when COMPLETE.  In
            # coordinator-less multi-host runs host 0's merge treats shard
            # existence as completeness, so a half-written shard must
            # never be visible under its final name.
            import os

            tmp = cfg.output + ".tmp"
            with open(tmp, "w") as fh:
                output.write_results_fasta(fh, results, cfg.fasta_line_width)
            os.replace(tmp, cfg.output)
        else:
            output.write_results_fasta(sys.stdout, results, cfg.fasta_line_width)

    if cfg.stats_fn:
        stats_path = (
            multihost.shard_output_path(cfg.stats_fn, args.host_id, args.num_hosts)
            if multi else cfg.stats_fn
        )
        with open(stats_path, "w") as fh:
            output.write_stats(
                fh, summaries,
                transitions.TransitionParams(cfg.pr_stay, cfg.pr_skip),
            )

    if multi:
        if args.coordinator:
            multihost.barrier("basecall-done")
        # shard FASTAs exist only when basecalling to files (not
        # --no-basecall, not --write-fast5) — merging otherwise would
        # fail on missing shards after a fully successful run
        if args.host_id == 0 and cfg.basecall and not cfg.write_fast5:
            multihost.merge_shards(args.output or "out.fa", args.num_hosts)
            log.info("merged %d shards into %s", args.num_hosts,
                     args.output or "out.fa")
    return 0


if __name__ == "__main__":
    sys.exit(main())
