"""Typed run configuration.

One dataclass replaces the reference's TCLAP option namespace + mutable
static singletons (nanocall.cpp:50-95,923-991).  Defaults match the
reference CLI defaults; `apply_pore_preset` mirrors the r73/r9 preset logic
(nanocall.cpp:943-964).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # model selection
    pore: str = "r9"  # reference default (nanocall.cpp:91); both r73 and
    # r9 builtin model banks ship in models/builtin.npz.
    model_files: list = dataclasses.field(default_factory=list)  # "strand:file"
    model_fofn: str = ""
    trans_file: str = ""
    # transition priors (nanocall.cpp:84-85)
    pr_stay: float = 0.1
    pr_skip: float = 0.3
    # event-detection input (nanocall.cpp:56,61-66)
    ed_group: str = ""
    min_ed_events: int = 10
    max_ed_events: int = 100000
    trim_ed_sq_start: int = 50
    trim_ed_sq_end: int = 50
    trim_ed_hp_start: int = 50
    trim_ed_hp_end: int = 50
    # training (nanocall.cpp:69-80)
    train: bool = True
    train_scaling: bool = True
    train_transitions: bool = True
    train_drift: bool | None = None  # None -> pore preset decides
    double_strand_scaling: bool = True
    scaling_select_threshold: float = 20.0
    scaling_min_progress: float = 1.0
    scaling_max_rounds: int = 10
    scaling_num_events: int = 200
    # basecalling
    basecall: bool = True
    template_only: bool = False  # --1d
    # strand/hairpin detection presets (nanocall.cpp:943-964)
    abasic_level_top_percent: float = 1.0
    abasic_level_top_offset: float = 5.0
    hairpin_island_window_size: int = 5
    hairpin_island_window_load: int = 5
    # output
    output: str = ""
    write_fast5: bool = False
    fasta_line_width: int = 80
    stats_fn: str = ""
    # execution
    kmer_size: int = 6
    # device batching: max padded events per decode bucket element and max
    # batch elements per bucket launch (memory control)
    bucket_max_batch: int = 256
    # score-only (forward, no traceback) chunks keep no backpointer tensor,
    # so their batch cap need not be HBM-bound like path chunks'.  Bigger
    # score chunks were a net loss on the previous accelerator: the
    # coarser granularity delays the first contests' winner path dispatch.
    # 0 = use the path chunks' cap; set >0 to cap score chunks
    # independently.  Chosen on the previous accelerator; not re-measured
    # on the H100.
    score_max_batch: int = 0
    # 128 groups x 4 seqs = 512 fwbw rows per EM dispatch: the EM scan is
    # iteration-latency bound at T=128, so rows amortize each step.
    # Chosen on the previous accelerator; not re-measured on the H100.
    train_group_batch: int = 128
    # two-phase EM: run every group this many rounds, then repack only the
    # still-unconverged groups and continue (a chunk otherwise waits on its
    # slowest group's round count; trajectory-identical — train.run_em
    # state0).  0 = single phase.  8 fits the simulated workload's rounds
    # histogram (about one group in nine needs more than 8 rounds, so
    # phase 2 shrinks to one chunk).
    em_phase1_rounds: int = 8
    # overlap decode packing/dispatch with phase-2 straggler EM
    # (run_pipeline), with the decode FETCHES deferred until the phase-2
    # results land so the host link carries one traffic direction at a
    # time.  Chosen on the previous accelerator, whose host link was
    # serial; not re-measured on the H100.  Score->path overlap inside the
    # decode driver is always on.
    overlap_decode: bool = True
    # parallel
    num_shards: int = 0  # 0 = use all local devices
    # ingest worker processes (-1 = auto: cpu_count-1 capped at 6; 0/1 =
    # in-process).  Forked, jax-free workers run summarize + event
    # filtering (~5 ms/read of GIL-bound numpy/h5py) off the streamed
    # pipeline's critical path; threads measurably don't (see ingest.py).
    ingest_workers: int = -1

    def apply_pore_preset(self) -> "Config":
        """r73/r9 presets for abasic/hairpin/drift knobs (nanocall.cpp:943-964)."""
        if self.pore == "r9":
            self.abasic_level_top_percent = 1.0
            self.abasic_level_top_offset = 0.0
            self.hairpin_island_window_size = 10
            self.hairpin_island_window_load = 5
            if self.train_drift is None:
                self.train_drift = False
        elif self.pore == "r73":
            self.abasic_level_top_percent = 1.0
            self.abasic_level_top_offset = 5.0
            self.hairpin_island_window_size = 5
            self.hairpin_island_window_load = 5
            if self.train_drift is None:
                self.train_drift = True
        else:
            raise ValueError(f"unknown pore type: {self.pore}")
        return self

    @property
    def trim_margins(self) -> tuple[int, int, int, int]:
        return (
            self.trim_ed_sq_start,
            self.trim_ed_sq_end,
            self.trim_ed_hp_start,
            self.trim_ed_hp_end,
        )
