"""Golden tests against the COMPILED reference dev tools.

These run the actual C++ reference code (built by tests/ref_tools.py from
/root/reference/src/nanocall with shimmed submodule headers) and assert
that this framework's tools produce identical results on shared TSV
fixtures — the HACKING.org:9-24 conformance contract:

  - compute-state-transitions: identical (i, j) edge sets, probs to print
    precision, for both --fast and the exact O(N^2) builder;
  - run-viterbi: IDENTICAL base strings (max-plus decode + tie-breaking);
  - run-fwbw: identical >=0.1 posterior kmer sets at the middle event,
    probabilities to float32 tolerance, default and --custom-fwbw.
"""

import io
import contextlib

import numpy as np
import pytest

from nanocall_tpu import events as events_mod, kmer, pore_model, tools, transitions
from nanocall_tpu.models import load_builtin_models
import ref_tools
from ref_tools import build_ref_tools, run_tool

K = 6
N = kmer.n_states(K)


@pytest.fixture(scope="module")
def ref():
    try:
        tools_map = build_ref_tools()
    except RuntimeError as e:
        ref_tools.golden_unavailable(f"reference tools failed to build: {e}")
    if tools_map is None:
        ref_tools.golden_unavailable("reference sources or g++ unavailable")
    return tools_map


def _parse_trans_tsv(text_or_path, from_file=False):
    """-> {(kmer_i, kmer_j): logp}"""
    if from_file:
        with open(text_or_path) as fh:
            text = fh.read()
    else:
        text = text_or_path
    out = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        a, b, p = line.split("\t")
        out[(a, b)] = float(p)
    return out


def _our_tool_stdout(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tools.main(argv)
    assert rc == 0
    return buf.getvalue()


@pytest.mark.parametrize("p_stay,p_skip", [(0.09, 0.28), (0.1, 0.3), (0.18, 0.22)])
def test_fast_transitions_match_reference(ref, tmp_path, p_stay, p_skip):
    ref_out = tmp_path / "ref_trans.tsv"
    run_tool(ref["compute-state-transitions"], "--fast",
             "-t", str(p_stay), "-k", str(p_skip), "-o", str(ref_out))
    ours = _our_tool_stdout([
        "compute-state-transitions", "--fast",
        "-t", str(p_stay), "-k", str(p_skip),
    ])
    r = _parse_trans_tsv(str(ref_out), from_file=True)
    o = _parse_trans_tsv(ours)
    assert set(r) == set(o), (
        f"edge sets differ: ref-only={list(set(r)-set(o))[:5]} "
        f"ours-only={list(set(o)-set(r))[:5]}")
    diffs = [abs(r[e] - o[e]) / max(abs(r[e]), 1e-9) for e in r]
    assert max(diffs) < 2e-5, max(diffs)


def test_exact_transitions_match_reference(ref, tmp_path):
    """The O(N^2) builder with the default 0.001 cutoff
    (State_Transitions.hpp:147-178)."""
    ref_out = tmp_path / "ref_trans_exact.tsv"
    run_tool(ref["compute-state-transitions"],
             "-t", "0.1", "-k", "0.3", "-p", "0.001", "-o", str(ref_out))
    ours = _our_tool_stdout([
        "compute-state-transitions", "-t", "0.1", "-k", "0.3", "-p", "0.001",
    ])
    r = _parse_trans_tsv(str(ref_out), from_file=True)
    o = _parse_trans_tsv(ours)
    assert set(r) == set(o), (
        f"{len(set(r)-set(o))} ref-only, {len(set(o)-set(r))} ours-only")
    diffs = [abs(r[e] - o[e]) / max(abs(r[e]), 1e-9) for e in r]
    assert max(diffs) < 2e-5, max(diffs)


# ---------------------------------------------------------------------------
# decode fixtures: scaled r73 model + generative-walk events
# ---------------------------------------------------------------------------


def _sample_events(pm_scaled, T, rng, p_stay=0.1, p_skip=0.3):
    """Random walk through the transition chain, emitting from the scaled
    model (the workload shape of real reads)."""
    st = transitions.build_structured(
        transitions.TransitionParams(p_stay, p_skip), K
    )
    pairs = list(transitions.structured_to_pairs(st))
    # build per-state successor lists
    succ: dict = {}
    for i, j, lp in pairs:
        succ.setdefault(i, ([], []))
        succ[i][0].append(j)
        succ[i][1].append(np.exp(lp))
    s = int(rng.integers(N))
    means, stdvs, starts, lengths = [], [], [], []
    t = 0.0
    for _ in range(T):
        means.append(float(rng.normal(pm_scaled.level_mean[s],
                                      pm_scaled.level_stdv[s])))
        stdvs.append(max(float(rng.normal(pm_scaled.sd_mean[s],
                                          pm_scaled.sd_stdv[s])), 0.05))
        starts.append(t)
        dt = 0.02
        lengths.append(dt)
        t += dt
        js, ps = succ[s]
        ps = np.asarray(ps)
        s = int(rng.choice(js, p=ps / ps.sum()))
    return events_mod.EventSequence(
        mean=means, stdv=stdvs, start=starts, length=lengths
    )


@pytest.fixture(scope="module")
def decode_fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    models = load_builtin_models("r73")
    pm = models["r73.t.006"]
    scaled = pm.scaled(pore_model.PoreModelParams(scale=1.02, shift=1.5))
    pm_path = d / "model.tsv"
    pore_model.save_tsv(scaled, pm_path)
    # both sides load the same transitions TSV
    st_path = d / "trans.tsv"
    st = transitions.build_structured(
        transitions.TransitionParams(0.1, 0.3), K
    )
    transitions.save_tsv(st, st_path)
    rng = np.random.default_rng(42)
    ev_paths = []
    for i, T in enumerate((120, 250, 400)):
        ev = _sample_events(scaled, T, rng)
        p = d / f"events_{i}.tsv"
        events_mod.save_tsv(ev, p)
        ev_paths.append(p)
    return pm_path, st_path, ev_paths


def test_run_viterbi_base_seq_matches_reference(ref, decode_fixtures):
    pm_path, st_path, ev_paths = decode_fixtures
    for ev_path in ev_paths:
        ref_seq = run_tool(
            ref["run-viterbi"],
            "-p", str(pm_path), "-s", str(st_path), "-e", str(ev_path),
        ).strip()
        our_seq = _our_tool_stdout([
            "run-viterbi",
            "-p", str(pm_path), "-s", str(st_path), "-e", str(ev_path),
        ]).strip()
        assert our_seq == ref_seq, (
            f"{ev_path.name}: base strings differ "
            f"(lens {len(our_seq)} vs {len(ref_seq)})")


@pytest.mark.parametrize("custom", [False, True])
def test_run_fwbw_posteriors_match_reference(ref, decode_fixtures, custom):
    pm_path, st_path, ev_paths = decode_fixtures
    extra = ["--custom-fwbw"] if custom else []
    for ev_path in ev_paths[:2]:
        ref_out = run_tool(
            ref["run-fwbw"],
            "-p", str(pm_path), "-s", str(st_path), "-e", str(ev_path), *extra,
        )
        our_out = _our_tool_stdout([
            "run-fwbw",
            "-p", str(pm_path), "-s", str(st_path), "-e", str(ev_path), *extra,
        ])

        def parse(text):
            out = {}
            for line in text.splitlines():
                if line.strip():
                    k, v = line.split("\t")
                    out[k] = float(v)
            return out

        r, o = parse(ref_out), parse(our_out)
        # the >=0.1 cutoff can flicker for borderline posteriors under
        # float32; require agreement away from the threshold
        for k in set(r) | set(o):
            rv, ov = r.get(k), o.get(k)
            if rv is None or ov is None:
                present = rv if rv is not None else ov
                assert abs(present - 0.1) < 5e-3, (k, rv, ov)
            else:
                assert abs(rv - ov) < 5e-3, (k, rv, ov)
