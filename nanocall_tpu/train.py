"""Per-read EM training of pore-model scaling and transition parameters.

Accelerator rebuild of /root/reference/src/nanocall/Parameter_Trainer.hpp and
the EM driver loops of nanocall.cpp:275-582.

One *training group* = one (read, model-candidate) pair, holding up to S
training event subsequences (2 per strand: the first and last
scaling_num_events/2 events, nanocall.cpp:327-338), per-strand unscaled
pore models, shared pore-model scaling params, and per-strand transition
params.  A whole bucket of G groups trains simultaneously:

  - E-step: batched forward-backward over the (G*S, T) padded sequences
    (fwbw kernel, ops/hmm.py), emissions kept for the M-step.
  - M-step (scaling): the per-event sufficient statistics
    s0..s2/l0..l2 (Parameter_Trainer.hpp:273-296) are one posterior x
    state-weight contraction; the 3x3 weighted-least-squares system
    is solved with the reference's scaled-partial-pivot Gaussian
    elimination (Parameter_Trainer.hpp:322-402), vectorized over groups,
    including its singularity detection (pivot < 1e-7 -> done).
  - M-step (transitions): posterior stay/step joint probabilities over the
    overlap-free kmer subset (Parameter_Trainer.hpp:30-57,434-532) as
    masked log-sum-exp reductions.

The data-dependent stopping rules (fit regression -> revert, min-progress,
singularity; nanocall.cpp:367-426) run on host over the small per-group
scalars, with per-group 'frozen' masks — device rounds always process the
full bucket.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import kmer, transitions
from .ops import hmm

# Scan unroll factors for the fused EM round (read at TRACE time, like
# _FORCE_LEGACY; env-overridable so an unroll sweep can A/B them in fresh
# processes).  fwd 2 / bwd 1 were chosen on the previous accelerator and
# are not re-measured on the H100.  Unrolling does not change the
# per-step op ORDER: on CPU results are bit-identical (test_train +
# whole-pipeline FASTA verified unchanged).  An accelerator's fusion of
# the unrolled lse scan may still reassociate lpd's low bits vs
# unroll=1 (see the note in hmm.fwbw_grouped) — drift of the same class
# as the backend's own CPU-vs-device differences, inside the documented
# WLS-amplification tolerance; the CPU-validated reference-conformance
# contract is unaffected.
EM_FWD_UNROLL = int(os.environ.get("NANOCALL_EM_FWD_UNROLL", "2"))
EM_BWD_UNROLL = int(os.environ.get("NANOCALL_EM_BWD_UNROLL", "1"))

PIVOT_EPS = 1e-7  # Parameter_Trainer.hpp:355
ST_CLAMP_LO = 0.05  # Parameter_Trainer.hpp:518-525
ST_CLAMP_HI = 0.4

# test hook: force the legacy materialize-then-reduce EM round (the code
# path --trans runs use) so tests can pin fused-vs-legacy agreement.
# Read at TRACE time — only meaningful with train_one_round.__wrapped__
# (the jit cache does not key on it).
_FORCE_LEGACY = False


@functools.lru_cache(maxsize=None)
def st_train_kmers(K: int) -> np.ndarray:
    """States used for transition training (Parameter_Trainer.hpp:30-57):
    self-overlap 0, and all 1-step successors have self-overlap <= 1."""
    mso = kmer.max_self_overlap(K)
    nl1 = kmer.neighbour_list(K, 1)
    good = (mso == 0) & (mso[nl1] <= 1).all(axis=1)
    return np.nonzero(good)[0].astype(np.int32)


@functools.lru_cache(maxsize=None)
def st_train_mask(K: int) -> np.ndarray:
    """(n_states,) float32 mask: 1 for transition-training k-mers, else 0."""
    m = np.zeros(kmer.n_states(K), dtype=np.float32)
    m[st_train_kmers(K)] = 1.0
    return m


def _solve3_pivoted(A, B, train_drift: bool):
    """Vectorized 3x3 Gaussian elimination with scaled partial pivoting,
    mirroring Parameter_Trainer.hpp:322-390.

    A: (G, 3, 3), B: (G, 3).  Returns (x (G, 3) with x=[shift, scale,
    drift], done (G,) bool singular flags).
    """
    G = A.shape[0]
    C = jnp.max(A, axis=2)  # scaling vector; A > 0, no abs needed (hpp:328)
    done = jnp.zeros(G, dtype=bool)
    for i in range(3):
        # pick pivot row among i..2 maximizing |A[r,i]|/C[r]
        vals = jnp.abs(A[:, :, i]) / C  # (G, 3)
        # an all-zero row gives 0/0 = NaN, which jnp.argmax would treat as
        # the maximum; map NaN to -inf so the pivot test flags the
        # singularity (p_val < eps -> done) instead of silently eliminating
        # with a garbage pivot.  DELIBERATE robustness deviation: the
        # reference's scan starts its candidate AT row i (hpp:342), so when
        # row i itself is all-zero its strict '>' (hpp:346) never replaces
        # the NaN candidate and it proceeds with the zero pivot (NaN
        # propagation); we instead either pick a valid later row or flag
        # the group singular.  Unreachable on realistic moment matrices
        # (rows of A are positive sums of squares; goldens pass).
        vals = jnp.where(jnp.isnan(vals), -jnp.inf, vals)
        mask = jnp.arange(3) >= i
        vals = jnp.where(mask, vals, -jnp.inf)
        # argmax keeps the FIRST maximum; the reference uses strict '>'
        # (hpp:346), also keeping the first -> match
        p = jnp.argmax(vals, axis=1)  # (G,)
        p_val = jnp.take_along_axis(vals, p[:, None], axis=1)[:, 0]
        done = done | (p_val < PIVOT_EPS)
        # swap rows i and p: permutation = identity with i <-> p exchanged
        idx = jnp.broadcast_to(jnp.arange(3, dtype=jnp.int32)[None, :], (G, 3))
        idx_i = jnp.full((G, 1), i, dtype=jnp.int32)
        p_col = p[:, None].astype(jnp.int32)
        swap_to = jnp.where(idx == idx_i, p_col, idx)
        swap_to = jnp.where(idx == p_col, idx_i, swap_to)
        A = jnp.take_along_axis(A, swap_to[:, :, None], axis=1)
        B = jnp.take_along_axis(B, swap_to, axis=1)
        C = jnp.take_along_axis(C, swap_to, axis=1)
        # eliminate column i from rows > i
        pivot = A[:, i, i]
        safe_pivot = jnp.where(jnp.abs(pivot) > 0, pivot, 1.0)
        for r in range(i + 1, 3):
            m = A[:, r, i] / safe_pivot
            newrow = A[:, r, :] - m[:, None] * A[:, i, :]
            newrow = newrow.at[:, i].set(0.0)
            A = A.at[:, r, :].set(newrow)
            B = B.at[:, r].set(B[:, r] - m * B[:, i])
    # back substitution (hpp:388-390): x order [shift(a), scale(b), drift(c)]
    A22 = jnp.where(jnp.abs(A[:, 2, 2]) > 0, A[:, 2, 2], 1.0)
    c = B[:, 2] / A22
    A11 = jnp.where(jnp.abs(A[:, 1, 1]) > 0, A[:, 1, 1], 1.0)
    b = (B[:, 1] - A[:, 1, 2] * c) / A11
    A00 = jnp.where(jnp.abs(A[:, 0, 0]) > 0, A[:, 0, 0], 1.0)
    a = (B[:, 0] - A[:, 0, 1] * b - A[:, 0, 2] * c) / A00
    if not train_drift:
        c = jnp.zeros_like(c)
    return jnp.stack([a, b, c], axis=-1), done


def _masked_lse(x, mask, axes):
    """logsumexp of x where mask, over axes; -inf if empty."""
    x = jnp.where(mask, x, -jnp.inf)
    m = jnp.max(x, axis=axes)
    safe = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.sum(jnp.exp(x - jnp.expand_dims(safe, axes)), axis=axes)
    return jnp.where(jnp.isfinite(m), safe + jnp.log(s), m)


def _fused_bwd_mstats(gtf, model, ev, lpd, alphas, W, x_unc, t_start,
                      valid, subset, p_stay_seq, p_skip_seq,
                      train_scaling: bool, train_transitions: bool):
    """Backward pass + BOTH M-steps' sufficient statistics as ONE
    streaming reverse scan — the fused EM round.

    The legacy formulation materialized alpha, beta and em as (B, T, n)
    float32 tensors (3 x 1.07 GB at the production training shape), paid
    a (T, B, n) -> (B, T, n) layout transpose on each, then re-read them
    in the M-steps, which cost several times the scans themselves on the
    previous accelerator.  Here the reverse scan
    carries beta (never materialized), recomputes the t+1 emission on the
    fly (17n ops/event is cheaper than 8n bytes of HBM), and accumulates

      - the scaling M-step's weighted-least-squares moments
        (Parameter_Trainer.hpp:265-321): per-step posterior x state-
        weight contractions s0..s2/l0..l2 folded against x/t/y into 14
        per-sequence scalars, and
      - the transition M-step's three masked log-sum-exp totals
        (Parameter_Trainer.hpp:434-517): per-step lse over the training
        subset, folded into running log-space accumulators (associative
        reassociation of the same summands as _train_st_params).  The
        per-term values are computed in LOG space term-for-term like the
        reference (alpha + log_p_trans + g - lpd); a cheaper
        probability-space factorization (exp(alpha+m-lpd) * the beta
        recursion's own block sums) was faster but drifted the trained
        p_stay/p_skip far enough to flip one decoded base at trained-fuzz
        seed 11/r73, breaking the fixed-round byte-FASTA contract —
        falsified, do not retry without a new exactness argument.

    HBM traffic per event drops from ~36n bytes (9 tensor passes) to ~8n
    (alpha write + read).  Results differ from the legacy path only by
    float reassociation; tests/test_train.py::test_fused_round_matches_
    legacy pins the agreement.

    Returns (scal: dict of (B,) moments, st: dict of (B,) log totals).
    """
    B, T = ev["mean"].shape
    n = model.level_mean.shape[-1]
    n4 = n // 4
    masks = transitions.grouped_correction_masks(gtf.K)
    mH = jnp.asarray(masks["H"])
    mP2 = jnp.asarray(masks["P2mH"])
    mS5T = jnp.asarray(masks["S5T"])
    e_stay = jnp.exp(gtf.stay_lp)
    e_step_to = jnp.exp(gtf.step_to_lp)
    e_skip_to = jnp.exp(gtf.skip_to_lp)
    lengths = ev["length"]
    lpd_c = lpd[:, None]
    valid_c = valid[:, None]

    def tile(x, r):
        return jnp.broadcast_to(x[:, None, :], (B, r, x.shape[1])).reshape(B, n)

    # per-sequence transition log-rates (constant over steps)
    log_p_stay = jnp.log(p_stay_seq)[:, None]
    log_p_step4 = (jnp.log(1.0 - p_stay_seq - p_skip_seq)
                   - jnp.log(4.0))[:, None]

    def step_lse(v, w_tr):
        vm = jnp.where(w_tr, v, -jnp.inf)
        m = jnp.max(vm, axis=-1)
        safe = jnp.where(jnp.isfinite(m), m, 0.0)
        s = jnp.sum(jnp.exp(vm - safe[:, None]), axis=-1)
        return jnp.where(jnp.isfinite(m), safe + jnp.log(s), m)

    means = jnp.moveaxis(ev["mean"], 1, 0)
    stdvs = jnp.moveaxis(ev["stdv"], 1, 0)
    log_stdvs = jnp.moveaxis(ev["log_stdv"], 1, 0)
    xs_u = jnp.moveaxis(x_unc, 1, 0)
    ts_u = jnp.moveaxis(t_start, 1, 0)
    ys_u = jnp.moveaxis(ev["stdv"], 1, 0)

    def post_stats(post, x_t, ts_t, y_t, w_t):
        """Scaling-M-step contributions of event t (hpp:265-296)."""
        # per-k elementwise reductions, NOT einsum('bn,bnk->bk'): the
        # batched mat-vec lowers to B separate (1, n) x (n, 6) products
        s0 = jnp.sum(post * W[:, :, 0], axis=-1)
        s1 = jnp.sum(post * W[:, :, 1], axis=-1)
        s2 = jnp.sum(post * W[:, :, 2], axis=-1)
        l0 = jnp.sum(post * W[:, :, 3], axis=-1)
        l1 = jnp.sum(post * W[:, :, 4], axis=-1)
        l2 = jnp.sum(post * W[:, :, 5], axis=-1)
        cnt = w_t[:, 0].astype(jnp.float32)
        return jnp.stack([
            s0, s1, s2,                      # A00, A01, A11
            s0 * ts_t, s1 * ts_t,            # A02, A12
            s0 * ts_t * ts_t,                # A22
            s0 * x_t, s1 * x_t,              # B0, B1
            s0 * x_t * ts_t,                 # B2
            s0 * x_t * x_t,                  # D
            l2 * y_t, l1,                    # Vn, Vd
            l0 / y_t,                        # Up
            cnt,                             # Ne
        ], axis=-1)  # (B, 14)

    # t = T-1 contributions (beta = 0; no outgoing transition)
    beta_init = jnp.zeros((B, n), jnp.float32)
    if train_scaling:
        w_last = ((T - 1 < lengths) & valid)[:, None]
        post_last = jnp.exp(alphas[T - 1] - lpd_c) * w_last
        scal0 = post_stats(post_last, xs_u[T - 1], ts_u[T - 1],
                           ys_u[T - 1], w_last)
    else:
        scal0 = jnp.zeros((B, 14), jnp.float32)
    st0 = jnp.full((B, 3), -jnp.inf, jnp.float32)

    def bwd_step(carry, x):
        beta_next, scal, st3 = carry
        alpha_t, mean_n, stdv_n, log_stdv_n, x_t, ts_t, y_t, t = x
        em_next = hmm.log_emission(model, mean_n, stdv_n, log_stdv_n)
        g = em_next + beta_next
        m = jnp.max(g, axis=-1, keepdims=True)  # always finite: em is
        G = jnp.exp(g - m)                      # finite, beta finite
        sum4 = jnp.sum(G.reshape(B, n4, 4), axis=-1)
        T4 = tile(sum4, 4)
        T16 = tile(jnp.sum(G.reshape(B, n // 16, 16), axis=-1), 16)
        total = (
            e_stay * G
            + e_step_to * (T4 - mH * G)
            + e_skip_to * (T16 - mP2 * G - mS5T * T4)
        )
        cand = m + jnp.log(total)
        beta_t = jnp.where((t >= lengths - 1)[:, None], 0.0, cand)

        # Pr[S_t = j | data]: shared by the posterior stats AND the
        # transition M-step's denominator (= exp(lp_j1), hpp:479)
        exp_lp = jnp.exp(alpha_t + beta_t - lpd_c)
        if train_scaling:
            w_t = ((t < lengths) & valid)[:, None]
            scal = scal + post_stats(exp_lp * w_t, x_t, ts_t, y_t, w_t)
        if train_transitions:
            # transition i = t (hpp:479-512); g/m reused from the beta
            # recursion (same quantities _train_st_params recomputes)
            lp_j1 = alpha_t + beta_t - lpd_c
            lp_stay = jnp.minimum(alpha_t + log_p_stay + g - lpd_c, lp_j1)
            safe_m = jnp.where(jnp.isfinite(m), m, 0.0)
            eg4 = jnp.exp(g - safe_m).reshape(B, n4, 4).sum(axis=-1)
            lsum4 = safe_m + jnp.tile(jnp.log(eg4), (1, 4))
            lp_steps = alpha_t + log_p_step4 + lsum4 - lpd_c
            lp_d01 = jnp.minimum(jnp.logaddexp(lp_stay, lp_steps), lp_j1)
            p_d2 = jnp.maximum(jnp.exp(lp_j1) - jnp.exp(lp_d01), 0.0)
            lp_d2 = jnp.log(p_d2)
            w_tr = ((t < lengths - 1)[:, None] & valid_c) & subset[None, :]
            part = jnp.stack([step_lse(lp_j1, w_tr),
                              step_lse(lp_stay, w_tr),
                              step_lse(lp_d2, w_tr)], axis=-1)
            st3 = jnp.logaddexp(st3, part)
        return (beta_t, scal, st3), None

    xs = (alphas[: T - 1], means[1:], stdvs[1:], log_stdvs[1:],
          xs_u[: T - 1], ts_u[: T - 1], ys_u[: T - 1],
          jnp.arange(T - 1))
    (final_beta, scal, st3), _ = jax.lax.scan(
        bwd_step, (beta_init, scal0, st0), xs, reverse=True,
        unroll=EM_BWD_UNROLL)
    del final_beta
    names = ("A00", "A01", "A11", "A02", "A12", "A22", "B0", "B1", "B2",
             "D", "Vn", "Vd", "Up", "Ne")
    return ({k: scal[:, i] for i, k in enumerate(names)},
            {"denom": st3[:, 0], "stay": st3[:, 1], "skip": st3[:, 2]})


@functools.partial(
    jax.jit, static_argnames=("K", "train_drift", "train_scaling", "train_transitions")
)
def train_one_round(
    ev: dict,
    models: dict,
    pm_params: jax.Array,
    st_params: jax.Array,
    K: int = 6,
    train_drift: bool = True,
    train_scaling: bool = True,
    train_transitions: bool = True,
    default_ops=None,
    default_priors=None,
):
    """One EM round over a bucket of training groups
    (Parameter_Trainer::train_one_round, hpp:541-579).

    Args:
      ev: dict of (G, S, T) float32 arrays {mean, stdv, log_stdv, start} plus
          (G, S) int32 'length', (G, S) int32 'strand', (G, S) bool 'valid'.
          'mean' is the UNCORRECTED event mean (drift correction is applied
          inside, from the current pm_params).
      models: dict of (G, 2, n) float32 unscaled model arrays
          {level_mean, level_stdv, sd_mean, sd_lambda} (index 1 = strand).
      pm_params: (G, 6) current scaling params rows
          (scale, shift, drift, var, scale_sd, var_sd).
      st_params: (G, 2, 2) current transition params (p_stay, p_skip) per strand.

    Returns dict with:
      fit (G,): sum of log_pr_data under the CURRENT params,
      new_pm_params (G, 6), done (G,) singularity flags,
      new_st_params (G, 2, 2).

    `models` may alternatively carry a model BANK: arrays shaped (M, 2, n)
    plus a (G,) int32 'model_idx' — the per-group tables are gathered on
    device (uploading each distinct model once instead of per group).

    default_ops / default_priors: a FILE-loaded default transition table
    (--trans) as hmm.TransOps plus the (2,) float32 CLI priors.  The
    reference's E-step runs under `default_transitions` — the loaded
    table — whenever a strand's st params are still default
    (Parameter_Trainer.hpp:117-133 via nanocall.cpp:374-377), which
    includes round 1 of EVERY candidate; with a generated default table
    the grouped decomposition represents it exactly, but a loaded table
    is arbitrary, so those sequences must E-step through the generic
    kernel with that exact table.  Both E-steps are computed and selected
    per sequence (st == priors at float32, the reference's is_default
    comparison over its float Float_Type) — 2x E-step cost, paid only on
    --trans runs.
    """
    G, S, T = ev["mean"].shape
    if "model_idx" in models:
        idx = models["model_idx"]
        models = {
            k: models[k][idx]
            for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")
        }
    n = models["level_mean"].shape[-1]

    # --- scale models with current params (fill_train_data, hpp:101-114)
    from .pore_model import scale_arrays

    lm_s, ls_s, sm_s, slam_s = scale_arrays(
        models["level_mean"],
        models["level_stdv"],
        models["sd_mean"],
        models["sd_lambda"],
        pm_params[:, None, :],
    )

    # --- per-strand grouped transition tables from current st params
    # (hpp:117-133); grouped decomposition with closed-form corrections
    # replaces the (G, 2, 21, n) slot tables (see hmm.fwbw_grouped)
    stay_t, step_t, skip_t = transitions.grouped_tables(
        st_params[..., 0], st_params[..., 1], K, xp=jnp
    )  # (G, 2, n) each
    step_to_t, skip_to_t = transitions.grouped_tables_to(
        st_params[..., 0], st_params[..., 1], K, xp=jnp
    )

    # --- gather per-sequence model/tables by strand tag
    strand = ev["strand"]  # (G, S)
    st_idx = strand[:, :, None]

    def sel(a):  # (G, 2, n) -> (G, S, n)
        return jnp.take_along_axis(a, st_idx, axis=1)

    lm_seq, ls_seq, sm_seq, slam_seq = sel(lm_s), sel(ls_s), sel(sm_s), sel(slam_s)

    # --- drift-corrected events (hpp:147-149); flatten groups x seqs
    drift = pm_params[:, 2][:, None, None]
    B = G * S
    corrected = ev["mean"] - drift * ev["start"]
    ev_flat = {
        "mean": corrected.reshape(B, T),
        "stdv": ev["stdv"].reshape(B, T),
        "log_stdv": ev["log_stdv"].reshape(B, T),
        "length": ev["length"].reshape(B),
    }
    model_flat = hmm.make_model_arrays(
        lm_seq.reshape(B, n), ls_seq.reshape(B, n), sm_seq.reshape(B, n),
        slam_seq.reshape(B, n),
    )
    gtf = hmm.GroupedTransFull(
        stay_lp=sel(stay_t).reshape(B, n),
        step_lp=sel(step_t).reshape(B, n),
        skip_lp=sel(skip_t).reshape(B, n),
        step_to_lp=sel(step_to_t).reshape(B, n),
        skip_to_lp=sel(skip_to_t).reshape(B, n),
        K=K,
    )

    # --- E-step
    # Fused streaming round (default): forward scan materializes only the
    # alphas in scan-natural (T, B, n) layout; ONE reverse scan then
    # computes beta on the fly, recomputes the t+1 emission, and folds
    # both M-steps' sufficient statistics into per-sequence scalars —
    # ~36n -> ~8n HBM bytes/event vs the legacy materialize-then-reduce
    # formulation (see _fused_bwd_mstats).  The legacy path remains for
    # --trans runs (default_ops), whose generic-kernel E-step selection
    # needs the materialized tensors.
    use_fused = (default_ops is None and not _FORCE_LEGACY
                 and (train_scaling or train_transitions))
    if use_fused:
        alphas_t, _, lpd = hmm.fwbw_grouped_forward(
            gtf, model_flat, ev_flat, unroll=EM_FWD_UNROLL)
        valid = ev["valid"].reshape(B)
        strand_b = strand.reshape(B)
        if train_scaling:
            lm_u, ls_u, sm_u, slam_u = (
                sel(models["level_mean"]).reshape(B, n),
                sel(models["level_stdv"]).reshape(B, n),
                sel(models["sd_mean"]).reshape(B, n),
                sel(models["sd_lambda"]).reshape(B, n),
            )
            w_s0 = 1.0 / (ls_u * ls_u)
            w_s1 = w_s0 * lm_u
            w_s2 = w_s1 * lm_u
            w_l0 = slam_u
            w_l1 = w_l0 / sm_u
            w_l2 = w_l1 / sm_u
            W = jnp.stack([w_s0, w_s1, w_s2, w_l0, w_l1, w_l2], axis=-1)
        else:
            W = jnp.zeros((B, n, 6), jnp.float32)
        p_stay_seq = jnp.take_along_axis(
            st_params[..., 0], strand, axis=1).reshape(B)
        p_skip_seq = jnp.take_along_axis(
            st_params[..., 1], strand, axis=1).reshape(B)
        scal, st3 = _fused_bwd_mstats(
            gtf, model_flat, ev_flat, lpd, alphas_t, W,
            ev["mean"].reshape(B, T), ev["start"].reshape(B, T),
            valid, jnp.asarray(st_train_mask(K)) > 0,
            p_stay_seq, p_skip_seq, train_scaling, train_transitions,
        )
        fit = jnp.sum(jnp.where(ev["valid"], lpd.reshape(G, S), 0.0), axis=1)
        out = {"fit": fit}

        def acc_b(v):  # per-seq (B,) -> per-group sums
            return jnp.sum(v.reshape(G, S), axis=1)

        if train_scaling:
            A00, A01, A11 = acc_b(scal["A00"]), acc_b(scal["A01"]), acc_b(scal["A11"])
            B0, B1 = acc_b(scal["B0"]), acc_b(scal["B1"])
            if train_drift:
                A02, A12 = acc_b(scal["A02"]), acc_b(scal["A12"])
                A22 = acc_b(scal["A22"])
                B2 = acc_b(scal["B2"])
            else:
                Z = jnp.zeros_like(A00)
                A02, A12, B2 = Z, Z, Z
                A22 = jnp.ones_like(A00)  # hpp:318-321
            D = acc_b(scal["D"])
            V_numer, V_denom = acc_b(scal["Vn"]), acc_b(scal["Vd"])
            U_pos = acc_b(scal["Up"])
            n_events_tot = acc_b(scal["Ne"])
            A = jnp.stack(
                [
                    jnp.stack([A00, A01, A02], axis=-1),
                    jnp.stack([A01, A11, A12], axis=-1),
                    jnp.stack([A02, A12, A22], axis=-1),
                ],
                axis=-2,
            )
            Bv = jnp.stack([B0, B1, B2], axis=-1)
            x_hat, done = _solve3_pivoted(A, Bv, train_drift)
            a_hat, b_hat, c_hat = x_hat[:, 0], x_hat[:, 1], x_hat[:, 2]
            d_numer = (
                D
                + a_hat**2 * A00
                + b_hat**2 * A11
                + c_hat**2 * A22
                + 2.0 * a_hat * b_hat * A01
                + 2.0 * a_hat * c_hat * A02
                + 2.0 * b_hat * c_hat * A12
                - 2.0 * (a_hat * B0 + b_hat * B1 + c_hat * B2)
            )
            d_hat = jnp.sqrt(jnp.maximum(d_numer, 0.0) / n_events_tot)
            v_hat = V_numer / V_denom
            u_hat = n_events_tot / (U_pos - V_denom / v_hat)
            new_pm = jnp.stack([b_hat, a_hat, c_hat, d_hat, v_hat, u_hat],
                               axis=-1)
            bad = (
                ~jnp.isfinite(new_pm).all(axis=-1)
                | (d_hat <= 0.0)
                | (u_hat <= 0.0)
            )
            done = done | bad
            new_pm = jnp.where(done[:, None], pm_params, new_pm)
            out["new_pm_params"] = new_pm
            out["done"] = done
        else:
            out["new_pm_params"] = pm_params
            out["done"] = jnp.zeros(G, dtype=bool)

        if train_transitions:
            new_st = []
            for st in (0, 1):
                seq_mask = (strand_b == st).reshape(G, S)

                def red_g(v):
                    return _masked_lse(v.reshape(G, S), seq_mask, (1,))

                denom = red_g(st3["denom"])
                num_stay = red_g(st3["stay"])
                num_skip = red_g(st3["skip"])
                p_stay_new = jnp.clip(jnp.exp(num_stay - denom),
                                      ST_CLAMP_LO, ST_CLAMP_HI)
                p_skip_new = jnp.clip(jnp.exp(num_skip - denom),
                                      ST_CLAMP_LO, ST_CLAMP_HI)
                has_seqs = jnp.any(
                    (strand == st) & ev["valid"] & (ev["length"] > 1), axis=1
                )
                p_stay_new = jnp.where(has_seqs, p_stay_new,
                                       st_params[:, st, 0])
                p_skip_new = jnp.where(has_seqs, p_skip_new,
                                       st_params[:, st, 1])
                new_st.append(jnp.stack([p_stay_new, p_skip_new], axis=-1))
            out["new_st_params"] = jnp.stack(new_st, axis=1)
        else:
            out["new_st_params"] = st_params
        return out

    fb = hmm.fwbw_grouped(gtf, model_flat, ev_flat, keep_emissions=True)
    alpha, beta, em = fb["alpha"], fb["beta"], fb["em"]  # (B, T, n)
    lpd = fb["log_pr_data"]  # (B,)
    if default_ops is not None:
        # sequences whose st params still equal the CLI priors E-step
        # under the LOADED table via the generic kernel (see docstring)
        fb2 = hmm.fwbw(default_ops, model_flat, ev_flat, keep_emissions=True)
        pri = jnp.asarray(default_priors, jnp.float32)
        use_def = jnp.all(st_params == pri, axis=-1)  # (G, 2) by strand
        use_seq = jnp.take_along_axis(use_def, strand, axis=1).reshape(B)
        m3 = use_seq[:, None, None]
        alpha = jnp.where(m3, fb2["alpha"], alpha)
        beta = jnp.where(m3, fb2["beta"], beta)
        em = jnp.where(m3, fb2["em"], em)
        lpd = jnp.where(use_seq, fb2["log_pr_data"], lpd)

    valid = ev["valid"].reshape(B)
    fit = jnp.sum(jnp.where(ev["valid"], lpd.reshape(G, S), 0.0), axis=1)

    out = {"fit": fit}

    # event-validity weights (B, T)
    t_idx = jnp.arange(T)[None, :]
    w = (t_idx < ev_flat["length"][:, None]) & valid[:, None]

    if train_scaling:
        # posteriors, zeroed outside valid events (hpp:278)
        post = jnp.exp(alpha + beta - lpd[:, None, None]) * w[:, :, None]

        # state weight matrix from UNSCALED models (hpp:279-284)
        lm_u, ls_u, sm_u, slam_u = (
            sel(models["level_mean"]).reshape(B, n),
            sel(models["level_stdv"]).reshape(B, n),
            sel(models["sd_mean"]).reshape(B, n),
            sel(models["sd_lambda"]).reshape(B, n),
        )
        w_s0 = 1.0 / (ls_u * ls_u)
        w_s1 = w_s0 * lm_u
        w_s2 = w_s1 * lm_u
        w_l0 = slam_u
        w_l1 = w_l0 / sm_u
        w_l2 = w_l1 / sm_u
        W = jnp.stack([w_s0, w_s1, w_s2, w_l0, w_l1, w_l2], axis=-1)  # (B, n, 6)
        stats = jnp.einsum(
            "btn,bnk->btk", post, W,
            preferred_element_type=jnp.float32, precision="highest",
        )  # (B, T, 6): s0 s1 s2 l0 l1 l2 per event
        s0, s1, s2 = stats[..., 0], stats[..., 1], stats[..., 2]
        l0, l1, l2 = stats[..., 3], stats[..., 4], stats[..., 5]

        x = ev["mean"].reshape(B, T)  # uncorrected mean (hpp:265)
        t_ = ev["start"].reshape(B, T)
        y = ev["stdv"].reshape(B, T)
        wf = w.astype(jnp.float32)

        def acc(v):  # sum over seqs+events per group
            # no re-mask: every stat is a product with `post`, which is
            # already zeroed outside valid events, and the padded
            # x/t_/y values are finite (pad_batch uses mean=stdv=1)
            return jnp.sum(v.reshape(G, S, T), axis=(1, 2))

        A00, A01, A11 = acc(s0), acc(s1), acc(s2)
        B0, B1 = acc(s0 * x), acc(s1 * x)
        if train_drift:
            A02, A12 = acc(s0 * t_), acc(s1 * t_)
            A22 = acc(s0 * t_ * t_)
            B2 = acc(s0 * x * t_)
        else:
            Z = jnp.zeros_like(A00)
            A02, A12, B2 = Z, Z, Z
            A22 = jnp.ones_like(A00)  # hpp:318-321
        D = acc(s0 * x * x)
        V_numer, V_denom = acc(l2 * y), acc(l1)
        U_pos = acc(l0 / y)
        n_events_tot = jnp.sum(wf.reshape(G, S, T), axis=(1, 2))

        A = jnp.stack(
            [
                jnp.stack([A00, A01, A02], axis=-1),
                jnp.stack([A01, A11, A12], axis=-1),
                jnp.stack([A02, A12, A22], axis=-1),
            ],
            axis=-2,
        )  # (G, 3, 3)
        Bv = jnp.stack([B0, B1, B2], axis=-1)

        x_hat, done = _solve3_pivoted(A, Bv, train_drift)
        a_hat, b_hat, c_hat = x_hat[:, 0], x_hat[:, 1], x_hat[:, 2]

        # var update (hpp:406-418)
        d_numer = (
            D
            + a_hat**2 * A00
            + b_hat**2 * A11
            + c_hat**2 * A22
            + 2.0 * a_hat * b_hat * A01
            + 2.0 * a_hat * c_hat * A02
            + 2.0 * b_hat * c_hat * A12
            - 2.0 * (a_hat * B0 + b_hat * B1 + c_hat * B2)
        )
        # f32 accumulation can round the cancellation-prone d_numer (a
        # difference of near-equal sums the reference accumulates in
        # double) below zero, or push the var_sd denominator through zero.
        # Clamp the sqrt argument and treat a non-positive/non-finite
        # var or var_sd as a singularity (keep current params,
        # hpp:354-360) so NaN params can never reach decoding.
        d_hat = jnp.sqrt(jnp.maximum(d_numer, 0.0) / n_events_tot)
        v_hat = V_numer / V_denom  # scale_sd (hpp:422)
        u_hat = n_events_tot / (U_pos - V_denom / v_hat)  # var_sd (hpp:426)

        new_pm = jnp.stack([b_hat, a_hat, c_hat, d_hat, v_hat, u_hat], axis=-1)
        bad = (
            ~jnp.isfinite(new_pm).all(axis=-1)
            | (d_hat <= 0.0)
            | (u_hat <= 0.0)
        )
        done = done | bad
        # on singularity, keep current params (hpp:354-360)
        new_pm = jnp.where(done[:, None], pm_params, new_pm)
        out["new_pm_params"] = new_pm
        out["done"] = done
    else:
        out["new_pm_params"] = pm_params
        out["done"] = jnp.zeros(G, dtype=bool)

    if train_transitions:
        out["new_st_params"] = _train_st_params(
            alpha, beta, em, lpd, w, ev, st_params, K, G, S, T
        )
    else:
        out["new_st_params"] = st_params
    return out


def _train_st_params(alpha, beta, em, lpd, w, ev, st_params, K, G, S, T):
    """Posterior-ratio estimation of p_stay/p_skip
    (Parameter_Trainer.hpp:434-532), vectorized over groups/strands.

    Gather-free formulation: all per-k-mer quantities are computed over the
    FULL state axis with reshape/tile patterns (the 4 step successors of j1
    are the contiguous block at suffix(j1, K-1) << 2), and the training
    k-mer subset (hpp:30-57) enters only as a static -inf mask in the final
    reductions.  Large static-index gathers made the previous
    accelerator's compile pathological (~10 minutes); this compiles fast
    and runs on elementwise ops and reshapes.
    """
    B = G * S
    n = alpha.shape[-1]
    n4 = n // 4
    lpd_b = lpd[:, None, None]

    a_i = alpha[:, :-1, :]  # (B, Tm, n)
    b_i = beta[:, :-1, :]
    lp_j1 = a_i + b_i - lpd_b  # log Pr[S_i = j1], all states

    strand = ev["strand"]  # (G, S)
    p_stay_cur = jnp.take_along_axis(st_params[..., 0], strand, axis=1)  # (G, S)
    p_skip_cur = jnp.take_along_axis(st_params[..., 1], strand, axis=1)
    log_p_stay = jnp.log(p_stay_cur).reshape(B)[:, None, None]
    log_p_step_4 = (jnp.log(1.0 - p_stay_cur - p_skip_cur) - jnp.log(4.0)).reshape(B)[
        :, None, None
    ]

    g = em[:, 1:, :] + beta[:, 1:, :]  # (B, Tm, n)
    # stay joint, clamped to <= lp_j1 (hpp:479-488)
    lp_stay = jnp.minimum(a_i + log_p_stay + g - lpd_b, lp_j1)

    # sum over the 4 step successors of j1: successors form the contiguous
    # 4-block at suffix(j1, K-1) << 2, so sum exp(g) over 4-blocks and tile
    m_g = jnp.max(g, axis=-1, keepdims=True)  # per (B, t) shift
    safe_m = jnp.where(jnp.isfinite(m_g), m_g, 0.0)
    eg4 = jnp.exp(g - safe_m).reshape(B, T - 1, n4, 4).sum(axis=-1)  # (B,Tm,n4)
    # value at j1 = eg4[suffix(j1, K-1)] = eg4[j1 mod n4]: tile along states
    # log on the (B, Tm, n/4) sums, THEN tile: identical values, 4x fewer
    # transcendentals than log(tile(eg4))
    lsum4 = safe_m + jnp.tile(jnp.log(eg4), (1, 1, 4))  # (B, Tm, n)
    lp_steps = a_i + log_p_step_4 + lsum4 - lpd_b  # lse of the 4 step joints

    # lp_d01 = logsumexp(clamped stay, steps), clamped to <= lp_j1
    # (hpp:491-510)
    lp_d01 = jnp.minimum(jnp.logaddexp(lp_stay, lp_steps), lp_j1)

    # skip mass: Pr[j1] - Pr[d <= 1] (hpp:511-512), >= 0 by the clamps
    p_d2 = jnp.maximum(jnp.exp(lp_j1) - jnp.exp(lp_d01), 0.0)
    lp_d2 = jnp.log(p_d2)

    # masks: training k-mer subset (static) x valid transitions (i < len-1)
    subset = jnp.asarray(st_train_mask(K)) > 0  # (n,)
    t_idx = jnp.arange(T - 1)[None, :]
    w_tr = (t_idx < ev["length"].reshape(B)[:, None] - 1) & ev["valid"].reshape(B)[
        :, None
    ]
    w_tr = w_tr[:, :, None] & subset[None, None, :]  # (B, T-1, n)

    new_st = []
    for st in range(2):
        m_st = (strand == st).reshape(B)[:, None, None] & w_tr
        m_grp = m_st.reshape(G, S, T - 1, -1)

        def red(x):
            return _masked_lse(
                x.reshape(G, S, T - 1, -1),
                jnp.broadcast_to(m_grp, x.reshape(G, S, T - 1, -1).shape),
                (1, 2, 3),
            )

        denom = red(lp_j1)
        num_stay = red(lp_stay)
        num_skip = red(lp_d2)
        p_stay_new = jnp.exp(num_stay - denom)
        p_skip_new = jnp.exp(num_skip - denom)
        p_stay_new = jnp.clip(p_stay_new, ST_CLAMP_LO, ST_CLAMP_HI)  # hpp:518-530
        p_skip_new = jnp.clip(p_skip_new, ST_CLAMP_LO, ST_CLAMP_HI)
        # strands with no training sequences keep their current params
        has_seqs = jnp.any(
            (strand == st) & ev["valid"] & (ev["length"] > 1), axis=1
        )
        p_stay_new = jnp.where(has_seqs, p_stay_new, st_params[:, st, 0])
        p_skip_new = jnp.where(has_seqs, p_skip_new, st_params[:, st, 1])
        new_st.append(jnp.stack([p_stay_new, p_skip_new], axis=-1))
    return jnp.stack(new_st, axis=1)  # (G, 2, 2)


# ---------------------------------------------------------------------------
# host-side EM driver (stopping rules of nanocall.cpp:367-426)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EMConfig:
    max_rounds: int = 10  # --scaling-max-rounds
    min_progress: float = 1.0  # --scaling-min-progress
    train_drift: bool = True
    train_scaling: bool = True
    train_transitions: bool = True
    double_strand: bool = True  # doubles the round cap (nanocall.cpp:420)
    K: int = 6

    def caps(self, joint) -> np.ndarray:
        """Per-group round caps: (2 if double-strand else 1) * max_rounds
        (nanocall.cpp:420 vs :534 — the cap is PER CANDIDATE, so a mixed
        joint/single bucket must not share one bucket-wide cap)."""
        joint = np.asarray(joint, bool)
        return np.where(joint, 2 * self.max_rounds, self.max_rounds).astype(np.int32)


@functools.partial(
    jax.jit,
    static_argnames=("K", "train_drift", "train_scaling", "train_transitions",
                     "max_rounds"),
)
def run_em_device(
    ev: dict,
    models: dict,
    pm_params0,
    st_params0,
    min_progress,
    caps,
    fit0,
    frozen0,
    rounds0,
    K: int = 6,
    train_drift: bool = True,
    train_scaling: bool = True,
    train_transitions: bool = True,
    max_rounds: int = 20,
    default_ops=None,
    default_priors=None,
):
    """The full EM loop as ONE device program: a lax.while_loop over rounds
    whose body is train_one_round plus the reference's per-candidate
    stopping rules (nanocall.cpp:367-426) as masked updates:
      - singularity -> freeze with current params,
      - fit regression -> revert fit, freeze (params were not yet updated),
      - accept new params otherwise; freeze on min-progress after round 1,
      - per-group round cap `caps` ((sst ? 2 : 1) * max_rounds,
        nanocall.cpp:420,536 — a (G,) int32 vector, so mixed joint/single
        buckets apply each candidate's own cap).
    Exits early when every group is frozen; `max_rounds` is only the static
    loop bound (= max cap).  One dispatch per bucket (host-driven per-round
    stepping would pay a host round trip per round).

    (fit0, frozen0, rounds0) is the per-group loop carry, so a run can be
    SPLIT across dispatches: run with a small max_rounds, repack only the
    still-unfrozen groups, and resume them with the fetched carry — the
    trajectory is identical to one uninterrupted run because every stopping
    rule reads only this per-group state (two-phase EM: a whole chunk
    otherwise waits on its slowest group's round count).  Pass -inf/False/0
    for a fresh start; padding rows should pass frozen0=True so they never
    hold the all-frozen early exit open.

    Returns (pm_params (G,6), st_params (G,2,2), fit (G,), rounds (G,),
    frozen (G,)).
    """

    def body(carry):
        pm, st, fit_prev, frozen, rounds, round_no = carry
        out = train_one_round(
            ev, models, pm, st, K=K, train_drift=train_drift,
            train_scaling=train_scaling, train_transitions=train_transitions,
            default_ops=default_ops, default_priors=default_priors,
        )
        fit = out["fit"]
        done = out["done"]
        active = ~frozen
        crt_fit = jnp.where(active, fit, fit_prev)
        frozen2 = frozen | (active & done)
        regress = active & ~done & (crt_fit < fit_prev)
        crt_fit = jnp.where(regress, fit_prev, crt_fit)
        frozen2 = frozen2 | regress
        advance = active & ~done & ~regress
        pm = jnp.where(advance[:, None], out["new_pm_params"], pm)
        st = jnp.where(advance[:, None, None], out["new_st_params"], st)
        rounds = jnp.where(advance, rounds + 1, rounds)
        cap_hit = advance & (rounds >= caps)
        no_progress = advance & (rounds > 1) & (crt_fit < fit_prev + min_progress)
        frozen2 = frozen2 | cap_hit | no_progress
        return pm, st, crt_fit, frozen2, rounds, round_no + 1

    def cond(carry):
        _, _, _, frozen, _, round_no = carry
        return (~jnp.all(frozen)) & (round_no < max_rounds)

    init = (
        jnp.asarray(pm_params0, jnp.float32),
        jnp.asarray(st_params0, jnp.float32),
        jnp.asarray(fit0, jnp.float32),
        jnp.asarray(frozen0, bool),
        jnp.asarray(rounds0, jnp.int32),
        jnp.int32(0),
    )
    pm, st, fit, frozen, rounds, _ = jax.lax.while_loop(cond, body, init)
    return pm, st, fit, rounds, frozen


def fetch_em_result(out):
    """Block on and convert a fetch=False run_em result."""
    pm, st, fit, rounds, frozen = jax.device_get(out)
    return (np.asarray(pm), np.asarray(st),
            np.asarray(fit, np.float64), np.asarray(rounds),
            np.asarray(frozen, bool))


def run_em(ev: dict, models: dict, pm_params0: np.ndarray, st_params0: np.ndarray,
           cfg: EMConfig, device=None, device_loop: bool = True,
           caps: np.ndarray | None = None, fetch: bool = True,
           state0: tuple | None = None, round_limit: int | None = None,
           default_ops=None, default_priors=None):
    """Run the full EM loop for a bucket of G training groups.

    Implements the reference's per-candidate stopping rules
    (nanocall.cpp:367-426): singularity stop, fit-regression revert,
    per-candidate round cap (2x for double-strand scaling — pass `caps`,
    a (G,) int32 vector from EMConfig.caps(joint_flags), for mixed
    buckets; defaults to the bucket-wide cfg.double_strand cap),
    min-progress.

    device: run the whole bucket on this device (None: JAX's default).
    A bucket is never split across devices: XLA's GPU reductions are not
    batch-invariant (the fusion plan, and with it a reduction's summation
    order, changes with the batch size), so G/n groups per card would
    train other parameters, and stop at other rounds, than the same G
    groups on one card.  Multi-device runs place whole buckets round-robin
    (parallel.mesh.DataSharder.device).

    device_loop=True runs the whole loop on device in one dispatch (default,
    avoids per-round host round-trips); False uses the host-stepped loop
    (same semantics, used as a cross-check in tests).

    fetch=False (device_loop only) returns the raw on-device output tuple
    without blocking, so callers can dispatch every bucket before fetching
    any (host packing of bucket N+1 overlaps device EM of bucket N).

    state0=(fit, frozen, rounds) resumes a previous run's per-group carry
    (see run_em_device: a split run is trajectory-identical to an
    uninterrupted one); round_limit caps THIS call's rounds (static loop
    bound) without changing the per-group caps — together they implement
    two-phase EM (run everyone a few rounds, repack the stragglers).

    Returns (pm_params (G,6), st_params (G,2,2), fit (G,), rounds (G,),
    frozen (G,)).
    """
    G = pm_params0.shape[0]
    if caps is None:
        caps = np.full(
            G, (2 if cfg.double_strand else 1) * cfg.max_rounds, np.int32
        )
    # the reference's cap check runs AFTER ++round (do-while style,
    # nanocall.cpp:420,536), so even --scaling-max-rounds 0 trains one round
    caps = np.maximum(np.asarray(caps, np.int32), 1)
    max_rounds = int(caps.max()) if G else 0
    if round_limit is not None:
        max_rounds = min(max_rounds, int(round_limit))
    if state0 is None:
        fit0 = np.full(G, -np.inf, np.float32)
        frozen0 = np.zeros(G, bool)
        rounds0 = np.zeros(G, np.int32)
    else:
        fit0, frozen0, rounds0 = state0
        fit0 = np.asarray(fit0, np.float32)
        frozen0 = np.asarray(frozen0, bool)
        rounds0 = np.asarray(rounds0, np.int32)
    if device is not None:
        ev, models, default_ops, default_priors = jax.device_put(
            (ev, models, default_ops, default_priors), device)
    if device_loop:
        args = (np.asarray(pm_params0, np.float32),
                np.asarray(st_params0, np.float32),
                np.float32(cfg.min_progress), caps, fit0, frozen0, rounds0)
        if device is not None:
            args = jax.device_put(args, device)
        out = run_em_device(
            ev, models, *args,
            K=cfg.K, train_drift=cfg.train_drift,
            train_scaling=cfg.train_scaling,
            train_transitions=cfg.train_transitions,
            max_rounds=max_rounds,
            default_ops=default_ops, default_priors=default_priors,
        )
        if not fetch:
            return out
        return fetch_em_result(out)
    crt_pm = np.asarray(pm_params0, dtype=np.float32).copy()
    crt_st = np.asarray(st_params0, dtype=np.float32).copy()
    # float32 like the device loop's carried fit, so the two paths make
    # identical stopping decisions at threshold-straddling fits
    crt_fit = np.asarray(fit0, dtype=np.float32).copy()
    rounds = rounds0.copy()
    frozen = frozen0.copy()

    round_no = 0
    while not frozen.all() and round_no < max_rounds:
        out = train_one_round(
            ev, models, jnp.asarray(crt_pm), jnp.asarray(crt_st),
            K=cfg.K, train_drift=cfg.train_drift,
            train_scaling=cfg.train_scaling,
            train_transitions=cfg.train_transitions,
            default_ops=default_ops, default_priors=default_priors,
        )
        out = jax.device_get(out)  # one host round-trip for all outputs
        fit = np.asarray(out["fit"], dtype=np.float32)
        new_pm = np.asarray(out["new_pm_params"])
        new_st = np.asarray(out["new_st_params"])
        done = np.asarray(out["done"])

        old_fit = crt_fit.copy()
        active = ~frozen
        # fit under current params
        crt_fit = np.where(active, fit, crt_fit)
        # singularity: stop, keep current params (already fitted above)
        frozen |= active & done
        # fit regression: revert params and fit, stop (nanocall.cpp:400-416)
        regress = active & ~done & (crt_fit < old_fit)
        if regress.any():
            crt_fit = np.where(regress, old_fit, crt_fit)
            frozen |= regress
        # otherwise accept the new params
        advance = active & ~done & ~regress
        crt_pm = np.where(advance[:, None], new_pm, crt_pm)
        crt_st = np.where(advance[:, None, None], new_st, crt_st)
        rounds = np.where(advance, rounds + 1, rounds)
        # stop conditions (nanocall.cpp:419-424): per-candidate round cap;
        # min-progress needs round > 1
        frozen |= advance & (rounds >= caps)
        no_progress = advance & (rounds > 1) & (
            crt_fit < old_fit + np.float32(cfg.min_progress)
        )
        frozen |= no_progress
        round_no += 1
    return crt_pm, crt_st, crt_fit, rounds, frozen
