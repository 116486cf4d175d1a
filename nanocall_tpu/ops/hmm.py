"""Batched HMM dynamic programs (Viterbi, forward-backward) as JAX scans.

Accelerator rebuild of the reference's DP inner loops:
  - Viterbi.hpp:44-150        (max-plus forward + traceback)
  - Forward_Backward.hpp:46-135 (log-space alpha/beta)
  - Forward_Backward_Custom.hpp:46-142 (per-step-normalized variant)

Design: the per-event "gather over 21 from-neighbours" of the reference
becomes a *reshape + repeat* on the state axis (see transitions.py for the
slot algebra), so the hot scan body is pure element-wise work on
(B, 21, n_states) tiles with reductions over the 21-slot axis — no gathers,
no dynamic shapes, n_states = 4096 on the minor axis.  Emissions are
computed inside the scan step from per-event scalars (never materializing a
T x n_states emission table in HBM for decoding).

All kernels are batched over reads (leading B axis) and masked for
variable-length padded sequences: a padded step leaves the DP carry
unchanged, so the final carry equals the DP state at each read's true last
event.

Tie-breaking matches the reference exactly: Viterbi keeps the *lowest
from-state index* among maxima (strict '>' over ascending from_v,
Viterbi.hpp:79-89), implemented here as an argmin over masked from-state
ids.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import transitions as trans_mod
from ..pore_model import LOG_2PI


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("from_logp", "to_logp", "from_idx", "to_idx"),
    meta_fields=("K",),
)
@dataclasses.dataclass(frozen=True)
class TransOps:
    """Device-side transition table. Exactly one of the two layouts is used:

    structured: from_logp/to_logp (..., 21, n); from_idx/to_idx are None.
    sparse:     from_logp/to_logp (deg, n) plus from_idx/to_idx (deg, n).

    K is pytree metadata (static under jit).
    """

    from_logp: jax.Array
    to_logp: jax.Array
    from_idx: jax.Array | None
    to_idx: jax.Array | None
    K: int


def make_trans_ops(t) -> TransOps:
    if isinstance(t, trans_mod.StructuredTransitions):
        return TransOps(
            from_logp=jnp.asarray(t.from_logp),
            to_logp=jnp.asarray(t.to_logp),
            from_idx=None,
            to_idx=None,
            K=t.K,
        )
    return TransOps(
        from_logp=jnp.asarray(t.from_logp),
        to_logp=jnp.asarray(t.to_logp),
        from_idx=jnp.asarray(t.from_idx),
        to_idx=jnp.asarray(t.to_idx),
        K=t.K,
    )


def make_trans_ops_batch(from_logp, to_logp, K: int) -> TransOps:
    """Structured ops with per-batch tables (B, 21, n)."""
    return TransOps(
        from_logp=jnp.asarray(from_logp),
        to_logp=jnp.asarray(to_logp),
        from_idx=None,
        to_idx=None,
        K=K,
    )


# ---------------------------------------------------------------------------
# slot algebra: neighbour-value expansion without gathers
# ---------------------------------------------------------------------------


def structured_from_vals(alpha: jax.Array, K: int) -> jax.Array:
    """alpha (..., n) -> (..., 21, n) where slot k holds alpha[from_k(j)].

    slot 0:      alpha[j]
    slots 1+b:   alpha[(b << 2(K-1)) | (j >> 2)]  == repeat of a (4, n/4) view
    slots 5+c:   alpha[(c << 2(K-2)) | (j >> 4)]  == repeat of a (16, n/16) view
    """
    n = alpha.shape[-1]
    lead = alpha.shape[:-1]
    a4 = alpha.reshape(lead + (4, n // 4))
    v_step = jnp.broadcast_to(a4[..., :, :, None], lead + (4, n // 4, 4)).reshape(
        lead + (4, n)
    )
    a16 = alpha.reshape(lead + (16, n // 16))
    v_skip = jnp.broadcast_to(a16[..., :, :, None], lead + (16, n // 16, 16)).reshape(
        lead + (16, n)
    )
    return jnp.concatenate([alpha[..., None, :], v_step, v_skip], axis=-2)


def structured_to_vals(g: jax.Array, K: int) -> jax.Array:
    """g (..., n) -> (..., 21, n) where slot k holds g[to_k(i)].

    slot 0:      g[i]
    slots 1+b:   g[((i mod n/4) << 2) | b]   == tile of a (n/4, 4) view
    slots 5+c:   g[((i mod n/16) << 4) | c]  == tile of a (n/16, 16) view
    """
    n = g.shape[-1]
    lead = g.shape[:-1]
    c4 = g.reshape(lead + (n // 4, 4))  # c4[m, b] = g[4m + b]
    # out[b, i] = c4[i mod n/4, b]: transpose then tile along the state axis
    t4 = jnp.swapaxes(c4, -1, -2)  # (..., 4, n/4)
    v_step = jnp.broadcast_to(t4[..., None, :], lead + (4, 4, n // 4)).reshape(
        lead + (4, n)
    )
    c16 = g.reshape(lead + (n // 16, 16))
    t16 = jnp.swapaxes(c16, -1, -2)  # (..., 16, n/16)
    v_skip = jnp.broadcast_to(t16[..., None, :], lead + (16, 16, n // 16)).reshape(
        lead + (16, n)
    )
    return jnp.concatenate([g[..., None, :], v_step, v_skip], axis=-2)


def _from_vals(ops: TransOps, alpha: jax.Array) -> jax.Array:
    if ops.from_idx is None:
        return structured_from_vals(alpha, ops.K)
    return alpha[..., ops.from_idx]  # (..., deg, n) gather


def _to_vals(ops: TransOps, g: jax.Array) -> jax.Array:
    if ops.to_idx is None:
        return structured_to_vals(g, ops.K)
    return g[..., ops.to_idx]


def _slot_from_state(ops: TransOps) -> jax.Array:
    """(S, n) int32 from-state ids per slot (for tie-breaking/traceback)."""
    if ops.from_idx is None:
        return jnp.asarray(trans_mod.slot_from_state(ops.K))
    return ops.from_idx


def from_state_of_slot(k: jax.Array, j: jax.Array, K: int) -> jax.Array:
    """Invert the structured slot layout: the from-state of slot k at state j."""
    step = ((k - 1) << (2 * (K - 1))) | (j >> 2)
    skip = ((k - 5) << (2 * (K - 2))) | (j >> 4)
    return jnp.where(k == 0, j, jnp.where(k <= 4, step, skip)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# emissions
# ---------------------------------------------------------------------------


class ModelArrays(NamedTuple):
    """Scaled pore-model tables on device; (..., n) float32 (broadcast
    against the batch).  log_level_stdv / log_sd_lambda precomputed."""

    level_mean: jax.Array
    level_stdv: jax.Array
    log_level_stdv: jax.Array
    sd_mean: jax.Array
    sd_lambda: jax.Array
    log_sd_lambda: jax.Array


def make_model_arrays(level_mean, level_stdv, sd_mean, sd_lambda) -> ModelArrays:
    level_mean = jnp.asarray(level_mean, jnp.float32)
    level_stdv = jnp.asarray(level_stdv, jnp.float32)
    sd_mean = jnp.asarray(sd_mean, jnp.float32)
    sd_lambda = jnp.asarray(sd_lambda, jnp.float32)
    return ModelArrays(
        level_mean=level_mean,
        level_stdv=level_stdv,
        log_level_stdv=jnp.log(level_stdv),
        sd_mean=sd_mean,
        sd_lambda=sd_lambda,
        log_sd_lambda=jnp.log(sd_lambda),
    )


@functools.partial(jax.jit, static_argnames=("K",))
def make_grouped_trans_device(p_stay, p_skip, K: int = 6) -> GroupedTrans:
    """Grouped tables built on device from per-task (B,) params — avoids
    uploading 3 x (B, n) tables per decode chunk."""
    from .. import transitions as tm

    stay, step, skip = tm.grouped_tables(p_stay, p_skip, K, xp=jnp)
    return GroupedTrans(stay_lp=stay, step_lp=step, skip_lp=skip, K=K)


@jax.jit
def make_scaled_model_arrays(bank, model_idx, params) -> ModelArrays:
    """Per-task scaled model tables computed on device.

    bank: dict of (M, n) float32 unscaled tables {level_mean, level_stdv,
    sd_mean, sd_lambda}; model_idx: (B,) int32; params: (B, 6) scaling rows.
    Uploads one copy of each distinct model instead of B scaled copies.
    """
    from ..pore_model import scale_arrays

    lm = bank["level_mean"][model_idx]
    ls = bank["level_stdv"][model_idx]
    sm = bank["sd_mean"][model_idx]
    slam = bank["sd_lambda"][model_idx]
    lm, ls, sm, slam = scale_arrays(lm, ls, sm, slam, params)
    return ModelArrays(
        level_mean=lm, level_stdv=ls, log_level_stdv=jnp.log(ls),
        sd_mean=sm, sd_lambda=slam, log_sd_lambda=jnp.log(slam),
    )


def log_emission(m: ModelArrays, ev_mean, ev_stdv, ev_log_stdv) -> jax.Array:
    """log Pr[event | state] over all states (Pore_Model.hpp:24-40,140-149).

    ev_*: (...,) scalars per batch element; model arrays (..., n).
    Returns (..., n).
    """
    x = ev_mean[..., None]
    a = (x - m.level_mean) / m.level_stdv
    lnorm = -m.log_level_stdv - (LOG_2PI + a * a) * 0.5
    y = ev_stdv[..., None]
    b = (y - m.sd_mean) / m.sd_mean
    linv = (
        m.log_sd_lambda - LOG_2PI - 3.0 * ev_log_stdv[..., None] - m.sd_lambda * b * b / y
    ) * 0.5
    return lnorm + linv


# ---------------------------------------------------------------------------
# Viterbi
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("stay_lp", "step_lp", "skip_lp"),
    meta_fields=("K",),
)
@dataclasses.dataclass(frozen=True)
class GroupedTrans:
    """Grouped (3-way) transition tables for the fast Viterbi kernel.

    stay_lp/step_lp/skip_lp: (..., n) float32 (see
    transitions.grouped_tables).  EXACT for max-plus recursions: every
    from-candidate of the 21-slot table is represented at its full
    probability in its primary group, and duplicate representations are
    strictly dominated (they can never decide the max or the tie-break).
    """

    stay_lp: jax.Array
    step_lp: jax.Array
    skip_lp: jax.Array
    K: int


def make_grouped_trans(params=None, K: int = 6, p_stay=None, p_skip=None) -> GroupedTrans:
    from .. import transitions as tm

    if params is not None:
        p_stay, p_skip = params.p_stay, params.p_skip
    stay, step, skip = tm.grouped_tables(p_stay, p_skip, K)
    return GroupedTrans(
        stay_lp=jnp.asarray(stay), step_lp=jnp.asarray(step),
        skip_lp=jnp.asarray(skip), K=K,
    )


def _grouped_step_core(gt: GroupedTrans, alpha: jax.Array):
    """One grouped max-plus transition step (shared by the full forward
    scan, the carry-in chunk variant, and the sequence-parallel decoder —
    all three MUST run the identical op sequence so chunked/sharded decodes
    stay bit-exact vs the single-program kernel).

    alpha (B, n) -> (best (B, n) pre-emission scores, bp (B, n) uint8).

    bp encoding (uint8): (group << 6) | within-group argmax
      group 0: stay (from = j)
      group 1: step (from = (arg << 2(K-1)) | (j >> 2))
      group 2: skip (from = (arg << 2(K-2)) | (j >> 4))
    """
    B, n = alpha.shape
    K = gt.K
    n4, n16 = n // 4, n // 16
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    f0 = iota_n  # stay from-state
    j_shr2 = iota_n >> 2
    j_shr4 = iota_n >> 4
    big = jnp.int32(np.iinfo(np.int32).max)

    def rep(x, r):  # (B, n/r) -> (B, n): value at column j = x[j >> log4(r)]
        return jnp.broadcast_to(
            x[:, :, None], (B, x.shape[1], r)
        ).reshape(B, n)

    def colmax(a):
        """Max + first-occurrence argmax over axis 1 of (B, R, m) via an
        explicit elementwise tree (middle-axis reduce/argmax ops lowered
        poorly on the previous accelerator; not re-measured on the
        H100)."""
        R = a.shape[1]
        m = a[:, 0]
        g = jnp.zeros_like(m, dtype=jnp.int32)
        for r in range(1, R):
            take = a[:, r] > m
            m = jnp.where(take, a[:, r], m)
            g = jnp.where(take, r, g)
        return m, g

    m4, g4 = colmax(alpha.reshape(B, 4, n4))
    m16, g16 = colmax(alpha.reshape(B, 16, n16))

    v0 = gt.stay_lp + alpha
    v1 = gt.step_lp + rep(m4, 4)
    v2 = gt.skip_lp + rep(m16, 16)
    best = jnp.maximum(jnp.maximum(v0, v1), v2)

    arg4 = rep(g4, 4).astype(jnp.int32)
    arg16 = rep(g16, 16).astype(jnp.int32)
    f1 = (arg4 << (2 * (K - 1))) | j_shr2
    f2 = (arg16 << (2 * (K - 2))) | j_shr4
    k0 = jnp.where(v0 == best, f0, big)
    k1 = jnp.where(v1 == best, f1, big)
    k2 = jnp.where(v2 == best, f2, big)
    fmin = jnp.minimum(jnp.minimum(k0, k1), k2)
    bp = jnp.where(
        k0 == fmin,
        0,
        jnp.where(k1 == fmin, 64 + arg4, 128 + arg16),
    ).astype(jnp.uint8)
    return best, bp


def viterbi_forward_grouped(gt: GroupedTrans, model: ModelArrays, ev: dict,
                            unroll: int = 1):
    """Grouped max-plus forward pass: per step, reduce alpha to 4-way and
    16-way column maxima once, then each destination j combines three
    candidates (stay, step-group, skip-group) — ~3-4x less elementwise work than
    the 21-slot expansion, with identical results and tie-breaking
    (see _grouped_step_core for the bp encoding).

    Returns (final_alpha (B, n), bps (T-1, B, n) uint8) — bps[t-1] is the
    backpointer table for event t (event 0 has no predecessor; the old
    sentinel row forced a full copy of the multi-GB tensor via concatenate).
    """
    n = model.level_mean.shape[-1]
    log_n = jnp.float32(math.log(n))
    lengths = ev["length"]
    B, T = ev["mean"].shape

    em0 = log_emission(model, ev["mean"][:, 0], ev["stdv"][:, 0], ev["log_stdv"][:, 0])
    alpha0 = em0 - log_n

    xs = (
        jnp.moveaxis(ev["mean"][:, 1:], 1, 0),
        jnp.moveaxis(ev["stdv"][:, 1:], 1, 0),
        jnp.moveaxis(ev["log_stdv"][:, 1:], 1, 0),
        jnp.arange(1, T),
    )

    def step(alpha, x):
        mean_t, stdv_t, log_stdv_t, t = x
        best, bp = _grouped_step_core(gt, alpha)
        em = log_emission(model, mean_t, stdv_t, log_stdv_t)
        new_alpha = best + em
        active = (t < lengths)[:, None]
        return jnp.where(active, new_alpha, alpha), bp

    final_alpha, bps = jax.lax.scan(step, alpha0, xs, unroll=unroll)
    return final_alpha, bps


def viterbi_forward_grouped_chunk(gt: GroupedTrans, model: ModelArrays,
                                  ev: dict, carry_alpha: jax.Array, t0,
                                  unroll: int = 2):
    """Forward scan over one T-chunk with an explicit incoming carry — the
    building block of T-chunked long-read decode and of the cross-device
    sequence-parallel scan (SURVEY §5 long-context; the reference instead
    caps reads at 100k events and materializes full DP matrices,
    Fast5_Summary.hpp:510-524).

    ev arrays are (B, Tc) chunk slices covering GLOBAL events
    [t0, t0+Tc); ev['length'] is the GLOBAL read length; carry_alpha (B, n)
    is alpha at event t0-1 (ignored when t0 == 0 — the t == 0 step
    initializes from the emission, exactly like the full kernel's alpha0).

    Returns (final_alpha (B, n) = alpha at event t0+Tc-1,
             bps (Tc, B, n) uint8) — row i is the backpointer table of
    global event t0+i; the row at global event 0 is all-zero filler (event
    0 has no predecessor).  Scanning chunks left-to-right while threading
    final_alpha reproduces viterbi_forward_grouped bit-exactly.
    """
    n = model.level_mean.shape[-1]
    log_n = jnp.float32(math.log(n))
    lengths = ev["length"]
    B, Tc = ev["mean"].shape
    t0 = jnp.asarray(t0, jnp.int32)

    xs = (
        jnp.moveaxis(ev["mean"], 1, 0),
        jnp.moveaxis(ev["stdv"], 1, 0),
        jnp.moveaxis(ev["log_stdv"], 1, 0),
        jnp.arange(Tc),
    )

    def step(alpha, x):
        mean_t, stdv_t, log_stdv_t, i = x
        t = t0 + i
        best, bp = _grouped_step_core(gt, alpha)
        em = log_emission(model, mean_t, stdv_t, log_stdv_t)
        first = t == 0
        new_alpha = jnp.where(first, em - log_n, best + em)
        bp = jnp.where(first, jnp.uint8(0), bp)
        active = (t < lengths)[:, None] | first
        return jnp.where(active, new_alpha, alpha), bp

    final_alpha, bps = jax.lax.scan(step, carry_alpha, xs, unroll=unroll)
    return final_alpha, bps


def viterbi_traceback_grouped_chunk(gt: GroupedTrans, end_state, carry_state,
                                    bps, t0, lengths, unroll: int = 8,
                                    compact: bool = False):
    """Reverse-scan one bp chunk of a T-chunked decode.

    bps (Tc, B, n) uint8 rows cover global events [t0, t0+Tc) (the
    viterbi_forward_grouped_chunk layout).  carry_state (B,) int32 is the
    decoded state at event t0+Tc-1's SUCCESSOR-side entry — i.e. the carry
    the full traceback scan holds when it is about to consume row
    t0+Tc-1; for the LAST chunk pass end_state.  end_state (B,) int32 =
    argmax of the final alpha (needed throughout for the t == lengths-1
    clamp, matching viterbi_traceback_grouped).

    Returns (carry_out (B,) int32 — feed as carry_state of the chunk to
    the LEFT; after the t0 == 0 chunk it is the state at event 0, i.e.
    path0, because the dummy t == 0 bp row is passed through — and ys
    (Tc, B): uint16 decoded states (row i = global event t0+i), or with
    compact=True the 6-bit per-event codes of viterbi_traceback_grouped
    (row t0 == 0 emits code 0; drop it before packing).  Concatenating
    chunk rows right-to-left reproduces the full kernel's path — and its
    packed code byte stream — bit-exactly, including the clamped suffix
    past each read's length.
    """
    Tm, B, n = bps.shape
    K = gt.K
    t0 = jnp.asarray(t0, jnp.int32)

    def step(s, x):
        bp_t, i = x
        t = t0 + i
        s_eff = jnp.where(t == lengths - 1, end_state, s)
        k = _lookup_bp(bp_t, s_eff)
        s_prev = grouped_from_state(k.astype(jnp.uint8), s_eff, K)
        # t == 0 is the dummy bp row: pass s_eff through so carry_out of
        # the first chunk is the state at event 0 (path0)
        real = (t >= 1) & (t <= lengths - 1)
        s_new = jnp.where(real, s_prev, s_eff)
        if compact:
            move = (k >> 6).astype(jnp.int32)
            code = jnp.where(real, (move << 4) | (s_eff & 15), 0)
            return s_new, code.astype(jnp.uint8)
        return s_new, s_eff.astype(jnp.uint16)

    xs = (bps, jnp.arange(Tm))
    carry_out, states = jax.lax.scan(step, carry_state, xs, reverse=True,
                                     unroll=unroll)
    return carry_out, states


def _lookup_bp(bp_t: jax.Array, s: jax.Array) -> jax.Array:
    """bp_t[b, s[b]] for bp_t (B, n) uint8, s (B,) int32, as a two-stage
    one-hot reduction (exact).

    A flat one-hot over (B, n) materializes n int32 compares per row each
    traceback step; splitting the index into hi/lo halves (row block of
    ~sqrt(n), then element) does ~2*sqrt(n) compares instead (chosen on
    the previous accelerator; not re-measured on the H100)."""
    B, n = bp_t.shape
    split = 1 << ((n.bit_length() - 1 + 1) // 2)  # ~sqrt(n), both powers of 2
    lo_n = n // split
    rows = bp_t.reshape(B, split, lo_n)
    hi = (s // lo_n).astype(jnp.int16)
    lo = (s % lo_n).astype(jnp.int16)
    i1 = jax.lax.iota(jnp.int16, split)[None, :, None]
    sub = jnp.sum(jnp.where(i1 == hi[:, None, None], rows, 0), axis=1)
    i2 = jax.lax.iota(jnp.int16, lo_n)[None, :]
    return jnp.sum(jnp.where(i2 == lo[:, None], sub, 0), axis=1)


def grouped_from_state(bp: jax.Array, j: jax.Array, K: int) -> jax.Array:
    """Decode a grouped bp byte into the from-state."""
    group = (bp >> 6).astype(jnp.int32)
    arg = (bp & 63).astype(jnp.int32)
    f_step = (arg << (2 * (K - 1))) | (j >> 2)
    f_skip = (arg << (2 * (K - 2))) | (j >> 4)
    return jnp.where(group == 0, j, jnp.where(group == 1, f_step, f_skip)).astype(
        jnp.int32
    )


def viterbi_traceback_grouped(gt: GroupedTrans, final_alpha, bps, lengths,
                              unroll: int = 8, compact: bool = False):
    """Traceback for the grouped bp encoding; bps has T-1 rows (event t's
    backpointers at bps[t-1]).  The scan body is tiny (one masked (B, n)
    reduction), so the sequential loop is iteration-latency-bound —
    unrolling amortizes the per-iteration overhead.

    compact=False: returns (path (B, T) uint16 states, logp (B,)).
    compact=True: returns (path0 (B,) int32, codes (B, 3*ceil((T-1)/4))
    uint8, logp) — each per-event code is (move << 4) | (state_t & 15)
    with move in {0 stay, 1 step, 2 skip}, only 6 significant bits, so
    FOUR codes are bit-packed into THREE bytes on device (little-endian
    24-bit groups: code r of group g lives at bits [6r, 6r+6) of
    bytes[3g:3g+3]) — 0.75 B/event to fetch vs 2 B for uint16 states.
    The full state path reconstructs losslessly from path0 by shifting in
    the low bases per move (native.path_from_packed_codes).  Entries at
    t >= length encode stay, reproducing the full path's clamped suffix
    exactly; pad codes past T-1 are zero (stay)."""
    Tm, B, n = bps.shape
    K = gt.K
    end_state = jnp.argmax(final_alpha, axis=-1).astype(jnp.int32)
    path_logp = jnp.max(final_alpha, axis=-1)

    def step(s, x):
        bp_t, t = x
        s_eff = jnp.where(t == lengths - 1, end_state, s)
        k = _lookup_bp(bp_t, s_eff)
        s_prev = grouped_from_state(k.astype(jnp.uint8), s_eff, K)
        real = t <= lengths - 1
        s_new = jnp.where(real, s_prev, s_eff)
        if compact:
            move = (k >> 6).astype(jnp.int32)
            code = jnp.where(real, (move << 4) | (s_eff & 15), 0)
            return s_new, code.astype(jnp.uint8)
        return s_new, s_eff.astype(jnp.uint16)

    # reverse=True: no reversed copy of the multi-GB bp tensor; forward-
    # order ys are the path at t = 1..T-1, and the final carry is the
    # state at t = 0
    xs = (bps, jnp.arange(1, Tm + 1))
    s0, ys = jax.lax.scan(step, end_state, xs, reverse=True,
                          unroll=unroll)
    if compact:
        return s0, _pack_codes(ys), path_logp
    path = jnp.concatenate([s0[None].astype(jnp.uint16), ys], axis=0)
    return jnp.moveaxis(path, 0, 1), path_logp


def _pack_codes(ys: jax.Array) -> jax.Array:
    """Bit-pack (Tm, B) six-bit codes 4-per-3-bytes -> (B, 3*ceil(Tm/4))
    (elementwise; negligible vs the scans, and the result fetch is the
    decode path's device-to-host cost)."""
    Tm, B = ys.shape
    G = -(-Tm // 4)
    c = ys if 4 * G == Tm else jnp.pad(ys, ((0, 4 * G - Tm), (0, 0)))
    c = c.reshape(G, 4, B).astype(jnp.int32)
    w = c[:, 0] | (c[:, 1] << 6) | (c[:, 2] << 12) | (c[:, 3] << 18)
    packed = jnp.stack(
        [w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF], axis=1
    ).astype(jnp.uint8).reshape(3 * G, B)
    return jnp.moveaxis(packed, 0, 1)


@functools.partial(
    jax.jit,
    static_argnames=("with_path", "fwd_unroll", "tb_unroll", "compact_path"),
)
def viterbi_decode_grouped(gt: GroupedTrans, model: ModelArrays, ev: dict,
                           with_path: bool = True, fwd_unroll: int = 2,
                           tb_unroll: int = 8, compact_path: bool = False):
    """Fast-path Viterbi decode on the grouped decomposition (standard
    stay/step/skip structured transitions only).

    fwd_unroll=2 / tb_unroll=8 defaults: chosen on the previous
    accelerator; not re-measured on the H100.

    compact_path=True returns {path0, codes, logp} instead of the full
    uint16 state path (see viterbi_traceback_grouped; 6-bit-packed codes
    cut the host transfer to 0.75 B/event — reconstruct with
    native.path_from_packed_codes)."""
    final_alpha, bps = viterbi_forward_grouped(gt, model, ev, unroll=fwd_unroll)
    if not with_path:
        return {"logp": jnp.max(final_alpha, axis=-1)}
    if compact_path:
        path0, codes, logp = viterbi_traceback_grouped(
            gt, final_alpha, bps, ev["length"], unroll=tb_unroll, compact=True)
        return {"path0": path0, "codes": codes, "logp": logp}
    path, logp = viterbi_traceback_grouped(gt, final_alpha, bps, ev["length"],
                                           unroll=tb_unroll)
    return {"path": path, "logp": logp}


@functools.partial(
    jax.jit,
    static_argnames=("Tc", "with_path", "fwd_unroll", "tb_unroll",
                     "compact_path"),
)
def viterbi_decode_grouped_tchunk(gt: GroupedTrans, model: ModelArrays,
                                  ev: dict, Tc: int, with_path: bool = True,
                                  fwd_unroll: int = 2, tb_unroll: int = 8,
                                  compact_path: bool = False):
    """Chunked-time grouped Viterbi decode as ONE program: C =
    ceil(T/Tc) carry-linked inner scans hold the backpointers
    chunk-by-chunk, then C reverse inner scans trace back one chunk at a
    time.  The reverse pass's layout-conversion copy (the full-scan
    program holds the whole bp tensor TWICE — the ~2.5x HBM peak,
    CLAUDE.md) is thereby bounded to ONE chunk: peak HBM is
    ~(1 + 1.5/C)x of the bp bytes, which admits ~2.5x the batch at the
    same budget (the cross-device equivalent is parallel/seqpar.py).

    Bit-identical to viterbi_decode_grouped — same _grouped_step_core op
    sequence, same masking, same compact 6-bit code packing (pinned by
    tests/test_seqpar.py) — so the pipeline can select it per bucket
    with no downstream change.  The chunk loop is a STATIC Python loop
    (C = ceil(T/Tc) inner scans inlined into the one program; the last
    chunk is simply shorter): an outer lax.scan's ys buffer costs an
    extra full-bp-tensor write pass, while the unrolled form keeps each
    inner scan's ys as its own buffer (chosen on the previous
    accelerator; not re-measured on the H100)."""
    n = model.level_mean.shape[-1]
    lengths = ev["length"]
    B, T = ev["mean"].shape
    bounds = [(t0, min(t0 + Tc, T)) for t0 in range(0, T, Tc)]

    alpha = jnp.zeros((B, n), jnp.float32)
    bps = []
    for lo, hi in bounds:
        evc = {"mean": ev["mean"][:, lo:hi], "stdv": ev["stdv"][:, lo:hi],
               "log_stdv": ev["log_stdv"][:, lo:hi], "length": lengths}
        alpha, bps_c = viterbi_forward_grouped_chunk(
            gt, model, evc, alpha, lo, unroll=fwd_unroll)
        bps.append(bps_c)
    logp = jnp.max(alpha, axis=-1)
    if not with_path:
        return {"logp": logp}
    end_state = jnp.argmax(alpha, axis=-1).astype(jnp.int32)

    s = end_state
    ys_chunks = [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        lo, _hi = bounds[c]
        s, ys_chunks[c] = viterbi_traceback_grouped_chunk(
            gt, end_state, s, bps[c], lo, lengths, unroll=tb_unroll,
            compact=compact_path)
    s0 = s  # = state at event 0 (the t == 0 dummy row passes through)
    ys_flat = jnp.concatenate(ys_chunks, axis=0)[1:]  # rows t = 1..T-1
    if compact_path:
        return {"path0": s0, "codes": _pack_codes(ys_flat), "logp": logp}
    path = jnp.concatenate([s0[None].astype(jnp.uint16), ys_flat], axis=0)
    return {"path": jnp.moveaxis(path, 0, 1), "logp": logp}


def viterbi_forward(ops: TransOps, model: ModelArrays, ev: dict,
                    unroll: int = 1):
    """Max-plus forward pass (Viterbi.hpp:44-99), batched + masked.

    ev: dict of (B, T) arrays {mean, stdv, log_stdv} + (B,) int32 'length'.
    Returns (final_alpha (B, n), bps (T-1, B, n) uint8 slot ids); bps[t-1]
    holds event t's backpointers (event 0 has no predecessor).
    """
    n = model.level_mean.shape[-1]
    log_n = jnp.float32(math.log(n))
    lengths = ev["length"]
    B, T = ev["mean"].shape
    slot_states = _slot_from_state(ops)  # (S, n) int32
    big = jnp.int32(np.iinfo(np.int32).max)

    em0 = log_emission(model, ev["mean"][:, 0], ev["stdv"][:, 0], ev["log_stdv"][:, 0])
    alpha0 = em0 - log_n

    xs = (
        jnp.moveaxis(ev["mean"][:, 1:], 1, 0),
        jnp.moveaxis(ev["stdv"][:, 1:], 1, 0),
        jnp.moveaxis(ev["log_stdv"][:, 1:], 1, 0),
        jnp.arange(1, T),
    )

    def step(alpha, x):
        mean_t, stdv_t, log_stdv_t, t = x
        vals = ops.from_logp + _from_vals(ops, alpha)  # (B, S, n)
        best = jnp.max(vals, axis=-2)  # (B, n)
        # tie-break: lowest from-state id among maxima (Viterbi.hpp:84)
        masked_states = jnp.where(vals == best[..., None, :], slot_states, big)
        bp = jnp.argmin(masked_states, axis=-2).astype(jnp.uint8)  # (B, n)
        em = log_emission(model, mean_t, stdv_t, log_stdv_t)
        new_alpha = best + em
        active = (t < lengths)[:, None]
        return jnp.where(active, new_alpha, alpha), bp

    final_alpha, bps = jax.lax.scan(step, alpha0, xs, unroll=unroll)
    return final_alpha, bps


def viterbi_traceback(ops: TransOps, final_alpha, bps, lengths,
                      unroll: int = 8):
    """Traceback (Viterbi.hpp:120-142): returns (path (B, T) int32,
    path_logp (B,) float32).  Entries at t >= length are clamped to the
    first real state of the suffix (harmless; callers mask by length).

    The per-step backpointer lookup is a two-stage one-hot masked reduction
    (_lookup_bp) rather than a gather: masked lane reductions beat a dynamic
    gather's lowering on the previous accelerator (not re-measured on the
    H100); the tiny body makes the loop iteration-latency-bound, so it is
    unrolled.
    """
    Tm, B, n = bps.shape  # T-1 rows: bps[t-1] = event t's backpointers
    K = ops.K
    # end state: argmax, first occurrence = lowest index (Viterbi.hpp:125-131)
    end_state = jnp.argmax(final_alpha, axis=-1).astype(jnp.int32)  # (B,)
    path_logp = jnp.max(final_alpha, axis=-1)
    sparse = ops.from_idx is not None
    if sparse:
        from_idx = ops.from_idx  # (S, n)

    def step(s, x):
        bp_t, t = x  # bp_t (B, n) uint8
        s_eff = jnp.where(t == lengths - 1, end_state, s)
        k = _lookup_bp(bp_t, s_eff)
        if sparse:
            s_prev = from_idx[k, s_eff]
        else:
            s_prev = from_state_of_slot(k, s_eff, K)
        s_new = jnp.where(t <= lengths - 1, s_prev, s_eff)
        return s_new, s_eff.astype(jnp.uint16)

    # reverse=True iterates t = T-1 .. 1 WITHOUT materializing a reversed
    # copy of the multi-GB bp tensor; ys come out in forward order (the
    # path at t = 1..T-1) and the final carry is the state at t = 0.
    # uint16: states < 4^K <= 65536 (halves the host transfer).
    xs = (bps, jnp.arange(1, Tm + 1))
    s0, path_rest = jax.lax.scan(step, end_state, xs, reverse=True,
                                 unroll=unroll)
    path = jnp.concatenate([s0[None].astype(jnp.uint16), path_rest], axis=0)
    return jnp.moveaxis(path, 0, 1), path_logp


@functools.partial(
    jax.jit, static_argnames=("with_path", "fwd_unroll", "tb_unroll")
)
def viterbi_decode(ops: TransOps, model: ModelArrays, ev: dict,
                   with_path: bool = True, fwd_unroll: int = 1,
                   tb_unroll: int = 8):
    """Full Viterbi decode: returns dict {path (B,T) int32, logp (B,)}."""
    final_alpha, bps = viterbi_forward(ops, model, ev, unroll=fwd_unroll)
    if not with_path:
        return {"logp": jnp.max(final_alpha, axis=-1)}
    path, logp = viterbi_traceback(ops, final_alpha, bps, ev["length"],
                                   unroll=tb_unroll)
    return {"path": path, "logp": logp}


# ---------------------------------------------------------------------------
# Forward-backward
# ---------------------------------------------------------------------------


def _logsumexp_slots(vals):
    """logsumexp over the slot axis (-2), -inf-safe."""
    m = jnp.max(vals, axis=-2)
    safe_m = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.sum(jnp.exp(vals - safe_m[..., None, :]), axis=-2)
    return jnp.where(jnp.isfinite(m), safe_m + jnp.log(s), m)


def fwbw(ops: TransOps, model: ModelArrays, ev: dict, keep_emissions: bool = False):
    """Exact log-space forward-backward (Forward_Backward.hpp:46-135).

    Returns dict:
      alpha (B, T, n), beta (B, T, n), log_pr_data (B,),
      em (B, T, n) if keep_emissions (needed by the EM trainer).
    Padded steps: alpha rows at t >= length hold frozen copies of the last
    real alpha (fwd_step stores the carried value); beta forced to 0 at
    t >= length-1.  Consumers must still mask by length — the frozen rows
    are finite but meaningless.
    """
    n = model.level_mean.shape[-1]
    log_n = jnp.float32(math.log(n))
    lengths = ev["length"]
    B, T = ev["mean"].shape

    means = jnp.moveaxis(ev["mean"], 1, 0)
    stdvs = jnp.moveaxis(ev["stdv"], 1, 0)
    log_stdvs = jnp.moveaxis(ev["log_stdv"], 1, 0)

    em0 = log_emission(model, means[0], stdvs[0], log_stdvs[0])
    alpha0 = em0 - log_n

    def fwd_step(alpha, x):
        mean_t, stdv_t, log_stdv_t, t = x
        vals = ops.from_logp + _from_vals(ops, alpha)
        em = log_emission(model, mean_t, stdv_t, log_stdv_t)
        new_alpha = em + _logsumexp_slots(vals)
        active = (t < lengths)[:, None]
        alpha_carry = jnp.where(active, new_alpha, alpha)
        return alpha_carry, (alpha_carry, em)

    xs = (means[1:], stdvs[1:], log_stdvs[1:], jnp.arange(1, T))
    final_alpha, (alphas_rest, ems_rest) = jax.lax.scan(fwd_step, alpha0, xs)
    alphas = jnp.concatenate([alpha0[None], alphas_rest], axis=0)  # (T, B, n)
    ems = jnp.concatenate([em0[None], ems_rest], axis=0)

    # log_pr_data: logsumexp over states of the final (length-1) alpha
    m = jnp.max(final_alpha, axis=-1)
    log_pr_data = m + jnp.log(jnp.sum(jnp.exp(final_alpha - m[:, None]), axis=-1))

    # backward: beta[t] = logsum_to(logp + em[t+1] + beta[t+1]); beta = 0 at
    # t >= length-1 (Forward_Backward.hpp:93-125)
    beta_init = jnp.zeros((B, n), dtype=jnp.float32)

    def bwd_step(beta, x):
        em_next, t = x  # em at t+1
        g = em_next + beta
        vals = ops.to_logp + _to_vals(ops, g)
        cand = _logsumexp_slots(vals)
        new_beta = jnp.where((t >= lengths - 1)[:, None], 0.0, cand)
        return new_beta, new_beta

    # reverse=True avoids materializing a reversed copy of the emissions
    xs_b = (ems[1:], jnp.arange(T - 1))
    _, betas_fwd = jax.lax.scan(bwd_step, beta_init, xs_b, reverse=True)
    betas = jnp.concatenate([betas_fwd, beta_init[None]], axis=0)  # (T, B, n)

    out = {
        "alpha": jnp.moveaxis(alphas, 0, 1),
        "beta": jnp.moveaxis(betas, 0, 1),
        "log_pr_data": log_pr_data,
    }
    if keep_emissions:
        out["em"] = jnp.moveaxis(ems, 0, 1)
    return out


fwbw_jit = jax.jit(fwbw, static_argnames=("keep_emissions",))


# ---------------------------------------------------------------------------
# grouped forward-backward (log-sum-exp with closed-form corrections)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("stay_lp", "step_lp", "skip_lp", "step_to_lp", "skip_to_lp"),
    meta_fields=("K",),
)
@dataclasses.dataclass(frozen=True)
class GroupedTransFull:
    """Grouped tables for both recursion directions (see
    transitions.grouped_tables / grouped_tables_to)."""

    stay_lp: jax.Array
    step_lp: jax.Array
    skip_lp: jax.Array
    step_to_lp: jax.Array
    skip_to_lp: jax.Array
    K: int


@functools.partial(jax.jit, static_argnames=("K",))
def make_grouped_full_device(p_stay, p_skip, K: int = 6) -> GroupedTransFull:
    from .. import transitions as tm

    stay, step, skip = tm.grouped_tables(p_stay, p_skip, K, xp=jnp)
    step_to, skip_to = tm.grouped_tables_to(p_stay, p_skip, K, xp=jnp)
    return GroupedTransFull(
        stay_lp=stay, step_lp=step, skip_lp=skip,
        step_to_lp=step_to, skip_to_lp=skip_to, K=K,
    )


def fwbw_grouped_forward(gtf: GroupedTransFull, model: ModelArrays, ev: dict,
                         unroll: int = 1):
    """The forward half of fwbw_grouped, in scan-natural (T, B, n) layout.

    Returns (alphas (T, B, n), ems (T, B, n), log_pr_data (B,)).  Exposed
    separately so the fused EM round (train._fused_bwd_mstats) can stream
    the backward pass + M-step statistics without materializing beta/em
    or paying the (T, B, n) -> (B, T, n) layout transposes; callers that
    ignore `ems` get it DCE'd out of the scan by jax.
    """
    from .. import transitions as tm

    n = model.level_mean.shape[-1]
    log_n = jnp.float32(math.log(n))
    lengths = ev["length"]
    B, T = ev["mean"].shape
    masks = tm.grouped_correction_masks(gtf.K)
    mH = jnp.asarray(masks["H"])
    mP2 = jnp.asarray(masks["P2mH"])
    mS5 = jnp.asarray(masks["S5"])
    n4, n16 = n // 4, n // 16

    e_stay = jnp.exp(gtf.stay_lp)
    e_step = jnp.exp(gtf.step_lp)
    e_skip = jnp.exp(gtf.skip_lp)

    def rep(x, r):
        return jnp.broadcast_to(x[:, :, None], (B, x.shape[1], r)).reshape(B, n)

    means = jnp.moveaxis(ev["mean"], 1, 0)
    stdvs = jnp.moveaxis(ev["stdv"], 1, 0)
    log_stdvs = jnp.moveaxis(ev["log_stdv"], 1, 0)

    em0 = log_emission(model, means[0], stdvs[0], log_stdvs[0])
    alpha0 = em0 - log_n

    def fwd_step(alpha, x):
        mean_t, stdv_t, log_stdv_t, t = x
        m = jnp.max(alpha, axis=-1, keepdims=True)
        E = jnp.exp(alpha - m)
        S4 = rep(jnp.sum(E.reshape(B, 4, n4), axis=1), 4)
        S16 = rep(jnp.sum(E.reshape(B, 16, n16), axis=1), 16)
        total = (
            e_stay * E
            + e_step * (S4 - mH * E)
            + e_skip * (S16 - mP2 * E - mS5 * S4)
        )
        em = log_emission(model, mean_t, stdv_t, log_stdv_t)
        new_alpha = em + m + jnp.log(total)
        active = (t < lengths)[:, None]
        alpha_carry = jnp.where(active, new_alpha, alpha)
        return alpha_carry, (alpha_carry, em)

    xs = (means[1:], stdvs[1:], log_stdvs[1:], jnp.arange(1, T))
    final_alpha, (alphas_rest, ems_rest) = jax.lax.scan(
        fwd_step, alpha0, xs, unroll=unroll)
    alphas = jnp.concatenate([alpha0[None], alphas_rest], axis=0)
    ems = jnp.concatenate([em0[None], ems_rest], axis=0)

    mfin = jnp.max(final_alpha, axis=-1)
    log_pr_data = mfin + jnp.log(
        jnp.sum(jnp.exp(final_alpha - mfin[:, None]), axis=-1)
    )
    return alphas, ems, log_pr_data


def fwbw_grouped(gtf: GroupedTransFull, model: ModelArrays, ev: dict,
                 keep_emissions: bool = False, unroll: int = 1):
    """Exact forward-backward via the grouped decomposition.

    Unlike max-plus, log-sum-exp counts every table row, so the duplicate /
    exceptional entries must be corrected explicitly — and every correction
    is a masked multiple of quantities already at hand (no gathers):

      forward sum at j = e_stay[j] E[j]
                       + e_step[j] (S4[j>>2]            - [j in H]  E[j])
                       + e_skip[j] (S16[j>>4] - [j in P2\\H] E[j]
                                              - [j in S5]  S4[j>>2])

    where E = exp(alpha - max), S4/S16 are the 4/16-way column sums of E,
    H = homopolymers (step group duplicates the stay entry), P2\\H =
    period-2 states (skip group duplicates stay), S5 = five-equal-leading-
    base states whose 4 "extra-step-overlap" skip entries are exactly the
    step-group members (so their phantom sum equals e_skip * S4).  The
    backward pass mirrors this with contiguous-block sums (tile patterns)
    and the trailing-base mask S5T.  ~10x fewer transcendentals and ~8x
    fewer lane-ops per step than the 21-slot kernel; results equal up to
    float reassociation.
    """
    from .. import transitions as tm

    n = model.level_mean.shape[-1]
    K = gtf.K
    n4, n16 = n // 4, n // 16
    lengths = ev["length"]
    B, T = ev["mean"].shape
    # backward-only body: the forward half (which consumed masks["S5"]
    # and log n) lives in fwbw_grouped_forward
    masks = tm.grouped_correction_masks(K)
    mH = jnp.asarray(masks["H"])
    mP2 = jnp.asarray(masks["P2mH"])
    mS5T = jnp.asarray(masks["S5T"])

    e_stay = jnp.exp(gtf.stay_lp)
    e_step_to = jnp.exp(gtf.step_to_lp)
    e_skip_to = jnp.exp(gtf.skip_to_lp)

    def tile(x, r):  # (B, n/r) -> (B, n): value at i = x[i mod (n/r)]
        return jnp.broadcast_to(x[:, None, :], (B, r, x.shape[1])).reshape(B, n)

    # unroll was a wash here on the previous accelerator (the exp/log-heavy
    # body is compute-bound, unlike the Viterbi forward), and an unrolled
    # program's fusion may reassociate the lse accumulation (log_pr_data
    # differs in low bits vs unroll=1) — default 1 keeps results
    # bit-stable AND the program small.  (Viterbi's max-plus scan has no
    # such drift: it only compares and adds.)  The FUSED EM round's call
    # of fwbw_grouped_forward unrolls by 2 (train.EM_FWD_UNROLL); the
    # low-bit lpd caveat applies to it identically.
    alphas, ems, log_pr_data = fwbw_grouped_forward(gtf, model, ev,
                                                    unroll=unroll)

    beta_init = jnp.zeros((B, n), dtype=jnp.float32)

    def bwd_step(beta, x):
        em_next, t = x
        g = em_next + beta
        m = jnp.max(g, axis=-1, keepdims=True)
        G = jnp.exp(g - m)
        T4 = tile(jnp.sum(G.reshape(B, n4, 4), axis=-1), 4)
        T16 = tile(jnp.sum(G.reshape(B, n16, 16), axis=-1), 16)
        total = (
            e_stay * G
            + e_step_to * (T4 - mH * G)
            + e_skip_to * (T16 - mP2 * G - mS5T * T4)
        )
        cand = m + jnp.log(total)
        new_beta = jnp.where((t >= lengths - 1)[:, None], 0.0, cand)
        return new_beta, new_beta

    xs_b = (ems[1:], jnp.arange(T - 1))
    _, betas_fwd = jax.lax.scan(bwd_step, beta_init, xs_b, reverse=True,
                                unroll=unroll)
    betas = jnp.concatenate([betas_fwd, beta_init[None]], axis=0)

    out = {
        "alpha": jnp.moveaxis(alphas, 0, 1),
        "beta": jnp.moveaxis(betas, 0, 1),
        "log_pr_data": log_pr_data,
    }
    if keep_emissions:
        out["em"] = jnp.moveaxis(ems, 0, 1)
    return out


def fwbw_custom(ops: TransOps, model: ModelArrays, ev: dict):
    """Per-step-normalized forward-backward
    (Forward_Backward_Custom.hpp:46-142).

    alpha[i,j] = Pr[S_i=j | e_1..e_{i-1}], beta[i,j] = Pr[S_i=j | e_1..e_i],
    gamma[i,j] = Pr[S_i=j | e_1..e_n]; all in log space.
    Returns dict {alpha, beta, gamma} of (B, T, n).
    """
    n = model.level_mean.shape[-1]
    log_n = jnp.float32(math.log(n))
    lengths = ev["length"]
    B, T = ev["mean"].shape

    means = jnp.moveaxis(ev["mean"], 1, 0)
    stdvs = jnp.moveaxis(ev["stdv"], 1, 0)
    log_stdvs = jnp.moveaxis(ev["log_stdv"], 1, 0)

    def norm(x):
        m = jnp.max(x, axis=-1, keepdims=True)
        return x - (m + jnp.log(jnp.sum(jnp.exp(x - m), axis=-1, keepdims=True)))

    alpha0 = jnp.full((B, n), -log_n, dtype=jnp.float32)
    em0 = log_emission(model, means[0], stdvs[0], log_stdvs[0])
    beta0 = norm(em0 + alpha0)

    def fwd_step(beta, x):
        mean_t, stdv_t, log_stdv_t, t = x
        vals = ops.from_logp + _from_vals(ops, beta)
        alpha_t = _logsumexp_slots(vals)
        em = log_emission(model, mean_t, stdv_t, log_stdv_t)
        beta_t = norm(em + alpha_t)
        active = (t < lengths)[:, None]
        beta_carry = jnp.where(active, beta_t, beta)
        return beta_carry, (alpha_t, beta_carry)

    xs = (means[1:], stdvs[1:], log_stdvs[1:], jnp.arange(1, T))
    beta_last, (alphas_rest, betas_rest) = jax.lax.scan(fwd_step, beta0, xs)
    alphas = jnp.concatenate([alpha0[None], alphas_rest], axis=0)
    betas = jnp.concatenate([beta0[None], betas_rest], axis=0)

    # gamma backward: gamma[i] = beta[i] + logsum_to(logp + gamma[i+1] - alpha[i+1])
    gamma_init = beta_last

    def bwd_step(gamma, x):
        alpha_next, beta_t, t = x
        g = gamma - alpha_next
        vals = ops.to_logp + _to_vals(ops, g)
        cand = beta_t + _logsumexp_slots(vals)
        new_gamma = jnp.where((t >= lengths - 1)[:, None], beta_t, cand)
        return new_gamma, new_gamma

    xs_b = (alphas[1:], betas[:-1], jnp.arange(T - 1))
    _, gammas_fwd = jax.lax.scan(bwd_step, gamma_init, xs_b, reverse=True)
    gammas = jnp.concatenate([gammas_fwd, gamma_init[None]], axis=0)

    return {
        "alpha": jnp.moveaxis(alphas, 0, 1),
        "beta": jnp.moveaxis(betas, 0, 1),
        "gamma": jnp.moveaxis(gammas, 0, 1),
    }


fwbw_custom_jit = jax.jit(fwbw_custom)
