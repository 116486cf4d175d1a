"""Ops-per-event roofline model for the decode and EM kernels, the published
peaks of the devices it knows, and a measured elementwise peak.

`bench.py` multiplies these per-event op counts by the measured events/s and
divides by (a) a MEASURED same-shape elementwise FMA peak and (b) the
device's published float32 peak (PEAKS), emitting both in its JSON detail.

Why a CUDA-core (not tensor-core) roofline: the Viterbi recursion is
max-plus — there is no matrix product to put on the tensor cores; every op
is an elementwise add/compare/select over (B, n) float32 lanes.  The legacy
EM E-step's sufficient statistics are one (G*S*T, n) x (n, k) contraction
(train.py, pinned to precision="highest", so no TF32); the fused round
replaced it with elementwise sums.

The op tallies below mirror ops/hmm.py line by line (each item names the
kernel expression it counts); tests/test_roofline.py pins them against the
kernel source so they cannot silently drift.  Counting convention: one ADD /
MUL / DIV / COMPARE / SELECT / bitwise op over one f32/i32 lane = 1 op;
broadcasts/reshapes/copies = 0.  A fused multiply-add counts 2 in the
published FLOP/s, so ops / peak FLOP/s is a lower bound on the time.
"""

from __future__ import annotations

import functools
import time


def log_emission_ops(n: int) -> int:
    """Per (batch row, event): ops/hmm.py log_emission over (n,) states.

    lnorm: a=(x-lm)/ls (2n), a*a (n), +LOG_2PI (n), *0.5 (n),
           -log_ls - (...) (2n)                                    -> 7n
    linv:  b=(y-sm)/sm (2n), b*b (n), *sd_lambda (n), /y (n),
           log_sd_lambda - LOG_2PI - 3*log_stdv - (...) (3n), *0.5 (n) -> 9n
    sum:   lnorm + linv                                            -> 1n
    """
    return 17 * n


def grouped_forward_ops_per_event(n: int) -> dict:
    """Per (batch row, event step): viterbi_forward_grouped's `step`.

    Returns an itemized dict; key "total" is the sum of the items.
    """
    items = {
        # colmax(alpha.reshape(B, 4, n/4)): 3 rounds x (compare + 2 selects)
        # over n/4 lanes
        "colmax4": 3 * 3 * (n // 4),
        # colmax(alpha.reshape(B, 16, n/16)): 15 rounds x 3 ops over n/16
        "colmax16": 15 * 3 * (n // 16),
        # v0/v1/v2 = table + candidate (3 adds over n)
        "candidate_adds": 3 * n,
        # best = max(max(v0, v1), v2)
        "best_max": 2 * n,
        # f1/f2 = (arg << c) | j_shr: 2 int ops each
        "from_state_int": 4 * n,
        # k0/k1/k2 = where(v == best, f, big): compare + select each
        "tie_candidates": 6 * n,
        # fmin = min(min(k0, k1), k2)
        "tie_min": 2 * n,
        # bp = where(k0==fmin, 0, where(k1==fmin, 64+arg4, 128+arg16)):
        # 2 compares + 2 selects + 2 adds
        "bp_select": 6 * n,
        # emissions fused into the step
        "emission": log_emission_ops(n),
        # new_alpha = best + em; where(active, new_alpha, alpha)
        "alpha_update": 2 * n,
    }
    items["total"] = sum(items.values())
    return items


def grouped_traceback_ops_per_event(n: int) -> dict:
    """Per (batch row, step): viterbi_traceback_grouped's `step` (the
    two-stage _lookup_bp dominates)."""
    split = 1 << ((n.bit_length() - 1 + 1) // 2)
    lo_n = n // split
    items = {
        # _lookup_bp stage 1: where(i1 == hi, rows, 0) + sum over split:
        # compare + select + add over all n lanes
        "lookup_stage1": 3 * n,
        # stage 2 over lo_n lanes
        "lookup_stage2": 3 * lo_n,
        # grouped_from_state: shifts/ors/compares/selects on (B,) scalars
        "from_state": 12,
        # masks, code packing on (B,) scalars
        "code_pack": 8,
    }
    items["total"] = sum(items.values())
    return items


def decode_ops_per_event(n: int) -> dict:
    """Full decode (forward + traceback) ops per (batch row, event)."""
    fwd = grouped_forward_ops_per_event(n)["total"]
    tb = grouped_traceback_ops_per_event(n)["total"]
    return {"forward": fwd, "traceback": tb, "total": fwd + tb}


# ---------------------------------------------------------------------------
# EM (training) roofline — the dominant e2e device stage
# ---------------------------------------------------------------------------


def fwbw_grouped_fwd_ops_per_event(n: int) -> dict:
    """Per (sequence row, event step): ops/hmm.py fwbw_grouped's fwd_step."""
    items = {
        # m = max(alpha, axis=-1)
        "max_alpha": n,
        # E = exp(alpha - m): sub + exp
        "exp_shift": 2 * n,
        # S4 = sum(E.reshape(B, 4, n/4), axis=1): 3 adds per n/4 lane
        "colsum4": 3 * (n // 4),
        # S16: 15 adds per n/16 lane
        "colsum16": 15 * (n // 16),
        # total = e_stay*E + e_step*(S4 - mH*E) + e_skip*(S16 - mP2*E
        #         - mS5*S4): 6 muls + 3 subs + 2 adds over n
        "total_mix": 11 * n,
        # emissions fused into the step
        "emission": log_emission_ops(n),
        # new_alpha = em + m + log(total): log + 2 adds
        "alpha_new": 3 * n,
        # where(active, new_alpha, alpha)
        "active_select": n,
    }
    items["total"] = sum(items.values())
    return items


def fwbw_grouped_bwd_ops_per_event(n: int) -> dict:
    """Per (sequence row, event step): fwbw_grouped's bwd_step (emissions
    reused from the forward pass, so no emission term)."""
    items = {
        "g_add": n,            # g = em_next + beta
        "max_g": n,
        "exp_shift": 2 * n,    # G = exp(g - m)
        "rowsum4": 3 * (n // 4),
        "rowsum16": 15 * (n // 16),
        "total_mix": 11 * n,   # same 3-term mix as forward
        "cand": 2 * n,         # m + log(total)
        "boundary_select": n,  # where(t >= len-1, 0, cand)
    }
    items["total"] = sum(items.values())
    return items


def em_scaling_mstep_ops_per_event(n: int) -> dict:
    """Per (sequence row, event): train.train_one_round's scaling M-step.

    The (B, n, 6) weight matrix W and the 3x3 solve are O(B*n) / O(G) —
    amortized over T they contribute <1 op/event and are omitted (noted
    here, not counted).  The stats einsum is a matrix product and is
    reported in a separate field (MACs, not elementwise lane ops).
    """
    items = {
        # post = exp(alpha + beta - lpd) * w: 2 adds + exp + mul
        "posterior": 4 * n,
        # acc(s0), acc(s0*x), ... ~20 muls/adds on (B, T) scalars
        "mstep_accumulations": 24,
    }
    items["total"] = sum(items.values())
    return items


def em_stats_einsum_macs_per_event(n: int) -> int:
    """Matrix-product MACs per (sequence row, event):
    einsum('btn,bnk->btk', post, W)
    with k=6 sufficient statistics (train.py)."""
    return 6 * n


def em_st_mstep_ops_per_event(n: int) -> dict:
    """Per (sequence row, event): train._train_st_params (transition
    M-step), the second-heaviest EM term after the E-step."""
    items = {
        "lp_j1": 2 * n,          # a_i + b_i - lpd
        "g_add": n,              # em[1:] + beta[1:]
        "lp_stay": 4 * n,        # 3 adds + min clamp
        "max_g": n,
        "exp_shift": 2 * n,
        "blocksum4": 3 * (n // 4),
        "log_blocks": n // 4,    # log on the (B,Tm,n/4) sums, then tile
        "lsum4_add": n,          # + safe_m
        "lp_steps": 3 * n,       # a_i + log_p_step_4 + lsum4 - lpd
        "logaddexp": 5 * n,      # max + 2 exp + log + add
        "d01_clamp": n,          # min(.., lp_j1)
        "skip_mass": 4 * n,      # exp + exp + sub + max(0)
        "log_d2": n,
        # _masked_lse(lp_j1 / lp_stay / lp_d2) x 2 strands: each is
        # where-mask + max-reduce + (sub, exp, sum-reduce) = 5n
        "masked_lse_reductions": 2 * 3 * 5 * n,
    }
    items["total"] = sum(items.values())
    return items


def em_ops_per_event(n: int, train_scaling: bool = True,
                     train_transitions: bool = True) -> dict:
    """Total elementwise lane-ops per (sequence row, event) for ONE EM
    round (train.train_one_round): grouped E-step + M-steps.  The
    statistics contraction's MACs are returned separately ('matmul_macs')."""
    out = {
        "fwd": fwbw_grouped_fwd_ops_per_event(n)["total"],
        "bwd": fwbw_grouped_bwd_ops_per_event(n)["total"],
    }
    out["scaling_mstep"] = (
        em_scaling_mstep_ops_per_event(n)["total"] if train_scaling else 0
    )
    out["st_mstep"] = (
        em_st_mstep_ops_per_event(n)["total"] if train_transitions else 0
    )
    out["total"] = sum(out.values())
    out["matmul_macs"] = em_stats_einsum_macs_per_event(n) if train_scaling else 0
    return out


def em_hbm_bytes_per_event(n: int) -> dict:
    """Minimum HBM traffic per (sequence row, event) for one EM round.

    Unlike decode (1-byte backpointers), the EM round materializes three
    full float32 (B, T, n) tensors — alpha, beta, em — because the
    M-steps re-read them outside the scans.  Counted: the three scan
    writes, plus one streamed read of each by the consumers XLA cannot
    fuse into the producing scan (bwd reads em; posterior/stats read
    alpha+beta; st_mstep re-reads all three — assume perfect fusion
    WITHIN each consumer pass, so each tensor is re-read once per
    consumer pass that needs it).  This is a lower bound on traffic and
    hence an upper bound on the bytes-roofline throughput.
    """
    f = 4 * n
    items = {
        "alpha_write": f, "beta_write": f, "em_write": f,
        "em_read_bwd": f,
        "alpha_read_post": f, "beta_read_post": f,
        "alpha_read_st": f, "beta_read_st": f, "em_read_st": f,
    }
    items["total"] = sum(items.values())
    return items


def em_fused_bwd_ops_per_event(n: int) -> dict:
    """Per (sequence row, event): the FUSED reverse scan
    (train._fused_bwd_mstats bwd_step) — beta recursion + recomputed
    emission + posterior + both M-steps' statistics.  The transition
    M-step block runs in LOG space, term-for-term like the reference
    (Parameter_Trainer.hpp:456-517) — the cheaper probability-space
    factorization was falsified by the trained fuzz (byte-FASTA flip at
    seed 11/r73)."""
    items = {
        "g_add": n,
        "max_g": n,
        "exp_shift": 2 * n,
        "rowsum4": 3 * (n // 4),
        "rowsum16": 15 * (n // 16),
        "total_mix": 11 * n,
        "cand": 2 * n,
        "boundary_select": n,
        # emission recomputed at t+1 (cheaper than reading a stored em)
        "emission": log_emission_ops(n),
        # exp_lp = exp(alpha + beta - lpd): 2 adds + exp
        "posterior": 3 * n,
        # scaling stats: post*w mul + six mul+sum reductions + scalars
        "scal_stats": 13 * n + 30,
        # st stats, log space: lp_j1 2n; lp_stay 4n; eg4 exp pass
        # 2n + 0.75n sum; lsum4 log(n/4) + add ~1.25n; lp_steps 3n;
        # logaddexp + min 5n; p_d2 (two exp, sub, max, log) 5n; three
        # step_lse (mask, max, sub, exp, sum) ~5n each = 15n
        "st_stats": 38 * n,
    }
    items["total"] = sum(items.values())
    return items


def em_fused_ops_per_event(n: int) -> dict:
    """Total elementwise lane-ops per (sequence row, event) for one FUSED EM
    round (the production default path since round 5)."""
    out = {
        "fwd": fwbw_grouped_fwd_ops_per_event(n)["total"],
        "bwd_fused": em_fused_bwd_ops_per_event(n)["total"],
    }
    out["total"] = sum(out.values())
    out["matmul_macs"] = 0  # the batched mat-vec was replaced by elementwise sums
    return out


def em_fused_hbm_bytes_per_event(n: int) -> dict:
    """HBM traffic per (sequence row, event) for one FUSED round: only
    the alphas are materialized (scan-natural layout, written by the
    forward scan, streamed by the reverse scan)."""
    f = 4 * n
    items = {"alpha_write": f, "alpha_read_bwd": f}
    items["total"] = sum(items.values())
    return items


# Published peaks keyed by jax.devices()[0].device_kind: dense rates, no
# sparsity, at the card's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops_per_s": 67e12,   # CUDA cores, outside the tensor cores
        "tf32_flops_per_s": 495e12,
        "bf16_flops_per_s": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column",
    },
}


def peak_for(device_kind: str) -> dict:
    """The PEAKS row of a device; an unknown device is an error, never a
    default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"add a row to roofline.PEAKS (known: {sorted(PEAKS)})"
        ) from None


def em_mfu_report(events_per_round_s: float, n: int, peak: dict,
                  fma_peak_ops_per_s: float | None = None,
                  fused: bool = True) -> dict:
    """Roofline verdict for a measured EM rate (event-rounds/s through
    train_one_round) on the device whose PEAKS row is `peak`: achieved
    lane ops/s and HBM bytes/s vs their ceilings, and which one binds.
    The compute ceiling is the measured FMA peak when given, else the
    published float32 peak.  fused=True (the production default path)
    uses the streaming-round models; fused=False the legacy
    materialize-then-reduce models (still used by --trans runs)."""
    ops = em_fused_ops_per_event(n) if fused else em_ops_per_event(n)
    bts = (em_fused_hbm_bytes_per_event(n) if fused
           else em_hbm_bytes_per_event(n))
    achieved_ops = events_per_round_s * ops["total"]
    achieved_bytes = events_per_round_s * bts["total"]
    peak_ops = fma_peak_ops_per_s or peak["fp32_flops_per_s"]
    hbm = peak["hbm_bytes_per_s"]
    out = {
        "ops_per_event_round": ops,
        "hbm_bytes_per_event_round": bts["total"],
        "achieved_ops_per_s": achieved_ops,
        "achieved_hbm_bytes_per_s": achieved_bytes,
        "mfu_vs_fma_peak": achieved_ops / peak_ops,
        "hbm_utilization_vs_spec": achieved_bytes / hbm,
        # ceiling event-rate implied by each resource: the binding one is
        # the smaller
        "ceiling_events_per_s_compute": peak_ops / ops["total"],
        "ceiling_events_per_s_hbm": hbm / bts["total"],
    }
    out["binding_resource"] = (
        "hbm" if out["ceiling_events_per_s_hbm"]
        < out["ceiling_events_per_s_compute"] else "compute"
    )
    return out


def measure_fma_peak(B: int, n: int, T: int, k: int = 24, n_iter: int = 4,
                     reduce_out: bool = False):
    """Measured elementwise speed-of-light at the recursion's own shape: a
    lax.scan of T steps, each a chain of k dependent FMAs over a (B, n)
    float32 carry — the same program structure (sequential scan over T,
    (B, n) elementwise body) as the Viterbi forward, with zero algorithmic
    content.  Returns achieved ops/s (= B*n*2k*T / time); the decode MFU
    against THIS number answers "how close is the kernel to the fastest
    possible scan-shaped elementwise program on this chip".

    k should be chosen so the chain's per-step op count (2k per lane)
    matches the kernel's per-step work (grouped_forward_ops_per_event /
    n / 2 ~= 24 at K=6) — a smaller body makes the scan
    iteration-latency-bound and measures step overhead, not arithmetic.

    XLA does not reassociate float FMA chains (not IEEE-safe), so the k
    multiply-adds cannot be algebraically collapsed.

    reduce_out=True returns jnp.sum(x) from the jitted chain (the sum
    depends on every element, so the chain cannot be elided).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    @functools.partial(jax.jit, static_argnames=("T", "k", "reduce_out"))
    def chain(x, c, d, T: int, k: int, reduce_out: bool):
        def step(x, _):
            for _ in range(k):
                x = x * c + d
            return x, None
        x, _ = jax.lax.scan(step, x, None, length=T)
        return jnp.sum(x) if reduce_out else x

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0.9, 1.1, (B, n)).astype(np.float32))
    c = jnp.asarray(np.float32(0.9999))
    d = jnp.asarray(np.float32(1e-4))
    jax.block_until_ready(chain(x, c, d, T, k, reduce_out))  # compile + warm
    t0 = time.perf_counter()
    outs = [chain(x, c, d, T, k, reduce_out) for _ in range(n_iter)]
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / n_iter
    return B * n * 2 * k * T / dt, dt


def mfu_report(B: int, T: int, n: int, decode_s: float, peak: dict,
               fma_peak_ops_per_s: float | None = None) -> dict:
    """MFU numbers for a measured full-decode time over a (B, T) batch on
    the device whose PEAKS row is `peak`."""
    ops = decode_ops_per_event(n)
    achieved = B * T * ops["total"] / decode_s
    out = {
        "ops_per_event_per_row": ops,
        "achieved_ops_per_s": achieved,
        "mfu_vs_fp32_spec": achieved / peak["fp32_flops_per_s"],
    }
    if fma_peak_ops_per_s:
        out["measured_fma_peak_ops_per_s"] = fma_peak_ops_per_s
        out["mfu_vs_measured_fma_peak"] = achieved / fma_peak_ops_per_s
    return out
