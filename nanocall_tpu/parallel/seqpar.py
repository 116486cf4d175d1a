"""Sequence-parallel Viterbi decode over a device mesh.

The reference caps reads at 100k events and materializes the full DP
matrix on one node (Fast5_Summary.hpp:510-524, nanocall.cpp:65; the
backpointer tensor is the decode path's HBM ceiling — see CLAUDE.md's
decode-program HBM anatomy).  Here the EVENT (time) axis of one batch of reads
is partitioned contiguously over a mesh axis: each device scans only its
T/D-event slice and materializes only its (T/D, B, n) backpointer slice,
so the per-device HBM requirement drops by the mesh factor — reads D
times longer (or batches D times wider) fit without host offload.

The max-plus recurrence is sequential in time, so the (B, n) alpha carry
is handed device-to-device with a single ppermute per step.  To keep all
devices busy the batch is split into M blocks and the work is
software-pipelined (GPipe-style over the time-chunk "stages"): at
microstep m, device d scans batch block m-d, so after a D-1-step fill the
devices run concurrently at M/(M+D-1) efficiency.  The traceback runs the
same pipeline in reverse (carry = decoded state, handed right-to-left).

Exactness: the per-chunk kernels (ops.hmm.viterbi_forward_grouped_chunk /
viterbi_traceback_grouped_chunk) run the identical op sequence as the
single-device kernels via the shared _grouped_step_core, so the sharded
decode is BIT-IDENTICAL to viterbi_decode_grouped — pinned by
tests/test_seqpar.py on an 8-way CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import hmm


def viterbi_decode_seqpar(gt, model, ev: dict, mesh: Mesh,
                          axis: str = "data", n_blocks: int | None = None,
                          fwd_unroll: int = 2, tb_unroll: int = 8):
    """Decode a (B, T) event batch with T sharded over mesh axis `axis`.

    ev: {mean, stdv, log_stdv: (B, T) f32; length: (B,) int32 global
    lengths}.  T must divide evenly by the mesh axis size D, and the batch
    B by n_blocks (default: min(B, D) pipeline blocks).

    Returns {"path": (B, T) uint16, "logp": (B,) f32}, bit-identical to
    hmm.viterbi_decode_grouped(gt, model, ev).
    """
    D = mesh.shape[axis]
    B, T = ev["mean"].shape
    n = model.level_mean.shape[-1]
    if T % D:
        raise ValueError(f"T={T} not divisible by mesh axis {axis}={D}")
    if n_blocks is None:
        # deepest pipeline that divides B, capped at D (more blocks than
        # devices only adds microsteps without filling more stages)
        n_blocks = max(m for m in range(1, min(B, D) + 1) if B % m == 0)
    M = n_blocks
    if B % M:
        raise ValueError(f"B={B} not divisible by n_blocks={M}")
    b = B // M

    seq = P(None, axis)   # (B, T) arrays: shard the time axis
    rep = P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(seq, seq, seq, rep, rep, rep),
        out_specs=(P(axis, None), rep),
        check_vma=False,
    )
    def run(mean, stdv, log_stdv, lengths, gt_, model_):
        rank = lax.axis_index(axis)
        Tl = mean.shape[1]
        t0 = rank * Tl

        # ---- forward: carry alpha rides left-to-right -------------------
        def fwd_micro(m, state):
            carry, bps_buf, finals = state
            j = m - rank
            valid = (j >= 0) & (j < M)
            row = jnp.clip(j, 0, M - 1) * b
            evb = {
                "mean": lax.dynamic_slice(mean, (row, 0), (b, Tl)),
                "stdv": lax.dynamic_slice(stdv, (row, 0), (b, Tl)),
                "log_stdv": lax.dynamic_slice(log_stdv, (row, 0), (b, Tl)),
                "length": lax.dynamic_slice(lengths, (row,), (b,)),
            }
            out_alpha, bps_blk = hmm.viterbi_forward_grouped_chunk(
                gt_, model_, evb, carry, t0, unroll=fwd_unroll)
            cur = lax.dynamic_slice(bps_buf, (0, row, 0), (Tl, b, n))
            bps_buf = lax.dynamic_update_slice(
                bps_buf, jnp.where(valid, bps_blk, cur), (0, row, 0))
            curf = lax.dynamic_slice(finals, (row, 0), (b, n))
            keep = valid & (rank == D - 1)
            finals = lax.dynamic_update_slice(
                finals, jnp.where(keep, out_alpha, curf), (row, 0))
            carry = lax.ppermute(
                out_alpha, axis, [(i, i + 1) for i in range(D - 1)])
            return carry, bps_buf, finals

        state = (
            jnp.zeros((b, n), jnp.float32),
            jnp.zeros((Tl, B, n), jnp.uint8),
            jnp.zeros((B, n), jnp.float32),
        )
        _, bps_buf, finals = lax.fori_loop(0, M + D - 1, fwd_micro, state)

        # final alphas live on the last rank only; zeros elsewhere make the
        # psum a broadcast (B*n floats — negligible next to the bp slices)
        finals = lax.psum(finals, axis)
        end_state = jnp.argmax(finals, axis=-1).astype(jnp.int32)
        logp = jnp.max(finals, axis=-1)

        # ---- traceback: carry state rides right-to-left -----------------
        def tb_micro(m, state):
            carry, states_buf = state
            j = m - (D - 1 - rank)
            valid = (j >= 0) & (j < M)
            row = jnp.clip(j, 0, M - 1) * b
            bps_blk = lax.dynamic_slice(bps_buf, (0, row, 0), (Tl, b, n))
            end_b = lax.dynamic_slice(end_state, (row,), (b,))
            len_b = lax.dynamic_slice(lengths, (row,), (b,))
            carry_in = jnp.where(rank == D - 1, end_b, carry)
            carry_out, states = hmm.viterbi_traceback_grouped_chunk(
                gt_, end_b, carry_in, bps_blk, t0, len_b, unroll=tb_unroll)
            cur = lax.dynamic_slice(states_buf, (0, row), (Tl, b))
            states_buf = lax.dynamic_update_slice(
                states_buf, jnp.where(valid, states, cur), (0, row))
            carry = lax.ppermute(
                carry_out, axis, [(i + 1, i) for i in range(D - 1)])
            return carry, states_buf

        state = (jnp.zeros((b,), jnp.int32), jnp.zeros((Tl, B), jnp.uint16))
        _, states_buf = lax.fori_loop(0, M + D - 1, tb_micro, state)
        return states_buf, logp

    # place the time-sharded inputs explicitly so shard_map's implicit
    # resharding never copies the big arrays through one device
    sh = NamedSharding(mesh, seq)
    rl = NamedSharding(mesh, rep)
    states, logp = run(
        jax.device_put(ev["mean"], sh), jax.device_put(ev["stdv"], sh),
        jax.device_put(ev["log_stdv"], sh),
        jax.device_put(jnp.asarray(ev["length"], jnp.int32), rl),
        jax.device_put(gt, rl), jax.device_put(model, rl),
    )
    return {"path": jnp.moveaxis(states, 0, 1), "logp": logp}
