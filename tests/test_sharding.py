"""Multi-device data parallelism: sharded runs must equal single-device runs.

Runs on the conftest-forced 8-virtual-CPU-device mesh.
"""

import numpy as np
import jax
import pytest

from nanocall_tpu import events, kmer, transitions
from nanocall_tpu.ops import hmm
from nanocall_tpu.parallel.mesh import DataSharder, make_mesh, shard_train_inputs

K = 3
N = kmer.n_states(K)


def _decode_batch(B, T, rng):
    lm = rng.uniform(40, 90, N).astype(np.float32)
    model = hmm.make_model_arrays(
        np.tile(lm, (B, 1)),
        np.tile(rng.uniform(0.8, 2.0, N).astype(np.float32), (B, 1)),
        np.tile(rng.uniform(0.5, 1.5, N).astype(np.float32), (B, 1)),
        np.tile(rng.uniform(2.0, 9.0, N).astype(np.float32), (B, 1)),
    )
    stdv = rng.uniform(0.5, 1.5, (B, T)).astype(np.float32)
    ev = {
        "mean": rng.uniform(40, 90, (B, T)).astype(np.float32),
        "stdv": stdv,
        "log_stdv": np.log(stdv),
        "length": rng.integers(T // 2, T + 1, B).astype(np.int32),
    }
    return model, ev


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_decode_matches_single():
    rng = np.random.default_rng(0)
    B, T = 16, 64
    model, ev = _decode_batch(B, T, rng)
    gt = hmm.make_grouped_trans(transitions.TransitionParams(), K)
    ref = hmm.viterbi_decode_grouped(gt, model, ev)

    sharder = DataSharder(8)
    assert sharder.active
    gt_s, model_s, ev_s = sharder.shard((gt, model, ev), B)
    out = hmm.viterbi_decode_grouped(gt_s, model_s, ev_s)
    assert np.array_equal(np.asarray(ref["path"]), np.asarray(out["path"]))
    assert np.array_equal(np.asarray(ref["logp"]), np.asarray(out["logp"]))


def test_sharded_train_round_matches_single():
    from nanocall_tpu import train

    rng = np.random.default_rng(1)
    G, S, T = 8, 2, 24
    stdv = rng.uniform(0.5, 1.5, (G, S, T)).astype(np.float32)
    ev = {
        "mean": rng.uniform(40, 90, (G, S, T)).astype(np.float32),
        "stdv": stdv,
        "log_stdv": np.log(stdv),
        "start": np.cumsum(np.full((G, S, T), 0.02, np.float32), axis=-1),
        "length": np.full((G, S), T, np.int32),
        "strand": np.zeros((G, S), np.int32),
        "valid": np.ones((G, S), bool),
    }
    mdl = {
        "level_mean": np.tile(rng.uniform(40, 90, N).astype(np.float32), (G, 2, 1)),
        "level_stdv": np.tile(rng.uniform(0.8, 2, N).astype(np.float32), (G, 2, 1)),
        "sd_mean": np.tile(rng.uniform(0.5, 1.5, N).astype(np.float32), (G, 2, 1)),
        "sd_lambda": np.tile(rng.uniform(2, 9, N).astype(np.float32), (G, 2, 1)),
    }
    pm0 = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (G, 1))
    st0 = np.tile(np.array([0.1, 0.3], np.float32), (G, 2, 1))

    ref = train.train_one_round(ev, mdl, pm0, st0, K=K)
    sharder = DataSharder(8)
    ev_s = sharder.shard(ev, G)
    mdl_s = sharder.shard(mdl, G)
    out = train.train_one_round(ev_s, mdl_s, pm0, st0, K=K)
    for k in ("fit", "new_pm_params", "new_st_params"):
        assert np.allclose(
            np.asarray(ref[k]), np.asarray(out[k]), rtol=1e-5, atol=1e-6
        ), k


def test_data_sharder_places_whole_batches_round_robin():
    devs = jax.local_devices()
    sharder = DataSharder(4)
    assert [sharder.device(i) for i in range(6)] == devs[:4] + devs[:2]
    assert DataSharder(1).device(3) is None  # one device: JAX places it


@pytest.mark.parametrize("device_loop", [True, False])
def test_em_bucket_on_another_device_matches_default(device_loop):
    """run_em(device=d) runs the whole bucket on d, bit-identical to the
    default placement: the pipeline's multi-device EM puts each bucket on
    one device, never splitting it."""
    from nanocall_tpu import train

    rng = np.random.default_rng(5)
    G, S, T = 4, 2, 16
    stdv = rng.uniform(0.5, 1.5, (G, S, T)).astype(np.float32)
    ev = {
        "mean": rng.uniform(40, 90, (G, S, T)).astype(np.float32),
        "stdv": stdv,
        "log_stdv": np.log(stdv),
        "start": np.cumsum(np.full((G, S, T), 0.02, np.float32), axis=-1),
        "length": np.full((G, S), T, np.int32),
        "strand": np.zeros((G, S), np.int32),
        "valid": np.ones((G, S), bool),
    }
    mdl = {k: np.tile(rng.uniform(lo, hi, N).astype(np.float32), (G, 2, 1))
           for k, lo, hi in (("level_mean", 40, 90), ("level_stdv", 0.8, 2),
                             ("sd_mean", 0.5, 1.5), ("sd_lambda", 2, 9))}
    pm0 = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (G, 1))
    st0 = np.tile(np.array([0.1, 0.3], np.float32), (G, 2, 1))
    cfg = train.EMConfig(K=K, max_rounds=3)
    dev = jax.local_devices()[5]
    ref = train.run_em(ev, mdl, pm0, st0, cfg, device_loop=device_loop)
    out = train.run_em(ev, mdl, pm0, st0, cfg, device=dev,
                       device_loop=device_loop, fetch=not device_loop)
    if device_loop:
        assert out[0].devices() == {dev}
        out = train.fetch_em_result(out)
    for a, b in zip(ref, out):
        assert np.array_equal(a, b)


def test_2d_mesh_decode():
    """Decode with states sharded over a second 'model' axis still matches."""
    rng = np.random.default_rng(2)
    B, T = 8, 32
    model, ev = _decode_batch(B, T, rng)
    st = transitions.build_structured(K=K)
    ops = hmm.make_trans_ops(st)
    ref = hmm.viterbi_decode(ops, model, ev)

    from nanocall_tpu.parallel.mesh import shard_decode_inputs

    mesh = make_mesh(8, model_axis=2)
    ops_s, model_s, ev_s = shard_decode_inputs(mesh, ops, model, ev)
    out = hmm.viterbi_decode(ops_s, model_s, ev_s)
    assert np.array_equal(np.asarray(ref["path"]), np.asarray(out["path"]))


def test_2d_mesh_production_decode_matches_single():
    """The PRODUCTION fused decode program (basecall._decode_chunk_pooled:
    pool gather + drift + device-built grouped tables + scaled bank +
    compact traceback codes) runs on an (data, model) 2-D mesh — bank
    states sharded over 'model', batch over 'data' — and must be
    bit-identical to the single-device run.  This is the same program
    shape production dispatches per chunk (K=6, real r73 bank), not the
    21-slot fallback."""
    from nanocall_tpu import basecall
    from nanocall_tpu.models import load_builtin_models
    from nanocall_tpu.parallel.mesh import shard_pooled_decode_inputs

    rng = np.random.default_rng(3)
    B, T = 8, 48
    pm = load_builtin_models("r73")["r73.t.006"]
    pool_mean = rng.uniform(40.0, 90.0, (B, T)).astype(np.float32)
    pool_stdv = rng.uniform(0.5, 1.5, (B, T)).astype(np.float32)
    pool_start = np.cumsum(
        rng.uniform(0.01, 0.05, (B, T)).astype(np.float32), axis=-1
    )
    bank = {
        "level_mean": pm.level_mean[None].astype(np.float32),
        "level_stdv": pm.level_stdv[None].astype(np.float32),
        "sd_mean": pm.sd_mean[None].astype(np.float32),
        "sd_lambda": pm.sd_lambda[None].astype(np.float32),
    }
    pm_params = np.zeros((B, 6), np.float32)
    pm_params[:, [0, 3, 4, 5]] = 1.0
    pm_params[:, 1] = rng.uniform(-1, 1, B)
    stp = np.stack([rng.uniform(0.08, 0.12, B), rng.uniform(0.25, 0.35, B)],
                   axis=-1).astype(np.float32)
    lengths = rng.integers(T // 2, T + 1, B).astype(np.int32)
    args = (pool_mean, pool_stdv, pool_start, np.arange(B, dtype=np.int32),
            np.full(B, 0.01, np.float32), bank, np.zeros(B, np.int32),
            pm_params, stp, lengths)
    ref = jax.device_get(basecall._decode_chunk_pooled(*args, K=6,
                                                       with_path=True))

    mesh = make_mesh(8, model_axis=2)
    with mesh:
        s_args = shard_pooled_decode_inputs(mesh, *args)
        out = jax.device_get(basecall._decode_chunk_pooled(*s_args, K=6,
                                                           with_path=True))
    for k in ("logp", "path0", "codes"):
        assert np.array_equal(np.asarray(ref[k]), np.asarray(out[k])), k


def test_sharded_pipeline_equals_single(tmp_path):
    """Full pipeline with num_shards=8 must produce the same FASTA as the
    single-device run (reads are independent; data parallelism only)."""
    import numpy as np

    from nanocall_tpu import basecall, output, read_pipeline, simulate
    from nanocall_tpu.config import Config
    from nanocall_tpu.models import load_builtin_models

    models = load_builtin_models("r73")
    rng = np.random.default_rng(4)
    d = tmp_path / "reads"
    d.mkdir()
    for i in range(8):
        simulate.write_sim_fast5(
            d / f"r{i}.fast5", models, "r73.t.006", None, 250, rng,
            read_id=f"r{i}", noise_scale=0.5,
        )

    import io

    def run(num_shards):
        cfg = Config(pore="r73", train=False, num_shards=num_shards).apply_pore_preset()
        cfg.template_only = True
        files = read_pipeline.init_files([str(d)])
        summaries = [read_pipeline.summarize(f, models, cfg) for f in files]
        results = basecall.basecall_reads(summaries, models, cfg)
        buf = io.StringIO()
        output.write_results_fasta(buf, results)
        return buf.getvalue()

    assert run(1) == run(8)
