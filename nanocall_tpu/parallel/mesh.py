"""Device-mesh data parallelism for batched decoding and training.

The reference parallelizes with a thread pool over reads
(pfor, nanocall.cpp:282,611).  Here the batch axis (reads / training
groups / decode tasks) shards over the 'data' axis of a JAX device mesh,
and the 4096-state axis can shard over a second 'model' axis (XLA/GSPMD
inserts the collectives; the structured-transition kernels are pure
reshape/elementwise ops, so resharding is mechanical).  EM sufficient
statistics reduce per-group — no cross-device reductions are required for
correctness, matching SURVEY.md section 2.10.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class DataSharder:
    """Shards batch-leading arrays over a 1D 'data' mesh of local devices.

    Used by the pipeline when more than one device is visible (the
    single-host multi-chip case; batch elements are independent reads, so
    this is pure data parallelism with no collectives — the device analogue of
    the reference's thread pool over reads).  Decode chunks split over the
    mesh (`shard`); EM buckets go whole to one device each (`device`).
    """

    def __init__(self, n_devices: int | None = None):
        # LOCAL devices: each host decodes its own file partition
        # (multihost.partition_files), so the data mesh must only contain
        # devices this process can address — jax.devices() would return
        # every host's chips after jax.distributed.initialize and the
        # first device_put onto a remote chip would raise
        devs = jax.local_devices()
        n = n_devices if n_devices else len(devs)
        self.n = max(1, min(n, len(devs)))
        self.devices = devs[: self.n]
        if self.n > 1:
            self.mesh = Mesh(np.array(devs[: self.n]), ("data",))
            self.spec = NamedSharding(self.mesh, P("data"))
            self.repl = NamedSharding(self.mesh, P())
        else:
            self.mesh = None

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def shard(self, tree, batch_size: int):
        """device_put arrays whose leading dim equals batch_size over
        'data'; replicate everything else."""
        if not self.active:
            return tree

        def put(x):
            if np.ndim(x) >= 1 and np.shape(x)[0] == batch_size:
                return jax.device_put(x, self.spec)
            return jax.device_put(x, self.repl)

        return jax.tree_util.tree_map(put, tree)

    def device(self, i: int):
        """Device of the i-th whole-batch dispatch, round-robin over the
        mesh; None when there is one device (leave placement to JAX)."""
        return self.devices[i % self.n] if self.active else None


def make_mesh(n_devices: int | None = None, model_axis: int = 1) -> Mesh:
    """Build an (data, model) mesh over the first n_devices devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    model = model_axis if n % model_axis == 0 else 1
    data = n // model
    grid = np.array(devs).reshape(data, model)
    return Mesh(grid, ("data", "model"))


def shard_decode_inputs(mesh: Mesh, ops, model, ev):
    """Place decode inputs on the mesh: batch over 'data', states over
    'model'."""
    dp = NamedSharding(mesh, P("data"))
    dp_state = NamedSharding(mesh, P("data", "model"))
    dp_tbl = NamedSharding(mesh, P("data", None, "model"))
    repl_tbl = NamedSharding(mesh, P(None, "model"))

    def put(x, s):
        return jax.device_put(x, s)

    import dataclasses

    ev = {
        k: put(v, dp if np.ndim(v) >= 1 else NamedSharding(mesh, P()))
        for k, v in ev.items()
    }
    model = type(model)(*(put(a, dp_state if a.ndim == 2 else
                              NamedSharding(mesh, P("model"))) for a in model))
    tbl_sh = dp_tbl if ops.from_logp.ndim == 3 else repl_tbl
    ops = dataclasses.replace(
        ops,
        from_logp=put(ops.from_logp, tbl_sh),
        to_logp=put(ops.to_logp, tbl_sh),
    )
    return ops, model, ev


def shard_pooled_decode_inputs(mesh: Mesh, pool_mean, pool_stdv, pool_start,
                               idx, drifts, bank, model_idx, pm_params, stp,
                               lengths):
    """Place the PRODUCTION fused decode program's inputs
    (basecall._decode_chunk_pooled: event-pool gather + device-built grouped
    tables + device-scaled model bank + grouped Viterbi w/ compact codes) on
    an (data, model) mesh: every batch-leading array shards over 'data', the
    model bank's 4096-state axis over 'model' (GSPMD propagates the state
    sharding through scale_arrays -> emissions -> the grouped recursion's
    reshape views and inserts the collectives).  Returns the argument tuple
    in _decode_chunk_pooled order."""
    dp = NamedSharding(mesh, P("data"))
    bank_sh = NamedSharding(mesh, P(None, "model"))
    put = jax.device_put
    return (
        put(pool_mean, dp), put(pool_stdv, dp), put(pool_start, dp),
        put(idx, dp), put(drifts, dp),
        {k: put(v, bank_sh) for k, v in bank.items()},
        put(model_idx, dp), put(pm_params, dp), put(stp, dp),
        put(lengths, dp),
    )


def shard_train_inputs(mesh: Mesh, ev, models, pm_params, st_params):
    """Place training-batch inputs: groups over 'data', states over 'model'."""
    def dp(*spec):
        return NamedSharding(mesh, P(*spec))

    ev = {k: jax.device_put(v, dp("data")) for k, v in ev.items()}
    models = {
        k: jax.device_put(v, dp("data", None, "model")) for k, v in models.items()
    }
    pm_params = jax.device_put(pm_params, dp("data"))
    st_params = jax.device_put(st_params, dp("data"))
    return ev, models, pm_params, st_params
