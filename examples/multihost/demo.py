"""Multi-host SPMD demo: N processes, one mesh, sharded training.

Validates the multi-host story without a pod: every process owns some
devices (here: virtual CPU devices), ``jax.distributed.initialize`` forms
the cluster, the (data, model) mesh spans all processes, each host feeds its
own slice of the input (data/pipeline.py process striding), and the SPMD
train step's psums ride the cross-process transport.

Run (2 processes on one machine):
  python examples/multihost/demo.py --procs 2
It re-execs itself once per process and checks all hosts agree on the loss.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, REPO)


def worker(process_id: int, num_processes: int, port: int):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    import jax.numpy as jnp
    import numpy as np

    from bert4clickpath import (
        ClickstreamModel,
        FeatureConfig,
        HeadConfig,
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from bert4clickpath.data.generator import ClickStreamGenerator
    from bert4clickpath.data.pipeline import ClozeDataset
    from bert4clickpath.parallel import spmd
    from bert4clickpath.parallel.mesh import make_mesh
    from bert4clickpath.training import schedules
    from bert4clickpath.training.train_state import TrainState, make_optimizer

    n_dev = len(jax.devices())
    assert n_dev == 4 * num_processes, (n_dev, num_processes)
    mesh = make_mesh(MeshConfig(data=num_processes * 2, model=2))

    gen = ClickStreamGenerator(n_items=40, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    # each host holds only ITS slice of the data
    ds = ClozeDataset(
        items, vocab, max_items=20,
        process_index=process_id, process_count=num_processes,
    )
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, 2, kernel_tile=32)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, 16)},
        num_layers=1,
        num_heads=2,
        ffn_dim=32,
        max_len=23,
        dropout_rate=0.0,
        head=HeadConfig("tied_softmax"),
    )
    model = ClickstreamModel(cfg)
    per_host_batch = 16 // num_processes * 2  # global batch 32 over data=4

    # build the GLOBAL batch from per-host shards via make_array_from_process_local_data
    from jax.sharding import NamedSharding, PartitionSpec as P

    def global_batch(local):
        def put(x, spec):
            return jax.make_array_from_process_local_data(
                NamedSharding(mesh, spec), np.asarray(x)
            )

        return {
            "features": {
                k: put(v, P("data", None)) for k, v in local.features.items()
            },
            "head_positions": put(local.head_positions, P("data", None)),
            "labels": put(local.labels, P("data", None)),
        }

    it = ds.train_batches(per_host_batch, seed=process_id + 1)
    b0 = next(it)
    # init on host data, replicate
    feats0 = {k: jnp.asarray(v) for k, v in b0.features.items()}
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, feats0, jnp.asarray(b0.head_positions)
    )["params"]
    tcfg = TrainConfig()
    tx = make_optimizer(tcfg)
    state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
    step = spmd.make_spmd_train_step(
        cfg, mesh, tx, schedules.constant(1e-2), vocab.label_vocab_size
    )
    losses = []
    for i in range(5):
        batch = global_batch(next(it) if i else b0)
        state, loss = step(state, batch, jax.random.PRNGKey(7))
        losses.append(float(np.asarray(loss)))
    print(
        f"[proc {process_id}] losses: {[round(l, 4) for l in losses]}",
        flush=True,
    )
    assert losses[-1] < losses[0], "did not learn"
    jax.distributed.shutdown()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--worker", type=int, default=-1)
    args = p.parse_args()
    port = args.port or (12300 + os.getpid() % 1000)
    if args.worker >= 0:
        worker(args.worker, args.procs, args.port)
        return
    procs = []
    env = dict(os.environ, PYTHONPATH="")
    for i in range(args.procs):
        procs.append(
            subprocess.Popen(
                [sys.executable, __file__, "--procs", str(args.procs),
                 "--port", str(port), "--worker", str(i)],
                env=env,
            )
        )
    codes = [q.wait() for q in procs]
    assert all(c == 0 for c in codes), codes
    print("multihost demo OK")


if __name__ == "__main__":
    main()
