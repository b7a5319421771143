"""Scaling benchmark: examples/s across mesh shapes (1 device / 1 host / N hosts).

Runs the SPMD train step over every requested mesh shape and reports
examples/s plus scaling efficiency vs the smallest shape. On several GPUs
this measures real scaling over their interconnect; on one device or a
virtual CPU mesh it validates the mechanics only.

  python benchmarks/scaling.py --meshes 1x1,2x1,4x1,4x2 --items 54542

Multi-process mode (the N-host rehearsal without a pod — each process owns
``--devices_per_proc`` virtual CPU devices, ``jax.distributed`` forms the
cluster, each host feeds its own batch shard via
``make_array_from_process_local_data``):

  python benchmarks/scaling.py --procs 2 --meshes 4x2 --items 1000
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_mesh(data_axis, model_axis, args, gen, vocab):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bert4clickpath import FeatureConfig, HeadConfig, MeshConfig, ModelConfig, TrainConfig
    from bert4clickpath.data.pipeline import ClozeDataset
    from bert4clickpath.parallel import spmd
    from bert4clickpath.parallel.mesh import make_mesh
    from bert4clickpath.training import schedules
    from bert4clickpath.training.train_state import TrainState, make_optimizer
    from bert4clickpath.utils.device import backend_dtype

    n_procs = jax.process_count()
    mesh = make_mesh(
        MeshConfig(data=data_axis, model=model_axis),
        devices=(
            None  # multi-process collectives need every global device enrolled
            if n_procs > 1
            else jax.devices()[: data_axis * model_axis]
        ),
    )
    rows = spmd.padded_vocab_rows(vocab.model_vocab_size, model_axis)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, args.d_model)},
        num_layers=args.layers,
        num_heads=4,
        ffn_dim=4 * args.d_model,
        max_len=args.max_items + 3,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size),
        dtype=backend_dtype(),
    )
    from bert4clickpath.models.model import ClickstreamModel

    model = ClickstreamModel(cfg)
    per_device_batch = args.per_device_batch
    batch = per_device_batch * data_axis
    # each host generates and feeds only ITS slice of the global batch
    local_rows = batch // n_procs
    items, _ = gen.generate_sessions(local_rows * 2)
    ds = ClozeDataset(items, vocab, max_items=args.max_items)
    b = next(ds.train_batches(local_rows, seed=jax.process_index()))
    local_batch = {
        "features": {k: jnp.asarray(v) for k, v in b.features.items()},
        "head_positions": jnp.asarray(b.head_positions),
        "labels": jnp.asarray(b.labels),
    }
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        local_batch["features"],
        local_batch["head_positions"],
    )["params"]
    tcfg = TrainConfig()
    tx = make_optimizer(tcfg)
    if getattr(args, "tier", "spmd") == "tp":
        # tensor-parallel tier (parallel/tp.py): encoder kernels shard over
        # 'model' via XLA auto-partitioning; dense loss, replicated table
        from bert4clickpath.parallel import tp

        state = tp.shard_tp_state(
            TrainState.create({"params": params}, tx), mesh, cfg
        )
        step = tp.make_tp_train_step(model, tx, schedules.constant(1e-3), mesh)
    elif getattr(args, "tier", "spmd") == "tp_spmd":
        # composed tier (parallel/tp_spmd.py): Megatron-sharded encoder AND
        # vocab-sharded table + fused CE in one shard_map program
        from bert4clickpath.parallel import tp_spmd

        state = tp_spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
        step = tp_spmd.make_tp_spmd_train_step(
            cfg, mesh, tx, schedules.constant(1e-3), vocab.label_vocab_size
        )
    else:
        state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
        step = spmd.make_spmd_train_step(
            cfg, mesh, tx, schedules.constant(1e-3), vocab.label_vocab_size
        )
    if n_procs > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sb = jax.tree.map(
            lambda x, s: jax.make_array_from_process_local_data(
                NamedSharding(mesh, s), np.asarray(x)
            ),
            local_batch,
            spmd.batch_specs(cfg),
            is_leaf=lambda x: isinstance(x, P),
        )
    else:
        sb = spmd.shard_batch(local_batch, mesh, cfg)
    rng = jax.random.PRNGKey(1)
    for _ in range(max(1, args.warmup)):  # >=1: 'loss' must exist for the sync
        state, loss = step(state, sb, rng)
    float(np.asarray(loss))
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, sb, rng)
    float(np.asarray(loss))
    dt = (time.perf_counter() - t0) / args.steps
    return {
        "mesh": f"{data_axis}x{model_axis}",
        "devices": data_axis * model_axis,
        "global_batch": batch,
        "ms_per_step": round(dt * 1e3, 3),
        "examples_per_s": round(batch / dt, 1),
    }


def run_shapes(args):
    import jax

    from bert4clickpath.data.generator import ClickStreamGenerator

    gen = ClickStreamGenerator(n_items=args.items, session_cohesiveness=200, seed=0)
    vocab = gen.item_vocab()
    if args.meshes:
        shapes = [tuple(map(int, m.split("x"))) for m in args.meshes.split(",")]
    else:
        shapes = [(len(jax.devices()), 1)]
    results = [run_mesh(d, m, args, gen, vocab) for d, m in shapes]
    base = results[0]
    for r in results:
        ideal = base["examples_per_s"] * r["devices"] / base["devices"]
        r["scaling_efficiency"] = round(r["examples_per_s"] / ideal, 3)
        r["processes"] = jax.process_count()
        if jax.process_index() == 0:
            print(json.dumps(r), flush=True)


def worker(args):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices_per_proc}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.procs,
        process_id=args.worker,
    )
    run_shapes(args)
    jax.distributed.shutdown()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--meshes", default="", help="e.g. 1x1,2x1,4x2 (default: all devices DP)")
    p.add_argument("--tier", default="spmd", choices=["spmd", "tp", "tp_spmd"], help="spmd: shard_map + vocab-sharded fused CE; tp: pjit tensor-parallel encoder; tp_spmd: composed (sharded encoder + sharded catalog)")
    p.add_argument("--items", type=int, default=54_542)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--per_device_batch", type=int, default=256)
    p.add_argument("--max_items", type=int, default=50)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--procs", type=int, default=1, help=">1: multi-process CPU cluster")
    p.add_argument("--devices_per_proc", type=int, default=4)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--worker", type=int, default=-1, help="internal")
    args = p.parse_args()

    if args.worker >= 0:
        worker(args)
        return
    if args.procs > 1:
        port = args.port or (12400 + os.getpid() % 1000)
        env = dict(os.environ, PYTHONPATH="")
        procs = [
            subprocess.Popen(
                [sys.executable, __file__, *sys.argv[1:],
                 "--port", str(port), "--worker", str(i)],
                env=env,
            )
            for i in range(args.procs)
        ]
        codes = [q.wait() for q in procs]
        if any(codes):
            raise SystemExit(f"worker exit codes: {codes}")
        return
    run_shapes(args)


if __name__ == "__main__":
    main()
