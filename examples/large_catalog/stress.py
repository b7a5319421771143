"""Large-catalog stress: row-sharded embedding tables at 10M items.

BASELINE.json configs[4]: synthetic 10M-item vocabulary, tables row-sharded
over the ``model`` mesh axis with psum-assembled lookups and vocab-parallel
CE (parallel/embedding.py) — the config where a dense head is impossible
(the (B, P, V) logits alone would be ~4 GB per batch; the full-catalog
softmax never materializes here).

Runs anywhere: on a pod slice it shards over real chips; on CPU use
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python examples/large_catalog/stress.py --items 1000000 --d_model 64

Prints per-shard memory, step time, and examples/s.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from bert4clickpath.utils.device import backend_dtype
from bert4clickpath import FeatureConfig, HeadConfig, MeshConfig, ModelConfig, TrainConfig
from bert4clickpath.constants import (
    CLS_ID,
    MASK_ID,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    SEP_ID,
)
from bert4clickpath.parallel import spmd
from bert4clickpath.parallel.mesh import make_mesh
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import TrainState, make_optimizer


def synthetic_batch(rng, batch, max_items, max_masked, n_items):
    """Uniform-random sessions directly in model space (the catalog is too
    big to enumerate host-side structures per item)."""
    length = max_items + 3
    tokens = np.full((batch, length), PAD_ID, np.int32)
    tokens[:, 0] = CLS_ID
    tokens[:, 1] = SEP_ID
    tokens[:, -1] = SEP_ID
    lens = rng.integers(5, max_items + 1, size=batch)
    positions = np.zeros((batch, max_masked), np.int32)
    labels = np.full((batch, max_masked), -1, np.int32)
    for i in range(batch):
        n = lens[i]
        items = rng.integers(0, n_items, size=n).astype(np.int32)
        tokens[i, 2 : 2 + n] = items + NUM_RESERVED_TOKENS
        n_masked = min(max_masked, max(1, int(0.4 * n)))
        picks = np.sort(rng.permutation(n)[:n_masked])
        labels[i, :n_masked] = items[picks]
        tokens[i, 2 + picks] = MASK_ID
        positions[i, :n_masked] = picks + 2
    return {
        "features": {"items": tokens},
        "head_positions": positions,
        "labels": labels,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--items", type=int, default=10_000_000)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--max_items", type=int, default=50)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--data_axis", type=int, default=0, help="0 = auto")
    p.add_argument("--model_axis", type=int, default=0, help="0 = auto")
    p.add_argument(
        "--sampled", type=int, default=0,
        help="train with S batch-shared sampled-softmax negatives instead "
        "of the full-catalog fused CE (O(N*S*D) loss; "
        "parallel.spmd.make_sampled_spmd_train_step)",
    )
    args = p.parse_args(argv)

    n_dev = len(jax.devices())
    model_axis = args.model_axis or min(4, n_dev)
    data_axis = args.data_axis or n_dev // model_axis
    mesh = make_mesh(MeshConfig(data=data_axis, model=model_axis))
    print(f"mesh: data={data_axis} model={model_axis} on {jax.devices()[0].platform}")

    rows = spmd.padded_vocab_rows(NUM_RESERVED_TOKENS + args.items + 1, model_axis)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, args.d_model)},
        num_layers=2,
        num_heads=4,
        ffn_dim=4 * args.d_model,
        max_len=args.max_items + 3,
        head=HeadConfig("tied_softmax", output_size=args.items),
        dtype=backend_dtype(),
    )
    table_gb = rows * args.d_model * 4 / 1e9
    print(
        f"catalog={args.items:,} table={table_gb:.2f} GB f32 "
        f"({table_gb / model_axis:.2f} GB/shard; x3 with Adam moments)"
    )
    dense_logits_gb = args.batch * 10 * args.items * 4 / 1e9
    print(f"dense (B,P,V) logits would be {dense_logits_gb:.1f} GB -> vocab-parallel CE instead")

    # init params without materializing the replicated table on one device:
    # build shard-by-shard via jax.jit with output shardings
    from jax.sharding import NamedSharding, PartitionSpec as P

    k0 = jax.random.PRNGKey(0)

    def init_table(key):
        return jax.random.normal(key, (rows, args.d_model), jnp.float32) * 0.02

    table_sharding = NamedSharding(mesh, P("model", None))
    table = jax.jit(init_table, out_shardings=table_sharding)(k0)

    # encoder params from a tiny throwaway init (replicated)
    from bert4clickpath.models.encoder import Encoder

    enc = spmd._encoder_module(cfg)
    dummy = jnp.zeros((2, cfg.max_len, cfg.d_model), jnp.float32)
    enc_params = enc.init(k0, dummy, None, True)["params"]
    params = {"embed_items": {"embedding": table}, "encoder": enc_params}

    tcfg = TrainConfig()
    tx = make_optimizer(tcfg)
    if args.sampled:
        # pjit tier wants the wrapped tree (the standard step applies it)
        from bert4clickpath.models.model import ClickstreamModel

        state = spmd.shard_state(
            TrainState.create({"params": params}, tx), mesh, cfg
        )
        step = spmd.make_sampled_spmd_train_step(
            ClickstreamModel(cfg), mesh, tx, schedules.constant(1e-3),
            args.items, args.sampled,
        )
        print(f"sampled softmax: S={args.sampled} negatives/step")
    else:
        state = spmd.shard_state(TrainState.create(params, tx), mesh, cfg)
        step = spmd.make_spmd_train_step(
            cfg, mesh, tx, schedules.constant(1e-3), args.items
        )

    rng = np.random.default_rng(0)
    batch = spmd.shard_batch(synthetic_batch(rng, args.batch, args.max_items, 10, args.items), mesh, cfg)
    key = jax.random.PRNGKey(1)
    state, loss = step(state, batch, key)  # compile
    print(f"first step loss={float(np.asarray(loss)):.4f} (expect ~ln(V)={np.log(args.items):.2f})")

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, batch, key)
    lv = float(np.asarray(loss))
    dt = (time.perf_counter() - t0) / args.steps
    print(
        f"steady: {dt * 1e3:.1f} ms/step -> {args.batch / dt:,.0f} examples/s "
        f"(loss {lv:.4f})"
    )


if __name__ == "__main__":
    main()
