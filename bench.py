"""Benchmark: flagship training throughput on one GPU.

Config: BERT4Rec-Beauty scale — 4-layer/256-dim bf16 encoder, tied-softmax
head over a 54,542-item catalog (the measured Amazon Beauty vocabulary,
BASELINE.md), batch 256, max_len 50+3 — BASELINE.json configs[1] at the
real catalog size. Metric: steady-state examples/s of the jitted train step
(forward, full-catalog fused CE, backward, Adam) run as one ``lax.scan``
dispatch of STEPS steps over device-resident batches, timed to a value
fetch. Data and masking are generated on the host ahead of time.

Refuses to run without a GPU: a CPU number is not this metric. Prints one
JSON line naming the device it ran on.
"""

from __future__ import annotations

import json
import sys
import time

import jax

# dropout bits from the backend's rng_bit_generator rather than threefry
jax.config.update("jax_default_prng_impl", "rbg")
import jax.numpy as jnp
import numpy as np

from bert4clickpath.utils.compile_cache import enable as _enable_compile_cache

_enable_compile_cache()

from bert4clickpath import (  # noqa: E402
    ClickstreamModel,
    FeatureConfig,
    HeadConfig,
    ModelConfig,
    TrainConfig,
)
from bert4clickpath.data.cloze import stack_batches  # noqa: E402
from bert4clickpath.data.generator import ClickStreamGenerator  # noqa: E402
from bert4clickpath.data.pipeline import ClozeDataset  # noqa: E402
from bert4clickpath.parallel.spmd import padded_vocab_rows  # noqa: E402
from bert4clickpath.training import schedules  # noqa: E402
from bert4clickpath.training.train_state import (  # noqa: E402
    TrainState,
    make_optimizer,
    make_scan_train_step,
)

N_ITEMS = 54_542  # Amazon Beauty catalog (BASELINE.md)
BATCH = 256
MAX_ITEMS = 50
STEPS = 100
METRIC = "train_examples_per_s_flagship"


def flagship_config(vocab, max_items: int = MAX_ITEMS) -> ModelConfig:
    return ModelConfig(
        features={
            "items": FeatureConfig(padded_vocab_rows(vocab.model_vocab_size, 1), 256)
        },
        num_layers=4,
        num_heads=4,
        ffn_dim=1024,
        dropout_rate=0.1,
        max_len=max_items + 3,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size),
        dtype="bfloat16",
        qkv_fused=True,
    )


def build(n_items: int = N_ITEMS, batch: int = BATCH, steps: int = STEPS,
          max_items: int = MAX_ITEMS, seed: int = 0):
    """(scan_step, state, stacked batches, rng) for the flagship step."""
    gen = ClickStreamGenerator(n_items=n_items, session_cohesiveness=200, seed=seed)
    vocab = gen.item_vocab()
    cfg = flagship_config(vocab, max_items)
    model = ClickstreamModel(cfg)
    items, _ = gen.generate_sessions(batch * 4)
    ds = ClozeDataset(items, vocab, max_items=max_items)
    it = ds.train_batches(batch, seed=seed)
    host = [next(it) for _ in range(8)]
    stacked_np = stack_batches([host[i % len(host)] for i in range(steps)])
    stacked = {
        "features": {k: jnp.asarray(v) for k, v in stacked_np.features.items()},
        "head_positions": jnp.asarray(stacked_np.head_positions),
        "labels": jnp.asarray(stacked_np.labels),
    }
    params = model.init(
        jax.random.PRNGKey(seed),
        {k: v[0] for k, v in stacked["features"].items()},
        stacked["head_positions"][0],
    )
    # bf16 Adam first moment: halves the table-moment traffic
    tx = make_optimizer(TrainConfig(batch_size=batch), mu_dtype=jnp.bfloat16)
    state = TrainState.create(params, tx)
    scan_step = make_scan_train_step(
        model, tx, schedules.constant(1e-3),
        fused_ce_num_valid=vocab.label_vocab_size,
    )
    return scan_step, state, stacked, jax.random.PRNGKey(seed + 1)


def time_windows(scan_step, state, stacked, rng, windows: int = 2):
    """Compile+warm one dispatch, then time ``windows`` dispatches, each
    ending in a value fetch. Returns (state, [seconds per window], losses)."""
    state, losses = scan_step(state, stacked, rng)
    float(np.asarray(losses[-1]))
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        state, losses = scan_step(state, stacked, rng)
        float(np.asarray(losses[-1]))
        times.append(time.perf_counter() - t0)
    return state, times, np.asarray(losses)


def device_record() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print("bench.py measures the GPU and found none", file=sys.stderr)
        return 1
    scan_step, state, stacked, rng = build()
    _, times, losses = time_windows(scan_step, state, stacked, rng)
    dt = min(times)
    print(json.dumps({
        "metric": METRIC,
        "value": BATCH * STEPS / dt,
        "unit": "examples/s",
        "step_ms": 1e3 * dt / STEPS,
        "final_loss": float(losses[-1]),
        "device": device_record(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
