"""Long-context bench: per-head XLA attention against cuDNN flash attention.

At the Beauty flagship shape (L=53) attention is a small share of the step.
Sessions of hundreds to thousands of events are where it grows: the
per-head path materializes each head's (B, L, L) scores in device memory
every layer, forward and backward, while cuDNN's fused kernel keeps them on
chip with an online softmax.

Reference anchor: the reference caps sessions at 50 events
(examples/BERT4Rec/data_prep/main.py:58) and computes dense O(L^2) attention
(transformer.py:83-95); long sessions are new capability, not a port.

The step is the same for both; only the attention it is traced with
differs (``models/encoder.forced_attention``).

Usage (``cudnn`` needs the GPU; ``--impls xla`` runs anywhere):
  python examples/long_context/bench.py --seq_len 512 --batch 32
  python examples/long_context/bench.py --seq_len 1024 --batch 16 --impls cudnn
Prints one ms/step line per attention impl.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_default_prng_impl", "rbg")
import jax.numpy as jnp
from bert4clickpath.utils.device import backend_dtype
from bert4clickpath.utils.compile_cache import enable as _enable_compile_cache

_enable_compile_cache()

import numpy as np

from bert4clickpath import FeatureConfig, HeadConfig, ModelConfig, TrainConfig
from bert4clickpath.models import encoder
from bert4clickpath.models.model import ClickstreamModel
from bert4clickpath.parallel.spmd import padded_vocab_rows
from bert4clickpath.training import schedules
from bert4clickpath.training.train_state import (
    TrainState,
    make_optimizer,
    make_train_step,
)

from examples.large_catalog.stress import synthetic_batch


ATTENTION = {"xla": encoder.attention_per_head, "cudnn": encoder.attention_cudnn}


def run_one(cfg, batch_np, steps, num_valid):
    model = ClickstreamModel(cfg)
    batch = {
        "features": {k: jnp.asarray(v) for k, v in batch_np["features"].items()},
        "head_positions": jnp.asarray(batch_np["head_positions"]),
        "labels": jnp.asarray(batch_np["labels"]),
    }
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        batch["features"],
        batch["head_positions"],
    )
    tcfg = TrainConfig(batch_size=batch["labels"].shape[0])
    tx = make_optimizer(tcfg)
    state = TrainState.create(params, tx)
    step = make_train_step(
        model, tx, schedules.constant(1e-3), fused_ce_num_valid=num_valid
    )
    rng = jax.random.PRNGKey(1)
    state, loss = step(state, batch, rng)  # compile
    float(np.asarray(loss))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch, rng)
    lv = float(np.asarray(loss))  # the value fetch waits for the device
    dt = (time.perf_counter() - t0) / steps
    return dt, lv


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq_len", type=int, default=512, help="L incl. [CLS]/[SEP]s")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--items", type=int, default=20_000)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument(
        "--impls", default="xla,cudnn",
        help="comma list of attention impls to time: xla (per head), cudnn",
    )
    args = p.parse_args(argv)

    max_items = args.seq_len - 3  # [CLS] [SEP] ... [SEP]
    rows = padded_vocab_rows(args.items + 11, 1)
    cfg = ModelConfig(
        features={"items": FeatureConfig(rows, args.d_model)},
        num_layers=args.layers,
        num_heads=args.heads,
        ffn_dim=4 * args.d_model,
        dropout_rate=args.dropout,
        max_len=args.seq_len,
        positional="learned",
        head=HeadConfig("tied_softmax", output_size=args.items),
        dtype=backend_dtype(),
    )
    impls = args.impls.split(",")
    unknown = set(impls) - set(ATTENTION)
    if unknown:
        sys.exit(f"unknown attention impls {sorted(unknown)}; expected {sorted(ATTENTION)}")
    if "cudnn" in impls and jax.default_backend() != "gpu":
        sys.exit("cudnn attention needs the GPU; run --impls xla here")
    scores_mb = (
        args.batch * args.heads * args.seq_len * args.seq_len * 2 / 1e6
    )
    print(
        f"L={args.seq_len} B={args.batch} H={args.heads}: dense (B,H,L,L) "
        f"scores = {scores_mb:.0f} MB bf16 per materialization "
        f"(x{args.layers} layers, fwd+bwd) on the per-head path"
    )

    rng = np.random.default_rng(0)
    batch_np = synthetic_batch(rng, args.batch, max_items, 10, args.items)

    results = {}
    for attn in impls:
        with encoder.forced_attention(ATTENTION[attn]):
            dt, lv = run_one(cfg, batch_np, args.steps, args.items)
        results[attn] = dt
        print(
            f"attn={attn:7s}: {dt * 1e3:8.2f} ms/step "
            f"{args.batch / dt:10,.0f} examples/s (loss {lv:.3f})"
        )
    if "xla" in results and "cudnn" in results:
        speedup = results["xla"] / results["cudnn"]
        print(f"cuDNN attention speedup at L={args.seq_len}: {speedup:.2f}x")

if __name__ == "__main__":
    main()
