"""Serving latency/throughput bench for ServingModel.recommend.

Measures the full serving path — host string→id encoding, fixed-shape token
build, jitted single-[MASK] forward + chunked catalog top-k (no (B, P, V)
logits, training/serving.py) — at several client batch sizes.

  python benchmarks/serving_bench.py                 # synthetic flagship-size export
  python benchmarks/serving_bench.py --export_dir /root/runs/r2_mlp256m6/export

Prints one JSON line per batch size: p50/p95 latency (ms) and sessions/s.
The reference's serving story was a SavedModel string-in signature
(clickstream_transformer.py:354-375) with dense full-vocab logits; this
path serves the same contract at catalogs where dense logits cannot exist.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bert4clickpath.utils.device import backend_dtype
from bert4clickpath.utils.compile_cache import enable as _enable_compile_cache

_enable_compile_cache()


def synthetic_export(n_items: int, d_model: int, layers: int, head: str) -> str:
    import jax

    from bert4clickpath import (
        ClickstreamModel,
        FeatureConfig,
        HeadConfig,
        ModelConfig,
    )
    from bert4clickpath.data.generator import ClickStreamGenerator
    from bert4clickpath.training.checkpoint import export_serving

    gen = ClickStreamGenerator(n_items=n_items, seed=0)
    vocab = gen.item_vocab()
    head_cfg = (
        HeadConfig("tied_softmax", output_size=vocab.label_vocab_size)
        if head == "tied_softmax"
        # the reference's MLP head shape (main.py:262) at flagship trunk
        else HeadConfig("softmax", (1024, 512, 256, 128), vocab.label_vocab_size)
    )
    cfg = ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, d_model)},
        num_layers=layers,
        num_heads=4,
        ffn_dim=4 * d_model,
        max_len=53,
        head=head_cfg,
        dtype=backend_dtype(),
    )
    model = ClickstreamModel(cfg)
    import jax.numpy as jnp

    feats = {"items": jnp.zeros((1, 53), jnp.int32)}
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, feats, jnp.zeros((1, 1), jnp.int32)
    )
    out = os.path.join(tempfile.mkdtemp(prefix="serving_bench_"), "export")
    return export_serving(out, jax.device_get(params), cfg, {"items": vocab})


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--export_dir", default="")
    p.add_argument("--items", type=int, default=54_542)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--head", default="softmax", choices=["softmax", "tied_softmax"])
    p.add_argument("--batch_sizes", default="1,8,64")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--session_len", type=int, default=20)
    args = p.parse_args()

    from bert4clickpath.training.serving import ServingModel

    export_dir = args.export_dir or synthetic_export(
        args.items, args.d_model, args.layers, args.head
    )
    served = ServingModel(export_dir)
    names = list(served.vocabs[served._item_feature].tokens)
    rng = np.random.default_rng(0)

    for bs in map(int, args.batch_sizes.split(",")):
        sessions = [
            [names[i] for i in rng.integers(0, len(names), size=args.session_len)]
            for _ in range(bs)
        ]
        t0 = time.perf_counter()
        served.recommend(sessions, k=args.k)  # cold: XLA compile + run
        cold_ms = (time.perf_counter() - t0) * 1e3
        lat = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            served.recommend(sessions, k=args.k)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.array(lat)
        print(
            json.dumps(
                {
                    "batch": bs,
                    "k": args.k,
                    "p50_ms": round(float(np.percentile(lat, 50)), 2),
                    "p95_ms": round(float(np.percentile(lat, 95)), 2),
                    "cold_ms": round(cold_ms, 1),
                    "sessions_per_s": round(bs / (np.percentile(lat, 50) / 1e3), 1),
                    "catalog": args.items if not args.export_dir else "export",
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
