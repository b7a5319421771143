"""Host input-pipeline throughput: numpy vs native (C++/OpenMP) Cloze batcher.

The host batch builder must produce well above the train step's
examples/s at the flagship config (bench.py) or it becomes the pipeline
bottleneck the moment prefetch depth is exhausted. This bench
measures both backends at flagship shapes, pure host time (no device).

  python benchmarks/input_pipeline_bench.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sequences", type=int, default=40_226)  # Beauty users
    p.add_argument("--items", type=int, default=54_542)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--max_items", type=int, default=50)
    p.add_argument("--batches", type=int, default=200)
    args = p.parse_args()

    from bert4clickpath.data import native
    from bert4clickpath.data.generator import ClickStreamGenerator
    from bert4clickpath.data.pipeline import ClozeDataset

    gen = ClickStreamGenerator(
        n_items=args.items, session_cohesiveness=200, seed=0
    )
    items, _ = gen.generate_sessions(args.sequences)
    vocab = gen.item_vocab()

    backends = ["numpy"] + (["native"] if native.available() else [])
    for backend in backends:
        ds = ClozeDataset(
            items, vocab, max_items=args.max_items, backend=backend
        )
        it = ds.train_batches(args.batch, seed=0)
        next(it)  # warm (native: compile + load the .so)
        t0 = time.perf_counter()
        for _ in range(args.batches):
            next(it)
        dt = time.perf_counter() - t0
        print(
            json.dumps(
                {
                    "backend": backend,
                    "batch": args.batch,
                    "max_items": args.max_items,
                    "examples_per_s": round(args.batch * args.batches / dt, 1),
                    "ms_per_batch": round(dt / args.batches * 1e3, 3),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
