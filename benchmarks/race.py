"""Race the implementations the flagship train step can be traced with.

Builds bench.py's flagship step (4L/256d bf16, tied softmax over the
Beauty-sized catalog, B=256, 100 steps per scan dispatch) once per
implementation and times it:

* ``ce`` — the fused CE's Triton kernels against its plain XLA scan
  (``ops/fused_ce.forced_impl``), at L=53;
* ``attention`` — cuDNN flash attention against the per-head XLA path
  (``models/encoder.forced_attention``), at L=53 and at L=512 (10 steps
  per dispatch there).

Each pair runs in the order A B B A; each run prints the ms/step of
``--windows`` timed dispatches after a compiling one. The card's name and
power limit come first: compare numbers only within one run.

Usage (on the GPU):
  python benchmarks/race.py
  python benchmarks/race.py --only attention --windows 5
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402  (sets the PRNG impl and the compile cache)
import jax  # noqa: E402

from bert4clickpath.models import encoder  # noqa: E402
from bert4clickpath.ops import fused_ce  # noqa: E402
from bert4clickpath.utils.device import card_line  # noqa: E402

ATTENTION = {"per_head": encoder.attention_per_head, "cudnn": encoder.attention_cudnn}


def time_step(forced, windows: int, max_items: int = bench.MAX_ITEMS,
              steps: int = bench.STEPS) -> dict:
    """ms/step of each timed window of the flagship step traced under
    ``forced`` (a context manager choosing an implementation)."""
    t0 = time.perf_counter()
    with forced:
        scan_step, state, stacked, rng = bench.build(max_items=max_items, steps=steps)
        _, times, losses = bench.time_windows(scan_step, state, stacked, rng, windows)
    return {
        "ms": [1e3 * t / steps for t in times],
        "loss": float(losses[-1]),
        "wall_s": time.perf_counter() - t0,
    }


def race(name: str, impls: dict, windows: int, max_items: int = bench.MAX_ITEMS,
         steps: int = bench.STEPS) -> None:
    a, b = impls
    for impl in (a, b, b, a):
        rec = time_step(impls[impl](), windows, max_items, steps)
        print(json.dumps({"race": name, "impl": impl, "L": max_items + 3, "steps": steps, **rec}),
              flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", choices=["ce", "attention"])
    p.add_argument("--windows", type=int, default=3)
    args = p.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("race.py times the GPU and found none", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    if args.only in (None, "ce"):
        race("ce", {
            "triton": lambda: fused_ce.forced_impl("triton"),
            "xla": lambda: fused_ce.forced_impl("xla"),
        }, args.windows)
    if args.only in (None, "attention"):
        impls = {n: (lambda fn=fn: encoder.forced_attention(fn)) for n, fn in ATTENTION.items()}
        race("attention", impls, args.windows)
        race("attention", impls, args.windows, max_items=509, steps=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
