"""Per-kernel device-time profile of the flagship train step on the GPU.

Runs bench.py's flagship step (4L/256d bf16 tied-softmax over the
Beauty-sized catalog, ``--steps`` steps in one scan dispatch) under
``jax.profiler``, walks the trace's xplane.pb with utils/xplane, and prints
per-kernel device ms/step, the device plane's busy share of the traced
window, and the analytic roofline against the card's published peaks.
Fails when the trace holds no GPU device plane: a host wall-clock figure is
not a device time.

Usage (on the GPU):
  python benchmarks/profile_step.py --steps 50
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import bench  # noqa: E402  (sets the PRNG impl and the compile cache)
import jax  # noqa: E402

from bert4clickpath.utils import profiling  # noqa: E402
from bert4clickpath.utils import xplane  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--logdir", default="runs/profile_step")
    p.add_argument("--top", type=int, default=30)
    args = p.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("profile_step.py profiles the GPU and found none", file=sys.stderr)
        return 1

    scan_step, state, stacked, rng = bench.build(steps=args.steps)
    state, _, _ = bench.time_windows(scan_step, state, stacked, rng, windows=1)

    t0 = time.perf_counter()
    with profiling.trace(args.logdir):
        state, losses = scan_step(state, stacked, rng)
        float(np.asarray(losses[-1]))
    wall = time.perf_counter() - t0

    with open(xplane.latest_xplane_pb(args.logdir), "rb") as f:
        data = f.read()
    print("planes (events per line):")
    for plane, lines in xplane.plane_inventory(data).items():
        print(f"  {plane}: {lines}")
    totals = xplane.plane_kernel_totals(data)
    if not totals:
        print("no GPU device plane in the trace", file=sys.stderr)
        return 1
    device_ms = sum(totals.values()) / 1e9 / args.steps
    print(f"\ndevice: {bench.device_record()}")
    print(
        f"wall: {wall * 1e3 / args.steps:.3f} ms/step   "
        f"device kernels: {device_ms:.3f} ms/step   "
        f"busy share of the window: {device_ms * args.steps / (wall * 1e3):.3f}"
    )
    print(f"{'device ms/step':>14s}  kernel")
    for name, ps in sorted(totals.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{ps / 1e9 / args.steps:14.4f}  {name[:100]}")

    cfg = bench.flagship_config(bench.ClickStreamGenerator(
        n_items=bench.N_ITEMS, session_cohesiveness=200, seed=0).item_vocab())
    cost = profiling.step_cost(cfg, bench.BATCH, cfg.head.output_size)
    peak = profiling.peaks(jax.devices()[0].device_kind)
    print("\nroofline vs device kernel time:",
          profiling.speed_of_light(cost, device_ms / 1e3, peak))
    return 0


if __name__ == "__main__":
    sys.exit(main())
