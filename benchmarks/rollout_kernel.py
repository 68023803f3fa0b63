"""Tile sweep of the rollout kernel against the plain XLA rollout.

For each env count and output mode, times the kernel
(ops/fused_rollout.py) at every (block_envs, num_warps) pair of the grid
below and the XLA rollout that draws the same seed-mode actions, over one
full timeout horizon.  Prints one JSON line per measurement, naming the
device; the pair with the best rate across cells is the kernel's default
(``BLOCK_ENVS``, ``NUM_WARPS``).

Usage (needs a GPU): python benchmarks/rollout_kernel.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from merging_gym_tpu.ops import fused_rollout as FR
from merging_gym_tpu.utils import compile_cache

STEPS = 2600
ENVS = (4096, 65536)
TILES = ((32, 1), (64, 1), (64, 2), (128, 1), (128, 2), (128, 4))
REPS = 5


def median_rate(fn, work):
    jax.block_until_ready(fn(0))
    rates = []
    for r in range(1, REPS + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r))
        rates.append(work / (time.perf_counter() - t0))
    return statistics.median(rates)


def main():
    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    tag = {"device_kind": dev.device_kind, "steps": STEPS}
    for n in ENVS:
        for mode, kernel, xla in (
                ("trajectory", FR.fused_rollout, FR.reference_rollout),
                ("counters", FR.fused_rollout_counters,
                 FR.reference_rollout_counters)):
            rate = median_rate(lambda s: xla(STEPS, n, seed=s), n * STEPS)
            print(json.dumps({"impl": "xla", "mode": mode, "envs": n,
                              "env_steps_per_s": rate, **tag}), flush=True)
            for block, warps in TILES:
                rate = median_rate(
                    lambda s: kernel(STEPS, n, seed=s, block_envs=block,
                                     num_warps=warps), n * STEPS)
                print(json.dumps({"impl": "kernel", "mode": mode, "envs": n,
                                  "block_envs": block, "num_warps": warps,
                                  "env_steps_per_s": rate, **tag}),
                      flush=True)


if __name__ == "__main__":
    main()
