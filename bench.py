"""Headline benchmark: vectorised env throughput on one GPU.

Measures env-steps/s of the 4,096-env rollout with the random joint
policy and full trajectory collection (BASELINE.json config 2), through
the rollout kernel (ops/fused_rollout.py).  Each launch is 2,600 steps,
one full 2,501-step timeout horizon; the value is the median of several
launches after a warm-up, each timed to ``block_until_ready``.  The
reference runs one serial Python env with two quadprog QP solves and a
shapely polygon test per step -- order 1e3 env-steps/s on a CPU at best
(BASELINE.md "implied throughput"); that 1e3 upper bound is the
``vs_baseline`` denominator.

Runs on JAX's default backend in this one process and exits non-zero
unless that backend is a GPU.  Prints ONE JSON line: {"metric", "value",
"unit", "vs_baseline", "device"}.
"""

import json
import statistics
import sys
import time

NUM_ENVS = 4096
STEPS = 2600
REPS = 5
REFERENCE_STEPS_PER_SEC = 1e3  # BASELINE.md: implied 1e2-1e3 on CPU


def main() -> int:
    import jax

    from merging_gym_tpu.ops.fused_rollout import fused_rollout
    from merging_gym_tpu.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX's default backend is "
              f"{dev.platform}", file=sys.stderr)
        return 1

    def run(seed):
        return jax.block_until_ready(fused_rollout(STEPS, NUM_ENVS,
                                                   seed=seed))

    run(0)                                       # compile + warm up
    rates = []
    for seed in range(1, REPS + 1):
        t0 = time.perf_counter()
        run(seed)
        rates.append(NUM_ENVS * STEPS / (time.perf_counter() - t0))
    value = statistics.median(rates)
    print(json.dumps({
        "metric": f"env_steps_per_sec_{NUM_ENVS}envs_trajectory",
        "value": value,
        "unit": "env-steps/s",
        "vs_baseline": value / REFERENCE_STEPS_PER_SEC,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
