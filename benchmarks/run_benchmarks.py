"""Benchmark suite: one JSON line per benchmark (bench.py runs only the
headline).  Each timing ends with a host readback of a scalar derived
from the computation's outputs, so the clock stops after the device has
finished.  Every line names the device it ran on.

Covers the BASELINE.json configs that fit on one device:

  rollout-<n>      vectorized env throughput at n envs, random policies
  fused-rollout-<n>        the rollout as one Pallas kernel (Triton route,
                           counter-based random policy)
  dqn-train        fused actor+replay+learner throughput (config 3)
  hdqn-train       hierarchical two-net trainer (config 4, 1-device slice)
  rainbow-train    Rainbow with PER + 3-step (config 5, 1-device slice)
  drqn-train       recurrent DQN trainer
  native-serial    C++ host core serial env-steps/s (reference-analogous path)
  oracle-serial    pure-Python float64 oracle (what the reference's stack costs
                   with the QP/GEOS replaced by closed forms)

Usage: python benchmarks/run_benchmarks.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Runnable as `python benchmarks/run_benchmarks.py` without installing:
# python puts the script's dir (benchmarks/) on sys.path, not the repo root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from merging_gym_tpu.utils import compile_cache


def _report(name, value, unit, **extra):
    dev = jax.devices()[0]
    print(json.dumps({"metric": name, "value": round(value, 1),
                      "unit": unit, "platform": dev.platform,
                      "device_kind": dev.device_kind,
                      "device_count": jax.device_count(), **extra}),
          flush=True)


def bench_rollout(num_envs, steps, chunks, collect="full"):
    from merging_gym_tpu.core import constants as C
    from merging_gym_tpu.core.env import EnvParams
    from merging_gym_tpu.core.vector import reset_batch, rollout

    params = EnvParams()
    state = reset_batch(params, jax.random.key(0), num_envs)

    def policy(ps, obs, key):
        return ps, jax.random.randint(key, (obs.shape[0], 2), -1, C.NUM_ACTIONS)

    def sync(state, traj):
        if collect == "full":
            return float(jnp.sum(traj.rewards))
        if collect == "rewards":
            return float(jnp.sum(traj[0]))
        return float(jnp.sum(state.pos))

    run = jax.jit(lambda s, k: rollout(params, s, policy, None, k, steps,
                                       collect=collect))
    (state, _), traj = run(state, jax.random.key(1))
    sync(state, traj)
    t0 = time.perf_counter()
    for i in range(chunks):
        (state, _), traj = run(state, jax.random.key(2 + i))
        sync(state, traj)
    dt = time.perf_counter() - t0
    _report(f"rollout-{num_envs}-{collect}", num_envs * steps * chunks / dt,
            "env-steps/s")


def bench_fused_rollout(num_envs, steps, chunks):
    from merging_gym_tpu.ops.fused_rollout import fused_rollout

    out = fused_rollout(steps, num_envs, seed=0)
    float(jnp.sum(out["rewards"]))
    t0 = time.perf_counter()
    for i in range(chunks):
        out = fused_rollout(steps, num_envs, seed=1 + i)
        float(jnp.sum(out["rewards"]))
    dt = time.perf_counter() - t0
    _report(f"fused-rollout-{num_envs}", num_envs * steps * chunks / dt,
            "env-steps/s")


def bench_dqn(num_envs, steps, chunks):
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.core.env import EnvParams

    cfg = D.DQNConfig(memory_capacity=4 * num_envs, opponent=D.OPP_SELFPLAY)
    env_params = EnvParams()
    carry = D.train_init(jax.random.key(0), cfg, env_params, num_envs)
    carry = D.train_chunk(cfg, env_params, carry, steps)
    float(jnp.sum(carry.dqn.params["fc2"]["b"]))
    t0 = time.perf_counter()
    for _ in range(chunks):
        carry = D.train_chunk(cfg, env_params, carry, steps)
        float(jnp.sum(carry.dqn.params["fc2"]["b"]))
    dt = time.perf_counter() - t0
    _report("dqn-train", num_envs * steps * chunks / dt, "env-steps/s",
            learns_per_sec=round(steps * chunks / dt, 1))


def bench_hdqn(num_envs, steps, chunks):
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.agents import hdqn as H
    from merging_gym_tpu.core.env import EnvParams

    cfg = H.HDQNConfig(memory_capacity=4 * num_envs, opponent=D.OPP_SELFPLAY)
    env_params = EnvParams()
    carry = H.hdqn_init(jax.random.key(0), cfg, env_params, num_envs)
    carry = H.hdqn_train_chunk(cfg, env_params, carry, steps)
    float(jnp.sum(carry.lower.params["fc2"]["b"]))
    t0 = time.perf_counter()
    for _ in range(chunks):
        carry = H.hdqn_train_chunk(cfg, env_params, carry, steps)
        float(jnp.sum(carry.lower.params["fc2"]["b"]))
    dt = time.perf_counter() - t0
    _report("hdqn-train", num_envs * steps * chunks / dt, "env-steps/s")


def bench_drqn(num_envs, steps, chunks):
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.agents import drqn as DR
    from merging_gym_tpu.core.env import EnvParams

    cfg = DR.DRQNConfig(memory_capacity=max(512, num_envs),
                        opponent=D.OPP_SELFPLAY)
    env_params = EnvParams()
    carry = DR.drqn_train_init(jax.random.key(0), cfg, env_params, num_envs)
    carry = DR.drqn_train_chunk(cfg, env_params, carry, steps)
    float(jnp.sum(carry.params["fc4"]["b"]))
    t0 = time.perf_counter()
    for _ in range(chunks):
        carry = DR.drqn_train_chunk(cfg, env_params, carry, steps)
        float(jnp.sum(carry.params["fc4"]["b"]))
    dt = time.perf_counter() - t0
    _report("drqn-train", num_envs * steps * chunks / dt, "env-steps/s")


def bench_rainbow(num_envs, steps, chunks):
    from merging_gym_tpu.agents import rainbow as R
    from merging_gym_tpu.core.env import EnvParams

    cfg = R.RainbowConfig(memory_capacity=4 * num_envs, per=True, n_step=3)
    env_params = EnvParams()
    carry = R.rainbow_train_init(jax.random.key(0), cfg, env_params, num_envs)
    carry = R.rainbow_train_chunk(cfg, env_params, carry, steps)
    float(jnp.sum(carry.params["linear1"]["b"]))
    t0 = time.perf_counter()
    for _ in range(chunks):
        carry = R.rainbow_train_chunk(cfg, env_params, carry, steps)
        float(jnp.sum(carry.params["linear1"]["b"]))
    dt = time.perf_counter() - t0
    _report("rainbow-train", num_envs * steps * chunks / dt, "env-steps/s")


def bench_native_serial(steps):
    from merging_gym_tpu.core import native

    if not native.available():
        return
    rng = np.random.default_rng(0)
    a1 = rng.integers(0, 5, size=steps).astype(np.int32)
    a2 = rng.integers(0, 5, size=steps).astype(np.int32)
    env = native.NativeMergeEnv(1)
    done_total = 0
    t0 = time.perf_counter()
    remaining = steps
    while remaining > 0:
        env.reset()
        n, _, _ = env.rollout(a1[:remaining], a2[:remaining])
        remaining -= n
        done_total += n
    dt = time.perf_counter() - t0
    _report("native-serial", done_total / dt, "env-steps/s")


def bench_oracle_serial(steps):
    from merging_gym_tpu.core.oracle import OracleMergeEnv

    rng = np.random.default_rng(0)
    env = OracleMergeEnv()
    t0 = time.perf_counter()
    done_count = 0
    for _ in range(steps):
        _, _, done, _ = env.step(int(rng.integers(0, 5)), int(rng.integers(0, 5)))
        done_count += 1
        if done:
            env.reset()
    dt = time.perf_counter() - t0
    _report("oracle-serial", done_count / dt, "env-steps/s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    q = args.quick
    compile_cache.enable()

    for n in ([1024] if q else [256, 1024, 4096, 16384]):
        bench_rollout(n, 256 if q else 1024, 2 if q else 4)
    for collect in ("rewards", "none"):
        bench_rollout(1024 if q else 4096, 256 if q else 1024,
                      2 if q else 4, collect)
    for n, t in ([(4096, 1024)] if q else [(4096, 2600), (65536, 2600)]):
        bench_fused_rollout(n, t, 2 if q else 3)
    bench_dqn(256 if q else 1024, 100 if q else 200, 2 if q else 5)
    bench_hdqn(256 if q else 1024, 100 if q else 200, 2 if q else 5)
    bench_drqn(256 if q else 1024, 100 if q else 200, 2 if q else 5)
    bench_rainbow(256 if q else 1024, 100 if q else 200, 2 if q else 5)
    bench_native_serial(20000 if q else 200000)
    bench_oracle_serial(5000 if q else 20000)


if __name__ == "__main__":
    main()
