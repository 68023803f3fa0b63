"""Reward-tuple sweep study: N full DQN trainings in ONE jitted program.

The reference explored reward shaping by hand: edit the constants at
merging_env.py:27-32, retrain for 2,000 episodes, and encode the tuple
in the checkpoint dir name -- its `test_params/dqn/` tree contains runs
for (2.0, 1.0, -10, 0.001) and (2.0, 1.0, -100, 0.001).  Each such
point cost a full serial training run.

Here the reward parameters are PyTree leaves of ``EnvParams``
(core/env.py), so the whole grid trains simultaneously as one vmap axis
(parallel/sweep.py): eight independent trainings -- distinct nets,
replays, env batches and PRNG streams -- in a single XLA program on one
chip.  After training, each entry's greedy policy is evaluated against
the L0 opponent under its own reward tuple.

The grid covers the reference's two hand-swept collision penalties plus
principled extensions along each axis of the tuple
(r_first, r_second, r_collision, vel_penalty):

  * collision-penalty axis: -3 / -10 / -30 / -100
  * velocity-shaping axis:  0.0 / 0.001 / 0.01
  * incentive-gap axis:     r_first 2.0 vs 4.0; r_second 1.0 vs 2.0

Writes docs/parity/reward_sweep.json.  Run on the accelerator:

    python benchmarks/reward_sweep.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

OUT = os.path.join(os.path.dirname(__file__), "..", "docs", "parity",
                   "reward_sweep.json")

# label -> (r_first, r_second, r_collision, vel_penalty)
GRID = [
    ("reference(2,1,-10,0.001)", (2.0, 1.0, -10.0, 0.001)),
    ("reference(2,1,-100,0.001)", (2.0, 1.0, -100.0, 0.001)),
    ("collision-3", (2.0, 1.0, -3.0, 0.001)),
    ("collision-30", (2.0, 1.0, -30.0, 0.001)),
    ("noshaping", (2.0, 1.0, -10.0, 0.0)),
    ("strongshaping", (2.0, 1.0, -10.0, 0.01)),
    ("first4", (4.0, 1.0, -10.0, 0.001)),
    ("second2", (2.0, 2.0, -10.0, 0.001)),
]


def run(num_envs: int, chunks: int, chunk_steps: int, seed: int,
        eval_episodes: int) -> dict:
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.agents.evaluate import evaluate
    from merging_gym_tpu.agents.policies import l0_policy, q_policy
    from merging_gym_tpu.core.env import EnvParams
    from merging_gym_tpu.nn.mlp import qnet_apply
    from merging_gym_tpu.parallel import sweep

    param_list = [EnvParams(r_first=a, r_second=b, r_collision=c,
                            vel_penalty=d) for _, (a, b, c, d) in GRID]
    stacked = sweep.stack_env_params(param_list)
    cfg = D.DQNConfig(memory_capacity=4 * num_envs, opponent=D.OPP_L0)

    t0 = time.time()
    carries = sweep.sweep_train_init(jax.random.key(seed), cfg, stacked,
                                     num_envs)
    history = []  # per chunk: stacked cumulative counters
    for _ in range(chunks):
        carries = sweep.sweep_train_chunk(cfg, stacked, carries, chunk_steps)
        m = carries.metrics
        history.append({
            "env_steps": [int(x) for x in m.env_steps],
            "episodes": [int(x) for x in m.episodes],
            "collisions": [int(x) for x in m.collisions],
            "wins": [int(x) for x in m.wins],
            "sum_ep_reward": [float(x) for x in m.sum_ep_reward],
        })
    train_wall = time.time() - t0
    total_steps = sum(history[-1]["env_steps"])
    print(f"trained {len(GRID)} configs x {num_envs} envs in "
          f"{train_wall:.1f}s ({total_steps / train_wall / 1e6:.1f}M "
          f"env-steps/s aggregate)", flush=True)

    results = {}
    t0 = time.time()
    for i, (label, tup) in enumerate(GRID):
        params_i = jax.tree.map(lambda x: x[i], carries.dqn.params)
        stats = evaluate(q_policy(qnet_apply, params_i, greedy=True),
                         l0_policy(), param_list[i],
                         jax.random.key(seed + 1000 + i),
                         min_episodes=eval_episodes)
        windows = []
        prev = None
        for h in history:
            if prev is not None and h["episodes"][i] > prev["episodes"][i]:
                d_ep = h["episodes"][i] - prev["episodes"][i]
                windows.append({
                    "env_steps": h["env_steps"][i],
                    "collision_rate": (h["collisions"][i]
                                       - prev["collisions"][i]) / d_ep,
                    "win_rate": (h["wins"][i] - prev["wins"][i]) / d_ep,
                    "mean_ep_reward": (h["sum_ep_reward"][i]
                                       - prev["sum_ep_reward"][i]) / d_ep,
                })
            prev = h
        results[label] = {
            "reward_tuple": list(tup),
            "train_episodes": history[-1]["episodes"][i],
            "train_windows": windows,
            "eval_vs_L0": stats,
        }
        print(f"{label}: {history[-1]['episodes'][i]} train episodes, "
              f"eval vs L0 -> {stats}", flush=True)
    eval_wall = time.time() - t0
    return {"config": {"num_envs": num_envs, "chunks": chunks,
                       "chunk_steps": chunk_steps, "seed": seed,
                       "grid_size": len(GRID),
                       "train_wall_s": round(train_wall, 1),
                       "eval_wall_s": round(eval_wall, 1),
                       "aggregate_train_steps_per_s":
                           round(total_steps / train_wall)},
            "results": results}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    q = args.quick
    out = run(num_envs=64 if q else 512,
              chunks=3 if q else 24,
              chunk_steps=100 if q else 250,
              seed=args.seed,
              eval_episodes=64 if q else 1024)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
