"""Replay-machinery ablations: what PER and n-step returns buy.

The reference defines a PrioritizedReplayBuffer but never instantiates
it (ranbowdqn.py:326-437 vs :647 -- main() uses the uniform buffer), and
has no n-step machinery at all.  This framework implements both as
first-class on-device components (ops/per.py, ops/nstep.py); this study
quantifies their effect on the reference's own Rainbow task so the
capability is evidenced, not just implemented.

Grid: {uniform, PER} x {1-step, 3-step} Rainbow self-play, the DQN
replay-sampling quirk ablation (faithful sample-with-replacement over
the full capacity incl. stale slots, main.py:130, vs valid-only
sampling), and the HDQN meta-transition quirk ablation (faithful: the
meta stores the final state twice, hdqn.py:320/325, vs textbook
(start_obs, goal, return, end_obs) transitions).  Each config runs
SEEDS seeds; per-window deltas of the episode counters give learning
trajectories.

Writes docs/parity/ablations.json.  Run on the accelerator:

    python benchmarks/ablations.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

OUT = os.path.join(os.path.dirname(__file__), "..", "docs", "parity",
                   "ablations.json")


def _window_rates(history):
    """Per-window rates from cumulative counters."""
    rows = []
    prev = None
    for h in history:
        if prev is not None:
            d_ep = h["episodes"] - prev["episodes"]
            if d_ep > 0:
                rows.append({
                    "env_steps": h["env_steps"],
                    "collision_rate": (h["collisions"] - prev["collisions"]) / d_ep,
                    "win_rate": (h["wins"] - prev["wins"]) / d_ep,
                    "mean_ep_reward": (h["sum_ep_reward"] - prev["sum_ep_reward"]) / d_ep,
                    "loss": h["loss"],
                })
        prev = h
    return rows


def run_rainbow(per: bool, n_step: int, seed: int, num_envs: int,
                chunks: int, chunk_steps: int):
    from merging_gym_tpu.agents import rainbow as R
    from merging_gym_tpu.core.env import EnvParams

    cfg = R.RainbowConfig(memory_capacity=8 * num_envs, per=per,
                          n_step=n_step)
    env_params = EnvParams()
    carry = R.rainbow_train_init(jax.random.key(seed), cfg, env_params,
                                 num_envs)
    history = []
    for i in range(chunks):
        carry = R.rainbow_train_chunk(cfg, env_params, carry, chunk_steps)
        m = carry.metrics
        history.append({
            "env_steps": int(m.env_steps), "episodes": int(m.episodes),
            "collisions": int(m.collisions), "wins": int(m.wins),
            "sum_ep_reward": float(m.sum_ep_reward),
            "loss": float(carry.last_loss),
        })
    return history


def run_dqn(sample_valid: bool, seed: int, num_envs: int, chunks: int,
            chunk_steps: int):
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.core.env import EnvParams

    cfg = D.DQNConfig(memory_capacity=4 * num_envs, opponent=D.OPP_L0,
                      sample_valid=sample_valid)
    env_params = EnvParams()
    carry = D.train_init(jax.random.key(seed), cfg, env_params, num_envs)
    history = []
    for i in range(chunks):
        carry = D.train_chunk(cfg, env_params, carry, chunk_steps)
        m = carry.metrics
        history.append({
            "env_steps": int(m.env_steps), "episodes": int(m.episodes),
            "collisions": int(m.collisions), "wins": int(m.wins),
            "sum_ep_reward": float(m.sum_ep_reward),
            "loss": float(carry.dqn.last_loss),
        })
    return history


def run_hdqn(faithful_meta: bool, seed: int, num_envs: int, chunks: int,
             chunk_steps: int):
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.agents import hdqn as H
    from merging_gym_tpu.core.env import EnvParams

    cfg = H.HDQNConfig(memory_capacity=4 * num_envs, opponent=D.OPP_L0,
                       faithful_meta=faithful_meta)
    env_params = EnvParams()
    carry = H.hdqn_init(jax.random.key(seed), cfg, env_params, num_envs)
    history = []
    for i in range(chunks):
        carry = H.hdqn_train_chunk(cfg, env_params, carry, chunk_steps)
        m = carry.metrics
        history.append({
            "env_steps": int(m.env_steps), "episodes": int(m.episodes),
            "collisions": int(m.collisions), "wins": int(m.wins),
            "sum_ep_reward": float(m.sum_ep_reward),
            "loss": float(carry.lower.last_loss),
        })
    return history


def _sweep(section, variants, runner, seeds, results):
    for name, kwargs in variants:
        runs = []
        for seed in range(seeds):
            t0 = time.time()
            h = runner(seed=seed, **kwargs)
            runs.append({"seed": seed, "windows": _window_rates(h),
                         "final": h[-1],
                         "wall_s": round(time.time() - t0, 1)})
            print(f"{section} {name} seed {seed}: "
                  f"{h[-1]['episodes']} episodes, {runs[-1]['wall_s']}s",
                  flush=True)
        results[section][name] = runs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--only", choices=["rainbow", "dqn_sampling", "hdqn_meta"],
                    default=None, help="run one section, merge into the JSON")
    args = ap.parse_args()
    q = args.quick
    num_envs = 256 if q else 512
    chunks = 4 if q else 24
    chunk_steps = 100 if q else 250
    dims = dict(num_envs=num_envs, chunks=chunks, chunk_steps=chunk_steps)

    results = {"config": {**dims, "seeds": args.seeds},
               "rainbow": {}, "dqn_sampling": {}, "hdqn_meta": {}}
    if args.only and os.path.exists(OUT):
        with open(OUT) as f:
            prev = json.load(f)
        for k, v in prev.items():
            if k != "config" and k != args.only and k in results:
                results[k] = v

    if args.only in (None, "rainbow"):
        # Self-play episodes drift toward the 2,501-step timeout, so this
        # section runs 3x longer for enough finished episodes per window.
        rdims = {**dims, "chunks": 3 * dims["chunks"]}
        _sweep("rainbow",
               [(f"{'per' if per else 'uniform'}-{n}step",
                 dict(per=per, n_step=n, **rdims))
                for per in (False, True) for n in (1, 3)],
               run_rainbow, args.seeds, results)
    if args.only in (None, "dqn_sampling"):
        _sweep("dqn_sampling",
               [("faithful_with_replacement", dict(sample_valid=False, **dims)),
                ("valid_only", dict(sample_valid=True, **dims))],
               run_dqn, args.seeds, results)
    if args.only in (None, "hdqn_meta"):
        _sweep("hdqn_meta",
               [("faithful", dict(faithful_meta=True, **dims)),
                ("textbook", dict(faithful_meta=False, **dims))],
               run_hdqn, args.seeds, results)

    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
