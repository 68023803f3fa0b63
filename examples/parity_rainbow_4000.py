"""Faithful single-env Rainbow at the reference's FULL 4,000-episode
scale (ranbowdqn.py:651), multiple seeds in one program.

Same faithful configuration as examples/parity_rainbow.py (ONE env,
self-play with the roll-3 slice bug, uniform 10,000 ring, batch 32,
Adam 1e-3, hard sync every 20 episodes, support-weighted projection, no
epsilon) -- but the seeds are vmapped: each lane of the vmap IS an
independent single-env faithful trainer (the per-seed program is
unchanged; vmap just batches the independent trainers onto the chip),
which turns 3 serial ~4 h runs into one ~wall-clock run.

Writes per-chunk aggregate curves to <out>/progress.jsonl as it goes
(the run is long; partial progress is still a result) and final
per-seed rates to <out>/final.json once every seed has finished
>= --episodes episodes.

    python examples/parity_rainbow_4000.py --seeds 3 --episodes 4000 \
        --out docs/parity/rainbow_4000
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/parity/rainbow_4000")
    ap.add_argument("--episodes", type=int, default=4000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--chunk-steps", type=int, default=2500)
    ap.add_argument("--max-hours", type=float, default=4.0,
                    help="wall budget; writes whatever has accumulated")
    args = ap.parse_args()

    from merging_gym_tpu.agents import rainbow as R
    from merging_gym_tpu.core.env import EnvParams

    cfg = R.RainbowConfig(  # ranbowdqn.py:645-652 + the :669 slice bug
        batch_size=32, lr=1e-3, gamma=0.99, memory_capacity=10000,
        target_sync_episodes=20, opponent_roll=3, faithful_c51=True,
        opponent="selfplay", obs_scale=None, epsilon=None)
    env_params = EnvParams()

    keys = jnp.stack([jax.random.key(s) for s in range(args.seeds)])
    init = jax.vmap(lambda k: R.rainbow_train_init(k, cfg, env_params,
                                                   num_envs=1))
    carry = init(keys)
    chunk = jax.jit(jax.vmap(
        lambda c: R.rainbow_train_chunk(cfg, env_params, c,
                                        args.chunk_steps)))

    os.makedirs(args.out, exist_ok=True)
    prog = open(os.path.join(args.out, "progress.jsonl"), "a")
    t0 = time.time()
    it = 0
    while True:
        carry = chunk(carry)
        m = carry.metrics
        eps = jnp.maximum(m.episodes, 1).astype(jnp.float32)
        # The host reads of the counters below wait for the chunk.
        row = {
            "it": it,
            "wall_s": round(time.time() - t0, 1),
            "episodes": [int(v) for v in m.episodes],
            "env_steps": [int(v) for v in m.env_steps],
            "collision_rate": [round(float(v), 4)
                               for v in m.collisions / eps],
            "win_rate": [round(float(v), 4) for v in m.wins / eps],
            "reward": [round(float(v), 3) for v in m.sum_ep_reward / eps],
            "loss": [round(float(v), 4) for v in carry.last_loss],
        }
        prog.write(json.dumps(row) + "\n")
        prog.flush()
        if it % 20 == 0:
            print(json.dumps(row), flush=True)
        it += 1
        done = int(jnp.min(m.episodes)) >= args.episodes
        out_of_time = (time.time() - t0) > args.max_hours * 3600
        if done or out_of_time:
            final = {
                "what": ("Faithful single-env Rainbow self-play at the "
                         "reference's 4,000-episode scale "
                         "(ranbowdqn.py:651), vmapped seeds -- each lane "
                         "an unchanged single-env faithful trainer."),
                "episodes_target": args.episodes,
                "completed": bool(done),
                "wall_hours": round((time.time() - t0) / 3600, 2),
                "per_seed": [
                    {"seed": s,
                     "episodes": row["episodes"][s],
                     "env_steps": row["env_steps"][s],
                     "collision_rate": row["collision_rate"][s],
                     "win_rate": row["win_rate"][s],
                     "reward": row["reward"][s],
                     "mean_ep_len": round(row["env_steps"][s]
                                          / max(row["episodes"][s], 1), 1),
                     "mode": ("timeout" if row["env_steps"][s]
                              / max(row["episodes"][s], 1) > 1250
                              else "racing")}
                    for s in range(args.seeds)],
            }
            with open(os.path.join(args.out, "final.json"), "w") as f:
                json.dump(final, f, indent=1)
                f.write("\n")
            print("final:", json.dumps(final), flush=True)
            break
    prog.close()


if __name__ == "__main__":
    main()
