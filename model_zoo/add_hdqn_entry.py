"""Finalize an hdqn CLI training run into a model_zoo entry.

Copies the {"upper","lower"} params.npz, writes meta.json, renders the
4-panel curves from the run's scalars.jsonl, and evaluates the frozen
hierarchical policy (agents.policies.hdqn_policy: Phi(eps)-greedy meta
goal re-selected every step, hdqn.py:303, over the goal-conditioned
lower net) vs L0, vs random, and optionally vs a ladder rung.

    python model_zoo/add_hdqn_entry.py --run /tmp/hd_l0_run --name HD_L0 \
        [--vs model_zoo/L1/params.npz] [--note "..."] [--cpu]
"""

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

ZOO = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--vs", default=None,
                    help="extra opponent params.npz (a ladder rung)")
    ap.add_argument("--note", default="")
    ap.add_argument("--hidden", type=int, nargs="+", default=[200, 100],
                    help="hidden sizes the run was trained with")
    ap.add_argument("--num-envs", type=int, default=128)
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="evaluate on the CPU backend (leave the GPU free)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from merging_gym_tpu.agents.evaluate import evaluate
    from merging_gym_tpu.agents.hdqn import HDQNConfig
    from merging_gym_tpu.agents.policies import (hdqn_policy, l0_policy,
                                                 q_policy, random_policy)
    from merging_gym_tpu.core.env import EnvParams
    from merging_gym_tpu.io.checkpoint import load_params_npz
    from merging_gym_tpu.nn.mlp import qnet_apply, qnet_init

    dst = os.path.join(ZOO, args.name)
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(args.run, "params.npz"),
                os.path.join(dst, "params.npz"))

    # Templates derive from HDQNConfig (the same recipe as
    # cli._load_frozen_hdqn) so runs trained with non-default hidden
    # sizes / goal counts load correctly instead of failing downstream.
    cfg = HDQNConfig(hidden=tuple(args.hidden))
    like = {"lower": qnet_init(jax.random.key(0), cfg.obs_dim + 1,
                               cfg.num_actions, cfg.hidden),
            "upper": qnet_init(jax.random.key(0), cfg.obs_dim,
                               cfg.num_goals, cfg.hidden)}
    nets = load_params_npz(os.path.join(dst, "params.npz"), like)
    me = hdqn_policy(nets["upper"], nets["lower"])

    matchups = {"L0": l0_policy(), "random": random_policy()}
    if args.vs:
        q_like = qnet_init(jax.random.key(0), 10, 5)
        matchups[os.path.basename(os.path.dirname(args.vs))] = q_policy(
            qnet_apply, load_params_npz(args.vs, q_like))

    results = {}
    for name, opp in matchups.items():
        results[f"vs {name}"] = {
            k: round(v, 4) if isinstance(v, float) else v
            for k, v in evaluate(me, opp, EnvParams(), jax.random.key(0),
                                 num_envs=args.num_envs,
                                 min_episodes=args.episodes).items()}
    rows = [json.loads(l) for l in open(os.path.join(args.run, "scalars.jsonl"))]
    final = rows[-1]
    doc = {"algo": "hdqn", "note": args.note,
           "training_final": {k: final[k] for k in
                              ("episodes", "env_steps", "collision_rate",
                               "win_rate", "reward", "loss")},
           "eval": results}
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    try:
        from merging_gym_tpu.io.analysis import plot_training_curves
        plot_training_curves(args.run)
        src = os.path.join(args.run, "curves.png")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(dst, "curves.png"))
    except Exception as e:
        print("curves skipped:", e)
    print(json.dumps(doc, indent=1))
    print("wrote", dst)


if __name__ == "__main__":
    main()
