"""Finalize a rainbow CLI training run into a model_zoo entry.

Copies params.npz, writes meta.json ({"algo": "rainbow", ...config}),
renders the 4-panel curves from the run's scalars.jsonl, and evaluates
the frozen policy head-to-head (rainbow_policy eval-mode actor) vs L0
and vs a given ladder rung, recording the results in final_metrics.json.

    python model_zoo/add_rainbow_entry.py --run /tmp/rb_l0d --name RB1 \
        [--vs model_zoo/L1/params.npz] [--note "..."]
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
    ap.add_argument("--obs-scale", type=float, default=None,
                    help="must match the run's RainbowConfig.obs_scale")
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--episodes", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="evaluate on the CPU backend (leave the GPU free)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from merging_gym_tpu.agents.evaluate import evaluate
    from merging_gym_tpu.agents.policies import l0_policy, q_policy, rainbow_policy
    from merging_gym_tpu.core.env import EnvParams
    from merging_gym_tpu.io.checkpoint import load_params_npz
    from merging_gym_tpu.nn.mlp import qnet_apply, qnet_init
    from merging_gym_tpu.nn.rainbow_net import rainbow_init

    dst = os.path.join(ZOO, args.name)
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(args.run, "params.npz"),
                os.path.join(dst, "params.npz"))

    rb_like = rainbow_init(jax.random.key(0), 10, 5)
    params = load_params_npz(os.path.join(dst, "params.npz"), rb_like)
    me = rainbow_policy(params, obs_scale=args.obs_scale)

    matchups = {"L0": l0_policy()}
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
    doc = {"algo": "rainbow", "note": args.note, "obs_scale": args.obs_scale,
           "training_final": {k: final[k] for k in
                              ("episodes", "env_steps", "collision_rate",
                               "win_rate", "reward", "loss")},
           "eval": results}
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(doc, f, indent=1)
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
