"""Command-line entry point.

The reference has no flag system: hyper-parameters are module constants
and behaviour switches are edit-the-source literals (``Strategy_OP``,
main.py:161; ``OP_MODEL``, human_player.py:45 -- SURVEY.md section 5).
This CLI surfaces all of them:

  python -m merging_gym_tpu.cli train   --algo dqn|hdqn|rainbow ...
  python -m merging_gym_tpu.cli levelk  --levels 3 ...   (level-k curriculum)
  python -m merging_gym_tpu.cli play    --op-model dqn|hdqn|rainbow|pvp|l0 ...
  python -m merging_gym_tpu.cli bench   ...
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _add_env_args(p):
    p.add_argument("--r-first", type=float, default=2.0)
    p.add_argument("--r-second", type=float, default=1.0)
    p.add_argument("--r-collision", type=float, default=-10.0)
    p.add_argument("--vel-penalty", type=float, default=0.001)
    p.add_argument("--time-penalty", type=float, default=0.0)
    p.add_argument("--random-start", action="store_true",
                   help="randomised start states (merging_env.py:219-221)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="episode step cap (default: the reference's "
                        "float-accumulated 2501, merging_env.py:141-143)")


def _env_params(args):
    from merging_gym_tpu.core.env import EnvParams
    extra = ({"max_steps": args.max_steps}
             if getattr(args, "max_steps", None) else {})
    return EnvParams(r_first=args.r_first, r_second=args.r_second,
                     r_collision=args.r_collision,
                     vel_penalty=args.vel_penalty,
                     time_penalty=args.time_penalty,
                     random_start=args.random_start, **extra)


def _train_args(p):
    _add_env_args(p)
    p.add_argument("--algo", choices=["dqn", "hdqn", "rainbow", "drqn"],
                   default="dqn")
    p.add_argument("--opponent", default="L0",
                   help='"L0", "selfplay", or a checkpoint dir/npz (frozen)')
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--episodes", type=int, default=2000,
                   help="stop once this many episodes completed (main.py:170)")
    p.add_argument("--max-chunks", type=int, default=10000)
    p.add_argument("--chunk-steps", type=int, default=200)
    p.add_argument("--memory-capacity", type=int, default=None)
    p.add_argument("--goal-memory-capacity", type=int, default=None,
                   help="hdqn: meta goal-memory slots (default 200, "
                        "hdqn.py:22)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--hidden", type=int, nargs=2, default=None,
                   metavar=("H1", "H2"),
                   help="Q-net hidden widths (dqn; default 200 100)")
    p.add_argument("--compute-dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="dqn/hdqn: matmul operand dtype (master params, "
                        "Adam moments and accumulation stay f32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="run directory (default: reference-style name)")
    p.add_argument("--per", action="store_true", help="prioritised replay (rainbow)")
    p.add_argument("--per-alpha", type=float, default=0.6,
                   help="PER priority exponent (ranbowdqn.py:344)")
    p.add_argument("--per-beta", type=float, default=0.4,
                   help="PER importance-weight exponent")
    p.add_argument("--n-step", type=int, default=1, help="n-step returns (rainbow)")
    p.add_argument("--gamma", type=float, default=None,
                   help="discount (dqn/hdqn default 0.90 main.py:15; "
                        "rainbow default 0.99 ranbowdqn.py:593)")
    p.add_argument("--epsilon", type=float, default=None,
                   help="Phi(eps)-greedy exploration threshold (main.py:105; "
                        "dqn/hdqn default 0.7; rainbow default None = the "
                        "reference's pure noisy-greedy actor)")
    p.add_argument("--obs-scale", type=float, default=None,
                   help="rainbow: multiply observations by this before the "
                        "net (raw O(1e2-1e3) features saturate the C51 "
                        "streams; 0.01 keeps them alive. default None = "
                        "faithful raw obs)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="orbax full-state checkpoint every N chunks and at "
                        "the end (0 = none; needs orbax-checkpoint)")
    p.add_argument("--resume", default=None,
                   help="run dir to resume from (restores the full orbax "
                        "train state: params, optimizer, replay, envs, RNG)")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars (needs tensorboardX, "
                        "which imports torch)")
    p.add_argument("--plot-every", type=int, default=0,
                   help="regenerate curves.png every N chunks (the live "
                        "matplotlib panel analog, main.py:176-235)")


def _load_frozen_qnet(path):
    import jax.numpy as jnp
    from merging_gym_tpu.io import torch_import as ti
    from merging_gym_tpu.io.checkpoint import load_params_npz
    from merging_gym_tpu.nn.mlp import qnet_init
    import jax

    if os.path.isdir(path) and os.path.exists(os.path.join(path, "eval.pth")):
        params, _ = ti.load_reference_dqn(path)
        return params
    if path.endswith(".npz"):
        like = qnet_init(jax.random.key(0), 10, 5)
        return load_params_npz(path, like)
    raise SystemExit(f"cannot load frozen opponent from {path}")


def _load_frozen_hdqn(path, cfg):
    """Load a frozen hierarchical opponent: a params.npz holding
    {"upper", "lower"} nets (cli hdqn runs save this layout) or a
    reference .pth run dir (meta_eval/eval, io.torch_import)."""
    if path.endswith(".npz"):
        import jax as _jax
        from merging_gym_tpu.io.checkpoint import load_params_npz
        from merging_gym_tpu.nn.mlp import qnet_init
        like = {
            "lower": qnet_init(_jax.random.key(0), cfg.obs_dim + 1,
                               cfg.num_actions, cfg.hidden),
            "upper": qnet_init(_jax.random.key(0), cfg.obs_dim,
                               cfg.num_goals, cfg.hidden),
        }
        nets = load_params_npz(path, like)
        return nets["upper"], nets["lower"]
    from merging_gym_tpu.io import torch_import as ti
    nets = ti.load_reference_hdqn(path)
    return nets["meta_eval"], nets["lower_eval"]


def _load_frozen_drqn(path):
    """Load a frozen recurrent (DRQN) opponent from a params.npz saved by
    a ``cli train --algo drqn`` run (nn.lstm.drqn_init layout)."""
    if path.endswith(".npz"):
        import jax as _jax
        from merging_gym_tpu.io.checkpoint import load_params_npz
        from merging_gym_tpu.nn.lstm import drqn_init
        like = drqn_init(_jax.random.key(0), 10, 5)
        return load_params_npz(path, like)
    raise SystemExit(f"cannot load frozen drqn opponent from {path} "
                     "(expected a params.npz from a --algo drqn run)")


def _opponent_mode(args, load=_load_frozen_qnet):
    """The shared opponent-string -> (mode, frozen params) resolution
    (main.py:161-168's Strategy_OP switch), used by every algo branch.

    ``load`` maps the frozen checkpoint path to params for the branch's
    net family (default: flat Q-net); pass ``None`` when the caller
    loads the checkpoint itself (e.g. hdqn, whose template needs cfg)."""
    from merging_gym_tpu.agents import dqn as D

    mode = (D.OPP_L0 if args.opponent == "L0"
            else D.OPP_SELFPLAY if args.opponent == "selfplay"
            else D.OPP_FROZEN)
    opp = load(args.opponent) if mode == D.OPP_FROZEN and load else None
    return mode, opp


def cmd_train(args):
    import jax
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.io.checkpoint import (CheckpointManager, run_dir_name,
                                               save_params_npz)
    from merging_gym_tpu.io.metrics import MetricsWriter, rates_from_counters

    if args.algo not in ("dqn", "hdqn") and (
            args.hidden or args.compute_dtype != "float32"):
        raise SystemExit("--hidden/--compute-dtype are wired into the dqn "
                         f"and hdqn trainers only; --algo {args.algo} would "
                         "silently ignore them (drop the flags or switch "
                         "algo)")
    if args.algo == "hdqn" and args.hidden:
        raise SystemExit("--hidden is wired into the dqn trainer only")
    env_params = _env_params(args)
    out = args.out or run_dir_name(f" {args.algo}", args.opponent,
                                   env_params.reward_tuple())
    os.makedirs(out, exist_ok=True)
    writer = MetricsWriter(out, tensorboard=args.tensorboard)
    ckpt = CheckpointManager(os.path.join(out, "ckpt")) if args.checkpoint_every else None
    key = jax.random.key(args.seed)

    if args.algo == "dqn":
        mode, opp = _opponent_mode(args)
        cfg = D.DQNConfig(
            opponent=mode,
            memory_capacity=args.memory_capacity or max(2000, 2 * args.num_envs),
            batch_size=args.batch_size or 128,
            lr=args.lr or 0.01,
            gamma=args.gamma if args.gamma is not None else 0.90,
            epsilon=args.epsilon if args.epsilon is not None else 0.7,
            hidden=tuple(args.hidden) if args.hidden else (200, 100),
            compute_dtype=args.compute_dtype)
        carry = D.train_init(key, cfg, env_params, args.num_envs, opp)
        step_fn = lambda c: D.train_chunk(cfg, env_params, c, args.chunk_steps)
        get_params = lambda c: c.dqn.params
        extra = lambda c: {"loss": float(c.dqn.last_loss),
                           "learns": int(c.dqn.learn_counter)}
    elif args.algo == "hdqn":
        from merging_gym_tpu.agents import hdqn as H
        mode, _ = _opponent_mode(args, load=None)  # template needs cfg; below
        cfg = H.HDQNConfig(
            opponent=mode,
            memory_capacity=args.memory_capacity or max(2000, 2 * args.num_envs),
            goal_memory_capacity=args.goal_memory_capacity or 200,
            batch_size=args.batch_size or 128, lr=args.lr or 0.01,
            gamma=args.gamma if args.gamma is not None else 0.90,
            epsilon=args.epsilon if args.epsilon is not None else 0.7,
            compute_dtype=args.compute_dtype)
        opp_u = opp_l = None
        if mode == D.OPP_FROZEN:
            opp_u, opp_l = _load_frozen_hdqn(args.opponent, cfg)
        carry = H.hdqn_init(key, cfg, env_params, args.num_envs, opp_u, opp_l)
        step_fn = lambda c: H.hdqn_train_chunk(cfg, env_params, c, args.chunk_steps)
        get_params = lambda c: {"lower": c.lower.params, "upper": c.upper.params}
        extra = lambda c: {"loss": float(c.lower.last_loss),
                           "meta_loss": float(c.upper.last_loss)}
    elif args.algo == "drqn":
        from merging_gym_tpu.agents import drqn as DR
        mode, opp = _opponent_mode(args, load=_load_frozen_drqn)
        cfg = DR.DRQNConfig(
            opponent=mode,
            # Window flushes are synchronized across lanes (every lane
            # emits on the same step), so the sequence ring must hold at
            # least one full flush of num_envs windows or the batched
            # scatter silently drops experience (drqn_train_init asserts).
            memory_capacity=args.memory_capacity or max(512, 2 * args.num_envs),
            batch_size=args.batch_size or 32, lr=args.lr or 0.01,
            gamma=args.gamma if args.gamma is not None else 0.90,
            epsilon=args.epsilon if args.epsilon is not None else 0.7)
        carry = DR.drqn_train_init(key, cfg, env_params, args.num_envs, opp)
        step_fn = lambda c: DR.drqn_train_chunk(cfg, env_params, c, args.chunk_steps)
        get_params = lambda c: c.params
        extra = lambda c: {"loss": float(c.last_loss),
                           "learns": int(c.learn_counter)}
    else:
        from merging_gym_tpu.agents import rainbow as R
        mode, opp = _opponent_mode(args)
        cfg = R.RainbowConfig(
            memory_capacity=args.memory_capacity or 10000,
            batch_size=args.batch_size or 32, lr=args.lr or 1e-3,
            per=args.per, per_alpha=args.per_alpha, per_beta=args.per_beta,
            n_step=args.n_step, opponent=mode,
            gamma=args.gamma if args.gamma is not None else 0.99,
            epsilon=args.epsilon, obs_scale=args.obs_scale)
        carry = R.rainbow_train_init(key, cfg, env_params, args.num_envs, opp)
        step_fn = lambda c: R.rainbow_train_chunk(cfg, env_params, c, args.chunk_steps)
        get_params = lambda c: c.params
        extra = lambda c: {"loss": float(c.last_loss)}

    if args.resume:
        from merging_gym_tpu.io.checkpoint import CheckpointManager as _CM
        mgr = _CM(os.path.join(args.resume, "ckpt"))
        carry = mgr.restore(carry)
        mgr.close()
        print(f"resumed from {args.resume} at step {int(carry.metrics.env_steps)}")

    t0 = time.time()
    for chunk in range(args.max_chunks):
        carry = step_fn(carry)
        jax.block_until_ready(carry.metrics.episodes)
        scalars = rates_from_counters(carry.metrics)
        scalars.update(extra(carry))
        scalars["env_steps_per_sec"] = scalars["env_steps"] / (time.time() - t0)
        writer.log(chunk, scalars)
        print(f"chunk {chunk}: {json.dumps(scalars)}", flush=True)
        if args.plot_every and (chunk + 1) % args.plot_every == 0:
            try:
                from merging_gym_tpu.io.analysis import plot_training_curves
                plot_training_curves(out)
            except Exception:
                pass
        if ckpt and (chunk + 1) % args.checkpoint_every == 0:
            ckpt.save(chunk, carry)
        if scalars["episodes"] >= args.episodes:
            break

    save_params_npz(os.path.join(out, "params.npz"), get_params(carry))
    try:
        from merging_gym_tpu.io.analysis import plot_training_curves
        plot_training_curves(out)
    except Exception as e:  # matplotlib optional on minimal hosts
        print(f"curve plot skipped: {e}")
    if ckpt:
        ckpt.save(args.max_chunks, carry, wait=True)
        ckpt.close()
    writer.close()
    print(f"run saved to {out}")
    return out


def cmd_levelk(args):
    """Level-k curriculum (main.py:161-168 done properly): L1 trains vs
    L0, L2 vs frozen L1, ... each level saved to its own run dir."""
    if args.algo not in ("dqn", "hdqn"):
        raise SystemExit(
            f"levelk supports --algo dqn or hdqn (got {args.algo!r}): "
            "the curriculum freezes each rung as the next opponent, and "
            "only MLP Q-nets can be frozen opponents (rainbow can train "
            "VS a frozen rung via train --opponent <npz>, but a frozen "
            "rainbow policy is not a supported opponent; drqn has "
            "neither mode)")
    prev = "L0"
    for level in range(1, args.levels + 1):
        sub = argparse.Namespace(**vars(args))
        sub.opponent = prev if level == 1 else os.path.join(prev, "params.npz")
        sub.out = os.path.join(args.out or "levelk_runs", f"L{level}")
        print(f"=== training L{level} vs {sub.opponent} ===")
        prev = cmd_train(sub)


def cmd_play(args):
    from merging_gym_tpu.ui.human import load_opponent, run_session

    opponent = load_opponent(args.op_model, args.load_path)
    result = run_session(opponent, episodes=args.episodes,
                         log_root=args.log_root)
    print(json.dumps(result))


def cmd_bench(args):
    import bench
    raise SystemExit(bench.main())


def _policy_from_spec(spec: str):
    from merging_gym_tpu.agents import policies as P
    from merging_gym_tpu.nn.mlp import qnet_apply

    if spec == "random":
        return P.random_policy()
    if spec == "l0":
        return P.l0_policy()
    if spec.startswith("const:"):
        return P.constant_policy(int(spec.split(":", 1)[1]))
    params = _load_frozen_qnet(spec)
    # The reference always plays checkpoints through its Phi(0.7)-greedy
    # actor (human_player.py:158 -> main.py:99-112); pure-greedy from the
    # deterministic start collapses every env to one trajectory.
    return P.q_policy(qnet_apply, params, greedy=False)


def cmd_eval(args):
    import jax
    from merging_gym_tpu.agents.evaluate import evaluate

    result = evaluate(_policy_from_spec(args.p1), _policy_from_spec(args.p2),
                      _env_params(args), jax.random.key(args.seed),
                      num_envs=args.num_envs, min_episodes=args.episodes)
    print(json.dumps(result, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(prog="merging_gym_tpu")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend instead of the default "
                        "accelerator")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train one agent")
    _train_args(pt)
    pt.set_defaults(fn=cmd_train)

    pl = sub.add_parser("levelk", help="level-k opponent curriculum")
    _train_args(pl)
    pl.add_argument("--levels", type=int, default=2)
    pl.set_defaults(fn=cmd_levelk)

    pp = sub.add_parser("play", help="human experiment session")
    pp.add_argument("--op-model", default="l0",
                    choices=["l0", "dqn", "hdqn", "rainbow", "pvp"])
    pp.add_argument("--load-path", default=None)
    pp.add_argument("--episodes", type=int, default=5)
    pp.add_argument("--log-root", default="log")
    pp.set_defaults(fn=cmd_play)

    pb = sub.add_parser("bench", help="run the headline benchmark")
    pb.set_defaults(fn=cmd_bench)

    pe = sub.add_parser("eval", help="head-to-head policy evaluation")
    _add_env_args(pe)
    pe.add_argument("--p1", default="random",
                    help='"random", "l0", "const:<a>", a params.npz, or a '
                         'reference .pth run dir')
    pe.add_argument("--p2", default="l0")
    pe.add_argument("--episodes", type=int, default=512)
    pe.add_argument("--num-envs", type=int, default=256)
    pe.add_argument("--seed", type=int, default=0)
    pe.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from merging_gym_tpu.utils import compile_cache
    compile_cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
