"""Smoke run of the main path on NVIDIA GPUs, each phase checked.

    python chip_smoke.py            # one GPU: phases 1-4 below
    python chip_smoke.py --gpus 4   # four GPUs: the data/tensor-parallel
                                    # trainers of parallel/spmd.py only

Phases on one GPU:

1. The device as JAX sees it, the card's name and power limit from
   nvidia-smi, and which precision a default f32 matmul gets.
2. The rollout kernel (ops/fused_rollout.py) against the plain XLA
   rollout at 4,096 envs x 2,600 steps, in actions mode and in seed mode,
   trajectories and counters; then both timed at 4,096 and 65,536 envs.
3. ``cli train`` for the four families (DQN at the reference width and
   at 1024x512 bf16, HDQN, Rainbow with PER and 3-step returns, DRQN), and
   one DQN chunk on the GPU against the same chunk on the CPU device.
4. ``cli eval`` of the L1 model-zoo net against L0 and against the
   random policy, each against the same evaluation on the CPU.

Everything runs in this one process, the only one that opens the cards.
The script exits non-zero if any phase fails or JAX finds no GPU; only
then is the last line of its output ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUNS = os.path.join(REPO, "runs", "chip_smoke")

ROLLOUT_STEPS = 2600          # one full 2,501-step timeout horizon and more
ROLLOUT_ENVS = 4096
TIMED_ENVS = (4096, 65536)
TIMED_REPS = 5

# obs are f32 arc coordinates: x = R*sin(angle) with R = 3e4 reaches ~1e3,
# where one f32 ulp is 6.1e-5, and x2 - x1 subtracts two such terms.  The
# kernel and XLA may round sin() and fuse multiply-adds differently, and a
# position carries such a difference for up to 2,501 steps of an episode.
OBS_ATOL = 2e-3
# Rewards are -0.001 * |v - 20| plus exact bonuses; a velocity difference
# of a few ulps (v <= 40) moves them by < 1e-7, the bonuses not at all.
REWARD_ATOL = 1e-5
# A reward sum adds up to 2,600 such rewards per env.
REWARD_SUM_ATOL = 2600 * REWARD_ATOL

TRAIN_RUNS = {
    "dqn": ["--algo", "dqn"],
    "dqn_1024x512_bf16": ["--algo", "dqn", "--hidden", "1024", "512",
                          "--compute-dtype", "bfloat16"],
    "hdqn": ["--algo", "hdqn"],
    "rainbow_per_3step": ["--algo", "rainbow", "--per", "--n-step", "3",
                          "--obs-scale", "0.01", "--memory-capacity", "10000"],
    "drqn": ["--algo", "drqn"],
}
TRAIN_ENVS, TRAIN_CHUNKS, TRAIN_CHUNK_STEPS = 1024, 3, 200
# The GPU-against-CPU DQN chunk.  Adam divides each step by the root of a
# running square, so a weight whose gradient is near zero moves by up to
# lr = 0.01 per learn in a direction that a last-bit difference of that
# gradient can flip; over REF_STEPS learns taken as a random walk that is
# lr * sqrt(REF_STEPS) ~ 0.17 on weights of scale ~1 (U(0, 1) init).
REF_STEPS = 300
PARAM_ATOL = 0.01 * REF_STEPS ** 0.5
# The learner's arithmetic on identical inputs (one batch, the CPU run's
# final params): the same f32 program at highest precision differs only
# in the order of its sums, ~1e-6 relative over dots of <= 200 terms.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3       # of the largest gradient entry
# Outcome rates of the eval runs against the CPU.  Both sides draw the
# same threefry streams, so at highest precision they differ only where
# an argmax over nearly tied Q-values or a collision test at a rounding
# boundary flips and an episode plays out differently.  At the default
# precision the GPU's f32 matmuls run as TF32 (~3 digits), near ties
# flip more often, and the rates agree only statistically: 0.05 is about
# 5 standard errors of a rate near 0.98 over 512 episodes.
EVAL_RATE_ATOL = 0.02
EVAL_RATE_ATOL_TF32 = 0.05
FORBIDDEN_MODULES = ("flax", "orbax", "gymnasium", "pygame", "torch")


class CheckFailed(AssertionError):
    """A comparison with the reference failed."""


def check_equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise CheckFailed(f"{name}: shape {got.shape} != {want.shape}")
    bad = np.flatnonzero(got.ravel() != want.ravel())
    if bad.size:
        raise CheckFailed(f"{name}: {bad.size} of {got.size} entries differ, "
                          f"first at flat index {bad[0]}")


def check_close(name, got, want, atol, rtol=0.0):
    """Raise unless |got - want| <= atol + rtol * |want|; return max error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise CheckFailed(f"{name}: shape {got.shape} != {want.shape}")
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise CheckFailed(f"{name}: non-finite values")
    err = np.abs(got - want)
    if (err > atol + rtol * np.abs(want)).any():
        raise CheckFailed(f"{name}: max |error| {err.max():.3e} exceeds "
                          f"atol {atol:g} + rtol {rtol:g} * |want|")
    return float(err.max()) if err.size else 0.0


def compare_trajectories(got, want):
    """Kernel trajectory (env-last) against the XLA rollout (env-first)."""
    for k in ("done", "winner", "collision"):
        check_equal(k, got[k], want[k])
    err_obs = check_close("obs", np.swapaxes(np.asarray(got["obs"]), 1, 2),
                          want["obs"], OBS_ATOL)
    err_rew = check_close("rewards",
                          np.swapaxes(np.asarray(got["rewards"]), 1, 2),
                          want["rewards"], REWARD_ATOL)
    return err_obs, err_rew


def counters_of(traj):
    """The counters ``fused_rollout_counters`` keeps, from a trajectory."""
    done = np.asarray(traj["done"])
    win = np.asarray(traj["winner"])
    col = np.asarray(traj["collision"])
    return {"reward_sum": np.asarray(traj["rewards"], np.float64).sum(0),
            "episodes": done.sum(0), "collisions": col.sum(0),
            "wins1": (done & (win == 1) & ~col).sum(0),
            "wins2": (done & (win == 2) & ~col).sum(0)}


def compare_counters(got, want):
    for k in ("episodes", "collisions", "wins1", "wins2"):
        check_equal(k, got[k], want[k])
    return check_close("reward_sum", got["reward_sum"], want["reward_sum"],
                       REWARD_SUM_ATOL)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _median_rate(fn, work, reps=TIMED_REPS):
    import jax
    jax.block_until_ready(fn(0))                  # compile + warm up
    rates = []
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r))
        rates.append(work / (time.perf_counter() - t0))
    return statistics.median(rates)


def phase_device(jax):
    import jax.numpy as jnp

    dev = jax.devices()[0]
    print(f"phase 1: {len(jax.devices())} x {dev.platform} {dev.device_kind}")
    print(f"card: {card_line()}")
    # Which precision does an f32 matmul get by default on this card?
    a = jax.random.normal(jax.random.key(0), (512, 512), jnp.float32)
    exact = np.asarray(a, np.float64) @ np.asarray(a, np.float64)
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = np.asarray(jax.jit(jnp.matmul)(a, a), np.float64)
        rel = float(np.abs(got - exact).max() / np.abs(exact).max())
        print(f"  f32 matmul at {prec} precision: max rel error {rel:.2e}")


def phase_rollout(jax):
    from merging_gym_tpu.ops import fused_rollout as FR

    T, N = ROLLOUT_STEPS, ROLLOUT_ENVS
    rng = np.random.default_rng(0)
    actions = rng.integers(-1, 5, size=(T, 2, N), dtype=np.int32)
    for label, src in (("actions", {"actions": actions}),
                       ("seed", {"seed": 7})):
        traj = jax.device_get(FR.fused_rollout(T, N, **src))
        ref = jax.device_get(FR.reference_rollout(T, N, **src))
        err_obs, err_rew = compare_trajectories(traj, ref)
        cnt = jax.device_get(FR.fused_rollout_counters(T, N, **src))
        err_sum = compare_counters(cnt, counters_of(traj))
        compare_counters(cnt, jax.device_get(
            FR.reference_rollout_counters(T, N, **src)))
        print(f"phase 2: rollout {label} mode, {N} envs x {T} steps: events "
              f"identical ({int(cnt['episodes'].sum())} episodes, "
              f"{int(cnt['collisions'].sum())} collisions, "
              f"{int(cnt['wins1'].sum())}/{int(cnt['wins2'].sum())} wins); "
              f"max |obs err| {err_obs:.2e}, |reward err| {err_rew:.2e}, "
              f"|reward-sum err| {err_sum:.2e}; counters = trajectory sums")

    for n in TIMED_ENVS:
        for mode, kernel, xla in (
                ("trajectory", FR.fused_rollout, FR.reference_rollout),
                ("counters", FR.fused_rollout_counters,
                 FR.reference_rollout_counters)):
            rk = _median_rate(lambda s: kernel(T, n, seed=s), n * T)
            rx = _median_rate(lambda s: xla(T, n, seed=s), n * T)
            print(f"phase 2: {mode} {n} envs x {T} steps: kernel {rk:.4e} "
                  f"env-steps/s, XLA rollout {rx:.4e} ({rk / rx:.2f}x)")


def _cli(argv):
    """Run ``python -m merging_gym_tpu.cli <argv>`` in this process."""
    from merging_gym_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def _last_scalars(out_dir):
    with open(os.path.join(out_dir, "scalars.jsonl")) as f:
        return json.loads(f.read().splitlines()[-1])


def phase_train(jax):
    for tag, flags in TRAIN_RUNS.items():
        out = os.path.join(RUNS, tag)
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        _cli(["train", *flags, "--num-envs", str(TRAIN_ENVS),
              "--chunk-steps", str(TRAIN_CHUNK_STEPS),
              "--max-chunks", str(TRAIN_CHUNKS), "--episodes", "1000000000",
              "--out", out])
        s = _last_scalars(out)
        want_steps = TRAIN_ENVS * TRAIN_CHUNKS * TRAIN_CHUNK_STEPS
        if int(s["env_steps"]) != want_steps:
            raise CheckFailed(f"train {tag}: {s['env_steps']} env steps, "
                              f"expected {want_steps}")
        if not np.isfinite(s["loss"]):
            raise CheckFailed(f"train {tag}: loss {s['loss']}")
        with np.load(os.path.join(out, "params.npz")) as z:
            if not all(np.isfinite(z[k]).all() for k in z.files):
                raise CheckFailed(f"train {tag}: non-finite params")
        print(f"phase 3: train {tag}: {want_steps} env steps, "
              f"{int(s['episodes'])} episodes, loss {s['loss']:.4g}, "
              f"{time.perf_counter() - t0:.1f} s with compilation")
    _train_against_cpu(jax)


def _train_against_cpu(jax):
    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.core.env import EnvParams
    from merging_gym_tpu.ops import replay as rp

    cfg = D.DQNConfig(memory_capacity=max(2000, 2 * TRAIN_ENVS))
    env = EnvParams()
    gpu_dev, cpu_dev = jax.devices()[0], jax.devices("cpu")[0]

    def run(dev):
        with jax.default_device(dev), jax.default_matmul_precision("highest"):
            carry = D.train_init(jax.random.key(0), cfg, env, TRAIN_ENVS)
            return jax.device_get(D.train_chunk(cfg, env, carry, REF_STEPS))

    gpu, cpu = run(gpu_dev), run(cpu_dev)
    for k in ("env_steps", "episodes", "collisions", "wins"):
        check_equal(f"dqn chunk {k}", getattr(gpu.metrics, k),
                    getattr(cpu.metrics, k))
    scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(cpu.dqn.params))
    err = max(check_close("dqn chunk params", g, c, PARAM_ATOL)
              for g, c in zip(jax.tree.leaves(gpu.dqn.params),
                              jax.tree.leaves(cpu.dqn.params)))

    batch, _ = rp.sample(cpu.replay, jax.random.key(1), cfg.batch_size)
    inputs = jax.device_get((cpu.dqn.params, cpu.dqn.target_params, batch))

    def loss_and_grads(dev):
        with jax.default_matmul_precision("highest"):
            args = jax.device_put(inputs, dev)
            return jax.device_get(jax.jit(jax.value_and_grad(D.td_loss),
                                          static_argnums=3)(*args, cfg))

    (lg, gg), (lc, gc) = loss_and_grads(gpu_dev), loss_and_grads(cpu_dev)
    check_close("dqn loss", lg, lc, 0.0, LOSS_RTOL)
    gmax = max(float(np.abs(x).max()) for x in jax.tree.leaves(gc))
    for g, c in zip(jax.tree.leaves(gg), jax.tree.leaves(gc)):
        check_close("dqn gradients", g, c, GRAD_RTOL * gmax)
    print(f"phase 3: dqn chunk of {REF_STEPS} steps at highest precision, "
          f"GPU against CPU: counters identical ({int(cpu.metrics.episodes)} "
          f"episodes, {int(cpu.dqn.learn_counter)} learns); max |param err| "
          f"{err:.3e} of scale {scale:.3g}; one batch's loss {float(lg):.7g} "
          f"vs {float(lc):.7g} and gradients within {GRAD_RTOL:g} of "
          f"{gmax:.3g}")


def phase_eval(jax):
    l1 = os.path.join(REPO, "model_zoo", "L1", "params.npz")
    rates = ("p1_first_rate", "p2_first_rate", "collision_rate",
             "timeout_rate")
    # The zoo's L1 lets L0 cross first in every game and never collides
    # with it; against the random policy it plays out both outcomes.
    for p2 in ("l0", "random"):
        argv = ["eval", "--p1", l1, "--p2", p2]
        gpu = json.loads(_cli(argv))
        with jax.default_matmul_precision("highest"):
            gpu_hi = json.loads(_cli(argv))
            with jax.default_device(jax.devices("cpu")[0]):
                cpu = json.loads(_cli(argv))
        for k in rates:
            check_close(f"eval {k}", gpu_hi[k], cpu[k], EVAL_RATE_ATOL)
            check_close(f"eval {k} (TF32)", gpu[k], cpu[k],
                        EVAL_RATE_ATOL_TF32)
        print(f"phase 4: eval L1 vs {p2}, p2-first / collision rates: GPU "
              f"{gpu['p2_first_rate']:.4f} / {gpu['collision_rate']:.4f} "
              f"({gpu['episodes']} episodes), GPU at highest precision "
              f"{gpu_hi['p2_first_rate']:.4f} / {gpu_hi['collision_rate']:.4f},"
              f" CPU {cpu['p2_first_rate']:.4f} / {cpu['collision_rate']:.4f}")
    loaded = [m for m in FORBIDDEN_MODULES if m in sys.modules]
    if loaded:
        raise CheckFailed(f"the main path imported {loaded}")


def phase_mesh(jax, devices):
    """parallel/spmd.py on four GPUs, checked like tests/test_spmd.py."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.agents import drqn as DR
    from merging_gym_tpu.agents import hdqn as H
    from merging_gym_tpu.agents import rainbow as R
    from merging_gym_tpu.core.env import EnvParams
    from merging_gym_tpu.nn.mlp import qnet_apply, qnet_init
    from merging_gym_tpu.parallel import spmd
    from merging_gym_tpu.parallel.mesh import make_mesh

    env = EnvParams()
    n_envs, steps, chunks = 1024, 100, 2

    def check_run(tag, mesh, init, chunk, cfg, params_of, sharded_of):
        carry = init(jax.random.key(0), cfg, env, num_envs=n_envs, mesh=mesh)
        for _ in range(chunks):
            carry = chunk(mesh, cfg, env, carry, steps)
        jax.block_until_ready(carry)
        m = carry.metrics
        if int(m.env_steps) != chunks * steps * n_envs:
            raise CheckFailed(f"{tag}: psum'd env_steps {int(m.env_steps)} "
                              f"!= {chunks * steps * n_envs}")
        # Every counter is a replicated psum: all four copies agree.
        for k in ("episodes", "collisions", "wins"):
            vals = {int(s.data) for s in getattr(m, k).addressable_shards}
            if len(vals) != 1:
                raise CheckFailed(f"{tag}: {k} differs across devices {vals}")
        for leaf in jax.tree.leaves(params_of(carry)):
            by_index = {}
            for s in leaf.addressable_shards:
                by_index.setdefault(str(s.index), []).append(np.asarray(s.data))
            for copies in by_index.values():
                for c in copies[1:]:
                    check_equal(f"{tag} replicated params", c, copies[0])
        shards = sharded_of(carry).addressable_shards
        on = sorted({s.data.devices().pop().id for s in shards})
        if on != sorted(d.id for d in mesh.devices.flat):
            raise CheckFailed(f"{tag}: env shards live on devices {on}")
        print(f"--gpus 4: {tag}: {int(m.env_steps)} env steps, "
              f"{int(m.episodes)} episodes; params bitwise identical on "
              f"{len(mesh.devices.flat)} devices; env shards on devices {on}")

    dcfg = D.DQNConfig(memory_capacity=2048, opponent=D.OPP_SELFPLAY)
    for dp, tp in ((4, 1), (2, 2)):
        mesh = make_mesh(data=dp, model=tp, devices=devices)
        check_run(f"dqn data={dp} model={tp}", mesh, spmd.spmd_train_init,
                  spmd.spmd_train_chunk, dcfg, lambda c: c.dqn.params,
                  lambda c: c.env_state.pos)
    mesh = make_mesh(data=4, model=1, devices=devices)
    check_run("rainbow data=4", mesh, spmd.spmd_rainbow_init,
              spmd.spmd_rainbow_chunk,
              R.RainbowConfig(memory_capacity=4096, per=True, n_step=3,
                              obs_scale=0.01, pmean_axis="data"),
              lambda c: c.params, lambda c: c.env_state.pos)
    check_run("hdqn data=4", mesh, spmd.spmd_hdqn_init, spmd.spmd_hdqn_chunk,
              H.HDQNConfig(memory_capacity=2048, opponent=D.OPP_SELFPLAY,
                           pmean_axis="data"),
              lambda c: (c.lower.params, c.upper.params),
              lambda c: c.env_state.pos)
    check_run("drqn data=4", mesh, spmd.spmd_drqn_init, spmd.spmd_drqn_chunk,
              DR.DRQNConfig(memory_capacity=2048, opponent=D.OPP_SELFPLAY,
                            pmean_axis="data"),
              lambda c: c.params, lambda c: c.env_state.pos)

    tp_mesh = make_mesh(data=1, model=4, devices=devices)
    params = qnet_init(jax.random.key(2), 10, 5, (1024, 512))
    x = jax.random.normal(jax.random.key(3), (256, 10), jnp.float32)
    specs = spmd.qnet_pspecs(params)
    sharded = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(tp_mesh, s), specs,
        is_leaf=lambda v: isinstance(v, P)))
    fn = jax.jit(jax.shard_map(spmd.qnet_apply_tp, mesh=tp_mesh,
                               in_specs=(specs, P()), out_specs=P(),
                               check_vma=False))
    with jax.default_matmul_precision("highest"):
        got = np.asarray(fn(sharded, x))
        want = np.asarray(jax.jit(qnet_apply)(params, x))
    err = check_close("tensor-parallel forward", got, want, 0.0, 1e-5)
    print(f"--gpus 4: tensor-parallel Q-net forward (1024x512 over model=4) "
          f"= unsharded forward at highest precision, max |err| {err:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                    help="4 runs only the four-GPU data/tensor-parallel path")
    args = ap.parse_args(argv)

    import jax

    from merging_gym_tpu.utils import compile_cache

    compile_cache.enable()
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.gpus:
        print(f"chip_smoke needs {args.gpus} GPU(s); JAX found "
              f"{len(devices)} x {devices[0].platform}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.gpus == 4:
        print(f"card: {card_line()}")
        phase_mesh(jax, devices[:4])
    else:
        phase_device(jax)
        phase_rollout(jax)
        phase_train(jax)
        phase_eval(jax)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
