"""The whole vectorised env rollout as one GPU kernel (Pallas, Triton route).

Every env is independent and its state is six numbers (two positions, two
velocities, the winner machine and the step counter), so one program of
the kernel owns a tile of ``block_envs`` envs, keeps their state in
registers and runs the whole horizon in a ``fori_loop``.  The plain XLA
rollout (``core.vector.rollout``) instead runs each env step as one
while-loop trip of several small kernels.

Layouts are env-last, so each per-step store is contiguous along the env
axis: trajectories are ``[T, c, N]``, actions ``[T, 2, N]``.  The grid has
``cdiv(N, block_envs)`` programs and the tail tile is masked, so any
``num_envs`` works.

Two action sources:

* ``actions=`` -- precomputed i32[T, 2, N] (``-1`` is the ACTION_NONE arm);
* ``seed=`` -- uniform joint actions in [-1, 5) from the counter-based
  generator of ``core.counter_rng``, keyed by (seed, env, step).  The
  stream depends on the seed alone, not on the tiling.

Two outputs: ``fused_rollout`` stores the per-step trajectory;
``fused_rollout_counters`` keeps per-env outcome counters in registers
and stores them once.

Deterministic starts only (the auto-reset writes constants); randomised
starts stay on the XLA path.  ``reference_rollout`` and
``reference_rollout_counters`` are that plain path with the same action
streams: the tests' reference and the baseline the kernel is timed
against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core import counter_rng
from merging_gym_tpu.core.env import EnvParams
from merging_gym_tpu.core.geometry import lon2coord, round_half_away
from merging_gym_tpu.core.vector import autoreset_step, reset_batch, rollout

# Envs per program and warps per program: one env per thread, 32 envs per
# program.  Fastest of the sweep in benchmarks/rollout_kernel.py at 4,096
# envs on an H100, and within 11% of the fastest at 65,536 envs (PERF.md,
# "Kernel decisions").
BLOCK_ENVS = 32
NUM_WARPS = 1

TRAJ_KEYS = ("obs", "rewards", "done", "winner", "collision")


def _player_step(pos, vel, action, pen_fn):
    """Dynamics of one player (mirrors core.env.step, same f32 ops)."""
    tv = 10.0 * jnp.clip(action, 0, C.NUM_ACTIONS - 1).astype(jnp.float32)
    acc = jnp.where(action < 0, 0.0, (tv - vel) / C.PREDICTION_T)
    vel = jnp.maximum(0.0, vel + acc * C.DT)
    pos = pos + vel * C.DT
    return pos, vel, pen_fn(vel)


def _env_step(state, a1, a2, rcfg, max_steps):
    """One step of a tile of envs, all state as per-env vectors.

    Mirrors core.env.step: the reference's first/second-across winner
    machine, the velocity penalty and the rounded-box collision test.
    """
    pos1, pos2, vel1, vel2, winner, tcnt = state
    r_first, r_second, r_collision, vel_penalty, time_penalty = rcfg

    def pen_fn(v):
        return -time_penalty - vel_penalty * jnp.abs(v - C.V_REF)

    pos1, vel1, pen1 = _player_step(pos1, vel1, a1, pen_fn)
    pos2, vel2, pen2 = _player_step(pos2, vel2, a2, pen_fn)

    tcnt = tcnt + 1
    done = tcnt >= max_steps

    c1 = pos1 > C.END_POINT
    r1 = jnp.where(c1, jnp.where(winner == 0, pen1 + r_first,
                                 jnp.where(winner == 1, 0.0, pen1 + r_second)),
                   pen1)
    done = done | (c1 & (winner == 2))
    w1 = jnp.where(c1 & (winner == 0), 1, winner)

    c2 = pos2 >= C.END_POINT
    r2 = jnp.where(c2, jnp.where(w1 == 0, pen2 + r_first,
                                 jnp.where(w1 == 2, 0.0, pen2 + r_second)),
                   pen2)
    done = done | (c2 & (w1 == 1))
    w2 = jnp.where(c2 & (w1 == 0), 2, w1)

    x1, y1 = lon2coord(pos1, +1.0)
    x2, y2 = lon2coord(pos2, -1.0)
    col = ((jnp.abs(round_half_away(x1) - round_half_away(x2)) <= C.VEHICLE_H)
           & (jnp.abs(round_half_away(y1) - round_half_away(y2)) <= C.VEHICLE_W))
    done = done | col
    bonus = jnp.where(col, r_collision, 0.0)
    obs = (x2 - x1, y2 - y1, vel2 - vel1, C.END_POINT - pos1, vel1,
           x1 - x2, y1 - y2, vel1 - vel2, C.END_POINT - pos2, vel2)
    return ((pos1, pos2, vel1, vel2, w2, tcnt), done, col,
            (r1 + bonus, r2 + bonus), obs)


def _reset_where(done, state):
    pos1, pos2, vel1, vel2, winner, tcnt = state
    return (jnp.where(done, C.START_POINT, pos1),
            jnp.where(done, C.START_POINT, pos2),
            jnp.where(done, C.START_VEL, vel1),
            jnp.where(done, C.START_VEL, vel2),
            jnp.where(done, 0, winner),
            jnp.where(done, 0, tcnt))


def _kernel(rcfg_ref, seed_ref, actions_ref, *out_refs, num_envs, num_steps,
            block, max_steps, use_seed, counters):
    env = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    live = env < num_envs
    rcfg = tuple(rcfg_ref[k] for k in range(5))
    if use_seed:
        key = counter_rng.env_key(seed_ref[0], env)

    f32 = functools.partial(jnp.full, (block,), dtype=jnp.float32)
    i32 = functools.partial(jnp.full, (block,), dtype=jnp.int32)
    state = (f32(C.START_POINT), f32(C.START_POINT), f32(C.START_VEL),
             f32(C.START_VEL), i32(0), i32(0))
    acc0 = (f32(0.0), f32(0.0), i32(0), i32(0), i32(0), i32(0))

    def body(t, carry):
        state, acc = carry
        if use_seed:
            a1, a2 = counter_rng.step_actions(key, t)
        else:
            a1 = plgpu.load(actions_ref.at[t, 0, env], mask=live, other=0)
            a2 = plgpu.load(actions_ref.at[t, 1, env], mask=live, other=0)
        state, done, col, rew, obs = _env_step(state, a1, a2, rcfg, max_steps)
        winner = state[4]
        if counters:
            acc = (acc[0] + rew[0], acc[1] + rew[1],
                   acc[2] + done.astype(jnp.int32),
                   acc[3] + col.astype(jnp.int32),
                   acc[4] + (done & (winner == 1) & ~col).astype(jnp.int32),
                   acc[5] + (done & (winner == 2) & ~col).astype(jnp.int32))
        else:
            obs_ref, rew_ref, done_ref, win_ref, col_ref = out_refs
            for k, v in enumerate(obs):
                plgpu.store(obs_ref.at[t, k, env], v, mask=live)
            for k, v in enumerate(rew):
                plgpu.store(rew_ref.at[t, k, env], v, mask=live)
            plgpu.store(done_ref.at[t, env], done.astype(jnp.int32), mask=live)
            plgpu.store(win_ref.at[t, env], winner, mask=live)
            plgpu.store(col_ref.at[t, env], col.astype(jnp.int32), mask=live)
        return _reset_where(done, state), acc

    _, acc = lax.fori_loop(0, num_steps, body, (state, acc0))
    if counters:
        rew_ref, cnt_ref = out_refs
        for k in range(2):
            plgpu.store(rew_ref.at[k, env], acc[k], mask=live)
        for k in range(4):
            plgpu.store(cnt_ref.at[k, env], acc[2 + k], mask=live)


@functools.partial(jax.jit, static_argnames=(
    "num_steps", "num_envs", "max_steps", "use_seed", "counters",
    "block_envs", "num_warps", "interpret"))
def _call(rcfg, seed, actions, *, num_steps, num_envs, max_steps, use_seed,
          counters, block_envs, num_warps, interpret):
    T, N = num_steps, num_envs
    if counters:
        out_shape = (jax.ShapeDtypeStruct((2, N), jnp.float32),
                     jax.ShapeDtypeStruct((4, N), jnp.int32))
    else:
        out_shape = (jax.ShapeDtypeStruct((T, 10, N), jnp.float32),
                     jax.ShapeDtypeStruct((T, 2, N), jnp.float32),
                     jax.ShapeDtypeStruct((T, N), jnp.int32),
                     jax.ShapeDtypeStruct((T, N), jnp.int32),
                     jax.ShapeDtypeStruct((T, N), jnp.int32))
    kernel = functools.partial(
        _kernel, num_envs=N, num_steps=T, block=block_envs,
        max_steps=max_steps, use_seed=use_seed, counters=counters)
    out = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(pl.cdiv(N, block_envs),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="fused_rollout_counters" if counters else "fused_rollout",
    )(rcfg, seed, actions)
    if counters:
        rewsum, counts = out
        return {"reward_sum": rewsum, "episodes": counts[0],
                "collisions": counts[1], "wins1": counts[2],
                "wins2": counts[3]}
    obs, rewards, done, winner, col = out
    return {"obs": obs, "rewards": rewards, "done": done.astype(bool),
            "winner": winner, "collision": col.astype(bool)}


def _check_args(num_steps, num_envs, actions, seed, env_params):
    if (actions is None) == (seed is None):
        raise ValueError("pass exactly one of actions= and seed=")
    if num_steps < 1 or num_envs < 1:
        raise ValueError(f"need num_steps >= 1 and num_envs >= 1, got "
                         f"{num_steps}, {num_envs}")
    env_params = EnvParams() if env_params is None else env_params
    if env_params.random_start:
        raise ValueError("the rollout kernel has deterministic starts only; "
                         "randomised starts run on core.vector.rollout")
    if actions is not None:
        actions = jnp.asarray(actions, jnp.int32)
        if actions.shape != (num_steps, 2, num_envs):
            raise ValueError(f"actions must be i32[{num_steps}, 2, "
                             f"{num_envs}], got {actions.shape}")
    return actions, env_params


def _run(num_steps, num_envs, actions, seed, env_params, counters,
         block_envs, num_warps, interpret):
    actions, env_params = _check_args(num_steps, num_envs, actions, seed,
                                      env_params)
    if block_envs < 1 or block_envs & (block_envs - 1):
        raise ValueError(f"block_envs must be a power of two, got "
                         f"{block_envs}")
    if not counters and num_steps * 10 * num_envs >= 2 ** 31:
        # The kernel addresses the obs trajectory with int32 offsets.
        raise ValueError(f"a {num_steps}-step trajectory of {num_envs} envs "
                         "is too large for one launch; split the steps")
    rcfg = jnp.asarray([env_params.r_first, env_params.r_second,
                        env_params.r_collision, env_params.vel_penalty,
                        env_params.time_penalty], jnp.float32)
    use_seed = actions is None
    if use_seed:
        actions = jnp.zeros((1, 2, 1), jnp.int32)   # never read
    seed = jnp.asarray([0 if seed is None else seed], jnp.int32)
    return _call(rcfg, seed, actions, num_steps=num_steps, num_envs=num_envs,
                 max_steps=env_params.max_steps, use_seed=use_seed,
                 counters=counters, block_envs=block_envs,
                 num_warps=num_warps, interpret=interpret)


def fused_rollout(num_steps: int, num_envs: int, actions=None, seed=None,
                  env_params: EnvParams | None = None, *,
                  block_envs: int = BLOCK_ENVS, num_warps: int = NUM_WARPS,
                  interpret: bool = False):
    """Run ``num_steps`` auto-resetting steps of ``num_envs`` envs.

    Exactly one of ``actions`` (i32[T, 2, N]) and ``seed`` (int) is given.
    Returns ``{"obs": f32[T, 10, N], "rewards": f32[T, 2, N],
    "done"/"collision": bool[T, N], "winner": i32[T, N]}`` -- the
    pre-reset step outputs, as ``core.vector.autoreset_step`` returns them.
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests).
    """
    return _run(num_steps, num_envs, actions, seed, env_params, False,
                block_envs, num_warps, interpret)


def fused_rollout_counters(num_steps: int, num_envs: int, actions=None,
                           seed=None, env_params: EnvParams | None = None, *,
                           block_envs: int = BLOCK_ENVS,
                           num_warps: int = NUM_WARPS,
                           interpret: bool = False):
    """Same rollout as ``fused_rollout``, reduced to per-env counters.

    Returns ``{"reward_sum": f32[2, N], "episodes", "collisions", "wins1",
    "wins2": i32[N]}`` where, summed over steps, episodes counts ``done``,
    collisions counts ``collision``, and winsP counts
    ``done & winner == P & ~collision``.
    """
    return _run(num_steps, num_envs, actions, seed, env_params, True,
                block_envs, num_warps, interpret)


# --------------------------------------------------------------------------
# Plain XLA reference: core.vector's auto-reset step under lax.scan, fed the
# same action streams.  Trajectories keep core.vector's own env-first
# layout (obs f32[T, N, 10], rewards f32[T, N, 2]); counters are the
# kernel's ([2, N] and [N]).
# --------------------------------------------------------------------------

def _policy(actions, seed, num_envs):
    env = jnp.arange(num_envs, dtype=jnp.int32)
    key = None if seed is None else counter_rng.env_key(seed, env)

    def policy(t, obs, rng):
        del obs, rng
        if key is None:
            a = actions[t].T
        else:
            a = jnp.stack(counter_rng.step_actions(key, t), axis=-1)
        return t + 1, a

    return policy


@functools.partial(jax.jit, static_argnames=("num_steps", "num_envs",
                                             "counters"))
def _reference(actions, seed, env_params, *, num_steps, num_envs, counters):
    policy = _policy(actions, seed, num_envs)
    state = reset_batch(env_params, jax.random.key(0), num_envs)
    if not counters:
        _, ts = rollout(env_params, state, policy, jnp.int32(0),
                        jax.random.key(0), num_steps)
        return {k: getattr(ts, k) for k in TRAJ_KEYS}

    def body(carry, _):
        state, t, rew, cnt = carry
        t, a = policy(t, None, None)
        state, ts = autoreset_step(env_params, state, a, jax.random.key(0))
        won = ts.done & ~ts.collision
        inc = jnp.stack([ts.done, ts.collision, won & (ts.winner == 1),
                         won & (ts.winner == 2)]).astype(jnp.int32)
        return (state, t, rew + ts.rewards.T, cnt + inc), None

    zeros = (jnp.zeros((2, num_envs), jnp.float32),
             jnp.zeros((4, num_envs), jnp.int32))
    (_, _, rew, cnt), _ = lax.scan(body, (state, jnp.int32(0), *zeros), None,
                                   length=num_steps)
    return {"reward_sum": rew, "episodes": cnt[0], "collisions": cnt[1],
            "wins1": cnt[2], "wins2": cnt[3]}


def reference_rollout(num_steps: int, num_envs: int, actions=None, seed=None,
                      env_params: EnvParams | None = None):
    """``fused_rollout``'s result computed by ``core.vector.rollout``.

    ``obs`` and ``rewards`` are env-first (f32[T, N, 10], f32[T, N, 2]),
    the XLA rollout's own layout; the other keys match the kernel's."""
    actions, env_params = _check_args(num_steps, num_envs, actions, seed,
                                      env_params)
    return _reference(actions, seed, env_params, num_steps=num_steps,
                      num_envs=num_envs, counters=False)


def reference_rollout_counters(num_steps: int, num_envs: int, actions=None,
                               seed=None, env_params: EnvParams | None = None):
    """``fused_rollout_counters``' result computed by the plain XLA scan."""
    actions, env_params = _check_args(num_steps, num_envs, actions, seed,
                                      env_params)
    return _reference(actions, seed, env_params, num_steps=num_steps,
                      num_envs=num_envs, counters=True)
