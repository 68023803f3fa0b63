"""Pure-functional two-player merging environment.

Device-first redesign of the reference ``MergeEnv`` (merging_gym/envs/
merging_env.py:72-230): the mutable gym class becomes a state PyTree plus
pure ``reset``/``step`` functions that jit, vmap and shard.  Rendering,
experiment screens and human input live in :mod:`merging_gym_tpu.ui`,
fully decoupled from this compute core.

Semantics are faithful to the reference step function
(merging_env.py:138-195) including its quirks:

* player 1 wins on ``pos > END_POINT`` (strict) but player 2 on ``>=``
  (merging_env.py:163,173);
* a player that already won has its per-step reward overwritten to 0
  (merging_env.py:167-168, 177-178) -- *before* any collision penalty is
  added;
* the first crosser gets ``RFirst`` but the episode continues until the
  second crosser (``RSecond``, done), a collision, or the timeout;
* ``action2 is None`` forces player 2's acceleration to 0 (the level-0
  constant-velocity opponent, merging_env.py:152) -- encoded here as the
  sentinel ``ACTION_NONE`` (-1) so the whole thing stays jittable;
* the timeout triggers on step 2501, matching the reference's float64
  ``time_stamp`` accumulation (see constants.TIMEOUT_STEPS).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from merging_gym_tpu.utils import struct

from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core.control import action_to_acc
from merging_gym_tpu.core.geometry import is_collided, lon2coord


@struct.dataclass
class EnvParams:
    """Reward/start-distribution parameters (merging_env.py:27-32,216-221).

    All reward fields are PyTree leaves so they can be swept under jit
    without recompilation; ``random_start`` selects the commented-out
    randomised start mode of the reference (merging_env.py:219-221).
    """

    r_first: float = C.R_FIRST
    r_second: float = C.R_SECOND
    r_collision: float = C.R_COLLISION
    vel_penalty: float = C.VEL_PENALTY
    time_penalty: float = C.TIME_PENALTY
    random_start: bool = struct.field(pytree_node=False, default=False)
    max_steps: int = struct.field(pytree_node=False, default=C.TIMEOUT_STEPS)

    def reward_tuple(self):
        """Mirror of ``MergeEnv.show_reward`` (merging_env.py:115-116)."""
        return (self.r_first, self.r_second, self.r_collision, self.vel_penalty)


@struct.dataclass
class EnvState:
    """Complete per-env simulation state; index 0 = player 1, 1 = player 2."""

    pos: jax.Array     # f[2] longitudinal arc positions
    vel: jax.Array     # f[2] velocities
    acc: jax.Array     # f[2] last applied accelerations
    t: jax.Array       # i32 step counter (time = t * DT)
    winner: jax.Array  # i32: 0 = none, 1, 2
    done: jax.Array    # bool
    r_acc: jax.Array   # f[2] accumulated rewards (merging_env.py:191-192)


@struct.dataclass
class TimeStep:
    """Everything ``MergeEnv.step`` returns, as stacked arrays."""

    obs: jax.Array        # f[10] player-1-centric observation
    rewards: jax.Array    # f[2]
    done: jax.Array       # bool
    collision: jax.Array  # bool   (info["collision"])
    winner: jax.Array     # i32    (env.winner after the step)
    actions: jax.Array    # i32[2] the actions that produced this step


def observe(state: EnvState) -> jax.Array:
    """10-dim mirrored two-player observation (merging_env.py:118-132)."""
    x1, y1 = lon2coord(state.pos[0], +1.0)
    x2, y2 = lon2coord(state.pos[1], -1.0)
    v1, v2 = state.vel[0], state.vel[1]
    return jnp.stack(
        [
            x2 - x1,
            y2 - y1,
            v2 - v1,
            C.END_POINT - state.pos[0],
            v1,
            x1 - x2,
            y1 - y2,
            v1 - v2,
            C.END_POINT - state.pos[1],
            v2,
        ]
    )


def swap_obs(obs: jax.Array) -> jax.Array:
    """Player-2 view of an observation: the ``state[5:] + state[:5]`` swap
    used for opponents throughout the reference (scripts/main.py:199,
    hdqn.py:285, human_player.py:40-41)."""
    return jnp.roll(obs, C.OBS_DIM // 2, axis=-1)


def reset(params: EnvParams, key: jax.Array | None = None,
          dtype=jnp.float32) -> EnvState:
    """Deterministic or randomised start (merging_env.py:208-230)."""
    if params.random_start:
        assert key is not None, "random_start requires a PRNG key"
        k1, k2, k3, k4 = jax.random.split(key, 4)
        pos1 = C.START_POINT + jax.random.normal(k1, dtype=dtype) * 5.0
        vel1 = C.START_VEL + jax.random.normal(k2, dtype=dtype) * 3.0
        pos2 = C.START_POINT + jax.random.uniform(
            k3, dtype=dtype, minval=-C.VEHICLE_H / 2, maxval=C.VEHICLE_H / 2)
        vel2 = C.START_VEL + jax.random.uniform(
            k4, dtype=dtype, minval=-5.0, maxval=10.0)
        pos = jnp.stack([pos1, pos2])
        vel = jnp.stack([vel1, vel2])
    else:
        pos = jnp.full((2,), C.START_POINT, dtype)
        vel = jnp.full((2,), C.START_VEL, dtype)
    return EnvState(
        pos=pos,
        vel=vel,
        acc=jnp.zeros((2,), dtype),
        t=jnp.zeros((), jnp.int32),
        winner=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        r_acc=jnp.zeros((2,), dtype),
    )


def step(params: EnvParams, state: EnvState, actions: jax.Array):
    """One simulation step for both players.

    ``actions`` is an int32[2] vector of discrete actions in [0, 5); the
    sentinel ``ACTION_NONE`` (-1) for either player forces that player's
    acceleration to 0, reproducing ``action2=None`` (merging_env.py:152).

    Returns ``(next_state, TimeStep)``.  Like the reference, stepping a
    done env keeps evolving it; auto-reset lives in core.vector.
    """
    dtype = state.pos.dtype
    actions = jnp.asarray(actions, jnp.int32)
    targets = jnp.asarray(C.TARGET_VELS, dtype)

    # --- dynamics (merging_env.py:147-154) ---------------------------------
    is_null = actions < 0
    acc = jnp.where(
        is_null,
        jnp.zeros((2,), dtype),
        action_to_acc(state.vel, targets[jnp.clip(actions, 0, C.NUM_ACTIONS - 1)]),
    )
    vel = jnp.maximum(jnp.zeros((), dtype), state.vel + acc * C.DT)
    pos = state.pos + vel * C.DT

    t = state.t + 1
    done = state.done | (t >= params.max_steps)

    # --- velocity-tracking penalty (merging_env.py:158-159) ----------------
    pen = -params.time_penalty - params.vel_penalty * jnp.abs(vel - C.V_REF)

    # --- first/second-across state machine (merging_env.py:163-181) --------
    w0 = state.winner
    c1 = pos[0] > C.END_POINT          # strict for player 1 (:163)
    r1 = jnp.where(
        c1,
        jnp.where(w0 == 0, pen[0] + params.r_first,
                  jnp.where(w0 == 1, jnp.zeros((), dtype),
                            pen[0] + params.r_second)),
        pen[0],
    )
    done = done | (c1 & (w0 == 2))
    w1 = jnp.where(c1 & (w0 == 0), 1, w0)

    c2 = pos[1] >= C.END_POINT         # inclusive for player 2 (:173)
    r2 = jnp.where(
        c2,
        jnp.where(w1 == 0, pen[1] + params.r_first,
                  jnp.where(w1 == 2, jnp.zeros((), dtype),
                            pen[1] + params.r_second)),
        pen[1],
    )
    done = done | (c2 & (w1 == 1))
    w2 = jnp.where(c2 & (w1 == 0), 2, w1)

    # --- collision (merging_env.py:183-187) --------------------------------
    x1, y1 = lon2coord(pos[0], +1.0)
    x2, y2 = lon2coord(pos[1], -1.0)
    collision = is_collided(x1, y1, x2, y2)
    done = done | collision
    rewards = jnp.stack([r1, r2]) + jnp.where(collision, params.r_collision, 0.0).astype(dtype)

    next_state = EnvState(
        pos=pos,
        vel=vel,
        acc=acc,
        t=t,
        winner=w2,
        done=done,
        r_acc=state.r_acc + rewards,
    )
    ts = TimeStep(
        obs=observe(next_state),
        rewards=rewards,
        done=done,
        collision=collision,
        winner=w2,
        actions=actions,
    )
    return next_state, ts
