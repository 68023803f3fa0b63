"""Hierarchical goal-conditioned DQN (h-DQN) -- vectorised, on-device.

Redesign of the reference HDQN trainer (scripts/hdqn.py): the
meta-controller (``Goal_DQN``, hdqn.py:58-139) picks one of 3 goals, the
low-level controller (``HDQN``, hdqn.py:142-221) picks velocity actions
conditioned on ``[goal] + obs`` (11-dim input, hdqn.py:146,291), and the
intrinsic reward is 1.0 iff the chosen goal matches the achieved
``goal_status`` (hdqn.py:223-236,314).

The reference's data-dependent two-timescale loop (outer goal loop, inner
action loop, hdqn.py:281-327) cannot vmap; the vectorised form carries a
per-env ``goal`` and an ``option_start`` mask, preserving the reference's
quirks:

* the goal is re-chosen after *every* env step (hdqn.py:303), so an
  option can drift mid-execution -- intrinsic reward compares the *newly*
  chosen goal against the status of the *pre-step* state (hdqn.py:314);
* an option ends when the env is done or the (new) goal matches the (new)
  state's status (hdqn.py:322-323);
* the meta transition is stored at option end as
  ``(state, goal, extrinsic_return, next_state)`` where, because
  ``state = next_state`` ran just before the break, both observations are
  the *final* state (hdqn.py:320,325) -- set ``faithful_meta=False`` for
  the textbook (option-start-obs, option-end-obs) pair;
* no winner-based store gating and unconditional reward accumulation
  (hdqn.py:312,316), unlike the flat DQN trainer;
* goal memory is tiny: 200 slots (hdqn.py:22,75).
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from merging_gym_tpu.utils import struct

from merging_gym_tpu.agents import dqn as D
from merging_gym_tpu.agents.policies import EPSILON, eps_greedy_from_q
from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core import env as core_env
from merging_gym_tpu.core.env import EnvParams, swap_obs
from merging_gym_tpu.core.vector import autoreset_step, observe_after_reset, reset_batch
from merging_gym_tpu.nn.mlp import qnet_apply, qnet_init
from merging_gym_tpu.ops import replay as rp


def goal_status(obs: jax.Array) -> jax.Array:
    """Discretise relative longitudinal position into 3 classes
    (hdqn.py:223-236): dx1 < -0.5*v2 -> 0 (behind); < 0.5*v2 -> 1
    (alongside); else 2 (ahead).  ``obs`` may be batched."""
    dx1 = obs[..., 0]
    v2 = obs[..., 9]
    return jnp.where(dx1 < -0.5 * v2, 0,
                     jnp.where(dx1 < 0.5 * v2, 1, 2)).astype(jnp.int32)


def goal_obs(goal: jax.Array, obs: jax.Array) -> jax.Array:
    """``[goal] + state`` input of the low-level net (hdqn.py:291)."""
    return jnp.concatenate(
        [goal[..., None].astype(obs.dtype), obs], axis=-1)


@struct.dataclass
class HDQNConfig:
    batch_size: int = struct.field(pytree_node=False, default=128)
    lr: float = struct.field(pytree_node=False, default=0.01)
    gamma: float = struct.field(pytree_node=False, default=0.90)
    epsilon: float = struct.field(pytree_node=False, default=EPSILON)
    memory_capacity: int = struct.field(pytree_node=False, default=2000)
    goal_memory_capacity: int = struct.field(pytree_node=False, default=200)
    target_sync: int = struct.field(pytree_node=False, default=100)
    obs_dim: int = struct.field(pytree_node=False, default=C.OBS_DIM)
    num_actions: int = struct.field(pytree_node=False, default=C.NUM_ACTIONS)
    num_goals: int = struct.field(pytree_node=False, default=C.NUM_GOALS)
    hidden: tuple = struct.field(pytree_node=False, default=(200, 100))
    mask_terminal: bool = struct.field(pytree_node=False, default=False)
    opponent: str = struct.field(pytree_node=False, default=D.OPP_L0)
    # Faithful default kept deliberately: the 6-seed ablation
    # (docs/parity/ablations.json hdqn_meta, summarized in
    # docs/parity/README.md) shows the duplicated-state meta transition
    # does NOT destabilize training relative to the textbook transition
    # -- both modes have the same (large, seed-dominated) variance bands.
    faithful_meta: bool = struct.field(pytree_node=False, default=True)
    # Set by parallel.spmd for data-parallel training: psum'd metrics,
    # pmean'd gradients, globally agreed learn gates.
    pmean_axis: str | None = struct.field(pytree_node=False, default=None)
    # Mixed precision for both learners' forwards (agents.dqn contract:
    # bf16 matmul operands, f32 masters/moments).
    compute_dtype: str = struct.field(pytree_node=False, default="float32")

    def lower_cfg(self) -> D.DQNConfig:
        return D.DQNConfig(
            batch_size=self.batch_size, lr=self.lr, gamma=self.gamma,
            epsilon=self.epsilon, memory_capacity=self.memory_capacity,
            target_sync=self.target_sync, obs_dim=self.obs_dim + 1,
            num_actions=self.num_actions, hidden=self.hidden,
            mask_terminal=self.mask_terminal,
            compute_dtype=self.compute_dtype)

    def upper_cfg(self) -> D.DQNConfig:
        return D.DQNConfig(
            batch_size=self.batch_size, lr=self.lr, gamma=self.gamma,
            epsilon=self.epsilon, memory_capacity=self.goal_memory_capacity,
            target_sync=self.target_sync, obs_dim=self.obs_dim,
            num_actions=self.num_goals, hidden=self.hidden,
            mask_terminal=self.mask_terminal,
            compute_dtype=self.compute_dtype)


@struct.dataclass
class HDQNCarry:
    env_state: Any
    obs: jax.Array
    goal: jax.Array          # i32[num_envs] current option
    goal_op: jax.Array       # i32[num_envs] opponent option (frozen/selfplay)
    option_start_obs: jax.Array  # f[num_envs, obs_dim] (textbook meta mode)
    option_start: jax.Array  # bool[num_envs]
    extr_return: jax.Array   # f[num_envs] per-option extrinsic return
    ep_reward: jax.Array
    upper: D.DQNState
    lower: D.DQNState
    opp_upper_params: Any
    opp_lower_params: Any
    upper_replay: rp.ReplayState
    lower_replay: rp.ReplayState
    key: jax.Array
    metrics: D.Metrics


def hdqn_init(key: jax.Array, cfg: HDQNConfig, env_params: EnvParams,
              num_envs: int, opp_upper=None, opp_lower=None) -> HDQNCarry:
    k_env, k_up, k_lo, k_run = jax.random.split(key, 4)
    env_state = reset_batch(env_params, k_env, num_envs)
    obs = jax.vmap(core_env.observe)(env_state)
    upper = D.dqn_init(k_up, cfg.upper_cfg())
    lower = D.dqn_init(k_lo, cfg.lower_cfg())
    if cfg.opponent != D.OPP_FROZEN:
        opp_upper, opp_lower = upper.params, lower.params
    assert opp_upper is not None and opp_lower is not None
    upper_replay = rp.replay_init(cfg.goal_memory_capacity,
                                  D.transition_example(cfg.upper_cfg()))
    lower_replay = rp.replay_init(cfg.memory_capacity,
                                  D.transition_example(cfg.lower_cfg()))
    return HDQNCarry(
        env_state=env_state, obs=obs,
        goal=jnp.zeros((num_envs,), jnp.int32),
        goal_op=jnp.zeros((num_envs,), jnp.int32),
        option_start_obs=obs.astype(jnp.float32),
        option_start=jnp.ones((num_envs,), bool),
        extr_return=jnp.zeros((num_envs,), jnp.float32),
        ep_reward=jnp.zeros((num_envs,), jnp.float32),
        upper=upper, lower=lower,
        opp_upper_params=opp_upper, opp_lower_params=opp_lower,
        upper_replay=upper_replay, lower_replay=lower_replay,
        key=k_run, metrics=D.Metrics.zero(),
    )


def _choose_goals(params, obs, key, cfg: HDQNConfig):
    n = obs.shape[0]
    q = qnet_apply(params, obs)
    return jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
        q, jax.random.split(key, n), cfg.epsilon, cfg.num_goals)


def _choose_actions_lower(params, goal, obs, key, cfg: HDQNConfig):
    n = obs.shape[0]
    q = qnet_apply(params, goal_obs(goal, obs))
    return jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
        q, jax.random.split(key, n), cfg.epsilon, cfg.num_actions)


def hdqn_step(cfg: HDQNConfig, env_params: EnvParams, carry: HDQNCarry, _):
    key, k_g0, k_a1, k_g2, k_a2, k_reset, k_ls, k_us, k_g1 = \
        jax.random.split(carry.key, 9)
    obs = carry.obs

    # Fresh options where the previous one ended (outer loop top,
    # hdqn.py:283-286): re-choose the goal and zero the extrinsic return.
    goal_fresh = _choose_goals(carry.upper.params, obs, k_g0, cfg)
    goal = jnp.where(carry.option_start, goal_fresh, carry.goal)
    extr = jnp.where(carry.option_start, 0.0, carry.extr_return)
    start_obs = jnp.where(carry.option_start[:, None],
                          obs.astype(jnp.float32), carry.option_start_obs)

    # Opponent goal refreshed at the same boundaries (hdqn.py:285).
    opp_obs = swap_obs(obs)
    if cfg.opponent == D.OPP_L0:
        goal_op = carry.goal_op
        a2 = jnp.full((obs.shape[0],), C.ACTION_NONE, jnp.int32)
    else:
        up_op = (carry.upper.params if cfg.opponent == D.OPP_SELFPLAY
                 else carry.opp_upper_params)
        lo_op = (carry.lower.params if cfg.opponent == D.OPP_SELFPLAY
                 else carry.opp_lower_params)
        goal_op_fresh = _choose_goals(up_op, opp_obs, k_g1, cfg)
        goal_op = jnp.where(carry.option_start, goal_op_fresh, carry.goal_op)
        a2 = _choose_actions_lower(lo_op, goal_op, opp_obs, k_a2, cfg)

    a1 = _choose_actions_lower(carry.lower.params, goal, obs, k_a1, cfg)
    actions = jnp.stack([a1, a2], axis=-1)
    env_state, ts = autoreset_step(env_params, carry.env_state, actions, k_reset)
    next_obs_env = observe_after_reset(env_params, env_state, ts)

    # Goal re-chosen from the post-step state every step (hdqn.py:303).
    goal_new = _choose_goals(carry.upper.params, ts.obs, k_g2, cfg)

    # Intrinsic reward: new goal vs pre-step status (hdqn.py:314).
    intrinsic = (goal_new == goal_status(obs)).astype(jnp.float32)

    lower_items = {
        "obs": goal_obs(goal, obs).astype(jnp.float32),
        "action": a1,
        "reward": intrinsic,
        "next_obs": goal_obs(goal_new, ts.obs).astype(jnp.float32),
        "done": ts.done,
    }
    lower_replay = rp.add_batch(carry.lower_replay, lower_items)

    def learn_lower(st):
        batch, _ = rp.sample(lower_replay, k_ls, cfg.batch_size)
        return D.learn(st, batch, cfg.lower_cfg(), axis=cfg.pmean_axis)

    lower = jax.lax.cond(rp.can_learn(lower_replay), learn_lower,
                         lambda s: s, carry.lower)

    # Option termination (hdqn.py:322-323).
    extr = extr + ts.rewards[:, 0]
    option_end = ts.done | (goal_new == goal_status(ts.obs))

    meta_s = ts.obs.astype(jnp.float32) if cfg.faithful_meta else start_obs
    upper_items = {
        "obs": meta_s,
        "action": goal_new,
        "reward": extr,
        "next_obs": ts.obs.astype(jnp.float32),
        "done": ts.done,
    }
    upper_replay = rp.add_batch(carry.upper_replay, upper_items, option_end)

    def learn_upper(st):
        batch, _ = rp.sample(upper_replay, k_us, cfg.batch_size)
        return D.learn(st, batch, cfg.upper_cfg(), axis=cfg.pmean_axis)

    # One meta learn per step when any option ended (reference: one per
    # option end, hdqn.py:326-327; at num_envs=1 this matches exactly).
    # Under SPMD the gate must be a global decision: option-end counts
    # and masked goal-memory fills differ per device.
    upper_fill = upper_replay.cursor
    any_end = option_end.any()
    if cfg.pmean_axis is not None:
        upper_fill = jax.lax.pmin(upper_fill, cfg.pmean_axis)
        any_end = jax.lax.psum(any_end.astype(jnp.int32), cfg.pmean_axis) > 0
    upper = jax.lax.cond(
        (upper_fill >= cfg.goal_memory_capacity) & any_end, learn_upper,
        lambda s: s, carry.upper)

    # Metrics (hdqn.py:330-346): unconditional reward accumulation.
    # Under SPMD, increments are psum'd so counters stay global/replicated.
    ep_reward = carry.ep_reward + ts.rewards[:, 0]
    m = carry.metrics
    done_i = ts.done.astype(m.episodes.dtype)
    # hdqn.py:342 evaluates the POST-final-step obs: `state = next_state`
    # (hdqn.py:320) runs BEFORE the break (hdqn.py:322), unlike main.py
    # where the break precedes the assignment -- the two trainers'
    # win tests genuinely differ (docs/PARITY.md faithful quirks).
    # ts.obs is the pre-reset transition obs, i.e. the final state.
    won = ts.done & (ts.obs[:, 8] > ts.obs[:, 3])
    inc = D.Metrics(
        env_steps=jnp.asarray(ts.done.shape[0], m.env_steps.dtype),
        episodes=jnp.sum(done_i),
        collisions=jnp.sum(ts.collision.astype(done_i.dtype)),
        wins=jnp.sum(won.astype(done_i.dtype)),
        sum_ep_reward=jnp.sum(jnp.where(ts.done, ep_reward, 0.0)),
    )
    if cfg.pmean_axis is not None:
        inc = jax.tree.map(lambda x: jax.lax.psum(x, cfg.pmean_axis), inc)
    metrics = jax.tree.map(jnp.add, m, inc)
    ep_reward = jnp.where(ts.done, 0.0, ep_reward)

    out = HDQNCarry(
        env_state=env_state, obs=next_obs_env,
        goal=goal_new, goal_op=goal_op,
        option_start_obs=start_obs, option_start=option_end,
        extr_return=jnp.where(option_end, 0.0, extr),
        ep_reward=ep_reward,
        upper=upper, lower=lower,
        opp_upper_params=carry.opp_upper_params,
        opp_lower_params=carry.opp_lower_params,
        upper_replay=upper_replay, lower_replay=lower_replay,
        key=key, metrics=metrics,
    )
    return out, None


@partial(jax.jit, static_argnums=(0, 3))
def hdqn_train_chunk(cfg: HDQNConfig, env_params: EnvParams,
                     carry: HDQNCarry, num_steps: int) -> HDQNCarry:
    carry, _ = jax.lax.scan(partial(hdqn_step, cfg, env_params), carry,
                            None, length=num_steps)
    return carry
