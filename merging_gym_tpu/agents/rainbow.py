"""Rainbow DQN (C51 + NoisyNet + Dueling, optional PER / n-step) on-device.

Redesign of the reference Rainbow trainer
(scripts/ranbowdqn.py:623-700) with the full actor+replay+learner fused
into one jitted scan, like agents.dqn.

Reference semantics preserved:
* both players driven by the same learning net in self-play; the
  opponent sees a rolled observation -- the reference rolls by 3
  (``state[3:] + state[:3]``, ranbowdqn.py:669), a bug for the 10-dim
  obs whose correct half-swap is 5 (cf. main.py:199).  ``opponent_roll``
  defaults to the correct 5; set 3 to reproduce the reference exactly;
* greedy action = argmax of E[Z] with the *current* noise -- no epsilon
  (ranbowdqn.py:543-548); noise is resampled only inside the learn step
  (``reset_noise`` on both nets, ranbowdqn.py:606-607);
* C51 projection with gamma=0.99 hardcoded and the support-weighted mass
  quirk (see ops.projection); cross-entropy on the action's distribution
  clamped to [0.01, 0.99] (ranbowdqn.py:595-600);
* Adam(1e-3), batch 32, 10000-slot ring sampled uniformly over the fill
  (ranbowdqn.py:645-653, 322), learning once fill > batch;
* hard target sync every 20 *episodes* (ranbowdqn.py:690-691), tracked
  through the vectorised episode counter.

First-class extensions the reference only gestures at (SURVEY.md
sections 2.3, 7.6): prioritised replay (``per=True``; the reference's
``PrioritizedReplayBuffer`` is dead code, ranbowdqn.py:326-437) and
n-step returns (``n_step > 1``) computed on-device from per-env history
windows.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax
from merging_gym_tpu.utils import struct

from merging_gym_tpu.agents import dqn as D
from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core import env as core_env
from merging_gym_tpu.core.env import EnvParams
from merging_gym_tpu.core.vector import autoreset_step, observe_after_reset, reset_batch
from merging_gym_tpu.nn.rainbow_net import (
    NUM_ATOMS, rainbow_apply, rainbow_init, rainbow_q_values,
    rainbow_sample_noise, support)
from merging_gym_tpu.ops import per as per_ops
from merging_gym_tpu.ops import replay as rp
from merging_gym_tpu.ops.nstep import NStepState, nstep_init, nstep_update
from merging_gym_tpu.ops.projection import categorical_projection


@struct.dataclass
class RainbowConfig:
    batch_size: int = struct.field(pytree_node=False, default=32)
    lr: float = struct.field(pytree_node=False, default=1e-3)
    gamma: float = struct.field(pytree_node=False, default=0.99)
    memory_capacity: int = struct.field(pytree_node=False, default=10000)
    target_sync_episodes: int = struct.field(pytree_node=False, default=20)
    num_atoms: int = struct.field(pytree_node=False, default=NUM_ATOMS)
    obs_dim: int = struct.field(pytree_node=False, default=C.OBS_DIM)
    num_actions: int = struct.field(pytree_node=False, default=C.NUM_ACTIONS)
    opponent_roll: int = struct.field(pytree_node=False, default=5)
    faithful_c51: bool = struct.field(pytree_node=False, default=True)
    per: bool = struct.field(pytree_node=False, default=False)
    per_alpha: float = struct.field(pytree_node=False, default=0.6)
    per_beta: float = struct.field(pytree_node=False, default=0.4)
    n_step: int = struct.field(pytree_node=False, default=1)
    # Opponent mode: the reference Rainbow trainer is self-play only
    # (ranbowdqn.py:668-669); "L0" (constant velocity, action2=None) and
    # "frozen" (a fixed MLP Q-net played through the reference's
    # Phi(0.7)-greedy actor, main.py:105) make Rainbow trainable against
    # the level-k ladder like the DQN trainer (main.py:161-168).
    opponent: str = struct.field(pytree_node=False, default=D.OPP_SELFPLAY)
    # Optional explicit exploration ON TOP of NoisyNet: the reference
    # quirk ``randn() <= eps`` => P(greedy) = Phi(eps) (main.py:105)
    # applied to the learning seat(s).  None (default) = the reference's
    # pure noisy-greedy actor (ranbowdqn.py:543-548).  Useful because
    # noisy-only exploration can collapse into the no-progress timeout
    # equilibrium on this env (docs/parity/README.md, model_zoo/RB*).
    epsilon: float | None = struct.field(pytree_node=False, default=None)
    # Input normalization (corrected-mode extension; None = the
    # reference's raw observations).  The raw features are O(1e2-1e3)
    # (positions/deltas in meters) which saturates the C51 net at torch
    # default init scales: the dueling advantage stream collapses to a
    # constant, every Q ties, argmax returns action 0 (target velocity
    # 0) and the policy parks -- measured on trained checkpoints
    # (Q = [4,4,4,4,4] at the start state).  obs_scale=0.01 keeps
    # pre-activations O(1) and the streams alive.
    obs_scale: float | None = struct.field(pytree_node=False, default=None)
    # When set (by parallel.spmd.spmd_rainbow_chunk), gradients are
    # pmean-combined over this mesh axis so params stay replicated.
    pmean_axis: str | None = struct.field(pytree_node=False, default=None)


@struct.dataclass
class RainbowCarry:
    env_state: Any
    obs: jax.Array
    ep_reward: jax.Array
    params: Any
    target_params: Any
    opt_state: Any
    noise: Any
    target_noise: Any
    noise_key: jax.Array    # shared stream: keeps noise replicated under SPMD
    replay: Any               # rp.ReplayState or per_ops.PERState
    nstep: NStepState         # sliding n-step windows (ops.nstep)
    sync_chunks: jax.Array    # i32 completed-episode // 20 chunks synced
    last_loss: jax.Array
    key: jax.Array
    metrics: D.Metrics
    opp_params: Any = None     # frozen-opponent MLP Q-net (opponent="frozen")


def _make_opt(cfg):
    return optax.adam(cfg.lr)


def rainbow_train_init(key, cfg: RainbowConfig, env_params: EnvParams,
                       num_envs: int, opp_params=None) -> RainbowCarry:
    if (cfg.opponent == D.OPP_FROZEN) != (opp_params is not None):
        raise ValueError("opp_params must be given exactly when "
                         f"opponent='frozen' (got opponent={cfg.opponent!r})")
    k_env, k_net, k_n1, k_n2, k_run, k_noise = jax.random.split(key, 6)
    env_state = reset_batch(env_params, k_env, num_envs)
    obs = jax.vmap(core_env.observe)(env_state)
    params = rainbow_init(k_net, cfg.obs_dim, cfg.num_actions, cfg.num_atoms)
    target_params = params  # update_target at init (ranbowdqn.py:648)
    example = D.transition_example(
        D.DQNConfig(obs_dim=cfg.obs_dim, num_actions=cfg.num_actions))
    if cfg.per:
        replay = per_ops.per_init(cfg.memory_capacity, example, cfg.per_alpha)
    else:
        replay = rp.replay_init(cfg.memory_capacity, example)
    nstep = nstep_init(cfg.n_step, num_envs, cfg.obs_dim)
    return RainbowCarry(
        env_state=env_state, obs=obs,
        ep_reward=jnp.zeros((num_envs,), jnp.float32),
        params=params, target_params=target_params,
        opt_state=_make_opt(cfg).init(params),
        noise=rainbow_sample_noise(k_n1, cfg.num_actions, cfg.num_atoms),
        target_noise=rainbow_sample_noise(k_n2, cfg.num_actions, cfg.num_atoms),
        replay=replay,
        noise_key=k_noise,
        nstep=nstep,
        sync_chunks=jnp.zeros((), jnp.int32),
        last_loss=jnp.zeros((), jnp.float32),
        key=k_run, metrics=D.Metrics.zero(),
        opp_params=opp_params,
    )


def _scaled(x, cfg: RainbowConfig):
    return x if cfg.obs_scale is None else x * cfg.obs_scale


def _act(params, noise, obs, cfg: RainbowConfig):
    dist = rainbow_apply(params, _scaled(obs, cfg), noise,
                         cfg.num_actions, cfg.num_atoms)
    return jnp.argmax(rainbow_q_values(dist), axis=-1).astype(jnp.int32)


def rainbow_loss(params, target_params, noise, target_noise, batch, weights,
                 cfg: RainbowConfig):
    sup = support()
    # Target distribution for the double-free greedy next action
    # (ranbowdqn.py:554-563: selection and evaluation both via target net).
    next_dist = rainbow_apply(target_params, _scaled(batch["next_obs"], cfg),
                              target_noise, cfg.num_actions, cfg.num_atoms)
    next_q = rainbow_q_values(next_dist, sup)
    a_star = jnp.argmax(next_q, axis=-1)
    next_probs = jnp.take_along_axis(
        next_dist, a_star[:, None, None], axis=-2)[:, 0, :]
    gamma_n = cfg.gamma ** cfg.n_step
    proj = categorical_projection(next_probs, batch["reward"], batch["done"],
                                  sup, gamma_n, cfg.faithful_c51)
    proj = jax.lax.stop_gradient(proj)

    dist = rainbow_apply(params, _scaled(batch["obs"], cfg), noise,
                         cfg.num_actions, cfg.num_atoms)
    dist = jnp.take_along_axis(dist, batch["action"][:, None, None],
                               axis=-2)[:, 0, :]
    dist = jnp.clip(dist, 0.01, 0.99)  # ranbowdqn.py:598
    ce = -jnp.sum(proj * jnp.log(dist), axis=-1)
    loss = jnp.mean(ce * weights)
    return loss, ce


def rainbow_train_step(cfg: RainbowConfig, env_params: EnvParams,
                       carry: RainbowCarry, _):
    # Extra splits happen only on static branches so the default
    # self-play RNG stream stays exactly what it always was.
    if cfg.opponent == D.OPP_FROZEN and cfg.epsilon is not None:
        key, k_reset, k_sample, k_act, k_eps = jax.random.split(carry.key, 5)
    elif cfg.opponent == D.OPP_FROZEN:
        key, k_reset, k_sample, k_act = jax.random.split(carry.key, 4)
    elif cfg.epsilon is not None:
        key, k_reset, k_sample, k_eps = jax.random.split(carry.key, 4)
    else:
        key, k_reset, k_sample = jax.random.split(carry.key, 3)
    noise_key, k_n1, k_n2 = jax.random.split(carry.noise_key, 3)
    obs = carry.obs
    num_envs = obs.shape[0]

    a1 = _act(carry.params, carry.noise, obs, cfg)
    if cfg.opponent == D.OPP_L0:
        # Constant-velocity opponent: action2 = None (main.py:196-197).
        a2 = jnp.full((num_envs,), C.ACTION_NONE, jnp.int32)
    elif cfg.opponent == D.OPP_FROZEN:
        # Frozen MLP Q-net (a level-k ladder rung) through the reference
        # Phi(0.7)-greedy actor on the proper half-swapped view.
        from merging_gym_tpu.agents.policies import EPSILON, eps_greedy_from_q
        from merging_gym_tpu.nn.mlp import qnet_apply

        q2 = qnet_apply(carry.opp_params, core_env.swap_obs(obs))
        a2 = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
            q2, jax.random.split(k_act, num_envs), EPSILON, cfg.num_actions)
    else:
        # Self-play: one net, both seats (ranbowdqn.py:668-669).
        # state[k:] + state[:k] is a LEFT rotation: roll by -k.  (The
        # default 5 is self-inverse mod 10; the reference-bug value 3 is
        # not.)
        a2 = _act(carry.params, carry.noise,
                  jnp.roll(obs, -cfg.opponent_roll, axis=-1), cfg)
    if cfg.epsilon is not None:
        # Phi(eps)-greedy over the noisy-greedy action (per-env draws),
        # for the learning seat(s); frozen/L0 opponents keep their own
        # actor semantics.
        def explore(a, k):
            kg, kr = jax.random.split(k)
            return jnp.where(
                jax.random.normal(kg) <= cfg.epsilon, a,
                jax.random.randint(kr, (), 0, cfg.num_actions, jnp.int32))

        ke1, ke2 = jax.random.split(k_eps)
        a1 = jax.vmap(explore)(a1, jax.random.split(ke1, num_envs))
        if cfg.opponent == D.OPP_SELFPLAY:
            a2 = jax.vmap(explore)(a2, jax.random.split(ke2, num_envs))
    actions = jnp.stack([a1, a2], axis=-1)
    env_state, ts = autoreset_step(env_params, carry.env_state, actions, k_reset)
    next_obs_env = observe_after_reset(env_params, env_state, ts)

    # --- n-step window maintenance (ops.nstep) -----------------------------
    if cfg.n_step == 1:
        nstep = carry.nstep
        items = {
            "obs": obs.astype(jnp.float32),
            "action": a1,
            "reward": ts.rewards[:, 0].astype(jnp.float32),
            "next_obs": ts.obs.astype(jnp.float32),
            "done": ts.done,
        }
        store_mask = jnp.ones((num_envs,), bool)
    else:
        nstep, items, store_mask = nstep_update(
            carry.nstep, obs, a1, ts.rewards[:, 0], ts.done,
            ts.obs, cfg.gamma)

    if cfg.per:
        replay = per_ops.per_add_batch(carry.replay, items, store_mask)
        fill = replay.base.cursor
    else:
        replay = rp.add_batch(carry.replay, items, store_mask)
        fill = replay.cursor
    if cfg.pmean_axis is not None:
        # Per-device ring fills can differ (n-step emit masks); the learn
        # gate must be a global decision or devices diverge around the
        # pmean collective.
        fill = jax.lax.pmin(fill, cfg.pmean_axis)
    fill_ok = fill > cfg.batch_size

    # --- learner ----------------------------------------------------------
    def do_learn(op):
        params, opt_state, replay = op
        if cfg.per:
            batch, idx, weights = per_ops.per_sample(
                replay, k_sample, cfg.batch_size, cfg.per_beta)
        else:
            batch, idx = rp.sample_valid(replay, k_sample, cfg.batch_size)
            weights = jnp.ones((cfg.batch_size,), jnp.float32)
        (loss, ce), grads = jax.value_and_grad(rainbow_loss, has_aux=True)(
            params, carry.target_params, carry.noise, carry.target_noise,
            batch, weights, cfg)
        if cfg.pmean_axis is not None:
            grads = jax.lax.pmean(grads, cfg.pmean_axis)
            loss = jax.lax.pmean(loss, cfg.pmean_axis)
        updates, opt_state = _make_opt(cfg).update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if cfg.per:
            replay = per_ops.per_update_priorities(replay, idx, ce + 1e-5)
            if cfg.pmean_axis is not None:
                # max_priority must stay replicated (new-item priorities
                # depend on it); take the global max like a single buffer.
                replay = replay.replace(max_priority=jax.lax.pmax(
                    replay.max_priority, cfg.pmean_axis))
        return params, opt_state, replay, loss.astype(jnp.float32)

    params, opt_state, replay, loss = jax.lax.cond(
        fill_ok, do_learn,
        lambda op: (op[0], op[1], op[2], carry.last_loss),
        (carry.params, carry.opt_state, replay))

    # Noise resampled only when the learner ran (ranbowdqn.py:606-607):
    # during warm-up the acting noise stays fixed, as in the reference.
    fresh_noise = rainbow_sample_noise(k_n1, cfg.num_actions, cfg.num_atoms)
    fresh_tnoise = rainbow_sample_noise(k_n2, cfg.num_actions, cfg.num_atoms)
    noise = jax.tree.map(lambda f, o: jnp.where(fill_ok, f, o),
                         fresh_noise, carry.noise)
    target_noise = jax.tree.map(lambda f, o: jnp.where(fill_ok, f, o),
                                fresh_tnoise, carry.target_noise)

    # --- metrics + episodic target sync ------------------------------------
    # Under SPMD (pmean_axis set) the increments are psum'd so the
    # counters are global and replicated -- which also makes the
    # every-20-episodes target sync a globally consistent decision.
    ep_reward = carry.ep_reward + ts.rewards[:, 0]
    m = carry.metrics
    done_i = ts.done.astype(m.episodes.dtype)
    # main.py:225 evaluates the obs from *before* the final step (the loop
    # breaks before state = next_state).
    won = ts.done & (obs[:, 8] > obs[:, 3])
    inc = D.Metrics(
        env_steps=jnp.asarray(num_envs, m.env_steps.dtype),
        episodes=jnp.sum(done_i),
        collisions=jnp.sum(ts.collision.astype(done_i.dtype)),
        wins=jnp.sum(won.astype(done_i.dtype)),
        sum_ep_reward=jnp.sum(jnp.where(ts.done, ep_reward, 0.0)),
    )
    if cfg.pmean_axis is not None:
        inc = jax.tree.map(lambda x: jax.lax.psum(x, cfg.pmean_axis), inc)
    metrics = jax.tree.map(jnp.add, m, inc)
    episodes = metrics.episodes
    ep_reward = jnp.where(ts.done, 0.0, ep_reward)

    chunks = (episodes // cfg.target_sync_episodes).astype(jnp.int32)
    sync = chunks > carry.sync_chunks
    target_params = jax.tree.map(
        lambda p, t: jnp.where(sync, p, t), params, carry.target_params)

    out = RainbowCarry(
        env_state=env_state, obs=next_obs_env, ep_reward=ep_reward,
        params=params, target_params=target_params, opt_state=opt_state,
        noise=noise, target_noise=target_noise, replay=replay,
        noise_key=noise_key, nstep=nstep,
        sync_chunks=chunks, last_loss=loss, key=key, metrics=metrics,
        opp_params=carry.opp_params,
    )
    return out, None


@partial(jax.jit, static_argnums=(0, 3))
def rainbow_train_chunk(cfg: RainbowConfig, env_params: EnvParams,
                        carry: RainbowCarry, num_steps: int) -> RainbowCarry:
    carry, _ = jax.lax.scan(partial(rainbow_train_step, cfg, env_params),
                            carry, None, length=num_steps)
    return carry
