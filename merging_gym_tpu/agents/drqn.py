"""Recurrent DQN (DRQN) trainer: sequence replay + scan-over-time learner.

The reference's DRQN is broken dead code (main.py:49-74); this is the
working on-device version SURVEY.md section 5 prescribes.  Design:

* the actor carries per-env LSTM state, zeroed on episode reset;
* each env accumulates non-overlapping windows of ``seq_len`` steps
  (obs window is ``seq_len + 1`` for bootstrap targets) which are
  emitted into a sequence replay ring;
* the learner samples whole windows, unrolls eval and target nets with
  ``lax.scan`` from zero initial state (the standard zero-start-state
  DRQN variant), takes Double-DQN targets per timestep after a burn-in
  prefix, and masks timesteps past the first in-window episode end;
* hyper-parameters default to the flat DQN's (Adam 0.01, gamma 0.90,
  target sync every 100 learns, Phi(0.7)-greedy) so DRQN slots into the
  same level-k curriculum;
* opponent modes mirror the flat DQN's (main.py:161-168 Strategy_OP):
  ``L0`` (the action2=None constant-velocity opponent), ``selfplay``
  (the live recurrent net acting on the half-swapped obs with its OWN
  per-env LSTM state), and ``frozen`` (a frozen DRQN checkpoint, also
  with its own recurrent state).  Both seats' hidden states zero on
  episode reset.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax
from merging_gym_tpu.utils import struct

from merging_gym_tpu.agents import dqn as D
from merging_gym_tpu.agents.policies import EPSILON, eps_greedy_from_q
from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core import env as core_env
from merging_gym_tpu.core.env import EnvParams
from merging_gym_tpu.core.vector import autoreset_step, observe_after_reset, reset_batch
from merging_gym_tpu.nn.lstm import (LSTM_HIDDEN, drqn_init, drqn_step,
                                     drqn_unroll, lstm_zero_carry)
from merging_gym_tpu.ops import replay as rp


@struct.dataclass
class DRQNConfig:
    batch_size: int = struct.field(pytree_node=False, default=32)
    lr: float = struct.field(pytree_node=False, default=0.01)
    gamma: float = struct.field(pytree_node=False, default=0.90)
    epsilon: float = struct.field(pytree_node=False, default=EPSILON)
    memory_capacity: int = struct.field(pytree_node=False, default=512)
    target_sync: int = struct.field(pytree_node=False, default=100)
    obs_dim: int = struct.field(pytree_node=False, default=C.OBS_DIM)
    num_actions: int = struct.field(pytree_node=False, default=C.NUM_ACTIONS)
    seq_len: int = struct.field(pytree_node=False, default=16)
    burn_in: int = struct.field(pytree_node=False, default=4)
    opponent: str = struct.field(pytree_node=False, default=D.OPP_L0)
    # Set by parallel.spmd for data-parallel training: pmean'd gradients,
    # globally agreed learn gate, psum'd metric increments.
    pmean_axis: str | None = struct.field(pytree_node=False, default=None)


@struct.dataclass
class DRQNCarry:
    env_state: Any
    obs: jax.Array
    lstm_h: jax.Array          # f[envs, hidden]
    lstm_c: jax.Array
    lstm_h2: jax.Array         # opponent seat's recurrent state (zeros
    lstm_c2: jax.Array         # and unused under the L0 opponent)
    opp_params: Any            # frozen opponent params (None unless OPP_FROZEN)
    window: Any                # accumulating {obs[L+1], action[L], reward[L], done[L]}
    window_len: jax.Array      # i32[envs]
    ep_reward: jax.Array
    params: Any
    target_params: Any
    opt_state: Any
    learn_counter: jax.Array
    last_loss: jax.Array
    replay: rp.ReplayState
    key: jax.Array
    metrics: D.Metrics


def _window_example(cfg: DRQNConfig):
    L = cfg.seq_len
    return {
        "obs": jnp.zeros((L + 1, cfg.obs_dim), jnp.float32),
        "action": jnp.zeros((L,), jnp.int32),
        "reward": jnp.zeros((L,), jnp.float32),
        "done": jnp.zeros((L,), bool),
    }


def drqn_train_init(key, cfg: DRQNConfig, env_params: EnvParams,
                    num_envs: int, opp_params: Any = None) -> DRQNCarry:
    if cfg.opponent == D.OPP_FROZEN:
        assert opp_params is not None, "frozen opponent needs params"
    else:
        assert opp_params is None, f"opponent={cfg.opponent!r} takes no params"
    # Window flushes are synchronized across lanes (window_len increments
    # on EVERY step for every lane, so all lanes emit on the same step).
    # A ring smaller than one flush would scatter num_envs windows onto
    # fewer slots -- duplicate indices with backend-dependent winners,
    # silently dropping experience.
    assert cfg.memory_capacity >= num_envs, (
        f"memory_capacity={cfg.memory_capacity} < num_envs={num_envs}: "
        "the sequence ring must hold at least one synchronized flush")
    k_env, k_net, k_tnet, k_run = jax.random.split(key, 4)
    env_state = reset_batch(env_params, k_env, num_envs)
    obs = jax.vmap(core_env.observe)(env_state)
    params = drqn_init(k_net, cfg.obs_dim, cfg.num_actions)
    target_params = drqn_init(k_tnet, cfg.obs_dim, cfg.num_actions)
    L = cfg.seq_len
    window = {
        "obs": jnp.zeros((num_envs, L + 1, cfg.obs_dim), jnp.float32),
        "action": jnp.zeros((num_envs, L), jnp.int32),
        "reward": jnp.zeros((num_envs, L), jnp.float32),
        "done": jnp.zeros((num_envs, L), bool),
    }
    window = jax.tree.map(lambda x: x, window)
    window["obs"] = window["obs"].at[:, 0].set(obs.astype(jnp.float32))
    h, c = lstm_zero_carry((num_envs,))
    h2, c2 = lstm_zero_carry((num_envs,))
    return DRQNCarry(
        env_state=env_state, obs=obs, lstm_h=h, lstm_c=c,
        lstm_h2=h2, lstm_c2=c2, opp_params=opp_params,
        window=window, window_len=jnp.zeros((num_envs,), jnp.int32),
        ep_reward=jnp.zeros((num_envs,), jnp.float32),
        params=params, target_params=target_params,
        opt_state=optax.adam(cfg.lr).init(params),
        learn_counter=jnp.zeros((), jnp.int32),
        last_loss=jnp.zeros((), jnp.float32),
        replay=rp.replay_init(cfg.memory_capacity, _window_example(cfg)),
        key=k_run, metrics=D.Metrics.zero(),
    )


def drqn_loss(params, target_params, batch, cfg: DRQNConfig):
    """Double-DQN over sequences, zero start state, burn-in + done masks.

    batch: {obs [B, L+1, d], action [B, L], reward [B, L], done [B, L]}.
    """
    obs = jnp.swapaxes(batch["obs"], 0, 1)       # [L+1, B, d]
    B = obs.shape[1]
    q_all, _ = drqn_unroll(params, obs, lstm_zero_carry((B,)))      # [L+1, B, A]
    qt_all, _ = drqn_unroll(target_params, obs, lstm_zero_carry((B,)))

    q_t = q_all[:-1]                              # [L, B, A]
    q_tp1 = jax.lax.stop_gradient(q_all[1:])
    qt_tp1 = qt_all[1:]

    action = jnp.swapaxes(batch["action"], 0, 1)  # [L, B]
    reward = jnp.swapaxes(batch["reward"], 0, 1)
    done = jnp.swapaxes(batch["done"], 0, 1)

    q_sel = jnp.take_along_axis(q_t, action[..., None], axis=-1)[..., 0]
    a_star = jnp.argmax(q_tp1, axis=-1)
    bootstrap = jnp.take_along_axis(qt_tp1, a_star[..., None], axis=-1)[..., 0]
    target = reward + cfg.gamma * bootstrap * (1.0 - done.astype(q_sel.dtype))

    L = cfg.seq_len
    t_idx = jnp.arange(L)[:, None]
    # Valid: past burn-in and not after an in-window episode end.
    ended_before = jnp.concatenate(
        [jnp.zeros((1, done.shape[1]), bool),
         jnp.cumsum(done[:-1], axis=0) > 0], axis=0)
    mask = (t_idx >= cfg.burn_in) & ~ended_before
    err = (q_sel - jax.lax.stop_gradient(target)) ** 2
    return jnp.sum(err * mask) / jnp.maximum(jnp.sum(mask), 1)


def drqn_train_step(cfg: DRQNConfig, env_params: EnvParams,
                    carry: DRQNCarry, _):
    key, k_act, k_act2, k_reset, k_sample = jax.random.split(carry.key, 5)
    obs = carry.obs
    n = obs.shape[0]

    # Recurrent actor: one LSTM step per env step, hidden carried.
    q, (h, c) = drqn_step(carry.params, obs, (carry.lstm_h, carry.lstm_c))
    a1 = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
        q, jax.random.split(k_act, n), cfg.epsilon, cfg.num_actions)

    # Opponent seat (main.py:161-168 modes, recurrent analog): selfplay
    # and frozen run a second LSTM step on the half-swapped obs
    # (main.py:199) with the opponent's OWN hidden state.
    h2, c2 = carry.lstm_h2, carry.lstm_c2
    if cfg.opponent == D.OPP_L0:
        a2 = jnp.full((n,), C.ACTION_NONE, jnp.int32)
    else:
        opp = (carry.params if cfg.opponent == D.OPP_SELFPLAY
               else carry.opp_params)
        q2, (h2, c2) = drqn_step(opp, core_env.swap_obs(obs), (h2, c2))
        a2 = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
            q2, jax.random.split(k_act2, n), cfg.epsilon, cfg.num_actions)
    actions = jnp.stack([a1, a2], -1)
    env_state, ts = autoreset_step(env_params, carry.env_state, actions, k_reset)
    next_obs = observe_after_reset(env_params, env_state, ts)

    # Zero hidden state where the episode reset (recurrent state must not
    # leak across episodes) -- both seats.
    done_col = ts.done[:, None]
    h = jnp.where(done_col, 0.0, h)
    c = jnp.where(done_col, 0.0, c)
    h2 = jnp.where(done_col, 0.0, h2)
    c2 = jnp.where(done_col, 0.0, c2)

    # Window accumulation.
    L = cfg.seq_len
    wl = carry.window_len
    w = carry.window
    idx = jnp.minimum(wl, L - 1)
    w = {
        "obs": w["obs"].at[jnp.arange(n), idx + 1].set(ts.obs.astype(jnp.float32)),
        "action": w["action"].at[jnp.arange(n), idx].set(a1),
        "reward": w["reward"].at[jnp.arange(n), idx].set(
            ts.rewards[:, 0].astype(jnp.float32)),
        "done": w["done"].at[jnp.arange(n), idx].set(ts.done),
    }
    wl = wl + 1
    emit = wl >= L
    replay = rp.add_batch(carry.replay, w, emit)

    # Restart only windows that emitted; windows freely span episode
    # boundaries (so terminal transitions are stored) and the loss's
    # first-done mask discards the steps past an in-window episode end.
    wl = jnp.where(emit, 0, wl)
    w["obs"] = jnp.where(emit[:, None, None],
                         jnp.zeros_like(w["obs"]).at[:, 0].set(
                             next_obs.astype(jnp.float32)),
                         w["obs"])
    w["done"] = jnp.where(emit[:, None], jnp.zeros_like(w["done"]), w["done"])

    # Learner.
    def do_learn(op):
        params, target_params, opt_state, cnt = op
        sync = cnt % cfg.target_sync == 0
        target_params = jax.tree.map(
            lambda e, t: jnp.where(sync, e, t), params, target_params)
        batch, _ = rp.sample_valid(replay, k_sample, cfg.batch_size)
        loss, grads = jax.value_and_grad(drqn_loss)(
            params, target_params, batch, cfg)
        if cfg.pmean_axis is not None:
            # Each device samples its own window batch from its local
            # ring; the pmean makes the update the global-batch gradient
            # and keeps params bitwise-replicated.
            grads = jax.lax.pmean(grads, cfg.pmean_axis)
            loss = jax.lax.pmean(loss, cfg.pmean_axis)
        updates, opt_state = optax.adam(cfg.lr).update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), target_params,
                opt_state, cnt + 1, loss.astype(jnp.float32))

    can = replay.cursor >= cfg.batch_size
    if cfg.pmean_axis is not None:
        # The learn gate must be a GLOBAL decision or devices diverge
        # around the pmean collective (the SPMD rule every distributed
        # trainer here follows).
        can = jax.lax.pmin(can.astype(jnp.int32), cfg.pmean_axis) > 0
    params, target_params, opt_state, cnt, loss = jax.lax.cond(
        can, do_learn,
        lambda op: (op[0], op[1], op[2], op[3], carry.last_loss),
        (carry.params, carry.target_params, carry.opt_state,
         carry.learn_counter))

    ep_reward = carry.ep_reward + ts.rewards[:, 0]
    m = carry.metrics
    done_i = ts.done.astype(m.episodes.dtype)
    won = ts.done & (obs[:, 8] > obs[:, 3])  # pre-final-step obs (main.py:225)
    inc = D.Metrics(
        env_steps=jnp.asarray(n, m.env_steps.dtype),
        episodes=jnp.sum(done_i),
        collisions=jnp.sum(ts.collision.astype(done_i.dtype)),
        wins=jnp.sum(won.astype(done_i.dtype)),
        sum_ep_reward=jnp.sum(jnp.where(ts.done, ep_reward, 0.0)),
    )
    if cfg.pmean_axis is not None:
        # psum the per-step increments so the counters stay replicated.
        inc = jax.tree.map(lambda x: jax.lax.psum(x, cfg.pmean_axis), inc)
    metrics = jax.tree.map(jnp.add, m, inc)
    ep_reward = jnp.where(ts.done, 0.0, ep_reward)

    out = DRQNCarry(
        env_state=env_state, obs=next_obs, lstm_h=h, lstm_c=c,
        lstm_h2=h2, lstm_c2=c2, opp_params=carry.opp_params,
        window=w, window_len=wl, ep_reward=ep_reward,
        params=params, target_params=target_params, opt_state=opt_state,
        learn_counter=cnt, last_loss=loss, replay=replay, key=key,
        metrics=metrics,
    )
    return out, None


@partial(jax.jit, static_argnums=(0, 3))
def drqn_train_chunk(cfg: DRQNConfig, env_params: EnvParams,
                     carry: DRQNCarry, num_steps: int) -> DRQNCarry:
    carry, _ = jax.lax.scan(partial(drqn_train_step, cfg, env_params),
                            carry, None, length=num_steps)
    return carry
