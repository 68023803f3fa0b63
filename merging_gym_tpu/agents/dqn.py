"""Double-DQN with level-k opponent curriculum -- fully on-device.

Redesign of the reference DQN trainer (scripts/main.py:76-245):
the serial env loop, host numpy replay and per-step torch SGD become one
jitted ``lax.scan`` in which thousands of vectorised envs, the on-device
ring replay and the learner all advance in lockstep.  Nothing touches the
host except low-frequency metric reads.

Reference semantics preserved (SURVEY.md section 7.4):
* eval and target nets are *independently* initialised; the first learn
  call syncs them (main.py:80,125-126);
* Double-DQN target: argmax from the eval net, value from the target net
  (main.py:144-152), with no terminal masking -- the reference bootstraps
  through episode ends (quirk; set ``mask_terminal=True`` for the
  textbook rule);
* MSE loss, Adam(lr=0.01), target sync every 100 learns, batch 128 from a
  2000-slot ring sampled with replacement (main.py:13-18,96-97,130);
* epsilon-greedy via the Phi(0.7) normal-draw quirk (main.py:105);
* transitions are stored -- and episode reward accumulated -- only while
  the ego has not already won (``env.winner is not 1``, main.py:209-211);
* opponent modes: "L0" (None action), "selfplay" (live params), frozen
  checkpoint params (main.py:161-168), acting on the half-swapped obs
  (main.py:199).
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax
from merging_gym_tpu.utils import struct

from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core.env import EnvParams, swap_obs
from merging_gym_tpu.core.vector import autoreset_step, observe_after_reset, reset_batch
from merging_gym_tpu.core import env as core_env
from merging_gym_tpu.agents.policies import EPSILON, eps_greedy_from_q
from merging_gym_tpu.nn.mlp import qnet_apply, qnet_init
from merging_gym_tpu.ops import replay as rp

# Opponent modes (main.py:161-168).
OPP_L0 = "L0"
OPP_SELFPLAY = "selfplay"
OPP_FROZEN = "frozen"


@struct.dataclass
class DQNConfig:
    """Hyper-parameters (main.py:13-18). Static: changing them recompiles."""

    batch_size: int = struct.field(pytree_node=False, default=128)
    lr: float = struct.field(pytree_node=False, default=0.01)
    gamma: float = struct.field(pytree_node=False, default=0.90)
    epsilon: float = struct.field(pytree_node=False, default=EPSILON)
    memory_capacity: int = struct.field(pytree_node=False, default=2000)
    target_sync: int = struct.field(pytree_node=False, default=100)
    obs_dim: int = struct.field(pytree_node=False, default=C.OBS_DIM)
    num_actions: int = struct.field(pytree_node=False, default=C.NUM_ACTIONS)
    hidden: tuple = struct.field(pytree_node=False, default=(200, 100))
    mask_terminal: bool = struct.field(pytree_node=False, default=False)
    opponent: str = struct.field(pytree_node=False, default=OPP_L0)
    learns_per_step: int = struct.field(pytree_node=False, default=1)
    # Corrected-mode switch for the reference's replay quirk pair
    # (main.py:130,213-214): sample uniform over filled slots only AND
    # open the learn gate at one batch stored instead of buffer-full.
    # (The faithful full-buffer gate makes with-replacement-over-capacity
    # indistinguishable from valid-only sampling -- every slot is filled
    # by the time it opens -- so the corrected mode changes both.)
    sample_valid: bool = struct.field(pytree_node=False, default=False)
    # Mixed precision: forward passes (actor + learner) run with params
    # and activations cast to this dtype while master params, gradients,
    # Adam moments and the TD-error math stay float32 (matmuls accumulate
    # in f32 on the MXU either way -- nn/mlp.py).  "bfloat16" doubles MXU
    # throughput at production net widths; the reference's 10-200-100-5
    # net is too small for it to matter (benchmarks/width_dtype.py).
    compute_dtype: str = struct.field(pytree_node=False, default="float32")


@struct.dataclass
class DQNState:
    """Learner state: the counterpart of the reference ``DQN`` object."""

    params: Any
    target_params: Any
    opt_state: Any
    learn_counter: jax.Array  # i32
    last_loss: jax.Array      # f32


def make_optimizer(cfg: DQNConfig):
    return optax.adam(cfg.lr)  # torch.optim.Adam defaults (main.py:96)


def dqn_init(key: jax.Array, cfg: DQNConfig = DQNConfig()) -> DQNState:
    k_eval, k_target = jax.random.split(key)
    params = qnet_init(k_eval, cfg.obs_dim, cfg.num_actions, cfg.hidden)
    target = qnet_init(k_target, cfg.obs_dim, cfg.num_actions, cfg.hidden)
    opt_state = make_optimizer(cfg).init(params)
    return DQNState(
        params=params,
        target_params=target,
        opt_state=opt_state,
        learn_counter=jnp.zeros((), jnp.int32),
        last_loss=jnp.zeros((), jnp.float32),
    )


def _compute_cast(tree, cfg: DQNConfig):
    """Cast params/activations to the compute dtype (no-op at f32).

    Differentiable: grads of a bf16 forward flow back into the f32
    master params (the cast's transpose is a cast)."""
    if cfg.compute_dtype == "float32":
        return tree
    dt = jnp.dtype(cfg.compute_dtype)
    return jax.tree.map(lambda x: x.astype(dt), tree)


def _qnet_fwd(params, x, cfg: DQNConfig):
    """Forward in the compute dtype, Q-values back in f32."""
    q = qnet_apply(_compute_cast(params, cfg), _compute_cast(x, cfg))
    return q.astype(jnp.float32)


def td_loss(params, target_params, batch, cfg: DQNConfig):
    """Double-DQN MSE loss (main.py:143-153)."""
    q_eval = _qnet_fwd(params, batch["obs"], cfg)
    q_sel = jnp.take_along_axis(q_eval, batch["action"][:, None], axis=-1)[:, 0]
    q_next_t = _qnet_fwd(target_params, batch["next_obs"], cfg)
    q_next_e = _qnet_fwd(jax.lax.stop_gradient(params), batch["next_obs"], cfg)
    a_star = jnp.argmax(q_next_e, axis=-1)
    bootstrap = jnp.take_along_axis(q_next_t, a_star[:, None], axis=-1)[:, 0]
    if cfg.mask_terminal:
        bootstrap = bootstrap * (1.0 - batch["done"].astype(bootstrap.dtype))
    target = batch["reward"] + cfg.gamma * bootstrap
    return jnp.mean((q_sel - jax.lax.stop_gradient(target)) ** 2)


def learn(state: DQNState, batch, cfg: DQNConfig, axis=None) -> DQNState:
    """One SGD step, with the every-100-learns target sync applied *before*
    the update exactly as the reference does (main.py:125-127).

    ``axis``: optional mesh axis name; when set, gradients and loss are
    pmean-combined so replicated params stay in lockstep (SPMD)."""
    sync = state.learn_counter % cfg.target_sync == 0
    target_params = jax.tree.map(
        lambda e, t: jnp.where(sync, e, t), state.params, state.target_params)
    loss, grads = jax.value_and_grad(td_loss)(state.params, target_params, batch, cfg)
    if axis is not None:
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
    updates, opt_state = make_optimizer(cfg).update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return DQNState(
        params=params,
        target_params=target_params,
        opt_state=opt_state,
        learn_counter=state.learn_counter + 1,
        last_loss=loss.astype(jnp.float32),
    )


# ---------------------------------------------------------------------------
# Actor-learner training loop
# ---------------------------------------------------------------------------

@struct.dataclass
class Metrics:
    """Running counters matching the reference's episode metrics
    (main.py:186-237): collision rate, win rate (state[8] > state[3],
    main.py:225), episode reward gated on not-yet-won (main.py:209-211)."""

    env_steps: jax.Array
    episodes: jax.Array
    collisions: jax.Array
    wins: jax.Array
    sum_ep_reward: jax.Array

    @classmethod
    def zero(cls):
        z = jnp.zeros((), jnp.int64) if jax.config.jax_enable_x64 else jnp.zeros((), jnp.int32)
        return cls(env_steps=z, episodes=z, collisions=z, wins=z,
                   sum_ep_reward=jnp.zeros((), jnp.float32))


@struct.dataclass
class TrainCarry:
    env_state: Any
    obs: jax.Array
    ep_reward: jax.Array       # f[num_envs] masked per-episode return
    dqn: DQNState
    opp_params: Any            # frozen opponent params (or None placeholder)
    replay: rp.ReplayState
    key: jax.Array
    metrics: Metrics


def transition_example(cfg: DQNConfig):
    return {
        "obs": jnp.zeros((cfg.obs_dim,), jnp.float32),
        "action": jnp.zeros((), jnp.int32),
        "reward": jnp.zeros((), jnp.float32),
        "next_obs": jnp.zeros((cfg.obs_dim,), jnp.float32),
        "done": jnp.zeros((), bool),
    }


def train_init(key: jax.Array, cfg: DQNConfig, env_params: EnvParams,
               num_envs: int, opp_params=None) -> TrainCarry:
    k_env, k_dqn, k_run = jax.random.split(key, 3)
    env_state = reset_batch(env_params, k_env, num_envs)
    obs = jax.vmap(core_env.observe)(env_state)
    dqn = dqn_init(k_dqn, cfg)
    if cfg.opponent == OPP_FROZEN:
        assert opp_params is not None, "frozen opponent needs params"
    else:
        opp_params = dqn.params  # placeholder with the right structure
    replay = rp.replay_init(cfg.memory_capacity, transition_example(cfg))
    return TrainCarry(
        env_state=env_state, obs=obs,
        ep_reward=jnp.zeros((num_envs,), jnp.float32),
        dqn=dqn, opp_params=opp_params, replay=replay, key=k_run,
        metrics=Metrics.zero(),
    )


def _choose_actions(carry: TrainCarry, cfg: DQNConfig, key):
    obs = carry.obs
    n = obs.shape[0]
    k1, k2 = jax.random.split(key)
    q1 = _qnet_fwd(carry.dqn.params, obs, cfg)
    a1 = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
        q1, jax.random.split(k1, n), cfg.epsilon, cfg.num_actions)
    if cfg.opponent == OPP_L0:
        a2 = jnp.full((n,), C.ACTION_NONE, jnp.int32)
    else:
        opp = carry.dqn.params if cfg.opponent == OPP_SELFPLAY else carry.opp_params
        q2 = _qnet_fwd(opp, swap_obs(obs), cfg)
        a2 = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
            q2, jax.random.split(k2, n), cfg.epsilon, cfg.num_actions)
    return jnp.stack([a1, a2], axis=-1)


def train_step(cfg: DQNConfig, env_params: EnvParams, carry: TrainCarry, _):
    """One lockstep actor+replay+learner step over all envs."""
    key, k_act, k_reset, k_sample = jax.random.split(carry.key, 4)
    actions = _choose_actions(carry, cfg, k_act)
    env_state, ts = autoreset_step(env_params, carry.env_state, actions, k_reset)
    next_obs = observe_after_reset(env_params, env_state, ts)

    # Store-gating: drop transitions once the ego has won (main.py:209-210).
    store_mask = ts.winner != 1
    items = {
        "obs": carry.obs.astype(jnp.float32),
        "action": actions[:, 0],
        "reward": ts.rewards[:, 0].astype(jnp.float32),
        "next_obs": ts.obs.astype(jnp.float32),
        "done": ts.done,
    }
    replay = rp.add_batch(carry.replay, items, store_mask)

    # Learner: fires only once the ring has filled (main.py:213-214).
    def do_learn(dqn):
        def one(dqn, k):
            draw = rp.sample_valid if cfg.sample_valid else rp.sample
            batch, _ = draw(replay, k, cfg.batch_size)
            return learn(dqn, batch, cfg), None
        dqn, _ = jax.lax.scan(one, dqn, jax.random.split(k_sample, cfg.learns_per_step))
        return dqn

    gate = (rp.can_learn_valid(replay, cfg.batch_size) if cfg.sample_valid
            else rp.can_learn(replay))
    dqn = jax.lax.cond(gate, do_learn, lambda d: d, carry.dqn)

    # Metrics at episode boundaries.
    ep_reward = carry.ep_reward + jnp.where(store_mask, ts.rewards[:, 0], 0.0)
    m = carry.metrics
    done_i = ts.done.astype(m.episodes.dtype)
    # main.py:225 evaluates state[8] > state[3] on the obs from *before*
    # the final step (the loop breaks before state = next_state).
    won = ts.done & (carry.obs[:, 8] > carry.obs[:, 3])
    metrics = Metrics(
        env_steps=m.env_steps + ts.done.shape[0],
        episodes=m.episodes + jnp.sum(done_i),
        collisions=m.collisions + jnp.sum(ts.collision.astype(done_i.dtype)),
        wins=m.wins + jnp.sum(won.astype(done_i.dtype)),
        sum_ep_reward=m.sum_ep_reward + jnp.sum(jnp.where(ts.done, ep_reward, 0.0)),
    )
    ep_reward = jnp.where(ts.done, 0.0, ep_reward)

    out = TrainCarry(env_state=env_state, obs=next_obs, ep_reward=ep_reward,
                     dqn=dqn, opp_params=carry.opp_params, replay=replay,
                     key=key, metrics=metrics)
    return out, None


@partial(jax.jit, static_argnums=(0, 3))
def train_chunk(cfg: DQNConfig, env_params: EnvParams, carry: TrainCarry,
                num_steps: int) -> TrainCarry:
    """Run ``num_steps`` fused actor+learner steps under one jit."""
    carry, _ = jax.lax.scan(partial(train_step, cfg, env_params), carry,
                            None, length=num_steps, unroll=2)
    return carry
