"""SPMD distributed DQN training: explicit shard_map + XLA collectives.

The answer to "the reference has no distributed backend" (SURVEY.md
sections 2.6, 5): one program, every device running it on its shard of
the work, communicating with explicit collectives that XLA hands to NCCL
over NVLink -- no parameter server, no host in the loop.

Layout on a ``(data, model)`` mesh:

* **data parallelism** -- env batch, replay ring and learner batch are
  sharded on ``data``; every device steps its own envs, stores into its
  *local* ring, samples its local sub-batch, and gradients are combined
  with ``psum`` over ``data`` before an identical Adam update, keeping
  params bitwise-replicated.
* **tensor parallelism** -- the Q-net's hidden layers are sharded on
  ``model``: fc0 column-parallel, fc1 row-parallel with one
  ``psum("model")`` on its output partial sums (Megatron-style), fc2
  replicated.  Overkill for a 200-unit MLP but the real
  mechanism, so the same code scales to wide nets.
* pipeline / sequence / expert parallelism are structurally n/a for a
  3-layer MLP on 10-float observations (SURVEY.md section 5, long-context
  row); the env batch axis *is* this workload's sequence axis.

Epsilon-greedy exploration and env auto-reset randomness derive from the
shared key folded with the device's ``data`` coordinate, so a run on an
``(n, 1)`` mesh is reproducible for fixed n.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from merging_gym_tpu.agents import dqn as D
from merging_gym_tpu.agents.policies import eps_greedy_from_q
from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core import env as core_env
from merging_gym_tpu.core.env import EnvParams, swap_obs
from merging_gym_tpu.core.vector import autoreset_step, observe_after_reset, reset_batch
from merging_gym_tpu.ops import replay as rp


# ---------------------------------------------------------------------------
# Per-device replay cursors
# ---------------------------------------------------------------------------
# Masked stores make ring cursors genuinely diverge across devices (DQN's
# winner gating, HDQN's option-end gating, Rainbow's n-step emits), so the
# sharded carries hold cursors with an explicit per-device axis (shape
# [dp], P("data")) rather than falsely declaring them replicated.  Inside
# shard_map each device sees its [1]-shaped shard; these helpers convert
# to/from the scalar the replay ops expect.

def _localize_cursor(replay):
    from merging_gym_tpu.ops.per import PERState
    if isinstance(replay, PERState):
        return replay.replace(base=replay.base.replace(cursor=replay.base.cursor[0]))
    return replay.replace(cursor=replay.cursor[0])


def _globalize_cursor(replay):
    from merging_gym_tpu.ops.per import PERState
    if isinstance(replay, PERState):
        return replay.replace(base=replay.base.replace(cursor=replay.base.cursor[None]))
    return replay.replace(cursor=replay.cursor[None])


def _per_device_cursor(replay, dp: int):
    """Give a freshly built replay a [dp]-shaped cursor for sharding."""
    from merging_gym_tpu.ops.per import PERState
    z = jnp.zeros((dp,), jnp.int32)
    if isinstance(replay, PERState):
        return replay.replace(base=replay.base.replace(cursor=z))
    return replay.replace(cursor=z)


# ---------------------------------------------------------------------------
# Tensor-parallel Q-net
# ---------------------------------------------------------------------------

def qnet_pspecs(params) -> Any:
    """PartitionSpecs for the 3-layer Q-net: fc0 column-, fc1 row-parallel."""
    specs = {}
    n = len(params)
    for i in range(n):
        if i == 0:
            specs[f"fc{i}"] = {"w": P(None, "model"), "b": P("model")}
        elif i == 1:
            specs[f"fc{i}"] = {"w": P("model", None), "b": P(None)}
        else:
            specs[f"fc{i}"] = {"w": P(None, None), "b": P(None)}
    return specs


def qnet_apply_tp(params, x):
    """Q-net forward inside shard_map: fc1's contraction runs on local
    shards and one psum over ``model`` completes the matmul."""
    h = jnp.dot(x, params["fc0"]["w"], preferred_element_type=jnp.float32)
    h = jax.nn.relu(h.astype(x.dtype) + params["fc0"]["b"])
    partial_h = jnp.dot(h, params["fc1"]["w"], preferred_element_type=jnp.float32)
    h = jax.lax.psum(partial_h.astype(x.dtype), "model") + params["fc1"]["b"]
    h = jax.nn.relu(h)
    out = jnp.dot(h, params["fc2"]["w"], preferred_element_type=jnp.float32)
    return out.astype(x.dtype) + params["fc2"]["b"]


# ---------------------------------------------------------------------------
# Per-device training step (runs inside shard_map)
# ---------------------------------------------------------------------------

def _td_loss_tp(params, target_params, batch, cfg: D.DQNConfig):
    q_eval = qnet_apply_tp(params, batch["obs"])
    q_sel = jnp.take_along_axis(q_eval, batch["action"][:, None], axis=-1)[:, 0]
    q_next_t = qnet_apply_tp(target_params, batch["next_obs"])
    q_next_e = qnet_apply_tp(jax.lax.stop_gradient(params), batch["next_obs"])
    a_star = jnp.argmax(q_next_e, axis=-1)
    bootstrap = jnp.take_along_axis(q_next_t, a_star[:, None], axis=-1)[:, 0]
    if cfg.mask_terminal:
        bootstrap = bootstrap * (1.0 - batch["done"].astype(bootstrap.dtype))
    target = batch["reward"] + cfg.gamma * bootstrap
    # Mean over the *global* batch: local mean then psum-mean over data.
    local = jnp.mean((q_sel - jax.lax.stop_gradient(target)) ** 2)
    return jax.lax.pmean(local, "data")


def _device_train_step(cfg: D.DQNConfig, env_params: EnvParams,
                       carry: D.TrainCarry, _):
    """One actor+replay+learner step on this device's shard."""
    key, k_act, k_reset, k_sample = jax.random.split(carry.key, 4)
    obs, n = carry.obs, carry.obs.shape[0]

    k1, k2 = jax.random.split(k_act)
    q1 = qnet_apply_tp(carry.dqn.params, obs)
    a1 = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
        q1, jax.random.split(k1, n), cfg.epsilon, cfg.num_actions)
    if cfg.opponent == D.OPP_L0:
        a2 = jnp.full((n,), C.ACTION_NONE, jnp.int32)
    else:
        opp = carry.dqn.params if cfg.opponent == D.OPP_SELFPLAY else carry.opp_params
        q2 = qnet_apply_tp(opp, swap_obs(obs))
        a2 = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None, None))(
            q2, jax.random.split(k2, n), cfg.epsilon, cfg.num_actions)
    actions = jnp.stack([a1, a2], axis=-1)

    env_state, ts = autoreset_step(env_params, carry.env_state, actions, k_reset)
    next_obs = observe_after_reset(env_params, env_state, ts)

    store_mask = ts.winner != 1
    items = {
        "obs": obs.astype(jnp.float32),
        "action": actions[:, 0],
        "reward": ts.rewards[:, 0].astype(jnp.float32),
        "next_obs": ts.obs.astype(jnp.float32),
        "done": ts.done,
    }
    replay = rp.add_batch(carry.replay, items, store_mask)

    def learn_one(dqn, k):
        batch, _ = rp.sample(replay, k, cfg.batch_size)
        sync = dqn.learn_counter % cfg.target_sync == 0
        target_params = jax.tree.map(
            lambda e, t: jnp.where(sync, e, t), dqn.params, dqn.target_params)
        loss, grads = jax.value_and_grad(_td_loss_tp)(
            dqn.params, target_params, batch, cfg)
        # DP gradient combine; params stay replicated across `data`.
        grads = jax.lax.pmean(grads, "data")
        updates, opt_state = D.make_optimizer(cfg).update(
            grads, dqn.opt_state, dqn.params)
        params = optax.apply_updates(dqn.params, updates)
        return D.DQNState(params=params, target_params=target_params,
                          opt_state=opt_state,
                          learn_counter=dqn.learn_counter + 1,
                          last_loss=loss.astype(jnp.float32)), None

    def do_learn(dqn):
        # Same key schedule as agents.dqn.train_step, so a one-device
        # mesh reproduces the single-device trainer.
        keys = jax.random.split(k_sample, cfg.learns_per_step)
        return jax.lax.scan(learn_one, dqn, keys)[0]

    # All devices agree on the gate: cursors may differ per device (masked
    # stores), so take the global minimum fill.
    fill = jax.lax.pmin(replay.cursor, "data")
    can = fill >= cfg.memory_capacity
    dqn = jax.lax.cond(can, do_learn, lambda d: d, carry.dqn)

    # Metrics: psum the per-step increments so the counters are *global*
    # and bitwise-replicated on every device at every step (no
    # end-of-chunk reduction that would double-count across chunks).
    ep_reward = carry.ep_reward + jnp.where(store_mask, ts.rewards[:, 0], 0.0)
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
    inc = jax.tree.map(lambda x: jax.lax.psum(x, "data"), inc)
    metrics = jax.tree.map(jnp.add, m, inc)
    ep_reward = jnp.where(ts.done, 0.0, ep_reward)

    out = D.TrainCarry(env_state=env_state, obs=next_obs, ep_reward=ep_reward,
                       dqn=dqn, opp_params=carry.opp_params, replay=replay,
                       key=key, metrics=metrics)
    return out, None


# ---------------------------------------------------------------------------
# Mesh-level entry points
# ---------------------------------------------------------------------------

def _place(build, key, specs_of, mesh: Mesh):
    """``build(key)`` laid out on ``mesh`` by the PartitionSpecs that
    ``specs_of(carry)`` gives.

    On a multi-process global mesh (examples/multiprocess_dryrun.py) host
    data cannot be device_put onto non-addressable devices; building the
    carry INSIDE jit with out_shardings places every process's local
    shards of the same deterministic computation.
    """
    shardings = jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s),
        specs_of(jax.eval_shape(build, key)),
        is_leaf=lambda x: isinstance(x, P))
    if jax.process_count() > 1:
        return jax.jit(build, out_shardings=shardings)(key)
    return jax.device_put(build(key), shardings)


def carry_pspecs(cfg: D.DQNConfig, carry: D.TrainCarry):
    """PartitionSpecs for the train carry on a (data, model) mesh."""
    # opt_state mirrors param structure: shard its moment buffers like
    # params, keep step counters replicated.
    mu_specs = qnet_pspecs(carry.dqn.params)
    opt_specs = []
    for part in carry.dqn.opt_state:
        if hasattr(part, "mu"):
            opt_specs.append(part._replace(count=P(), mu=mu_specs, nu=mu_specs))
        else:
            opt_specs.append(jax.tree.map(lambda _: P(), part))
    dqn_specs = D.DQNState(
        params=qnet_pspecs(carry.dqn.params),
        target_params=qnet_pspecs(carry.dqn.target_params),
        opt_state=tuple(opt_specs),
        learn_counter=P(), last_loss=P(),
    )

    batched = P("data")
    return D.TrainCarry(
        env_state=jax.tree.map(lambda _: batched, carry.env_state),
        obs=batched,
        ep_reward=batched,
        dqn=dqn_specs,
        opp_params=qnet_pspecs(carry.opp_params),
        replay=rp.ReplayState(
            data=jax.tree.map(lambda _: batched, carry.replay.data),
            cursor=P("data"),
        ),
        key=P(),
        metrics=jax.tree.map(lambda _: P(), carry.metrics),
    )


def spmd_train_init(key, cfg: D.DQNConfig, env_params: EnvParams,
                    num_envs: int, mesh: Mesh, opp_params=None) -> D.TrainCarry:
    """Build a carry whose batched leaves are sharded over ``data`` and
    whose params are sharded over ``model``.

    ``cfg.memory_capacity`` here is the *per-device* ring size.  The key
    stored in the carry is shared; shard_map folds in the device index.
    """
    dp = mesh.shape["data"]
    assert num_envs % dp == 0, (num_envs, dp)

    def build(k):
        carry = D.train_init(k, cfg, env_params, num_envs, opp_params)
        # Scale the replay to per-device capacity x dp so specs divide
        # evenly; the cursor gets an explicit per-device axis (see
        # _per_device_cursor).
        replay = _per_device_cursor(
            rp.replay_init(cfg.memory_capacity * dp,
                           D.transition_example(cfg)), dp)
        return carry.replace(replay=replay)

    return _place(build, key, partial(carry_pspecs, cfg), mesh)


@partial(jax.jit, static_argnums=(0, 3, 4))
def _spmd_chunk(cfg, env_params, carry, num_steps, mesh):
    specs = carry_pspecs(cfg, carry)

    def per_device(carry):
        # Decorrelate per-device randomness; keep the shared key evolving
        # deterministically so every device returns the same one.
        shared_key = carry.key
        idx = jax.lax.axis_index("data")
        carry = carry.replace(key=jax.random.fold_in(shared_key, idx),
                              replay=_localize_cursor(carry.replay))
        carry, _ = jax.lax.scan(
            partial(_device_train_step, cfg, env_params), carry,
            None, length=num_steps)
        return carry.replace(
            # Chunk advance folds in a value outside the axis-index range
            # (2**31 + num_steps) so it can never collide with a device's
            # per-chunk fold_in(shared_key, idx) when num_steps < mesh
            # size (ADVICE r3).
            key=jax.random.fold_in(shared_key,
                                   jnp.uint32(2**31) + jnp.uint32(num_steps)),
            replay=_globalize_cursor(carry.replay))

    out_specs = carry_pspecs(cfg, carry)
    return jax.shard_map(per_device, mesh=mesh, in_specs=(specs,),
                         out_specs=out_specs, check_vma=False)(carry)


def spmd_train_chunk(mesh: Mesh, cfg: D.DQNConfig, env_params: EnvParams,
                     carry: D.TrainCarry, num_steps: int) -> D.TrainCarry:
    """Run ``num_steps`` SPMD actor+learner steps across the mesh."""
    return _spmd_chunk(cfg, env_params, carry, num_steps, mesh)


# ---------------------------------------------------------------------------
# Distributed Rainbow (BASELINE config 5: envs sharded over the data axis
# feeding a data-parallel learner)
# ---------------------------------------------------------------------------

def rainbow_carry_pspecs(carry):
    """PartitionSpecs for a RainbowCarry: env batch, replay and n-step
    history sharded over ``data``; params, noise and counters replicated."""
    from merging_gym_tpu.agents.rainbow import RainbowCarry
    from merging_gym_tpu.ops.per import PERState

    batched = P("data")
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    if isinstance(carry.replay, PERState):
        replay_specs = PERState(
            base=rp.ReplayState(
                data=jax.tree.map(lambda _: batched, carry.replay.base.data),
                cursor=P("data")),
            priorities=batched, max_priority=P(), alpha=P())
    else:
        replay_specs = rp.ReplayState(
            data=jax.tree.map(lambda _: batched, carry.replay.data),
            cursor=P("data"))
    return RainbowCarry(
        env_state=jax.tree.map(lambda _: batched, carry.env_state),
        obs=batched, ep_reward=batched,
        params=rep(carry.params), target_params=rep(carry.target_params),
        opt_state=rep(carry.opt_state),
        noise=rep(carry.noise), target_noise=rep(carry.target_noise),
        noise_key=P(),
        replay=replay_specs,
        nstep=jax.tree.map(
            lambda x: P(None, "data") if x.ndim > 1 else batched,
            carry.nstep),
        sync_chunks=P(), last_loss=P(), key=P(),
        metrics=jax.tree.map(lambda _: P(), carry.metrics),
        opp_params=rep(carry.opp_params),
    )


def spmd_rainbow_init(key, cfg, env_params: EnvParams, num_envs: int,
                      mesh: Mesh):
    """Sharded Rainbow carry; ``cfg.memory_capacity`` is per-device.

    Use ``env_params.random_start=True`` for vectorised self-play: with
    deterministic starts and no epsilon, noisy-greedy clones every env.
    """
    from merging_gym_tpu.agents import rainbow as R

    dp = mesh.shape["data"]
    assert num_envs % dp == 0
    assert cfg.pmean_axis == "data", "set RainbowConfig(pmean_axis='data')"

    def build(k):
        carry = R.rainbow_train_init(k, cfg, env_params, num_envs)
        if cfg.per:
            from merging_gym_tpu.ops import per as per_ops
            replay = per_ops.per_init(cfg.memory_capacity * dp,
                                      D.transition_example(D.DQNConfig()),
                                      cfg.per_alpha)
        else:
            replay = rp.replay_init(cfg.memory_capacity * dp,
                                    D.transition_example(D.DQNConfig()))
        return carry.replace(replay=_per_device_cursor(replay, dp))

    return _place(build, key, rainbow_carry_pspecs, mesh)


@partial(jax.jit, static_argnums=(0, 3, 4))
def _spmd_rainbow_chunk(cfg, env_params, carry, num_steps, mesh):
    from merging_gym_tpu.agents import rainbow as R

    specs = rainbow_carry_pspecs(carry)

    def per_device(carry):
        shared_key = carry.key
        idx = jax.lax.axis_index("data")
        carry = carry.replace(key=jax.random.fold_in(shared_key, idx),
                              replay=_localize_cursor(carry.replay))
        carry, _ = jax.lax.scan(
            partial(R.rainbow_train_step, cfg, env_params), carry,
            None, length=num_steps)
        return carry.replace(
            # Chunk advance folds in a value outside the axis-index range
            # (2**31 + num_steps) so it can never collide with a device's
            # per-chunk fold_in(shared_key, idx) when num_steps < mesh
            # size (ADVICE r3).
            key=jax.random.fold_in(shared_key,
                                   jnp.uint32(2**31) + jnp.uint32(num_steps)),
            replay=_globalize_cursor(carry.replay))

    return jax.shard_map(per_device, mesh=mesh, in_specs=(specs,),
                         out_specs=specs, check_vma=False)(carry)


def spmd_rainbow_chunk(mesh: Mesh, cfg, env_params: EnvParams, carry,
                       num_steps: int):
    """Distributed Rainbow: envs + replay sharded on ``data``, one
    pmean-combined learner, globally consistent episodic target sync."""
    return _spmd_rainbow_chunk(cfg, env_params, carry, num_steps, mesh)


# ---------------------------------------------------------------------------
# Distributed HDQN (BASELINE config 4 at multi-device scale)
# ---------------------------------------------------------------------------

def hdqn_carry_pspecs(carry):
    from merging_gym_tpu.agents.hdqn import HDQNCarry

    batched = P("data")
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    replay_specs = lambda r: rp.ReplayState(
        data=jax.tree.map(lambda _: batched, r.data), cursor=P("data"))
    return HDQNCarry(
        env_state=jax.tree.map(lambda _: batched, carry.env_state),
        obs=batched, goal=batched, goal_op=batched,
        option_start_obs=batched, option_start=batched,
        extr_return=batched, ep_reward=batched,
        upper=rep(carry.upper), lower=rep(carry.lower),
        opp_upper_params=rep(carry.opp_upper_params),
        opp_lower_params=rep(carry.opp_lower_params),
        upper_replay=replay_specs(carry.upper_replay),
        lower_replay=replay_specs(carry.lower_replay),
        key=P(), metrics=jax.tree.map(lambda _: P(), carry.metrics),
    )


def spmd_hdqn_init(key, cfg, env_params: EnvParams, num_envs: int,
                   mesh: Mesh, opp_upper=None, opp_lower=None):
    """Sharded HDQN carry; memory capacities are per-device."""
    from merging_gym_tpu.agents import hdqn as H

    dp = mesh.shape["data"]
    assert num_envs % dp == 0
    assert cfg.pmean_axis == "data", "set HDQNConfig(pmean_axis='data')"

    def build(k):
        carry = H.hdqn_init(k, cfg, env_params, num_envs, opp_upper,
                            opp_lower)
        return carry.replace(
            upper_replay=_per_device_cursor(
                rp.replay_init(cfg.goal_memory_capacity * dp,
                               D.transition_example(cfg.upper_cfg())), dp),
            lower_replay=_per_device_cursor(
                rp.replay_init(cfg.memory_capacity * dp,
                               D.transition_example(cfg.lower_cfg())), dp),
        )

    return _place(build, key, hdqn_carry_pspecs, mesh)


@partial(jax.jit, static_argnums=(0, 3, 4))
def _spmd_hdqn_chunk(cfg, env_params, carry, num_steps, mesh):
    from merging_gym_tpu.agents import hdqn as H

    specs = hdqn_carry_pspecs(carry)

    def per_device(carry):
        shared_key = carry.key
        idx = jax.lax.axis_index("data")
        carry = carry.replace(
            key=jax.random.fold_in(shared_key, idx),
            upper_replay=_localize_cursor(carry.upper_replay),
            lower_replay=_localize_cursor(carry.lower_replay))
        carry, _ = jax.lax.scan(
            partial(H.hdqn_step, cfg, env_params), carry,
            None, length=num_steps)
        return carry.replace(
            # Chunk advance folds in a value outside the axis-index range
            # (2**31 + num_steps) so it can never collide with a device's
            # per-chunk fold_in(shared_key, idx) when num_steps < mesh
            # size (ADVICE r3).
            key=jax.random.fold_in(shared_key,
                                   jnp.uint32(2**31) + jnp.uint32(num_steps)),
            upper_replay=_globalize_cursor(carry.upper_replay),
            lower_replay=_globalize_cursor(carry.lower_replay))

    return jax.shard_map(per_device, mesh=mesh, in_specs=(specs,),
                         out_specs=specs, check_vma=False)(carry)


def spmd_hdqn_chunk(mesh: Mesh, cfg, env_params: EnvParams, carry,
                    num_steps: int):
    """Distributed hierarchical DQN over the ``data`` axis."""
    return _spmd_hdqn_chunk(cfg, env_params, carry, num_steps, mesh)


def drqn_carry_pspecs(carry):
    from merging_gym_tpu.agents.drqn import DRQNCarry

    batched = P("data")
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    return DRQNCarry(
        env_state=jax.tree.map(lambda _: batched, carry.env_state),
        obs=batched, lstm_h=batched, lstm_c=batched,
        lstm_h2=batched, lstm_c2=batched,
        opp_params=rep(carry.opp_params),
        window=jax.tree.map(lambda _: batched, carry.window),
        window_len=batched, ep_reward=batched,
        params=rep(carry.params), target_params=rep(carry.target_params),
        opt_state=rep(carry.opt_state),
        learn_counter=P(), last_loss=P(),
        replay=rp.ReplayState(
            data=jax.tree.map(lambda _: batched, carry.replay.data),
            cursor=P("data")),
        key=P(), metrics=jax.tree.map(lambda _: P(), carry.metrics),
    )


def spmd_drqn_init(key, cfg, env_params: EnvParams, num_envs: int,
                   mesh: Mesh, opp_params=None):
    """Sharded recurrent-DQN carry: envs, both seats' LSTM states, the
    accumulating windows and the sequence ring live on the ``data`` axis
    (memory capacity is per-device); params/target/moments replicated.
    """
    from merging_gym_tpu.agents import drqn as DR

    dp = mesh.shape["data"]
    assert num_envs % dp == 0
    assert cfg.pmean_axis == "data", "set DRQNConfig(pmean_axis='data')"
    # Per-device flush-size requirement (cf. drqn_train_init's assert on
    # the single-chip ring): each device's ring must hold one
    # synchronized flush of its num_envs/dp local windows.
    assert cfg.memory_capacity >= num_envs // dp, (
        f"per-device memory_capacity={cfg.memory_capacity} < local envs "
        f"{num_envs // dp}")
    init_cfg = (cfg if cfg.memory_capacity >= num_envs
                else cfg.replace(memory_capacity=num_envs))

    def build(k):
        carry = DR.drqn_train_init(k, init_cfg, env_params, num_envs,
                                   opp_params)
        return carry.replace(
            replay=_per_device_cursor(
                rp.replay_init(cfg.memory_capacity * dp,
                               DR._window_example(cfg)), dp))

    return _place(build, key, drqn_carry_pspecs, mesh)


@partial(jax.jit, static_argnums=(0, 3, 4))
def _spmd_drqn_chunk(cfg, env_params, carry, num_steps, mesh):
    from merging_gym_tpu.agents import drqn as DR

    specs = drqn_carry_pspecs(carry)

    def per_device(carry):
        shared_key = carry.key
        idx = jax.lax.axis_index("data")
        carry = carry.replace(
            key=jax.random.fold_in(shared_key, idx),
            replay=_localize_cursor(carry.replay))
        carry, _ = jax.lax.scan(
            partial(DR.drqn_train_step, cfg, env_params), carry,
            None, length=num_steps)
        return carry.replace(
            # Chunk advance folds in a value outside the axis-index range
            # (2**31 + num_steps) so it can never collide with a device's
            # per-chunk fold_in(shared_key, idx) when num_steps < mesh
            # size (ADVICE r3).
            key=jax.random.fold_in(shared_key,
                                   jnp.uint32(2**31) + jnp.uint32(num_steps)),
            replay=_globalize_cursor(carry.replay))

    return jax.shard_map(per_device, mesh=mesh, in_specs=(specs,),
                         out_specs=specs, check_vma=False)(carry)


def spmd_drqn_chunk(mesh: Mesh, cfg, env_params: EnvParams, carry,
                    num_steps: int):
    """Distributed recurrent DQN over the ``data`` axis."""
    return _spmd_drqn_chunk(cfg, env_params, carry, num_steps, mesh)
