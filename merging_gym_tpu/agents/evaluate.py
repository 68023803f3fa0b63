"""Head-to-head policy evaluation (league play).

The reference evaluates policies implicitly -- win counters inside
training loops (main.py:224-227) and humans playing checkpoints
(human_player.py) -- with no standalone evaluator.  This module pits any
two :class:`~merging_gym_tpu.agents.policies.Policy` objects against
each other over thousands of vectorised envs and reports the episode
outcome distribution: who crossed first, collisions, timeouts, returns.

Works with learned params (ours or imported reference .pth), L0,
random, or constant policies -- anything expressible in the policy
protocol -- so level-k ladders can be scored round-robin.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from merging_gym_tpu.agents.policies import (EPSILON, Policy,
                                             eps_greedy_from_q, l0_policy,
                                             two_player)
from merging_gym_tpu.core import env as core_env
from merging_gym_tpu.core.env import EnvParams, swap_obs
from merging_gym_tpu.core.vector import (autoreset_step, observe_after_reset,
                                         reset_batch, rollout)


def evaluate(policy1: Policy, policy2: Policy, env_params: EnvParams,
             key: jax.Array, num_envs: int = 256, min_episodes: int = 512,
             chunk_steps: int = 512, max_chunks: int = 64) -> dict:
    """Play until at least ``min_episodes`` finished; return outcome stats.

    Outcomes per finished episode:
      * ``p1_first`` / ``p2_first`` -- who crossed the merge point first
        (``winner`` at the done step);
      * ``collisions`` -- episode ended in a collision (either way);
      * ``timeouts`` -- episode hit the 2501-step cap with no winner.

    Buckets can overlap: the winner latches on the first crossing
    (core/env.py winner machine) and the episode can still END in a
    collision, so such an episode counts in both a ``p*_first`` bucket
    and ``collisions`` -- the four buckets sum to >= episodes.
    ``timeouts`` is exclusive with the winner buckets by construction.
    """
    policy_fn, pstate = two_player(policy1, policy2)
    k_env, key = jax.random.split(key)
    state = reset_batch(env_params, k_env, num_envs)

    counts = {"episodes": 0, "p1_first": 0, "p2_first": 0,
              "collisions": 0, "timeouts": 0}
    ret_sums = np.zeros(2)
    ep_r = np.zeros((num_envs, 2))

    for i in range(max_chunks):
        key, k = jax.random.split(key)
        (state, pstate), traj = _run_chunk(env_params, state, policy_fn,
                                           pstate, k, chunk_steps)
        _accumulate(counts, ret_sums, ep_r, traj)
        if counts["episodes"] >= min_episodes:
            break

    return _finalize(counts, ret_sums)


def _accumulate(counts, ret_sums, ep_r, traj):
    """Fold one chunk's trajectory into the running outcome counters."""
    done = np.asarray(traj.done)
    rewards = np.asarray(traj.rewards)
    winner = np.asarray(traj.winner)
    collision = np.asarray(traj.collision)
    for t in range(done.shape[0]):
        ep_r += rewards[t]
        d = done[t]
        if d.any():
            counts["episodes"] += int(d.sum())
            counts["p1_first"] += int((d & (winner[t] == 1)).sum())
            counts["p2_first"] += int((d & (winner[t] == 2)).sum())
            counts["collisions"] += int((d & collision[t]).sum())
            counts["timeouts"] += int((d & (winner[t] == 0) & ~collision[t]).sum())
            ret_sums += ep_r[d].sum(axis=0)
            ep_r[d] = 0.0


def _finalize(counts, ret_sums):
    eps = max(counts["episodes"], 1)
    return {
        **counts,
        "p1_first_rate": counts["p1_first"] / eps,
        "p2_first_rate": counts["p2_first"] / eps,
        "collision_rate": counts["collisions"] / eps,
        "timeout_rate": counts["timeouts"] / eps,
        "mean_return_p1": float(ret_sums[0]) / eps,
        "mean_return_p2": float(ret_sums[1]) / eps,
    }


@functools.partial(jax.jit, static_argnames=("policy_fn", "chunk_steps"))
def _run_chunk(env_params, state, policy_fn, pstate, key, chunk_steps):
    # policy_fn is a cached function object (agents.policies), so every
    # matchup of the same policy kinds reuses one compilation.
    return rollout(env_params, state, policy_fn, pstate, key, chunk_steps)


def round_robin(named_policies: dict, env_params: EnvParams, key: jax.Array,
                **kwargs) -> dict:
    """All ordered pairs of a policy dict -> results table keyed
    ``"A vs B"``.  The level-k ladder evaluation the reference does by
    hand."""
    results = {}
    for name1, p1 in named_policies.items():
        for name2, p2 in named_policies.items():
            if name1 == name2:
                continue
            key, k = jax.random.split(key)
            results[f"{name1} vs {name2}"] = evaluate(
                p1, p2, env_params, k, **kwargs)
    return results


def evaluate_drqn(params1, policy2: Policy | None = None,
                  env_params: EnvParams | None = None,
                  key: jax.Array | None = None, num_envs: int = 256,
                  min_episodes: int = 512, chunk_steps: int = 512,
                  max_chunks: int = 64, greedy: bool = False,
                  epsilon: float = EPSILON,
                  drqn_params2=None) -> dict:
    """:func:`evaluate` with a DRQN in seat 1 (see :func:`evaluate_mixed`).

    Seat 2 is a stateless :class:`Policy` (default L0, the reference's
    ``action2=None`` opponent, merging_env.py:152) or -- with
    ``drqn_params2`` -- a second DRQN with its own recurrent state.
    """
    if drqn_params2 is not None:
        assert policy2 is None, \
            "pass either a stateless policy2 or drqn_params2, not both"
        seat2 = ("drqn", drqn_params2)
    else:
        seat2 = ("policy", policy2 if policy2 is not None else l0_policy())
    return evaluate_mixed(("drqn", params1), seat2, env_params, key,
                          num_envs, min_episodes, chunk_steps, max_chunks,
                          greedy, epsilon)


def evaluate_mixed(seat1, seat2, env_params: EnvParams | None = None,
                   key: jax.Array | None = None, num_envs: int = 256,
                   min_episodes: int = 512, chunk_steps: int = 512,
                   max_chunks: int = 64, greedy: bool = False,
                   epsilon: float = EPSILON) -> dict:
    """:func:`evaluate` where either seat may be recurrent.

    Each seat is ``("policy", agents.policies.Policy)`` or
    ``("drqn", nn.lstm.drqn_init params)``.  A DRQN seat's per-env LSTM
    state is carried across steps and zeroed on episode reset -- state
    the stateless :class:`Policy` protocol cannot express, so the
    recurrent rollout lives here rather than in ``two_player``.  Seat 2
    acts on the half-swapped obs (main.py:199).  Returns the same
    outcome dict as :func:`evaluate`.
    """
    from merging_gym_tpu.nn.lstm import lstm_zero_carry

    env_params = env_params or EnvParams()
    key = key if key is not None else jax.random.key(0)

    def unpack(seat):
        kind, payload = seat
        assert kind in ("policy", "drqn"), kind
        if kind == "drqn":
            return True, None, payload
        return False, payload.act, payload.params

    rec1, act1, p1 = unpack(seat1)
    rec2, act2, p2 = unpack(seat2)

    k_env, key = jax.random.split(key)
    state = reset_batch(env_params, k_env, num_envs)
    obs = jax.vmap(core_env.observe)(state)
    h1, c1 = lstm_zero_carry((num_envs,))
    h2, c2 = lstm_zero_carry((num_envs,))

    counts = {"episodes": 0, "p1_first": 0, "p2_first": 0,
              "collisions": 0, "timeouts": 0}
    ret_sums = np.zeros(2)
    ep_r = np.zeros((num_envs, 2))

    for i in range(max_chunks):
        key, k = jax.random.split(key)
        carry = (state, obs, h1, c1, h2, c2)
        carry, traj = _run_chunk_mixed(
            env_params, carry, p1, p2, k, rec1, rec2, act1, act2,
            greedy, epsilon, chunk_steps)
        state, obs, h1, c1, h2, c2 = carry
        _accumulate(counts, ret_sums, ep_r, traj)
        if counts["episodes"] >= min_episodes:
            break

    return _finalize(counts, ret_sums)


@functools.partial(jax.jit, static_argnames=("rec1", "rec2", "act1", "act2",
                                             "greedy", "epsilon",
                                             "chunk_steps"))
def _run_chunk_mixed(env_params, carry, p1, p2, key, rec1, rec2, act1, act2,
                     greedy, epsilon, chunk_steps):
    from merging_gym_tpu.nn.lstm import drqn_step

    def act_recurrent(params, obs, hc, k):
        q, hc = drqn_step(params, obs, hc)
        if greedy:
            return jnp.argmax(q, axis=-1).astype(jnp.int32), hc
        a = jax.vmap(eps_greedy_from_q, in_axes=(0, 0, None))(
            q, jax.random.split(k, obs.shape[0]), epsilon)
        return a, hc

    def seat(recurrent, act, params, obs, hc, k):
        if recurrent:
            return act_recurrent(params, obs, hc, k)
        a = jax.vmap(act, in_axes=(None, 0, 0))(
            params, obs, jax.random.split(k, obs.shape[0]))
        return a, hc

    def body(carry, k):
        state, obs, h1, c1, h2, c2 = carry
        k_a1, k_a2, k_reset = jax.random.split(k, 3)
        a1, (h1, c1) = seat(rec1, act1, p1, obs, (h1, c1), k_a1)
        a2, (h2, c2) = seat(rec2, act2, p2, swap_obs(obs), (h2, c2), k_a2)
        actions = jnp.stack([a1, a2], axis=-1)
        state, ts = autoreset_step(env_params, state, actions, k_reset)
        obs = observe_after_reset(env_params, state, ts)
        dc = ts.done[:, None]
        h1, c1 = jnp.where(dc, 0.0, h1), jnp.where(dc, 0.0, c1)
        h2, c2 = jnp.where(dc, 0.0, h2), jnp.where(dc, 0.0, c2)
        return (state, obs, h1, c1, h2, c2), ts

    keys = jax.random.split(key, chunk_steps)
    return jax.lax.scan(body, carry, keys)
