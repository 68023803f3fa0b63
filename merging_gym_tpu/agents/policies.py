"""Policy protocol: params-PyTree + pure act function.

Unifies every actor kind in the reference -- the L0 constant-velocity
"None" opponent (merging_env.py:152), random/scripted actions, epsilon-
greedy Q-nets (main.py:99-112), frozen level-k checkpoints (main.py:
164-168) and human keyboard input -- behind one batched interface so
self-play, level-k curricula and pve/pvp share a single rollout engine
(BASELINE.json north star).

Reference quirk preserved: "epsilon-greedy" draws a standard normal and
acts greedily iff ``randn() <= 0.7`` (main.py:105), i.e. P(greedy) =
Phi(0.7) ~= 0.758, constant over training.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
from merging_gym_tpu.utils import struct

from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core.env import swap_obs

EPSILON = 0.7  # main.py:16 ("EPISILO")


@struct.dataclass
class Policy:
    """A single-player policy over the player's own view of the obs.

    ``act(params, obs, key) -> int32 action`` for one env; batching is
    applied by the two-player composer below.
    """

    act: Callable[[Any, jax.Array, jax.Array], jax.Array] = struct.field(pytree_node=False)
    params: Any = None


# act callables are cached so that two policies of the same kind share the
# same function object -- jit caches keyed on the act function then reuse
# one compilation across policy instances (e.g. a round-robin league).

@functools.lru_cache(maxsize=None)
def _const_act(action: int):
    return lambda p, obs, key: jnp.int32(action)


def l0_policy() -> Policy:
    """The ``action2=None`` constant-velocity opponent (merging_env.py:152)."""
    return Policy(act=_const_act(C.ACTION_NONE))


def constant_policy(action: int) -> Policy:
    return Policy(act=_const_act(action))


@functools.lru_cache(maxsize=None)
def _random_act(num_actions: int):
    return lambda p, obs, key: jax.random.randint(key, (), 0, num_actions, jnp.int32)


def random_policy(num_actions: int = C.NUM_ACTIONS) -> Policy:
    return Policy(act=_random_act(num_actions))


def eps_greedy_from_q(q_values: jax.Array, key: jax.Array,
                      epsilon: float = EPSILON,
                      num_actions: int = C.NUM_ACTIONS) -> jax.Array:
    """Reference epsilon-greedy over precomputed Q-values (main.py:105-111)."""
    kg, kr = jax.random.split(key)
    greedy = jax.random.normal(kg) <= epsilon
    return jnp.where(greedy,
                     jnp.argmax(q_values, axis=-1).astype(jnp.int32),
                     jax.random.randint(kr, (), 0, num_actions, jnp.int32))


@functools.lru_cache(maxsize=None)
def _q_act(apply_fn, greedy: bool, epsilon: float):
    def act(p, obs, key):
        q = apply_fn(p, obs)
        if greedy:
            return jnp.argmax(q, axis=-1).astype(jnp.int32)
        return eps_greedy_from_q(q, key, epsilon)
    return act


def q_policy(apply_fn, params, greedy: bool = False,
             epsilon: float = EPSILON) -> Policy:
    """Epsilon-greedy (or purely greedy) policy over a Q-net apply_fn.

    Params live in ``Policy.params`` (threaded through the rollout
    policy-state), so policies sharing (apply_fn, greedy, epsilon) share
    one act function and therefore one compilation."""
    return Policy(act=_q_act(apply_fn, greedy, epsilon), params=params)


@functools.lru_cache(maxsize=None)
def _rainbow_act(greedy: bool, epsilon: float, obs_scale):
    from merging_gym_tpu.nn.rainbow_net import rainbow_apply, rainbow_q_values

    def act(p, obs, key):
        # Eval-mode forward (noise=None -> mu weights), greedy argmax of
        # E[Z] -- RainbowDQN.act (ranbowdqn.py:543-548).  greedy=False
        # additionally applies the Phi(eps)-greedy quirk so league play
        # from the deterministic start does not collapse to one
        # trajectory (same protocol as q_policy).
        x = obs if obs_scale is None else obs * obs_scale
        q = rainbow_q_values(rainbow_apply(p, x))
        if greedy:
            return jnp.argmax(q, axis=-1).astype(jnp.int32)
        return eps_greedy_from_q(q, key, epsilon)
    return act


def rainbow_policy(params, greedy: bool = False, epsilon: float = EPSILON,
                   obs_scale: float | None = None) -> Policy:
    """Policy over a frozen Rainbow (dueling C51 NoisyNet) checkpoint.

    ``obs_scale`` must match the value the checkpoint was trained with
    (RainbowConfig.obs_scale; recorded in the zoo entry's meta.json)."""
    return Policy(act=_rainbow_act(greedy, epsilon, obs_scale), params=params)


@functools.lru_cache(maxsize=None)
def _hdqn_act(greedy: bool, epsilon: float):
    from merging_gym_tpu.nn.mlp import qnet_apply

    def act(params, obs, key):
        upper, lower = params["upper"], params["lower"]
        # Goal re-selected from the CURRENT obs on every step -- exactly
        # the reference's goal-drift quirk (hdqn.py:303), which the
        # trainers reproduce; a stateless greedy evaluation policy is
        # therefore the faithful one (a goal persists only while it
        # stays the argmax).
        g = jnp.argmax(qnet_apply(upper, obs)).astype(jnp.float32)
        x = jnp.concatenate([g[None], obs])
        q = qnet_apply(lower, x)
        if greedy:
            return jnp.argmax(q).astype(jnp.int32)
        return eps_greedy_from_q(q, key, epsilon, q.shape[-1])

    return act


def hdqn_policy(upper_params, lower_params, greedy: bool = False,
                epsilon: float = EPSILON) -> Policy:
    """Hierarchical policy: goal via the meta-controller, action via the
    goal-conditioned lower net (hdqn.py:283-292), with the every-step
    goal re-selection quirk (hdqn.py:303)."""
    return Policy(act=_hdqn_act(greedy, epsilon),
                  params={"upper": upper_params, "lower": lower_params})


def two_player(policy1: Policy, policy2: Policy):
    """Compose two single-player policies into a batched rollout policy_fn.

    Player 2 sees the half-swapped observation (main.py:199).  Returns a
    function with the ``core.vector.rollout`` policy signature; its state
    is the pair of policy params, so learned params can be swapped in
    per-iteration without retracing -- and the function itself is cached
    on the (act1, act2) pair, so matchups between same-kind policies
    share one compilation.
    """
    return _two_player_fn(policy1.act, policy2.act), (policy1.params, policy2.params)


@functools.lru_cache(maxsize=None)
def _two_player_fn(act1, act2):
    def policy_fn(pstate, obs, key):
        p1, p2 = pstate
        n = obs.shape[0]
        k1, k2 = jax.random.split(key)
        a1 = jax.vmap(act1, in_axes=(None, 0, 0))(
            p1, obs, jax.random.split(k1, n))
        a2 = jax.vmap(act2, in_axes=(None, 0, 0))(
            p2, swap_obs(obs), jax.random.split(k2, n))
        return pstate, jnp.stack([a1, a2], axis=-1)
    return policy_fn
