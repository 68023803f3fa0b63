"""Prioritised experience replay -- on-device, pointer-free.

The reference defines a PER buffer (scripts/ranbowdqn.py:326-437) over
array segment trees (ranbowdqn.py:130-262) but never instantiates it
(main() uses the uniform buffer, ranbowdqn.py:647); SURVEY.md directs
this build to make it first-class.

On-device design: no pointer tree.  Priorities live in a flat f32
array; proportional sampling is stratified inverse-CDF over a cumsum
(``searchsorted``) -- a log-depth scan plus a vectorised binary search,
which beats a sequential tree descent on a vector machine by orders of
magnitude and is exactly equivalent in distribution to the reference's
``find_prefixsum_idx`` (ranbowdqn.py:225-248).

Reference semantics preserved: alpha-powered priorities, new items get
``max_priority ** alpha`` (ranbowdqn.py:353-358), beta importance weights
normalised by the max weight over the buffer (ranbowdqn.py:405-413), and
``update_priorities`` tracks the running max (ranbowdqn.py:431-437).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from merging_gym_tpu.utils import struct

from merging_gym_tpu.ops import replay as rp


@struct.dataclass
class PERState:
    base: rp.ReplayState
    priorities: jax.Array    # f32[capacity], already alpha-powered
    max_priority: jax.Array  # f32 scalar (pre-alpha, like the reference)
    alpha: float = 0.6


def per_init(capacity: int, example_item, alpha: float = 0.6) -> PERState:
    return PERState(
        base=rp.replay_init(capacity, example_item),
        priorities=jnp.zeros((capacity,), jnp.float32),
        max_priority=jnp.ones((), jnp.float32),
        alpha=alpha,
    )


def per_add_batch(state: PERState, items, mask=None) -> PERState:
    """Append items with priority ``max_priority ** alpha`` (ranbowdqn.py:353-358)."""
    cap = rp.replay_capacity(state.base)
    n = jax.tree.leaves(items)[0].shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    rank = jnp.cumsum(mask) - 1
    slots = jnp.where(mask, (state.base.cursor + rank) % cap, cap)
    p_new = state.max_priority ** state.alpha
    return state.replace(
        base=rp.add_batch(state.base, items, mask),
        priorities=state.priorities.at[slots].set(p_new, mode="drop"),
    )


def per_sample(state: PERState, key: jax.Array, batch_size: int, beta: float):
    """Stratified proportional sampling + importance weights.

    Returns ``(batch, idx, weights)``.  Weights are normalised by the max
    weight over the whole buffer (min priority), as the reference does
    (ranbowdqn.py:405-413).
    """
    cap = rp.replay_capacity(state.base)
    filled = jnp.minimum(state.base.cursor, cap)
    valid = jnp.arange(cap) < filled
    p = jnp.where(valid, state.priorities, 0.0)
    total = jnp.sum(p)
    cdf = jnp.cumsum(p)

    # Stratified uniforms: one per equal slice of total mass.
    u = (jnp.arange(batch_size) +
         jax.random.uniform(key, (batch_size,))) / batch_size * total
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right"), 0, cap - 1)

    probs = p[idx] / total
    n = filled.astype(probs.dtype)
    weights = (probs * n) ** (-beta)
    p_min = jnp.min(jnp.where(valid, p, jnp.inf)) / total
    max_weight = (p_min * n) ** (-beta)
    weights = weights / max_weight

    batch = jax.tree.map(lambda buf: buf[idx], state.base.data)
    return batch, idx, weights.astype(jnp.float32)


def per_update_priorities(state: PERState, idx: jax.Array,
                          priorities: jax.Array) -> PERState:
    """Set new (pre-alpha) priorities for sampled indices (ranbowdqn.py:417-437)."""
    priorities = jnp.maximum(priorities.astype(jnp.float32), 1e-8)
    return state.replace(
        priorities=state.priorities.at[idx].set(priorities ** state.alpha),
        max_priority=jnp.maximum(state.max_priority, jnp.max(priorities)),
    )


def per_can_learn(state: PERState, min_fill: int) -> jax.Array:
    return state.base.cursor > min_fill
