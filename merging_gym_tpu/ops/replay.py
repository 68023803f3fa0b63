"""On-device uniform replay: a fixed-shape ring buffer PyTree.

Replaces the reference's host-side numpy ring (main.py:92,115-119) and
list buffer (ranbowdqn.py:265-323) with device arrays updated by masked
scatters inside jit, so actor -> replay -> learner never leaves the chip.

Reference semantics preserved:
* ring overwrite at ``cursor % capacity`` (main.py:117-118);
* sampling draws uniform *with replacement over the full capacity*
  regardless of fill (``np.random.choice(MEMORY_CAPACITY, BATCH_SIZE)``,
  main.py:130) -- safe because learning only starts once the buffer is
  full (main.py:213), mirrored by :func:`can_learn`;
* the store-gating mask (transitions dropped once the ego already won,
  main.py:209-210) becomes the ``mask`` argument of :func:`add_batch`.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from merging_gym_tpu.utils import struct


@struct.dataclass
class ReplayState:
    data: Any          # PyTree of f[capacity, ...] arrays
    cursor: jax.Array  # i32 total number of accepted writes


def replay_init(capacity: int, example_item) -> ReplayState:
    """Allocate a zeroed buffer shaped like ``example_item`` x capacity."""
    data = jax.tree.map(
        lambda x: jnp.zeros((capacity,) + jnp.shape(x), jnp.asarray(x).dtype),
        example_item,
    )
    return ReplayState(data=data, cursor=jnp.zeros((), jnp.int32))


def replay_capacity(state: ReplayState) -> int:
    return jax.tree.leaves(state.data)[0].shape[0]


def add_batch(state: ReplayState, items, mask=None) -> ReplayState:
    """Append a batch of items (leading axis = batch), optionally masked.

    Masked-out items are dropped without consuming a slot, matching the
    reference's conditional ``store_transition`` (main.py:209-210).  Write
    order within the batch follows batch index; the ring wraps modulo
    capacity.
    """
    cap = replay_capacity(state)
    n = jax.tree.leaves(items)[0].shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    rank = jnp.cumsum(mask) - 1
    slots = jnp.where(mask, (state.cursor + rank) % cap, cap)  # cap -> dropped

    def scatter(buf, x):
        return buf.at[slots].set(x, mode="drop")

    return ReplayState(
        data=jax.tree.map(scatter, state.data, items),
        cursor=state.cursor + jnp.sum(mask, dtype=jnp.int32),
    )


def can_learn(state: ReplayState) -> jax.Array:
    """Learning gate: buffer filled once (main.py:213-214)."""
    return state.cursor >= replay_capacity(state)


def can_learn_valid(state: ReplayState, batch_size: int) -> jax.Array:
    """Corrected-mode gate: learn as soon as one batch is storable.

    Note the faithful gate above makes ``sample`` vs ``sample_valid``
    indistinguishable once it opens (every slot is filled by then); the
    with-replacement-over-capacity quirk only has teeth combined with
    this earlier start."""
    return state.cursor >= batch_size


def sample(state: ReplayState, key: jax.Array, batch_size: int):
    """Uniform with replacement over the full capacity (main.py:130)."""
    idx = jax.random.randint(key, (batch_size,), 0, replay_capacity(state))
    return jax.tree.map(lambda buf: buf[idx], state.data), idx


def sample_valid(state: ReplayState, key: jax.Array, batch_size: int):
    """Uniform over currently-filled slots (the correctness-minded variant;
    the reference's own Rainbow buffer samples this way, ranbowdqn.py:322)."""
    cap = replay_capacity(state)
    filled = jnp.minimum(state.cursor, cap)
    idx = jax.random.randint(key, (batch_size,), 0, jnp.maximum(filled, 1))
    return jax.tree.map(lambda buf: buf[idx], state.data), idx
