"""Array-backed segment trees (sum / min) as pure jnp ops.

The reference implements pointer-chasing segment trees for PER
(scripts/ranbowdqn.py:130-262): O(log n) updates walking parent links and
a sequential prefix-sum descent.  On a vector machine both are wrong
shapes; here the tree is a single f32[2*capacity] array (leaves in
[capacity, 2*capacity)) and

* updates are *batched*: scatter the leaves, then rebuild the O(log n)
  ancestor levels with strided pairwise reductions -- total work O(n)
  of pure VPU ops, no matter how many leaves changed at once;
* ``find_prefixsum_idx`` is a vectorised tree descent: a ``fori_loop``
  over the log2(capacity) levels moving a whole batch of queries down
  simultaneously, bit-exact with the reference's descent
  (ranbowdqn.py:240-248) including its left-subtree-strict ``>`` rule.

ops.per uses the simpler cumsum/searchsorted sampler by default (same
distribution); this module is the like-for-like replacement for the
reference's data structure, and the backend of choice when priorities
are updated incrementally between samples.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from merging_gym_tpu.utils import struct


def _levels(capacity: int) -> int:
    assert capacity > 0 and capacity & (capacity - 1) == 0, \
        "capacity must be a power of 2"  # ranbowdqn.py:154
    return capacity.bit_length() - 1


@struct.dataclass
class SegmentTreeState:
    tree: jax.Array                 # f32[2 * capacity]
    op: str = struct.field(pytree_node=False, default="sum")

    @property
    def capacity(self) -> int:
        return self.tree.shape[0] // 2

    def leaves(self) -> jax.Array:
        cap = self.capacity
        return self.tree[cap:]


def tree_init(capacity: int, op: str = "sum") -> SegmentTreeState:
    neutral = 0.0 if op == "sum" else jnp.inf
    return SegmentTreeState(
        tree=jnp.full((2 * capacity,), neutral, jnp.float32), op=op)


def _combine(op: str, a, b):
    return a + b if op == "sum" else jnp.minimum(a, b)


def tree_set(state: SegmentTreeState, idx: jax.Array,
             values: jax.Array) -> SegmentTreeState:
    """Batched leaf update + ancestor rebuild (cf. ranbowdqn.py:196-206)."""
    cap = state.capacity
    tree = state.tree.at[cap + idx].set(values.astype(jnp.float32), mode="drop")

    level = tree[cap:]
    out = tree
    pos = cap
    while pos > 1:
        level = _combine(state.op, level[0::2], level[1::2])
        pos //= 2
        out = jax.lax.dynamic_update_slice(out, level, (pos,))
    return SegmentTreeState(tree=out, op=state.op)


def tree_total(state: SegmentTreeState) -> jax.Array:
    """Root reduction over all leaves (sum() / min(), ranbowdqn.py:221-223,
    259-262)."""
    return state.tree[1]


def find_prefixsum_idx(state: SegmentTreeState,
                       prefixsum: jax.Array) -> jax.Array:
    """Vectorised descent (ranbowdqn.py:240-248): for each query mass,
    the highest leaf index whose prefix sum is <= mass."""
    assert state.op == "sum"
    cap = state.capacity
    tree = state.tree

    def body(_, carry):
        idx, mass = carry
        left = tree[2 * idx]
        go_left = left > mass
        idx = jnp.where(go_left, 2 * idx, 2 * idx + 1)
        mass = jnp.where(go_left, mass, mass - left)
        return idx, mass

    idx0 = jnp.ones_like(jnp.atleast_1d(prefixsum), jnp.int32)
    idx, _ = jax.lax.fori_loop(
        0, _levels(cap), body, (idx0, jnp.atleast_1d(prefixsum)))
    return idx - cap
