"""Counter-based random actions: a pure function of (seed, env, step, draw).

The rollout kernel (ops/fused_rollout.py) and its plain XLA reference both
draw their random joint actions from this module, so a seed-mode rollout
is one fixed stream whatever the kernel's tiling, and the kernel can be
checked against the reference in seed mode as well as in actions mode.

The generator chains Chris Wellons' ``lowbias32`` integer finaliser over
the four counters, each stage keyed by the previous one::

    k = mix(mix(seed ^ GOLDEN) ^ env)      # once per env
    h = mix(k ^ step)                      # once per env step
    bits = mix(h ^ draw)                   # once per draw (0 = player 1)

Everything is 32-bit integer arithmetic (wrapping multiplies, logical
shifts), which XLA, Triton and numpy all compute bit-identically.  The
arithmetic is done on int32 with the constants written as their signed
two's-complement values, so no unsigned constant has to be lowered.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from merging_gym_tpu.core import constants as C

_GOLDEN = 0x9E3779B9
_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def _i32(v: int) -> jnp.ndarray:
    """A 32-bit constant as the int32 with the same bits."""
    return jnp.int32(v - (1 << 32) if v >= (1 << 31) else v)


def mix32(x):
    """``lowbias32`` on the 32 bits of an int32 array (a bijection)."""
    x = x ^ lax.shift_right_logical(x, jnp.int32(16))
    x = x * _i32(_M1)
    x = x ^ lax.shift_right_logical(x, jnp.int32(15))
    x = x * _i32(_M2)
    return x ^ lax.shift_right_logical(x, jnp.int32(16))


def env_key(seed, env):
    """Per-env stream key from an int32 ``seed`` and int32 env indices."""
    seed = jnp.asarray(seed, jnp.int32)
    env = jnp.asarray(env, jnp.int32)
    return mix32(mix32(seed ^ _i32(_GOLDEN)) ^ env)


def step_actions(key, step):
    """Both players' actions in [-1, NUM_ACTIONS) for one env step.

    ``-1`` is the ACTION_NONE arm, so each of the six values is equally
    likely: the joint random policy of the benchmarks.  The top 16 bits
    are scaled to [0, 6) by a multiply and shift (no integer division).
    """
    h = mix32(key ^ jnp.asarray(step, jnp.int32))
    n = jnp.int32(C.NUM_ACTIONS + 1)

    def draw(d):
        bits = mix32(h ^ jnp.int32(d))
        hi = lax.shift_right_logical(bits, jnp.int32(16))
        return lax.shift_right_logical(hi * n, jnp.int32(16)) - 1

    return draw(0), draw(1)
