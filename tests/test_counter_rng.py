"""The counter-based action generator (core/counter_rng.py): equal to an
independent numpy implementation, uniform over the six action values, and
distinct streams for neighbouring envs, steps and seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core import counter_rng as R


def _np_mix(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))


def _np_actions(seed, env, step):
    seed = np.uint32(seed & 0xFFFFFFFF)
    key = _np_mix(_np_mix(seed ^ np.uint32(0x9E3779B9))
                  ^ np.asarray(env, np.uint32))
    h = _np_mix(key ^ np.asarray(step, np.uint32))
    out = []
    for d in (0, 1):
        bits = _np_mix(h ^ np.uint32(d))
        out.append(((bits >> np.uint32(16)) * np.uint32(6)
                    >> np.uint32(16)).astype(np.int64) - 1)
    return out


def _actions(seed, env, step):
    a1, a2 = jax.jit(lambda s, e, t: R.step_actions(R.env_key(s, e), t))(
        jnp.int32(seed), jnp.asarray(env, jnp.int32), jnp.int32(step))
    return np.asarray(a1), np.asarray(a2)


def test_mix32_matches_numpy():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x = x.astype(np.uint32)
    got = np.asarray(jax.jit(R.mix32)(jnp.asarray(x.view(np.int32))))
    np.testing.assert_array_equal(got.view(np.uint32), _np_mix(x))


@pytest.mark.parametrize("seed", [0, 1, 12345, -7, 2**31 - 1])
@pytest.mark.parametrize("step", [0, 1, 2600])
def test_actions_match_numpy(seed, step):
    env = np.arange(512)
    got = _actions(seed, env, step)
    want = _np_actions(seed, env, step)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_actions_are_uniform_chi_square():
    env = np.arange(4096)
    draws = np.concatenate([np.concatenate(_actions(3, env, t))
                            for t in range(32)])
    assert draws.min() == -1 and draws.max() == C.NUM_ACTIONS - 1
    counts = np.bincount(draws + 1, minlength=C.NUM_ACTIONS + 1)
    expect = draws.size / (C.NUM_ACTIONS + 1)
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    # 5 degrees of freedom: P(chi2 > 20.5) = 0.001.
    assert chi2 < 20.5, counts


def test_the_two_seats_are_independent():
    a1, a2 = _actions(5, np.arange(1 << 16), 0)
    joint = np.bincount((a1 + 1) * 6 + (a2 + 1), minlength=36)
    expect = a1.size / 36
    chi2 = float(((joint - expect) ** 2 / expect).sum())
    # 35 degrees of freedom: P(chi2 > 66.6) = 0.001.
    assert chi2 < 66.6


@pytest.mark.parametrize("vary", ["env", "step", "seed"])
def test_neighbouring_streams_differ(vary):
    """Streams one env, one step or one seed apart agree only by chance
    (1/6 per draw), not systematically."""
    n = 2048
    base = dict(seed=10, env=np.arange(n), step=np.full(n, 100))
    other = dict(base)
    other[vary] = base[vary] + 1
    keys = jax.vmap(R.env_key)
    bits = lambda s, e, t: np.concatenate(
        [np.asarray(a) for a in jax.jit(jax.vmap(
            lambda k, t: R.step_actions(k, t)))(
            keys(jnp.full(n, s, jnp.int32), jnp.asarray(e, jnp.int32)),
            jnp.asarray(t, jnp.int32))])
    a = bits(base["seed"], base["env"], base["step"])
    b = bits(other["seed"], other["env"], other["step"])
    agree = float(np.mean(a == b))
    assert abs(agree - 1 / 6) < 0.03, agree
