"""Hyper-parameter sweeps as a vmap axis: N experiments in one jit.

The reference explored reward shaping by editing constants and re-running
whole trainings -- its checkpoint dirs encode the sweep by hand:
``...(2.0, 1.0, -10, 0.001)``, ``...(2.0, 1.0, -100, 0.001)``
(test_params/dqn/*, merging_env.py:27-32).  Because this framework's
reward parameters are PyTree *leaves* of ``EnvParams`` (not baked
constants), a sweep is just one more batch dimension: ``vmap`` the fused
actor+replay+learner chunk over stacked ``(EnvParams, TrainCarry)`` and
the GPU trains every configuration simultaneously in a single program --
no retracing, no serial runs, near-perfect utilisation since the configs
share every shape.

Static hyper-parameters (net sizes, batch size, capacities) stay shared;
anything that is a float leaf (reward tuple, penalties) can sweep.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from merging_gym_tpu.agents import dqn as D
from merging_gym_tpu.core.env import EnvParams


def stack_env_params(param_list) -> EnvParams:
    """Stack N EnvParams into one with leading sweep axis (static fields
    must agree)."""
    first = param_list[0]
    assert all(p.random_start == first.random_start and
               p.max_steps == first.max_steps for p in param_list)
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32)
                                               for x in xs]), *param_list)


def sweep_train_init(key: jax.Array, cfg: D.DQNConfig,
                     stacked_params: EnvParams, num_envs: int):
    """One independent TrainCarry per sweep entry (stacked on axis 0):
    distinct net inits, env batches, replays and PRNG streams."""
    n = jax.tree.leaves(stacked_params)[0].shape[0]
    keys = jax.random.split(key, n)
    return jax.vmap(lambda k, p: D.train_init(k, cfg, p, num_envs))(
        keys, stacked_params)


@partial(jax.jit, static_argnums=(0, 3))
def sweep_train_chunk(cfg: D.DQNConfig, stacked_params: EnvParams, carries,
                      num_steps: int):
    """Advance every sweep entry ``num_steps`` fused steps in one jit."""
    def one(p, c):
        c, _ = jax.lax.scan(partial(D.train_step, cfg, p), c, None,
                            length=num_steps)
        return c

    return jax.vmap(one)(stacked_params, carries)
