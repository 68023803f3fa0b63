"""N-step return windows for vectorised envs -- pure, testable.

Maintains, per env, a sliding FIFO of the last ``n`` transitions with
incrementally accumulated discounted returns:

* slot ``k`` holds the entry of age ``k+1`` (number of rewards already
  folded into its return);
* on each step the new reward ``r_t`` adds ``gamma^age`` to every open
  entry, the window shifts, and the new entry enters with return
  ``r_t``;
* an entry matures at age ``n`` (its return is the full n-step sum
  ``r_j + gamma r_{j+1} + ... + gamma^{n-1} r_{j+n-1}``) and is emitted
  with ``done=False`` and bootstrap observation ``s_{j+n}`` (this
  step's post-step obs);
* when the episode ends, *all* open entries flush immediately with
  their truncated returns and ``done=True`` -- before any next-episode
  reward could pollute them.

One mature emission per env per step in steady state (every transition
becomes an n-step transition), up to ``n`` on episode end.  Used by
agents.rainbow for ``n_step > 1``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from merging_gym_tpu.utils import struct


@struct.dataclass
class NStepState:
    obs: jax.Array     # f[n, envs, obs_dim]
    action: jax.Array  # i32[n, envs]
    ret: jax.Array     # f[n, envs] accumulated discounted return
    length: jax.Array  # i32[envs] open entries (after this step's insert)


def nstep_init(n: int, num_envs: int, obs_dim: int) -> NStepState:
    return NStepState(
        obs=jnp.zeros((n, num_envs, obs_dim), jnp.float32),
        action=jnp.zeros((n, num_envs), jnp.int32),
        ret=jnp.zeros((n, num_envs), jnp.float32),
        length=jnp.zeros((num_envs,), jnp.int32),
    )


def nstep_update(state: NStepState, obs, action, reward, done, next_obs,
                 gamma: float):
    """Fold one env step into the windows.

    Args are batched over envs: obs f[envs, d] (pre-step), action
    i32[envs], reward f[envs], done bool[envs], next_obs f[envs, d]
    (post-step, pre-reset).

    Returns ``(new_state, items, mask)`` where items is a flat
    [n*envs]-batched transition dict and mask selects the emitted ones.
    """
    n = state.obs.shape[0]
    reward = reward.astype(jnp.float32)

    # 1. Accumulate gamma^age * r into open entries (slot k has age k+1).
    ages = jnp.arange(1, n + 1, dtype=jnp.float32)[:, None]
    open_mask = (jnp.arange(n)[:, None] < state.length[None, :])
    ret = state.ret + jnp.where(open_mask, (gamma ** ages) * reward[None, :], 0.0)

    # 2. Shift by one age and insert the new entry at slot 0.
    new_obs = jnp.roll(state.obs, 1, axis=0).at[0].set(obs.astype(jnp.float32))
    new_action = jnp.roll(state.action, 1, axis=0).at[0].set(action)
    new_ret = jnp.roll(ret, 1, axis=0).at[0].set(reward)
    length = jnp.minimum(state.length + 1, n)

    # 3. Emission: the mature slot (n-1) in steady state, every valid slot
    # on episode end.
    valid = jnp.arange(n)[:, None] < length[None, :]
    mature = jnp.zeros((n,), bool).at[n - 1].set(True)[:, None] & valid
    emit = jnp.where(done[None, :], valid, mature)

    envs = obs.shape[0]
    items = {
        "obs": new_obs.reshape(n * envs, -1),
        "action": new_action.reshape(n * envs),
        "reward": new_ret.reshape(n * envs),
        "next_obs": jnp.broadcast_to(next_obs.astype(jnp.float32),
                                     (n,) + next_obs.shape).reshape(n * envs, -1),
        "done": jnp.broadcast_to(done, (n, envs)).reshape(n * envs),
    }
    mask = emit.reshape(n * envs)

    # 4. Post-emission bookkeeping: mature slot frees up; done clears all.
    length = jnp.where(done, 0, jnp.where(length >= n, n - 1, length))
    return NStepState(obs=new_obs, action=new_action, ret=new_ret,
                      length=length), items, mask
