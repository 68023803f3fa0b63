"""C51 categorical Bellman projection.

On-device port of the reference ``projection_distribution``
(scripts/ranbowdqn.py:554-582): the torch ``index_add_`` scatter over
``(batch*atoms)`` becomes a pair of ``.at[].add`` scatters under jit.

Faithfulness note: the reference projects ``p_i * z_i`` -- it reuses the
support-weighted distribution it built for action selection as the mass
being projected (ranbowdqn.py:560-563) -- rather than the plain
probabilities ``p_i`` of textbook C51, so its target "distribution" sums
to E[Z], not 1.  ``weight_by_support=True`` (default) reproduces that;
``False`` gives the textbook projection.
"""

import jax.numpy as jnp


def categorical_projection(next_probs, rewards, dones, support,
                           gamma=0.99, weight_by_support=True):
    """Project the target distribution onto the fixed support.

    Args:
      next_probs: f[B, atoms] softmax output of the target net for the
        already-selected greedy action.
      rewards: f[B]; dones: f/bool[B]; support: f[atoms] linspace(Vmin, Vmax).
      gamma: 0.99, hardcoded in the reference (ranbowdqn.py:569).

    Returns f[B, atoms] projected mass.
    """
    num_atoms = support.shape[0]
    vmin, vmax = support[0], support[-1]
    delta_z = (vmax - vmin) / (num_atoms - 1)

    mass = next_probs * support if weight_by_support else next_probs

    dones = dones.astype(next_probs.dtype)
    tz = rewards[:, None] + (1.0 - dones[:, None]) * gamma * support
    tz = jnp.clip(tz, vmin, vmax)
    b = (tz - vmin) / delta_z
    lo = jnp.floor(b)
    hi = jnp.ceil(b)

    lo_w = hi - b
    hi_w = b - lo
    if not weight_by_support:
        # Textbook mode conserves mass when Tz lands exactly on an atom
        # (lo == hi makes both weights 0); the faithful mode reproduces the
        # reference's mass loss there (ranbowdqn.py:572-580).
        lo_w = lo_w + (lo == hi).astype(mass.dtype)

    proj = jnp.zeros_like(mass)
    proj = proj.at[jnp.arange(b.shape[0])[:, None], lo.astype(jnp.int32)].add(
        mass * lo_w)
    proj = proj.at[jnp.arange(b.shape[0])[:, None], hi.astype(jnp.int32)].add(
        mass * hi_w)
    return proj
