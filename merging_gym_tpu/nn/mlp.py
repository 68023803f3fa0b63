"""Q-network MLPs as transparent param-PyTree + pure-apply pairs.

Counterpart of the reference ``Net`` modules (scripts/main.py:30-47,
hdqn.py:38-55): input -> 200 -> 100 -> outputs with ReLU, weights
U(0, 1), biases torch-default.  Params are plain nested dicts, so they
replicate/shard with jax.sharding and vmap over ensembles.
"""

import jax
import jax.numpy as jnp

from merging_gym_tpu.nn.init import linear_params

HIDDEN = (200, 100)  # main.py:34-38


def qnet_init(key, num_inputs, num_outputs, hidden=HIDDEN,
              weight_init="uniform01", dtype=jnp.float32):
    """Init the reference MLP Q-net (main.py:30-47)."""
    dims = (num_inputs,) + tuple(hidden) + (num_outputs,)
    keys = jax.random.split(key, len(dims) - 1)
    return {
        f"fc{i}": linear_params(k, dims[i], dims[i + 1], weight_init, dtype)
        for i, k in enumerate(keys)
    }


def qnet_apply(params, x):
    """Forward pass; ``x``: f[..., num_inputs] -> f[..., num_outputs].

    Matmuls carry ``preferred_element_type=f32`` so the MXU accumulates in
    f32 even if params/activations are bf16.
    """
    n = len(params)
    for i in range(n):
        p = params[f"fc{i}"]
        x = jnp.dot(x, p["w"], preferred_element_type=jnp.float32).astype(x.dtype) + p["b"]
        if i < n - 1:
            x = jax.nn.relu(x)
    return x
