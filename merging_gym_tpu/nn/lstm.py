"""LSTM recurrent Q-network -- the reference's DRQN, resurrected.

The reference defines a ``DRQN`` (scripts/main.py:49-74) that can never
run: it references an undefined ``Flatten`` and an unused Conv2d, and is
never instantiated -- dead code.  SURVEY.md section 5 prescribes the
On-device resurrection: scan over time.  The intended
architecture (main.py:60-66, minus the dead conv path) is kept:

    fc1: obs -> 200 (ReLU, U(0,1) weights)   # main.py:60-61
    fc2: 200 -> 16                            # main.py:62-63
    lstm: 16 -> 16 (single layer)             # main.py:52-54,58
    fc3: 16 -> 16 (ReLU)                      # main.py:65
    fc4: 16 -> num_actions                    # main.py:66

Implemented functionally: params are dicts, the cell is a pure function,
sequences run under ``jax.lax.scan``.  Torch LSTM gate init
(U(-1/sqrt(h), 1/sqrt(h)) for all weights and both biases) is matched.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from merging_gym_tpu.nn.init import linear_params

LSTM_HIDDEN = 16  # main.py:52-53


def lstm_cell_init(key, input_size, hidden_size, dtype=jnp.float32):
    """Torch nn.LSTM single-layer init: U(-k, k), k = 1/sqrt(hidden)."""
    k = 1.0 / math.sqrt(hidden_size)
    ks = jax.random.split(key, 4)
    u = lambda kk, shape: jax.random.uniform(kk, shape, dtype, -k, k)
    return {
        "w_ih": u(ks[0], (input_size, 4 * hidden_size)),
        "w_hh": u(ks[1], (hidden_size, 4 * hidden_size)),
        "b_ih": u(ks[2], (4 * hidden_size,)),
        "b_hh": u(ks[3], (4 * hidden_size,)),
    }


def lstm_cell_apply(params, x, carry):
    """One LSTM step; torch gate order i, f, g, o."""
    h, c = carry
    gates = (jnp.dot(x, params["w_ih"], preferred_element_type=jnp.float32)
             .astype(x.dtype) + params["b_ih"]
             + jnp.dot(h, params["w_hh"], preferred_element_type=jnp.float32)
             .astype(x.dtype) + params["b_hh"])
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    h = jax.nn.sigmoid(o) * jnp.tanh(c)
    return h, (h, c)


def lstm_zero_carry(batch_shape, hidden_size=LSTM_HIDDEN, dtype=jnp.float32):
    z = jnp.zeros(batch_shape + (hidden_size,), dtype)
    return (z, z)


def drqn_init(key, num_inputs, num_actions, dtype=jnp.float32,
              hidden=LSTM_HIDDEN):
    """``hidden`` widens the LSTM/fc3 trunk past the reference's 16
    (main.py:52-66) for the production width-scaling study
    (benchmarks/drqn_width.py); the default is reference-faithful."""
    ks = jax.random.split(key, 5)
    return {
        "fc1": linear_params(ks[0], num_inputs, 200, "uniform01", dtype),
        "fc2": linear_params(ks[1], 200, hidden, "uniform01", dtype),
        "lstm": lstm_cell_init(ks[2], hidden, hidden, dtype),
        "fc3": linear_params(ks[3], hidden, hidden, "torch", dtype),
        "fc4": linear_params(ks[4], hidden, num_actions, "torch", dtype),
    }


def _dense(p, x):
    return jnp.dot(x, p["w"], preferred_element_type=jnp.float32).astype(x.dtype) + p["b"]


def drqn_step(params, obs, carry):
    """One timestep: obs [..., num_inputs] -> (q [..., A], new carry)."""
    h = jax.nn.relu(_dense(params["fc1"], obs))
    h = _dense(params["fc2"], h)
    h, carry = lstm_cell_apply(params["lstm"], h, carry)
    h = jax.nn.relu(_dense(params["fc3"], h))
    return _dense(params["fc4"], h), carry


def drqn_unroll(params, obs_seq, carry):
    """Scan over time: obs_seq [T, ..., num_inputs] -> q [T, ..., A]."""
    def body(carry, obs):
        q, carry = drqn_step(params, obs, carry)
        return carry, q

    carry, qs = jax.lax.scan(body, carry, obs_seq)
    return qs, carry
