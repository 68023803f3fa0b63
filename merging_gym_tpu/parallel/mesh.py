"""Device-mesh construction helpers.

The reference has no distributed backend at all (SURVEY.md section 2.6);
here the scaling axes are first-class: a named ``jax.sharding.Mesh`` with
a ``data`` axis (env batch + learner batch, the dominant axis for this
workload) and a ``model`` axis (tensor-parallel hidden dims).  Collectives
are XLA's (psum/all_gather inside jit/shard_map); multi-host runs use
``jax.distributed.initialize`` with the same SPMD program per host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """Build a (data, model) mesh; ``data`` defaults to all-devices/model."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if data is None:
        data = len(devices) // model
    assert data * model <= len(devices), (data, model, len(devices))
    arr = np.asarray(devices[: data * model]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the data axis (env batch, replay)."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Place a PyTree with its leading axis sharded over ``data``."""
    return jax.device_put(tree, data_sharding(mesh))
