"""Multi-host / multi-slice process coordination.

The reference is strictly single-process (SURVEY.md section 2.6).  The
scaling story across hosts is: every host runs the *same* SPMD program
(parallel.spmd) over the global mesh; ``jax.distributed.initialize``
wires the hosts together over the network, after which ``jax.devices()``
is the global device list and the shard_map collectives run exactly as
in the single-host case.

Nothing else in the framework changes per host -- env shards, replay
shards and metrics psum are already expressed over the ``data`` axis of
the global mesh.  This module holds the only host-aware glue: process
initialisation, a host-0 predicate for logging/checkpoint writers, and
per-host env-count bookkeeping.
"""

from __future__ import annotations

import jax

from merging_gym_tpu.parallel.mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wire this process into the multi-host run.

    Pass the coordinator's ``host:port``, the process count and this
    process's index (a cluster manager that JAX detects can supply them
    instead).  Call once per process, before the first backend use.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def is_coordinator() -> bool:
    """True on the process that should own writers (metrics/ckpt)."""
    return jax.process_index() == 0


def global_mesh(model: int = 1):
    """The global (data, model) mesh over every device in the job."""
    return make_mesh(model=model)


def envs_per_host(num_envs_global: int) -> int:
    """How many envs this host materialises: global count split over the
    data axis lands ``num_envs_global / num_devices`` per device, and
    jax places each device's shard on its own host automatically."""
    n = jax.device_count()
    assert num_envs_global % n == 0, (num_envs_global, n)
    return num_envs_global // jax.process_count() if jax.process_count() > 1 \
        else num_envs_global
