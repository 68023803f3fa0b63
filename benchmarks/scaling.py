"""SPMD weak-scaling validation on a virtual device mesh.

This runs the SPMD DQN trainer across 1/2/4/8 *virtual CPU devices*
(`--xla_force_host_platform_device_count`) at a
fixed per-device env count.  Virtual devices share one host's CPU cores,
so throughput CANNOT increase with device count here -- the measurement
is a *structure* check, not a speed check: every mesh size must compile,
run, keep params replicated, and sustain roughly constant total
throughput (i.e. the program adds no cross-device serialisation beyond
the psum/pmin collectives).  On real devices -- where each mesh
coordinate is its own GPU -- the same program weak-scales with device
count (``chip_smoke.py --gpus 4`` runs it on four); parallel/multihost
wires it per host.

Run standalone (it must configure the platform before first backend use):

    python benchmarks/scaling.py
"""

import json
import os
import time

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from merging_gym_tpu.agents import dqn as D  # noqa: E402
from merging_gym_tpu.core.env import EnvParams  # noqa: E402
from merging_gym_tpu.parallel import spmd  # noqa: E402
from merging_gym_tpu.parallel.mesh import make_mesh  # noqa: E402


def measure(dp: int, envs_per_device: int = 64, steps: int = 50,
            chunks: int = 3) -> float:
    mesh = make_mesh(data=dp, model=1, devices=jax.devices()[:dp])
    cfg = D.DQNConfig(memory_capacity=256, batch_size=32,
                      opponent=D.OPP_SELFPLAY)
    env_params = EnvParams()
    carry = spmd.spmd_train_init(jax.random.key(0), cfg, env_params,
                                 num_envs=dp * envs_per_device, mesh=mesh)
    carry = spmd.spmd_train_chunk(mesh, cfg, env_params, carry, steps)
    float(jnp.sum(carry.dqn.params["fc2"]["b"]))
    t0 = time.perf_counter()
    for _ in range(chunks):
        carry = spmd.spmd_train_chunk(mesh, cfg, env_params, carry, steps)
        float(jnp.sum(carry.dqn.params["fc2"]["b"]))
    dt = time.perf_counter() - t0
    return dp * envs_per_device * steps * chunks / dt


def main():
    base = None
    for dp in (1, 2, 4, 8):
        rate = measure(dp)
        base = base or rate
        print(json.dumps({
            "metric": f"spmd-dqn-dp{dp}-virtualcpu",
            "value": round(rate, 1),
            "unit": "env-steps/s",
            # ~1.0 = no serialisation added by the mesh (virtual devices
            # share host cores, so > dp1 throughput is not possible here).
            "total_throughput_vs_dp1": round(rate / base, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
