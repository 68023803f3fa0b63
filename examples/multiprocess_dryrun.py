"""Multi-PROCESS distributed training dryrun (one step up from the
single-process virtual mesh): N OS processes, each owning a shard of a
virtual CPU device mesh, wired together with jax.distributed -- the
same ``parallel.multihost.initialize`` + global-mesh + shard_map path a
real multi-host GPU cluster uses (collectives ride Gloo here, NCCL
there; the program is identical, SURVEY.md section 2.6).

Each process runs the full distributed DQN training step
(``parallel.spmd.spmd_train_chunk``: sharded envs + replay, psum grads,
tensor-parallel Q-net) over the GLOBAL mesh and prints a params
checksum; the launcher asserts every process computes the identical
replicated params -- cross-process gradient psum working end to end.

Run one process per shard (see tests/test_multiprocess.py, which
launches this):

    python examples/multiprocess_dryrun.py <proc_id> <num_procs> <port>
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(proc_id: int, num_procs: int, port: int,
         devices_per_proc: int = 2) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{devices_per_proc}")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from merging_gym_tpu.parallel import multihost

    multihost.initialize(f"localhost:{port}", num_processes=num_procs,
                         process_id=proc_id)
    assert jax.process_count() == num_procs
    ndev = len(jax.devices())
    assert ndev == num_procs * devices_per_proc

    import jax.numpy as jnp
    import numpy as np

    from merging_gym_tpu.agents import dqn as D
    from merging_gym_tpu.core.env import EnvParams
    from merging_gym_tpu.parallel import spmd
    from merging_gym_tpu.parallel.mesh import make_mesh

    # dp x tp global mesh spanning both processes (tp=2 exercises the
    # tensor-parallel psum("model") across the process boundary too).
    mesh = make_mesh(data=ndev // 2, model=2)
    cfg = D.DQNConfig(memory_capacity=16, batch_size=8,
                      opponent=D.OPP_SELFPLAY)
    env_params = EnvParams()
    carry = spmd.spmd_train_init(jax.random.key(0), cfg, env_params,
                                 num_envs=(ndev // 2) * 4, mesh=mesh)
    for _ in range(3):
        carry = spmd.spmd_train_chunk(mesh, cfg, env_params, carry, 3)
    jax.block_until_ready(carry.dqn.params)
    assert int(carry.metrics.env_steps) == 9 * (ndev // 2) * 4

    # Params are replicated: every process must print the SAME checksum.
    # Read each leaf through its locally-addressable replica (eager ops
    # on multi-process global arrays are not allowed; the local shard of
    # a replicated array IS the full array).
    csum = float(sum(np.abs(np.asarray(leaf.addressable_data(0))).sum()
                     for leaf in jax.tree.leaves(carry.dqn.params)))
    print(f"PROC{proc_id} OK env_steps={int(carry.metrics.env_steps)} "
          f"params_checksum={csum:.6f}", flush=True)

    # The other three XLA families over a pure data-parallel mesh that
    # spans the processes: per-step gradient pmean, per-device replay
    # cursors and psum'd counters crossing the process boundary.
    from merging_gym_tpu.agents import drqn as DR
    from merging_gym_tpu.agents import hdqn as H
    from merging_gym_tpu.agents import rainbow as R

    dmesh = make_mesh(data=ndev, model=1)
    families = (
        ("RAINBOW", R.RainbowConfig(memory_capacity=32, batch_size=8,
                                    per=True, n_step=3, pmean_axis="data"),
         spmd.spmd_rainbow_init, spmd.spmd_rainbow_chunk,
         lambda c: c.params),
        ("HDQN", H.HDQNConfig(memory_capacity=32, goal_memory_capacity=8,
                              batch_size=8, opponent=D.OPP_SELFPLAY,
                              pmean_axis="data"),
         spmd.spmd_hdqn_init, spmd.spmd_hdqn_chunk,
         lambda c: (c.lower.params, c.upper.params)),
        ("DRQN", DR.DRQNConfig(memory_capacity=8, batch_size=4, seq_len=4,
                               burn_in=1, opponent=D.OPP_SELFPLAY,
                               pmean_axis="data"),
         spmd.spmd_drqn_init, spmd.spmd_drqn_chunk, lambda c: c.params),
    )
    for i, (tag, fcfg, init, chunk, params_of) in enumerate(families):
        fcarry = init(jax.random.key(5 + i), fcfg, env_params,
                      num_envs=ndev * 4, mesh=dmesh)
        for _ in range(2):
            fcarry = chunk(dmesh, fcfg, env_params, fcarry, 3)
        jax.block_until_ready(params_of(fcarry))
        assert int(fcarry.metrics.env_steps) == 6 * ndev * 4
        fsum = float(sum(np.abs(np.asarray(a.addressable_data(0))).sum()
                         for a in jax.tree.leaves(params_of(fcarry))))
        print(f"PROC{proc_id} {tag} OK "
              f"env_steps={int(fcarry.metrics.env_steps)} "
              f"params_checksum={fsum:.6f}", flush=True)

    # Multi-host checkpoint/resume (VERDICT r4 item 4): save the XLA
    # dp x tp carry -- params replicated, env batch + replay SHARDED over
    # a mesh spanning both processes -- through the process-aware orbax
    # path, restore it collectively, continue, and require the continued
    # run to be bitwise identical to the uninterrupted one.
    from merging_gym_tpu.io.checkpoint import CheckpointManager

    ckpt_dir = os.environ.get("MGT_MP_CKPT_DIR",
                              f"/tmp/mgt_mp_ckpt_{port}")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=1)
    mgr.save(0, carry, wait=True)
    cont = carry
    for _ in range(2):
        cont = spmd.spmd_train_chunk(mesh, cfg, env_params, cont, 3)
    restored = mgr.restore(carry)
    for _ in range(2):
        restored = spmd.spmd_train_chunk(mesh, cfg, env_params, restored, 3)
    jax.block_until_ready(restored.dqn.params)
    for a, b in zip(jax.tree.leaves(cont), jax.tree.leaves(restored)):
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            a, b = jax.random.key_data(a), jax.random.key_data(b)
        np.testing.assert_array_equal(np.asarray(a.addressable_data(0)),
                                      np.asarray(b.addressable_data(0)))
    csum2 = float(sum(np.abs(np.asarray(leaf.addressable_data(0))).sum()
                      for leaf in jax.tree.leaves(restored.dqn.params)))
    mgr.close()
    print(f"PROC{proc_id} CKPT OK env_steps={int(restored.metrics.env_steps)} "
          f"params_checksum={csum2:.6f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]),
         int(sys.argv[3]) if len(sys.argv) > 3 else 13557)
