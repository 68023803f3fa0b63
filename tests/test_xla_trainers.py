"""Properties shared by the four XLA trainer families (DQN, HDQN, Rainbow,
DRQN): learn-gate and target-sync timing step by step, resume ==
continue through a full-state checkpoint, and the ``parallel.spmd``
wrappers on a one-device mesh equal to the single-device path."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import numpy as np
import pytest

from merging_gym_tpu.agents import dqn as D
from merging_gym_tpu.agents import drqn as DR
from merging_gym_tpu.agents import hdqn as H
from merging_gym_tpu.agents import rainbow as R
from merging_gym_tpu.core.env import EnvParams
from merging_gym_tpu.parallel import spmd
from merging_gym_tpu.parallel.mesh import make_mesh

N_ENVS = 8


@dataclasses.dataclass(frozen=True)
class Family:
    cfg: Any
    init: Callable              # (key, cfg, env_params, num_envs) -> carry
    chunk: Callable             # (cfg, env_params, carry, steps) -> carry
    spmd_init: Callable
    spmd_chunk: Callable
    nets: Callable              # carry -> (params, target_params)


FAMILIES = {
    "dqn": Family(
        D.DQNConfig(memory_capacity=32, batch_size=8, target_sync=3),
        D.train_init, D.train_chunk, spmd.spmd_train_init,
        spmd.spmd_train_chunk, lambda c: (c.dqn.params, c.dqn.target_params)),
    "hdqn": Family(
        H.HDQNConfig(memory_capacity=32, goal_memory_capacity=8,
                     batch_size=8, target_sync=3),
        H.hdqn_init, H.hdqn_train_chunk, spmd.spmd_hdqn_init,
        spmd.spmd_hdqn_chunk, lambda c: (c.lower.params, c.lower.target_params)),
    "rainbow": Family(
        R.RainbowConfig(memory_capacity=64, batch_size=8,
                        target_sync_episodes=8, obs_scale=0.01),
        R.rainbow_train_init, R.rainbow_train_chunk, spmd.spmd_rainbow_init,
        spmd.spmd_rainbow_chunk, lambda c: (c.params, c.target_params)),
    "drqn": Family(
        DR.DRQNConfig(memory_capacity=32, batch_size=4, seq_len=4, burn_in=1,
                      target_sync=3),
        DR.drqn_train_init, DR.drqn_train_chunk, spmd.spmd_drqn_init,
        spmd.spmd_drqn_chunk, lambda c: (c.params, c.target_params)),
}


def _leaves(tree):
    out = []
    for x in jax.tree.leaves(tree):
        if jax.dtypes.issubdtype(getattr(x, "dtype", None), jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        out.append(np.asarray(x))
    return out


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(la, lb))


def _assert_same(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


def _learn_gate(name, cfg, carry):
    """The family's own learn gate, read from the carry after a step."""
    if name == "dqn":
        return int(carry.replay.cursor) >= cfg.memory_capacity
    if name == "hdqn":
        return int(carry.lower_replay.cursor) >= cfg.memory_capacity
    if name == "drqn":
        return int(carry.replay.cursor) >= cfg.batch_size
    return int(carry.replay.cursor) > cfg.batch_size


def _learns(name, carry):
    return int({"dqn": lambda c: c.dqn.learn_counter,
                "hdqn": lambda c: c.lower.learn_counter,
                "drqn": lambda c: c.learn_counter}[name](carry))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_learn_gate_and_target_sync_timing(name):
    """Step one env step at a time: the learner runs exactly on the steps
    where the family's gate is open, and the target net is replaced on
    exactly the steps its sync rule names -- every ``target_sync`` learns
    before the update (DQN, HDQN, DRQN: main.py:125-127), or when the
    completed-episode count crosses a multiple of ``target_sync_episodes``
    after the update (Rainbow: ranbowdqn.py:690-691)."""
    fam = FAMILIES[name]
    cfg = fam.cfg
    env = EnvParams(max_steps=5) if name == "rainbow" else EnvParams()
    prev = fam.init(jax.random.key(0), cfg, env, N_ENVS)
    learned_steps = synced_steps = 0
    for _ in range(16):
        cur = fam.chunk(cfg, env, prev, 1)
        (p0, t0), (p1, t1) = fam.nets(prev), fam.nets(cur)
        gate = _learn_gate(name, cfg, cur)
        if name == "rainbow":
            assert (not _same(p0, p1)) == gate
            eps = lambda c: int(c.metrics.episodes) // cfg.target_sync_episodes
            sync = eps(cur) > eps(prev)
            _assert_same(t1, p1 if sync else t0, "rainbow target")
        else:
            n0 = _learns(name, prev)
            assert _learns(name, cur) == n0 + gate
            sync = gate and n0 % cfg.target_sync == 0
            _assert_same(t1, p0 if sync else t0, f"{name} target")
        learned_steps += gate
        synced_steps += sync
        prev = cur
    assert learned_steps >= 4 and synced_steps >= 2, (learned_steps,
                                                     synced_steps)


@pytest.mark.parametrize("name", ["dqn", "hdqn", "rainbow"])
def test_resume_equals_continue(name, tmp_path):
    """A run restored from a full-state checkpoint continues bit for bit
    like the uninterrupted run (the DRQN case is
    tests/test_recovery.py::test_drqn_orbax_resume_equals_continue)."""
    from merging_gym_tpu.io.checkpoint import CheckpointManager

    fam = FAMILIES[name]
    env = EnvParams(max_steps=30)
    carry0 = fam.init(jax.random.key(1), fam.cfg, env, N_ENVS)
    mid = fam.chunk(fam.cfg, env, carry0, 12)
    cont = fam.chunk(fam.cfg, env, mid, 12)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, mid, wait=True)
    restored = mgr.restore(fam.init(jax.random.key(1), fam.cfg, env, N_ENVS))
    mgr.close()
    _assert_same(fam.chunk(fam.cfg, env, restored, 12), cont, name)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_one_device_mesh_equals_single_device(name):
    """``spmd_*`` on a (data=1, model=1) mesh runs the same program as the
    single-device trainer with the chunk key folded with device index 0:
    counters and env states come out identical, the nets equal up to
    rounding (the two programs may fuse the learner's sums differently)."""
    fam = FAMILIES[name]
    dev = jax.devices()[:1]
    mesh = make_mesh(data=1, model=1, devices=dev)
    env = EnvParams(max_steps=40)
    dp_cfg = fam.cfg if name == "dqn" else fam.cfg.replace(pmean_axis="data")
    steps = 24

    sharded = fam.spmd_init(jax.random.key(2), dp_cfg, env,
                            num_envs=N_ENVS, mesh=mesh)
    sharded = jax.device_get(fam.spmd_chunk(mesh, dp_cfg, env, sharded, steps))

    single = fam.init(jax.random.key(2), fam.cfg, env, N_ENVS)
    single = single.replace(key=jax.random.fold_in(single.key, 0))
    single = jax.device_get(fam.chunk(fam.cfg, env, single, steps))

    _assert_same(sharded.metrics, single.metrics, f"{name} metrics")
    _assert_same(sharded.env_state, single.env_state, f"{name} env state")
    for a, b in zip(_leaves(fam.nets(sharded)), _leaves(fam.nets(single))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} nets")


@pytest.mark.parametrize("name", ["dqn", "hdqn"])
def test_bf16_compute_keeps_f32_masters(name):
    """``compute_dtype="bfloat16"`` runs the forwards in bf16 while the
    learned params, their targets and Adam's moments stay float32 and
    follow the f32 run from the same start closely."""
    fam = FAMILIES[name]
    env = EnvParams(max_steps=30)
    runs = {}
    for dt in ("float32", "bfloat16"):
        cfg = fam.cfg.replace(compute_dtype=dt)
        carry = fam.init(jax.random.key(3), cfg, env, N_ENVS)
        runs[dt] = jax.device_get(fam.chunk(cfg, env, carry, 6))
    learner = (lambda c: c.dqn) if name == "dqn" else (lambda c: c.lower)
    bf = learner(runs["bfloat16"])
    assert int(bf.learn_counter) > 0
    for leaf in jax.tree.leaves((bf.params, bf.target_params, bf.opt_state)):
        if np.issubdtype(np.asarray(leaf).dtype, np.floating):
            assert np.asarray(leaf).dtype == np.float32
            assert np.isfinite(leaf).all()
    f32 = learner(runs["float32"])
    for a, b in zip(jax.tree.leaves(bf.params), jax.tree.leaves(f32.params)):
        # Adam moves each weight by at most lr = 0.01 per learn.
        np.testing.assert_allclose(a, b, atol=0.01 * int(bf.learn_counter))
