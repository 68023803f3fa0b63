"""Locks for the counters mode of the rollout kernel
(``fused_rollout_counters``): its per-env counters equal the reductions
of the trajectory kernel's outputs over the same action stream, in
actions mode and in seed mode, whatever the tiling."""

import numpy as np
import pytest

from merging_gym_tpu.core import constants as C
from merging_gym_tpu.ops import fused_rollout as FR

import chip_smoke


def _run(counters, T, N, block=64, warps=1, **kw):
    fn = FR.fused_rollout_counters if counters else FR.fused_rollout
    return fn(T, N, block_envs=block, num_warps=warps, interpret=True, **kw)


@pytest.mark.parametrize("num_envs", [50, 256])
def test_counters_match_trajectory_reductions_actions_mode(num_envs):
    T = 400
    rng = np.random.default_rng(3)
    kw = {"actions": rng.integers(-1, C.NUM_ACTIONS, size=(T, 2, num_envs)
                                  ).astype(np.int32)}
    traj = _run(False, T, num_envs, **kw)
    cnt = _run(True, T, num_envs, **kw)
    # Random joint actions over 400 steps produce every outcome class;
    # guard that the lock is not vacuous.
    assert int(np.sum(cnt["episodes"])) > 0
    assert int(np.sum(cnt["collisions"])) > 0
    chip_smoke.compare_counters(cnt, chip_smoke.counters_of(traj))


@pytest.mark.parametrize("block,warps", [(32, 1), (64, 2), (128, 4)])
def test_counters_match_trajectory_reductions_seed_mode(block, warps):
    T, N, seed = 512, 200, 7
    traj = _run(False, T, N, block, warps, seed=seed)
    cnt = _run(True, T, N, block, warps, seed=seed)
    chip_smoke.compare_counters(cnt, chip_smoke.counters_of(traj))


@pytest.mark.parametrize("counters", [False, True])
def test_seed_mode_is_independent_of_tiling(counters):
    """The counter-based generator keys each draw by (seed, env, step), so
    one seed gives one stream whatever the tile size."""
    T, N = 120, 100
    base = _run(counters, T, N, 32, seed=9)
    for block in (64, 128):
        other = _run(counters, T, N, block, seed=9)
        for k in base:
            np.testing.assert_array_equal(np.asarray(other[k]),
                                          np.asarray(base[k]), err_msg=k)
