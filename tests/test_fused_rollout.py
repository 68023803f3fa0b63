"""The rollout kernel (ops/fused_rollout.py) in the Pallas interpreter
against the plain XLA rollout (core.vector), which it must reproduce:
events exactly, floats to rounding."""

import numpy as np
import pytest

from merging_gym_tpu.core import constants as C
from merging_gym_tpu.core.env import EnvParams
from merging_gym_tpu.ops import fused_rollout as FR

import chip_smoke


def _actions(T, N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, C.NUM_ACTIONS, size=(T, 2, N)).astype(np.int32)


def _kernel(T, N, block=32, counters=False, **kw):
    fn = FR.fused_rollout_counters if counters else FR.fused_rollout
    return fn(T, N, block_envs=block, num_warps=1, interpret=True, **kw)


def _check_traj(T, N, block, **kw):
    got = _kernel(T, N, block, **kw)
    want = FR.reference_rollout(T, N, **kw)
    chip_smoke.compare_trajectories(got, want)
    return got


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("num_envs", [1, 77, 128, 300, 1024])
def test_trajectory_matches_reference_actions_mode(num_envs, block):
    T = 96
    _check_traj(T, num_envs, block, actions=_actions(T, num_envs))


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("num_envs", [1, 77, 300])
def test_trajectory_matches_reference_seed_mode(num_envs, block):
    _check_traj(96, num_envs, block, seed=11)


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("num_envs", [1, 77, 128, 300, 1024])
def test_counters_match_reference(num_envs, block):
    T = 96
    kw = {"actions": _actions(T, num_envs, seed=1)}
    chip_smoke.compare_counters(_kernel(T, num_envs, block, True, **kw),
                                FR.reference_rollout_counters(T, num_envs,
                                                              **kw))


def test_events_occur_in_checked_horizon():
    """The comparisons above are not vacuous: a 300-step random rollout
    produces collisions, wins for both seats and completed episodes."""
    T, N = 300, 128
    cnt = _kernel(T, N, 64, True, seed=2)
    assert int(np.sum(cnt["episodes"])) > 0
    assert int(np.sum(cnt["collisions"])) > 0
    assert int(np.sum(cnt["wins1"])) > 0 and int(np.sum(cnt["wins2"])) > 0
    chip_smoke.compare_counters(cnt, FR.reference_rollout_counters(T, N,
                                                                   seed=2))


@pytest.mark.parametrize("max_steps", [1, 5, 37])
def test_short_max_steps_forces_timeouts(max_steps):
    T, N = 80, 40
    ep = EnvParams(max_steps=max_steps)
    acts = np.zeros((T, 2, N), np.int32)       # both brake: only timeouts
    got = _check_traj(T, N, 32, actions=acts, env_params=ep)
    done = np.asarray(got["done"])
    steps = np.arange(1, T + 1)[:, None]
    np.testing.assert_array_equal(done, np.broadcast_to(
        steps % max_steps == 0, done.shape))


@pytest.mark.parametrize("params", [
    EnvParams(r_collision=-100.0),
    EnvParams(r_first=5.0, r_second=0.5),
    EnvParams(vel_penalty=0.01, time_penalty=0.1),
], ids=["collision", "bonuses", "penalties"])
def test_reward_variants(params):
    T, N = 200, 64
    got = _check_traj(T, N, 64, seed=5, env_params=params)
    cnt = _kernel(T, N, 64, True, seed=5, env_params=params)
    chip_smoke.compare_counters(cnt, chip_smoke.counters_of(got))


def test_collision_reward_reaches_both_seats():
    T, N = 200, 32
    acts = np.full((T, 2, N), 2, np.int32)     # mirror matchup -> collision
    base = _kernel(T, N, actions=acts)
    harsh = _kernel(T, N, actions=acts, env_params=EnvParams(r_collision=-100.))
    col = np.asarray(base["collision"])
    assert col.any()
    diff = np.asarray(harsh["rewards"]) - np.asarray(base["rewards"])
    np.testing.assert_allclose(diff[:, 0][col], -90.0, atol=1e-4)
    np.testing.assert_allclose(diff[:, 1][col], -90.0, atol=1e-4)
    np.testing.assert_allclose(diff[:, 0][~col], 0.0, atol=1e-6)


@pytest.mark.parametrize("counters", [False, True])
def test_single_step(counters):
    kw = {"actions": _actions(1, 5)}
    got = _kernel(1, 5, 32, counters, **kw)
    if counters:
        chip_smoke.compare_counters(got, FR.reference_rollout_counters(1, 5,
                                                                       **kw))
    else:
        chip_smoke.compare_trajectories(got, FR.reference_rollout(1, 5, **kw))
        np.testing.assert_allclose(np.asarray(got["obs"])[0, 3],
                                   C.END_POINT - C.START_POINT - np.asarray(
                                       got["obs"])[0, 4] * C.DT, atol=1e-3)


def test_tail_tile_is_masked():
    """Envs past num_envs in the last tile neither read nor write: the
    outputs have exactly num_envs columns equal to the reference."""
    T, N = 30, 33
    acts = _actions(T, N, seed=4)
    got = _kernel(T, N, 32, actions=acts)
    assert np.asarray(got["obs"]).shape == (T, 10, N)
    cnt = _kernel(T, N, 32, True, actions=acts)
    assert np.asarray(cnt["reward_sum"]).shape == (2, N)
    chip_smoke.compare_counters(cnt, chip_smoke.counters_of(got))


def test_autoreset_restarts_from_the_start_state():
    T, N = 300, 8
    acts = np.zeros((T, 2, N), np.int32)
    acts[:, 0] = 4                               # ego floors it vs L0
    acts[:, 1] = C.ACTION_NONE
    got = _kernel(T, N, actions=acts)
    done = np.asarray(got["done"])[:, 0]
    t_done = int(np.argmax(done))
    assert done[t_done]
    # The step after a reset starts again near the start line.
    assert float(np.asarray(got["obs"])[t_done + 1, 3, 0]) > 890.0


@pytest.mark.parametrize("fn", [FR.fused_rollout, FR.fused_rollout_counters,
                                FR.reference_rollout])
def test_random_start_is_refused(fn):
    with pytest.raises(ValueError, match="deterministic starts"):
        fn(4, 8, seed=0, env_params=EnvParams(random_start=True))


@pytest.mark.parametrize("kw", [{}, {"seed": 0, "actions": _actions(4, 8)}],
                         ids=["neither", "both"])
def test_exactly_one_action_source(kw):
    with pytest.raises(ValueError, match="exactly one"):
        FR.fused_rollout(4, 8, **kw)


def test_bad_shapes_and_tiles_are_refused():
    with pytest.raises(ValueError, match="actions must be"):
        FR.fused_rollout(4, 8, actions=_actions(4, 9))
    with pytest.raises(ValueError, match="power of two"):
        FR.fused_rollout(4, 8, seed=0, block_envs=48)
    with pytest.raises(ValueError, match="too large"):
        FR.fused_rollout(2600, 131072, seed=0)
