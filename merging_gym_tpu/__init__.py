"""merging_gym_tpu: a JAX two-player on-ramp merging RL framework.

A from-scratch JAX/XLA re-design with the full capability surface of the
reference ``merging-gym`` project (YikangZhang1641/merging-gym): the
merging simulator, level-k DQN / hierarchical DQN / Rainbow-C51 training,
human-experiment harness with CSV logging, checkpointing, and rendering --
rebuilt as pure functions over state PyTrees that jit, vmap, and shard
across GPU device meshes.
"""

__version__ = "0.1.0"

from merging_gym_tpu.core import constants
from merging_gym_tpu.core.env import EnvParams, EnvState, TimeStep, observe, reset, step, swap_obs
from merging_gym_tpu.core.oracle import OracleMergeEnv
from merging_gym_tpu.core.vector import autoreset_step, reset_batch, rollout, step_batch

__all__ = [
    "constants",
    "EnvParams",
    "EnvState",
    "TimeStep",
    "observe",
    "reset",
    "step",
    "swap_obs",
    "OracleMergeEnv",
    "autoreset_step",
    "reset_batch",
    "rollout",
    "step_batch",
]
