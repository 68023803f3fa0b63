"""Checkpoint / resume: full-training-state snapshots via orbax.

orbax is imported only when a ``CheckpointManager`` is built, so training
without ``--checkpoint-every``/``--resume`` and the ``params.npz`` export
need numpy alone.

The reference saves only net state_dicts at run end (main.py:244-245,
hdqn.py:362-366, ranbowdqn.py:699-700) -- no optimizer, replay, env or
RNG state, so a "resume" is a cold restart (SURVEY.md section 5).  Here a
checkpoint is the *entire* jitted train carry (params, target params,
optimizer moments, replay ring + cursor, env states, PRNG key, metrics),
so a restored run continues the exact trajectory -- the elastic-recovery
story the reference lacks.

The human-readable run-dir naming convention of the reference is kept:
``<timestamp><label> with OP:<strategy><reward tuple>`` (main.py:239,
hdqn.py:273), so downstream tooling that parses those names keeps working.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import jax
import numpy as np


def run_dir_name(label: str, strategy: str, reward_tuple, root: str = ".") -> str:
    """Reference-style run directory name (main.py:239)."""
    stamp = datetime.datetime.now().strftime("%Y--%m--%d %H:%M:%S")
    return os.path.join(root, f"{stamp}{label} with OP:{strategy}{tuple(reward_tuple)}")


class CheckpointManager:
    """Thin orbax wrapper: periodic full-state saves with retention.

    Multi-host aware (VERDICT r4 item 4): when the job spans processes
    (``jax.process_count() > 1``), every process constructs the manager
    on the SAME (shared-filesystem) directory and calls save/restore
    collectively.  Sharded ``jax.Array`` leaves are passed to orbax
    as-is -- each process writes/reads its addressable shards and the
    restore adopts the target's shardings -- instead of the
    single-process ``device_get`` path (which cannot materialise
    non-addressable shards).  Locked by the cross-process
    resume==continue check in examples/multiprocess_dryrun.py /
    tests/test_multiprocess.py.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        try:
            import orbax.checkpoint as ocp
        except ImportError as e:
            raise RuntimeError(
                "full-state checkpoints (--checkpoint-every, --resume) need "
                "the orbax-checkpoint package, which is not installed") from e
        self._ocp = ocp
        self.directory = os.path.abspath(directory)
        options = ocp.CheckpointManagerOptions(
            max_to_keep=max_to_keep, create=True)
        self._mgr = ocp.CheckpointManager(self.directory, options=options)

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        if jax.process_count() == 1:
            state = jax.device_get(state)
        self._mgr.save(step, args=self._ocp.args.StandardSave(state))
        if wait or jax.process_count() > 1:
            # Multi-process: the async write must be fenced before any
            # process proceeds (a later restore may race the writers).
            self._mgr.wait_until_finished()

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        step = self.latest_step() if step is None else step
        assert step is not None, f"no checkpoints under {self.directory}"
        if jax.process_count() == 1:
            target = jax.device_get(state_like)
        else:
            # Keep the concrete sharded arrays: StandardRestore re-creates
            # each leaf with the target's global sharding, every process
            # reading its own shards.
            target = state_like
        return self._mgr.restore(step, args=self._ocp.args.StandardRestore(target))

    def latest_step(self):
        return self._mgr.latest_step()

    def close(self):
        self._mgr.wait_until_finished()
        self._mgr.close()


def save_params_npz(path: str, params: Any) -> None:
    """Dependency-free flat-npz export of a param PyTree (for sharing
    policies without orbax)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    arrays = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
    np.savez(path, **arrays)


def load_params_npz(path: str, params_like: Any) -> Any:
    data = np.load(path)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params_like)
    leaves = [data[jax.tree_util.keystr(k)] for k, _ in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)
