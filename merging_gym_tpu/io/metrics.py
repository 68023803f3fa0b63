"""Metrics / observability: scalar logging off the hot path.

The reference logs through tensorboardX scalars (q_eval, reward,
collision_rate, win_rate -- hdqn.py:274,330-346; episode_reward --
ranbowdqn.py:693), a live matplotlib panel (main.py:176-235) and prints.
Here metrics accumulate *on device* inside the jitted scan
(agents.dqn.Metrics) and are read back at low frequency; this module
turns those reads into the same scalar series on disk:

* JSONL (one object per log call) -- machine-readable, append-only;
* CSV mirror -- notebook-friendly;
* TensorBoard via tensorboardX, when asked for (``tensorboard=True``,
  ``cli train --tensorboard``) and installed.  It is opt-in because
  tensorboardX imports torch.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Mapping


class MetricsWriter:
    """Append-only scalar writer: JSONL + CSV (+ tensorboardX if asked)."""

    def __init__(self, log_dir: str, tensorboard: bool = False):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        self._csv_path = os.path.join(self.log_dir, "scalars.csv")
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields = None
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter  # type: ignore
                self._tb = SummaryWriter(log_dir=self.log_dir)
            except ImportError:
                print("tensorboardX is not installed; logging JSONL + CSV")
        self._t0 = time.time()

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        row = {"step": int(step), "wall_time": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

        if self._csv_writer is None:
            self._csv_fields = list(row)
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, self._csv_fields)
            if self._csv_file.tell() == 0:
                self._csv_writer.writeheader()
        self._csv_writer.writerow({k: row.get(k, "") for k in self._csv_fields})
        self._csv_file.flush()

        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"scalar/{k}", float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._csv_file:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()


def rates_from_counters(metrics) -> dict:
    """Derive the reference's episode-rate scalars from the on-device
    counters (collision_rate = collisions/episodes as in main.py:224,
    win_rate as in main.py:225-227, mean episode reward)."""
    eps = max(int(metrics.episodes), 1)
    return {
        "episodes": int(metrics.episodes),
        "env_steps": int(metrics.env_steps),
        "collision_rate": int(metrics.collisions) / eps,
        "win_rate": int(metrics.wins) / eps,
        "reward": float(metrics.sum_ep_reward) / eps,
    }
