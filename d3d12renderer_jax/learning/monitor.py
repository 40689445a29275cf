"""Episode statistics monitor for vectorized envs.

Reference: learning/vec_monitor.py:14 — VecMonitor wraps the SubprocVecEnv
and records per-episode reward/length to CSV for the best-model callback.
Here: a small pytree carried through jitted rollouts accumulating
per-env episode returns/lengths, flushed into host-side running stats.
"""

from __future__ import annotations

import csv
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np
from ..core import struct


@struct.dataclass
class EpisodeStats:
    """Carry through the rollout: per-env accumulators + completed-episode
    aggregates (fixed shape, jit-friendly)."""

    running_return: jnp.ndarray   # (B,)
    running_length: jnp.ndarray   # (B,)
    episode_count: jnp.ndarray    # ()
    return_sum: jnp.ndarray       # ()
    length_sum: jnp.ndarray       # ()
    best_return: jnp.ndarray      # ()


def init_stats(num_envs: int) -> EpisodeStats:
    return EpisodeStats(
        running_return=jnp.zeros(num_envs),
        running_length=jnp.zeros(num_envs),
        episode_count=jnp.zeros(()),
        return_sum=jnp.zeros(()),
        length_sum=jnp.zeros(()),
        best_return=jnp.full((), -jnp.inf),
    )


def update_stats(stats: EpisodeStats, rewards, dones) -> EpisodeStats:
    """Fold one vectorized step into the stats (call inside the rollout)."""
    ret = stats.running_return + rewards
    length = stats.running_length + 1
    finished = dones.astype(jnp.float32)
    return EpisodeStats(
        running_return=ret * (1 - finished),
        running_length=length * (1 - finished),
        episode_count=stats.episode_count + finished.sum(),
        return_sum=stats.return_sum + (ret * finished).sum(),
        length_sum=stats.length_sum + (length * finished).sum(),
        best_return=jnp.maximum(stats.best_return,
                                jnp.max(jnp.where(dones, ret, -jnp.inf))),
    )


def summarize(stats: EpisodeStats) -> dict:
    n = max(float(stats.episode_count), 1.0)
    return {
        "episodes": float(stats.episode_count),
        "mean_return": float(stats.return_sum) / n,
        "mean_length": float(stats.length_sum) / n,
        "best_return": float(stats.best_return),
    }


class MonitorCSV:
    """CSV episode log (reference: VecMonitor results file)."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(["timesteps", "mean_return",
                                    "mean_length", "episodes", "walltime"])

    def write(self, timesteps: int, stats: EpisodeStats):
        s = summarize(stats)
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([
                timesteps, f"{s['mean_return']:.4f}",
                f"{s['mean_length']:.1f}", int(s["episodes"]),
                f"{time.time() - self._t0:.1f}",
            ])
