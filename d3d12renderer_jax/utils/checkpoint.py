"""Checkpointing + NaN guard.

Reference behaviors: binary scene snapshots (src/scene/
serialization_binary.cpp, used by undo/play-mode), RL best-model checkpoints
with resume (learning/learn_locomotion.py:44-56,78), and the physics VALIDATE
NaN sweeps (src/physics/physics.cpp:805-905, compiled out by default).

Here any sim/train state is a pytree, saved as a plain flatten of its
leaves; `nan_guard` wraps a step function and rolls back to the
last good state when non-finite values appear (SURVEY.md §5.3 resilience).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def save_pytree(path: str, tree: Any):
    """Binary snapshot of an arbitrary pytree (device arrays -> numpy)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    host = [np.asarray(l) for l in leaves]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"treedef": treedef, "leaves": host}, f)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        doc = pickle.load(f)
    return jax.tree_util.tree_unflatten(
        doc["treedef"], [jnp.asarray(l) for l in doc["leaves"]]
    )


def load_pytree_sharded(path: str, shardings: Any) -> Any:
    """Restore a snapshot onto a device mesh.

    `shardings` is a pytree of jax.sharding.Sharding matching the saved
    tree's structure (or a prefix of it, e.g. a TrainState of
    NamedShardings) — each restored leaf is device_put with its sharding,
    so a multi-chip trainer resumes with the exact layout it saved from.
    Checkpoints themselves are layout-agnostic (host numpy), the same
    single-file format save_pytree writes."""
    return jax.device_put(load_pytree(path), shardings)


class CheckpointManager:
    """Keep the N most recent checkpoints + best-by-metric
    (reference: SaveOnBestTrainingRewardCallback, learn_locomotion.py:18-56)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.best_metric = -float("inf")
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, metric: Optional[float] = None):
        path = os.path.join(self.directory, f"ckpt_{step:09d}.bin")
        save_pytree(path, tree)
        if metric is not None and metric > self.best_metric:
            self.best_metric = metric
            save_pytree(os.path.join(self.directory, "best.bin"), tree)
        self._prune()
        return path

    def _prune(self):
        ckpts = sorted(
            f for f in os.listdir(self.directory) if f.startswith("ckpt_"))
        for old in ckpts[:-self.keep]:
            os.remove(os.path.join(self.directory, old))

    def latest(self) -> Optional[Any]:
        ckpts = sorted(
            f for f in os.listdir(self.directory) if f.startswith("ckpt_"))
        if not ckpts:
            return None
        return load_pytree(os.path.join(self.directory, ckpts[-1]))

    def latest_step(self) -> Optional[int]:
        ckpts = sorted(
            f for f in os.listdir(self.directory) if f.startswith("ckpt_"))
        return int(ckpts[-1][5:14]) if ckpts else None

    def best(self) -> Optional[Any]:
        p = os.path.join(self.directory, "best.bin")
        return load_pytree(p) if os.path.exists(p) else None


def tree_all_finite(tree) -> jnp.ndarray:
    """Device-side check that every float leaf is finite (the VALIDATE
    equivalent, evaluable inside jit)."""
    ok = jnp.array(True)
    for leaf in jax.tree_util.tree_leaves(tree):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            ok = ok & jnp.isfinite(leaf).all()
    return ok


def nan_guard(step_fn: Callable, on_rollback: Optional[Callable] = None):
    """Wrap `state' = step_fn(state, *a)` so non-finite results roll back to
    the input state (SURVEY.md §5.3: NaN-guard that rolls back a step batch).

    Returns wrapped(state, *args) -> (state', was_rolled_back)."""

    def wrapped(state, *args, **kw):
        new_state = step_fn(state, *args, **kw)
        ok = tree_all_finite(new_state)
        guarded = jax.tree_util.tree_map(
            lambda new, old: jnp.where(ok, new, old), new_state, state
        )
        return guarded, ~ok

    return wrapped
