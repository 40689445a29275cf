"""Data-parallel PPO over a device mesh.

The reference's only multi-worker axis is 16 OS processes each running the
physics DLL (reference: learning/util.py:30-47 SubprocVecEnv).  Here the
env batch is sharded across a device mesh with `shard_map`: each
device rolls out its env shard locally, and gradient all-reduce (`pmean` over
the mesh axis) keeps the learner replicated — the single collective this
workload needs (SURVEY.md §5.8).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..learning.loco_env import LocoEnv
from ..learning.monitor import EpisodeStats
from ..learning.ppo import PPOConfig, TrainState, make_ppo

AXIS = "data"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    import numpy as np
    devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devices).reshape(-1), (AXIS,))


def train_state_spec() -> TrainState:
    """PartitionSpec tree for a distributed TrainState: params/optimizer
    replicated, env state + per-env monitor accumulators sharded along the
    env axis, RNG per-shard; scalar episode aggregates replicated (kept so
    by psum-ing their per-shard deltas each iteration)."""
    return TrainState(
        params=P(),
        opt_state=P(),
        env_state=P(AXIS),
        last_obs=P(AXIS),
        rng=P(AXIS),
        stats=EpisodeStats(
            running_return=P(AXIS), running_length=P(AXIS),
            episode_count=P(), return_sum=P(), length_sum=P(),
            best_return=P(),
        ),
    )


def make_distributed_ppo(env: LocoEnv, config: PPOConfig, mesh: Mesh):
    """Build (init_fn, train_iteration_fn) sharded over `mesh`.

    `config.num_envs` is the PER-DEVICE env count; global batch =
    num_envs * mesh size.  Params/optimizer state are replicated, env state is
    sharded along the leading env axis, RNG keys are per-shard."""
    n = mesh.devices.size
    config = config.replace(axis_name=AXIS)
    init_local, train_local, policy_apply = make_ppo(env, config)

    state_spec = train_state_spec()

    def init(key):
        # One shared key for the network init (params must start identical on
        # every shard); distinct per-shard keys for env/rollout randomness.
        shard_keys = jax.random.split(jax.random.fold_in(key, 1), n)

        def init_shard(net_key, shard_key):
            st = init_local(net_key)
            shard_key = shard_key[0]
            k_env, k_train = jax.random.split(shard_key)
            env_rngs = jax.random.split(k_env, config.num_envs)
            env_state = st.env_state.replace(rng=env_rngs)
            return st._replace(env_state=env_state, rng=k_train[None])

        return jax.jit(
            jax.shard_map(
                init_shard, mesh=mesh, in_specs=(P(), P(AXIS)),
                out_specs=state_spec, check_vma=False,
            )
        )(key, shard_keys)

    def iteration_shard(state: TrainState):
        st = state._replace(rng=state.rng[0])
        st, metrics = train_local(st)
        metrics = jax.tree_util.tree_map(
            lambda x: jax.lax.pmean(x, AXIS), metrics
        )
        # Scalar episode aggregates: old values are replicated, so summing
        # every shard's local increment keeps them replicated-and-global.
        old, new = state.stats, st.stats
        stats = new.replace(
            episode_count=old.episode_count + jax.lax.psum(
                new.episode_count - old.episode_count, AXIS),
            return_sum=old.return_sum + jax.lax.psum(
                new.return_sum - old.return_sum, AXIS),
            length_sum=old.length_sum + jax.lax.psum(
                new.length_sum - old.length_sum, AXIS),
            best_return=jax.lax.pmax(new.best_return, AXIS),
        )
        return st._replace(rng=state.rng.at[0].set(st.rng), stats=stats), metrics

    train = jax.jit(
        jax.shard_map(
            iteration_shard, mesh=mesh,
            in_specs=(state_spec,), out_specs=(state_spec, P()),
            check_vma=False,
        )
    )
    return init, train, policy_apply
