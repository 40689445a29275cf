"""PPO, fully on-device: rollout collection, GAE, and clipped-objective updates
inside one jitted training step.

Hyperparameter defaults mirror the reference's stable-baselines3 run
(reference: learning/learn_locomotion.py:85-96: clip 0.1, minibatch 128,
10 epochs, 2048-step rollouts, lr 2.5e-5) — but the env batch is a vmapped
axis on-chip instead of 16 OS processes (reference: learning/util.py:30-47),
so rollout -> learn has zero host round-trips.  Scale-out across an ICI mesh
is plain data parallelism: shard the env batch, psum the gradients
(see parallel/data_parallel.py).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from ..core import struct

from .loco_env import LocoEnv
from .monitor import EpisodeStats, init_stats, update_stats
from .networks import ActorCritic, gaussian_entropy, gaussian_logp, sample_action


@struct.dataclass
class PPOConfig:
    num_envs: int = struct.field(pytree_node=False, default=64)
    rollout_steps: int = struct.field(pytree_node=False, default=128)
    minibatches: int = struct.field(pytree_node=False, default=8)
    epochs: int = struct.field(pytree_node=False, default=10)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.1
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    learning_rate: float = 2.5e-5
    # Mesh axis name for data-parallel training (None = single device).
    # When set, gradients and advantage statistics are pmean'd across the axis
    # so every shard applies identical updates (replicated params).
    axis_name: Optional[str] = struct.field(pytree_node=False, default=None)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_state: Any
    last_obs: jnp.ndarray
    rng: jnp.ndarray
    # Per-episode return/length accumulators (reference: VecMonitor,
    # learning/vec_monitor.py:14) — folded from each rollout inside the
    # jitted iteration so episode stats survive across iterations.
    stats: EpisodeStats


class Transition(NamedTuple):
    obs: jnp.ndarray
    action: jnp.ndarray
    logp: jnp.ndarray
    value: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray


def make_ppo(env: LocoEnv, config: PPOConfig = PPOConfig(),
             action_size: Optional[int] = None):
    """Build (init_fn, train_iteration_fn, policy_apply).

    train_iteration_fn: TrainState -> (TrainState, metrics) — one full
    rollout + update cycle, jit-compiled."""
    from .loco_env import ACTION_SIZE

    act_dim = action_size if action_size is not None else ACTION_SIZE
    network = ActorCritic(action_dim=act_dim)
    tx = optax.chain(
        optax.clip_by_global_norm(config.max_grad_norm),
        optax.adam(config.learning_rate),
    )

    def init(key):
        k_net, k_env, k_train = jax.random.split(key, 3)
        obs, env_state = jax.vmap(env.reset)(
            jax.random.split(k_env, config.num_envs)
        )
        params = network.init(k_net, obs[:1])
        opt_state = tx.init(params)
        return TrainState(params, opt_state, env_state, obs, k_train,
                          init_stats(config.num_envs))

    def policy_step(params, obs, key):
        mean, log_std, value = network.apply(params, obs)
        action, logp = sample_action(mean, log_std, key)
        return action, logp, value

    def rollout_step(carry, _):
        params, env_state, obs, rng = carry
        rng, k_act = jax.random.split(rng)
        action, logp, value = policy_step(params, obs, k_act)
        next_obs, env_state, reward, done = jax.vmap(env.step)(env_state, action)
        t = Transition(obs, action, logp, value, reward, done)
        return (params, env_state, next_obs, rng), t

    def compute_gae(traj: Transition, last_value):
        def scan_fn(carry, t):
            gae, next_value = carry
            delta = t.reward + config.gamma * next_value * (1 - t.done) - t.value
            gae = delta + config.gamma * config.gae_lambda * (1 - t.done) * gae
            return (gae, t.value), gae

        (_, _), advantages = jax.lax.scan(
            scan_fn, (jnp.zeros_like(last_value), last_value), traj, reverse=True
        )
        return advantages, advantages + traj.value

    def _mean(x):
        if config.axis_name is not None:
            return jax.lax.pmean(jnp.mean(x), config.axis_name)
        return jnp.mean(x)

    def loss_fn(params, batch, advantages, returns):
        mean, log_std, value = network.apply(params, batch.obs)
        logp = gaussian_logp(batch.action, mean, log_std)
        ratio = jnp.exp(logp - batch.logp)
        adv_mean = _mean(advantages)
        adv_std = jnp.sqrt(jnp.maximum(_mean((advantages - adv_mean) ** 2), 1e-16))
        adv = (advantages - adv_mean) / (adv_std + 1e-8)
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv
        pg_loss = -jnp.mean(jnp.minimum(pg1, pg2))
        vf_loss = 0.5 * jnp.mean((value - returns) ** 2)
        ent = jnp.mean(gaussian_entropy(log_std))
        total = pg_loss + config.vf_coef * vf_loss - config.ent_coef * ent
        return total, (pg_loss, vf_loss, ent)

    def update_minibatch(carry, minibatch):
        params, opt_state = carry
        batch, advantages, returns = minibatch
        grads, aux = jax.grad(loss_fn, has_aux=True)(
            params, batch, advantages, returns
        )
        if config.axis_name is not None:
            grads = jax.lax.pmean(grads, config.axis_name)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), aux

    def train_iteration(state: TrainState):
        # 1. Rollout (scan over time, envs vectorized).
        carry = (state.params, state.env_state, state.last_obs, state.rng)
        carry, traj = jax.lax.scan(
            rollout_step, carry, None, length=config.rollout_steps
        )
        params, env_state, last_obs, rng = carry

        # 2. GAE.
        _, _, last_value = network.apply(params, last_obs)
        advantages, returns = compute_gae(traj, last_value)

        # 3. Flatten (T, B, ...) -> (T*B, ...), shuffle, minibatch updates.
        n = config.rollout_steps * config.num_envs
        flat = jax.tree_util.tree_map(
            lambda x: x.reshape((n,) + x.shape[2:]), (traj, advantages, returns)
        )

        def epoch(carry, _):
            params, opt_state, rng = carry
            rng, k = jax.random.split(rng)
            perm = jax.random.permutation(k, n)
            shuffled = jax.tree_util.tree_map(lambda x: x[perm], flat)
            mb = jax.tree_util.tree_map(
                lambda x: x.reshape((config.minibatches, -1) + x.shape[1:]),
                shuffled,
            )
            (params, opt_state), aux = jax.lax.scan(
                update_minibatch, (params, opt_state), mb
            )
            return (params, opt_state, rng), aux

        (params, opt_state, rng), aux = jax.lax.scan(
            epoch, (params, state.opt_state, rng), None, length=config.epochs
        )

        pg_loss, vf_loss, ent = aux

        # 4. Fold the rollout's rewards/dones into the episode monitor.
        stats, _ = jax.lax.scan(
            lambda s, rd: (update_stats(s, rd[0], rd[1]), None),
            state.stats, (traj.reward, traj.done),
        )

        metrics = {
            "reward_mean": traj.reward.mean(),
            "episode_done_rate": traj.done.mean(),
            "pg_loss": pg_loss.mean(),
            "vf_loss": vf_loss.mean(),
            "entropy": ent.mean(),
            "value_mean": traj.value.mean(),
        }
        return TrainState(params, opt_state, env_state, last_obs, rng,
                          stats), metrics

    return init, jax.jit(train_iteration), network.apply
