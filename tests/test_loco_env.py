"""Locomotion environment tests: standing stability, reward shape, batching.

Mirrors the reference's env smoke testing via check_env + reward curves
(reference: learning/learn_locomotion.py:13, SURVEY.md §4.5).
"""

import pytest
import numpy as np
import jax
import jax.numpy as jnp

from d3d12renderer_jax.learning.loco_env import (
    ACTION_SIZE, STATE_SIZE, LocoEnv, make_vec_env,
)


def make_env():
    return LocoEnv()


def test_obs_and_action_sizes():
    env = make_env()
    obs, st = env.reset(jax.random.PRNGKey(0))
    assert obs.shape == (STATE_SIZE,)
    assert STATE_SIZE == 66 and ACTION_SIZE == 27
    lo, hi = env.action_limits()
    assert lo.shape == (27,) and np.all(lo < hi)


@pytest.mark.slow
def test_ragdoll_stands_briefly_with_zero_action():
    """With position motors holding the initial pose, the ragdoll should not
    fall within the first second."""
    env = make_env()
    obs, st = env.reset(jax.random.PRNGKey(1))
    step = jax.jit(env.step)
    zero = jnp.zeros(ACTION_SIZE)
    fallen = False
    for _ in range(60):
        obs, st, reward, done = step(st, zero)
        fallen = fallen or bool(done)
    assert not fallen
    assert np.isfinite(jax.device_get(obs)).all()
    # Positive imitation reward while still standing (pose motors hold joint
    # angles but cannot balance indefinitely — that is the policy's job).
    assert float(reward) > 0.5


@pytest.mark.slow
def test_reward_drops_when_perturbed():
    env = make_env()
    obs, st = env.reset(jax.random.PRNGKey(2))
    step = jax.jit(env.step)
    zero = jnp.zeros(ACTION_SIZE)
    obs, st, r0, _ = step(st, zero)
    # Command an extreme pose: rewards should drop as the pose diverges.
    weird = jnp.full((ACTION_SIZE,), 1.0)
    r = r0
    for _ in range(90):
        obs, st, r, done = step(st, weird)
        if bool(done):
            break
    assert float(r) < float(r0)


@pytest.mark.slow
def test_batched_env_runs_and_auto_resets():
    env = make_env()
    reset, step = make_vec_env(env, batch_size=16)
    obs, st = reset(jax.random.PRNGKey(3))
    assert obs.shape == (16, STATE_SIZE)
    # Drive with random strong actions until some envs fall and auto-reset.
    key = jax.random.PRNGKey(4)
    any_done = False
    for i in range(120):
        key, k = jax.random.split(key)
        actions = jax.random.uniform(k, (16, ACTION_SIZE), minval=-2, maxval=2)
        obs, st, rewards, dones = step(st, actions)
        any_done = any_done or bool(jnp.any(dones))
    assert np.isfinite(jax.device_get(obs)).all()
    # After auto-reset, step counters for reset envs went back to small values.
    assert np.isfinite(jax.device_get(rewards)).all()
