"""PPO learner smoke tests: shapes, finiteness, parameter updates."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.learning.loco_env import LocoEnv
from d3d12renderer_jax.learning.ppo import PPOConfig, make_ppo


@pytest.mark.slow
def test_ppo_iteration_runs_and_updates_params():
    env = LocoEnv()
    config = PPOConfig(num_envs=4, rollout_steps=8, minibatches=2, epochs=2,
                       learning_rate=1e-3)
    init, train_iteration, _ = make_ppo(env, config)
    state = init(jax.random.PRNGKey(0))

    p0 = jax.tree_util.tree_map(lambda x: np.array(x), state.params)
    state, metrics = train_iteration(state)
    state, metrics = train_iteration(state)

    # Metrics finite.
    for k, v in metrics.items():
        assert np.isfinite(float(v)), f"{k} not finite"
    # Params changed.
    p1 = state.params
    diffs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()), p0, p1
    )
    total = sum(jax.tree_util.tree_leaves(diffs))
    assert total > 0.0
    # Env produced sensible reward while standing at start.
    assert float(metrics["reward_mean"]) > 0.1
