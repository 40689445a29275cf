"""core/struct.py pytree dataclasses and the plain-JAX ActorCritic MLP."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from d3d12renderer_jax.core import struct
from d3d12renderer_jax.learning.networks import (
    HIDDEN, ActorCritic, gaussian_logp,
)


@struct.dataclass
class _Body:
    pos: jnp.ndarray
    mass: float = 1.0
    name: str = struct.field(pytree_node=False, default="box")


def test_struct_replace_returns_changed_copy():
    a = _Body(pos=jnp.zeros(3))
    b = a.replace(mass=2.0)
    assert a.mass == 1.0 and b.mass == 2.0 and b.name == "box"
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.mass = 3.0


def test_struct_static_fields_are_tree_metadata():
    a = _Body(pos=jnp.ones(3), mass=jnp.float32(2.0), name="ball")
    leaves, treedef = jax.tree_util.tree_flatten(a)
    assert len(leaves) == 2  # pos and mass; name is static
    assert jax.tree_util.tree_unflatten(treedef, leaves).name == "ball"
    # A different static value is a different tree structure.
    other = jax.tree_util.tree_structure(a.replace(name="box"))
    assert other != treedef


def test_struct_jit_round_trip():
    calls = []

    @jax.jit
    def step(b):
        calls.append(b.name)  # runs only while tracing
        return b.replace(pos=b.pos + b.mass)

    a = _Body(pos=jnp.arange(3.0), mass=jnp.float32(0.5), name="ball")
    out = step(step(a))
    assert isinstance(out, _Body) and out.name == "ball"
    np.testing.assert_allclose(np.asarray(out.pos), [1.0, 2.0, 3.0])
    assert calls == ["ball"]  # one trace for one static value
    step(a.replace(name="box"))
    assert calls == ["ball", "box"]


def test_actor_critic_shapes_and_init_scheme():
    net = ActorCritic(action_dim=5)
    obs = jnp.ones((7, 11))
    params = net.init(jax.random.PRNGKey(0), obs[:1])
    p = params["params"]
    assert p["pi_0"]["kernel"].shape == (11, HIDDEN)
    assert p["pi_1"]["kernel"].shape == (HIDDEN, HIDDEN)
    assert p["vf_0"]["kernel"].shape == (11, HIDDEN)
    assert p["value_head"]["kernel"].shape == (HIDDEN, 1)
    head = np.asarray(p["action_head"]["kernel"])
    assert head.shape == (HIDDEN, 5)
    assert head.min() >= 0.0 and head.max() <= 0.01  # U(0, 0.01)
    for name in ("pi_0", "pi_1", "action_head", "vf_0", "vf_1",
                 "value_head"):
        np.testing.assert_array_equal(np.asarray(p[name]["bias"]), 0.0)
    np.testing.assert_array_equal(np.asarray(p["log_std"]), 0.0)
    # LeCun normal: std ~ 1/sqrt(fan_in) (truncated normal, so a bit less).
    std = float(np.asarray(p["pi_1"]["kernel"]).std())
    assert 0.7 / np.sqrt(HIDDEN) < std < 1.2 / np.sqrt(HIDDEN)
    mean, log_std, value = net.apply(params, obs)
    assert mean.shape == (7, 5) and log_std.shape == (5,)
    assert value.shape == (7,)


def test_actor_critic_deterministic_per_key():
    net = ActorCritic(action_dim=3)
    obs = jnp.ones((1, 4))
    a = net.init(jax.random.PRNGKey(1), obs)
    b = net.init(jax.random.PRNGKey(1), obs)
    c = net.init(jax.random.PRNGKey(2), obs)
    same = jax.tree_util.tree_map(lambda x, y: bool((x == y).all()), a, b)
    assert all(jax.tree_util.tree_leaves(same))
    assert not bool((a["params"]["pi_0"]["kernel"]
                     == c["params"]["pi_0"]["kernel"]).all())


def test_actor_critic_gradient_step_lowers_loss():
    """One small gradient step on a policy-likelihood + value loss lowers
    it and moves every tower."""
    net = ActorCritic(action_dim=2)
    key = jax.random.PRNGKey(3)
    obs = jax.random.normal(key, (32, 6))
    act = jax.random.normal(jax.random.fold_in(key, 1), (32, 2))
    ret = jax.random.normal(jax.random.fold_in(key, 2), (32,))
    params = net.init(key, obs[:1])

    def loss(p):
        mean, log_std, value = net.apply(p, obs)
        return (-gaussian_logp(act, mean, log_std).mean()
                + ((value - ret) ** 2).mean())

    opt = optax.sgd(1e-3)
    grads = jax.grad(loss)(params)
    for name in ("pi_0", "action_head", "vf_0", "value_head"):
        assert float(jnp.abs(grads["params"][name]["kernel"]).max()) > 0.0
    assert float(jnp.abs(grads["params"]["log_std"]).max()) > 0.0
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    assert float(loss(new)) < float(loss(params))
