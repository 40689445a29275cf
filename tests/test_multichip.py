"""Multi-chip sharding tests on the virtual 8-device CPU mesh (conftest)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.learning.loco_env import LocoEnv
from d3d12renderer_jax.learning.ppo import PPOConfig, make_ppo
from d3d12renderer_jax.parallel.data_parallel import (
    make_distributed_ppo, make_mesh,
)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_distributed_ppo_one_iteration():
    mesh = make_mesh(8)
    env = LocoEnv()
    config = PPOConfig(num_envs=2, rollout_steps=4, minibatches=2, epochs=1)
    init, train, _ = make_distributed_ppo(env, config, mesh)
    state = init(jax.random.PRNGKey(0))
    state, metrics = train(state)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), f"{k} not finite"


@pytest.mark.slow
def test_sharded_eval_render_matches_single_device():
    """Pixel-sharded eval path trace (all_gather of per-shard scanline
    bands) must equal the identically-seeded single-device render."""
    import math

    from d3d12renderer_jax.parallel.eval_render import pathtrace_sharded
    from d3d12renderer_jax.render import bvh as bvh_mod
    from d3d12renderer_jax.render import mesh as mesh_mod
    from d3d12renderer_jax.render.camera import Camera, generate_rays, look_at
    from d3d12renderer_jax.render.pathtracer import (
        Materials, PathTracerSettings, Scene, default_sky, trace_sample,
    )

    ground = mesh_mod.quad(half=6.0)
    ball = mesh_mod.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0))
    b = bvh_mod.build_bvh([(ground, 0), (ball, 1)])
    mats = Materials(
        albedo=jnp.array([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2]]),
        emissive=jnp.zeros((2, 3)),
        roughness=jnp.array([0.7, 0.4]),
        metallic=jnp.zeros((2,)),
    )
    scene = Scene(bvh=b, materials=mats, sky=default_sky())
    cam = look_at((4.0, 3.0, 5.0), (0.0, 0.8, 0.0),
                  v_fov=math.radians(50), aspect=1.0)
    settings = PathTracerSettings(recursion_depth=1)
    w = h = 32
    key = jax.random.PRNGKey(3)

    mesh = make_mesh(8)
    frame = pathtrace_sharded(scene, cam, w, h, mesh, settings=settings,
                              spp=1, key=key)
    assert frame.shape == (h, w, 3)
    assert np.isfinite(np.asarray(frame)).all()
    assert float(jnp.std(frame)) > 1e-3, "degenerate (constant) frame"

    # Single-device reference: identical camera key, identical per-shard
    # trace keys applied to the same scanline bands.
    k_cam, k_trace = jax.random.split(key)
    o, d = generate_rays(cam, w, h, key=k_cam)
    shard_keys = jax.random.split(k_trace, 8)
    bands = []
    rows = h * w // 8
    for i in range(8):
        sl = slice(i * rows, (i + 1) * rows)
        bands.append(trace_sample(scene, settings, o[sl], d[sl],
                                  jax.random.fold_in(shard_keys[i], 0)))
    ref = jnp.concatenate(bands).reshape(h, w, 3)
    np.testing.assert_allclose(np.asarray(frame), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.slow
def test_sharded_trainstate_checkpoint_roundtrip(tmp_path):
    """Save a mesh-sharded TrainState, restore it with the same shardings,
    and keep training: values equal, layout preserved, step usable."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from d3d12renderer_jax.parallel.data_parallel import AXIS, train_state_spec
    from d3d12renderer_jax.utils.checkpoint import (
        load_pytree_sharded, save_pytree,
    )

    mesh = make_mesh(4)
    env = LocoEnv()
    config = PPOConfig(num_envs=2, rollout_steps=4, minibatches=1, epochs=1)
    init, train, _ = make_distributed_ppo(env, config, mesh)
    state = init(jax.random.PRNGKey(2))
    state, _ = train(state)

    path = str(tmp_path / "ckpt.bin")
    save_pytree(path, state)

    spec = train_state_spec()
    shardings = jax.tree_util.tree_map(
        lambda p: NamedSharding(mesh, p), spec,
        is_leaf=lambda x: isinstance(x, P))
    restored = load_pytree_sharded(path, shardings)

    for a, b_ in zip(jax.tree_util.tree_leaves(state),
                     jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    # env-state leaves must come back sharded over the mesh axis, params
    # replicated.
    env_leaf = jax.tree_util.tree_leaves(restored.env_state)[0]
    assert len(env_leaf.addressable_shards) == 4
    assert not env_leaf.sharding.is_fully_replicated
    param_leaf = jax.tree_util.tree_leaves(restored.params)[0]
    assert param_leaf.sharding.is_fully_replicated

    state2, metrics = train(restored)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), f"{k} not finite after resume"


@pytest.mark.slow
def test_distributed_params_stay_replicated():
    """After a training step with psum'd gradients, every shard must hold
    identical parameters."""
    mesh = make_mesh(4)
    env = LocoEnv()
    config = PPOConfig(num_envs=2, rollout_steps=4, minibatches=1, epochs=1,
                       learning_rate=1e-3)
    init, train, _ = make_distributed_ppo(env, config, mesh)
    state = init(jax.random.PRNGKey(1))
    state, _ = train(state)
    # Pull each leaf fully addressable and compare device shards.
    for leaf in jax.tree_util.tree_leaves(state.params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        for s in shards[1:]:
            np.testing.assert_array_equal(shards[0], s)
