"""Light probes, debug visualization, camera controllers."""

import pytest
import math

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.core.camera_controller import FlyController, OrbitController
from d3d12renderer_jax.render.debug_viz import (
    draw_outlines, object_outlines, rasterize_lines, wire_box, wire_cone,
    wire_sphere,
)
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.light_probe import (
    create_probe_grid, oct_decode, probe_positions, sample_irradiance,
    update_probes, _oct_encode,
)

from tests.test_render import make_scene


def test_octahedral_roundtrip():
    d = jnp.asarray(np.random.default_rng(0).normal(size=(64, 3)))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    back = oct_decode(_oct_encode(d))
    np.testing.assert_allclose(np.asarray(back), np.asarray(d), atol=1e-5)


@pytest.mark.slow
def test_probe_grid_update_and_sample():
    scene = make_scene()
    grid = create_probe_grid(origin=(-3, 0.5, -3), extent=(6, 3, 6),
                             dims=(3, 2, 3))
    assert probe_positions(grid).shape == (18, 3)
    grid = jax.jit(lambda g, k: update_probes(g, scene, k, rays_per_probe=32,
                                              max_steps=128))(
        grid, jax.random.PRNGKey(0))
    irr = np.asarray(grid.irradiance)
    assert np.isfinite(irr).all() and irr.max() > 0.01
    dep = np.asarray(grid.depth)
    assert (dep[..., 0] >= 0).all()

    # Sampling: upward normals see sky-ish light; finite everywhere.
    pos = jnp.array([[0.0, 1.0, 0.0], [1.0, 2.0, 1.0]])
    nrm = jnp.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    s = sample_irradiance(grid, pos, nrm)
    assert np.isfinite(np.asarray(s)).all()
    assert float(s.max()) > 0.01


def test_wire_primitives():
    assert wire_box((0, 0, 0), (1, 1, 1)).shape == (12, 2, 3)
    ws = wire_sphere((0, 0, 0), 1.0, segments=12)
    assert ws.shape == (36, 2, 3)
    r = np.linalg.norm(ws.reshape(-1, 3), axis=-1)
    np.testing.assert_allclose(r, 1.0, atol=1e-5)
    wc = wire_cone((0, 0, 0), (0, -1, 0), 0.5, 2.0)
    assert np.isfinite(wc).all()


def test_rasterize_lines_and_outlines():
    cam = look_at(eye=(0, 0, 5), target=(0, 0, 0), aspect=1.0)
    img = jnp.zeros((64, 64, 3))
    segs = wire_box((0, 0, 0), (1, 1, 1))
    out = rasterize_lines(img, segs, (1.0, 0.0, 0.0), cam)
    assert float(out.max()) == 1.0  # drew something
    assert float(out[..., 1].max()) == 0.0

    ids = jnp.zeros((16, 16), jnp.int32).at[4:10, 4:10].set(7)
    edges = object_outlines(ids)
    assert bool(edges.any()) and not bool(edges.all())
    hl = draw_outlines(jnp.zeros((16, 16, 3)), ids, 7)
    assert float(hl.max()) > 0.5


def test_camera_controllers():
    orbit = OrbitController(target=(1, 0, 0), distance=5.0)
    c1 = orbit.camera()
    d = np.linalg.norm(np.asarray(c1.position) - np.array([1, 0, 0]))
    assert abs(d - 5.0) < 1e-4
    orbit.rotate(0.5, 0.2)
    orbit.zoom(0.5)
    c2 = orbit.camera()
    d2 = np.linalg.norm(np.asarray(c2.position) - np.array([1, 0, 0]))
    assert abs(d2 - 2.5) < 1e-4

    fly = FlyController(position=(0, 0, 0), yaw=0.0, pitch=0.0)
    fly.move(1.0, forward=1.0)   # looks down -z
    assert fly.position[2] < -4.9
    fly.look(math.pi / 2, 0.0)
    fly.move(1.0, forward=1.0)
    assert fly.position[0] < -4.9


def test_episode_monitor_stats():
    from d3d12renderer_jax.learning.monitor import (
        init_stats, summarize, update_stats,
    )
    stats = init_stats(2)
    r = jnp.array([1.0, 2.0])
    d_no = jnp.array([False, False])
    d_yes = jnp.array([False, True])
    stats = update_stats(stats, r, d_no)
    stats = update_stats(stats, r, d_yes)   # env1 finishes: return 4, len 2
    s = summarize(stats)
    assert s["episodes"] == 1
    assert abs(s["mean_return"] - 4.0) < 1e-6
    assert abs(s["mean_length"] - 2.0) < 1e-6
    assert abs(s["best_return"] - 4.0) < 1e-6
    # env1 accumulators reset.
    assert float(stats.running_return[1]) == 0.0
