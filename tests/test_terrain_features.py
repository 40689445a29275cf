"""Placement / grass / water / tree tests."""

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.terrain.grass import (
    blade_lod, blade_triangles, generate_grass_blades,
)
from d3d12renderer_jax.terrain.heightmap import generate_heightmap
from d3d12renderer_jax.terrain.placement import generate_placement_points
from d3d12renderer_jax.terrain.tree import weld_vertices, wind_bend
from d3d12renderer_jax.terrain.water import water_color, water_normal


def test_placement_respects_slope_and_density():
    h = generate_heightmap(resolution=64, world_size=32.0, amplitude=6.0, seed=2)
    origin = jnp.array([-16.0, 0.0, -16.0])
    pts = generate_placement_points(
        h, origin, 32.0 / 63, 32.0, jax.random.PRNGKey(0),
        points_per_side=32, max_slope_y=0.9, density=0.5,
    )
    n_total = 32 * 32
    count = int(pts["count"])
    assert 0 < count < n_total  # both masks bite
    # Valid points sit on the terrain surface.
    valid = np.asarray(pts["valid"])
    pos = np.asarray(pts["position"])[valid]
    assert np.isfinite(pos).all()
    assert (pos[:, 1] >= -0.01).all() and (pos[:, 1] <= 6.01).all()
    # Order lists valid rows first.
    order = np.asarray(pts["order"])
    assert valid[order[:count]].all()


def test_grass_blades_and_wind():
    h = generate_heightmap(resolution=64, world_size=32.0, amplitude=2.0, seed=4)
    origin = jnp.array([-16.0, 0.0, -16.0])
    blades = generate_grass_blades(h, origin, 32.0 / 63, 32.0,
                                   jax.random.PRNGKey(1), blades_per_side=16)
    v0, t0 = blade_triangles(blades, time=0.0)
    v1, t1 = blade_triangles(blades, time=1.0)
    assert v0.shape == v1.shape and t0.shape == t1.shape
    assert int(t0.max()) < v0.shape[0]
    # Wind moves blade tips over time.
    assert float(jnp.abs(v1 - v0).max()) > 1e-3
    # Blade roots stay put.
    lod = blade_lod(blades["position"], jnp.array([0.0, 0.0, 0.0]))
    assert set(np.unique(np.asarray(lod))) <= {0, 1}


def test_water_normal_and_color():
    x = jnp.linspace(-5, 5, 32)
    n0 = water_normal(x, x, time=0.0)
    n1 = water_normal(x, x, time=2.0)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(n0), axis=-1), 1.0,
                               atol=1e-5)
    assert float(jnp.abs(n1 - n0).max()) > 1e-3  # animated
    c_shallow = water_color(jnp.array(0.1))
    c_deep = water_color(jnp.array(10.0))
    assert float(c_shallow[1]) > float(c_deep[1])  # shallow greener


def test_tree_wind_and_weld():
    pos = jnp.array([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0]])
    bent0 = wind_bend(pos, 0.3)
    # Root does not move; crown does.
    np.testing.assert_allclose(np.asarray(bent0[0]), [0, 0, 0], atol=1e-6)
    assert abs(float(bent0[1, 0])) > 1e-3

    p = np.array([[0, 0, 0], [1, 0, 0], [1.00001, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 3], [2, 3, 0]], np.int32)
    new_p, new_i, _ = weld_vertices(p, idx, tolerance=1e-3)
    assert len(new_p) == 3
    assert new_i.max() < 3


def test_grass_chunk_culling_and_lod():
    """Frame-ready grass: per-chunk frustum culling drops behind-camera
    blades (zero-area tris), both LOD classes appear, shapes stay fixed
    (reference: grass chunk culling + LOD, src/terrain/grass.h:21-39)."""
    import math

    from d3d12renderer_jax.render.camera import look_at
    from d3d12renderer_jax.terrain.grass import (
        LOD0_SEGMENTS, LOD1_SEGMENTS, grass_lod_triangles,
    )

    h = jnp.zeros((64, 64))
    origin = (0.0, 0.0, 0.0)
    world = 32.0
    blades = generate_grass_blades(h, origin, world / 63, world,
                                   jax.random.PRNGKey(5),
                                   blades_per_side=48, density=0.9)
    # Camera at the field center looking +x: half the field is behind it.
    cam = look_at((16.0, 1.2, 16.0), (26.0, 0.5, 16.0),
                  v_fov=math.radians(60), aspect=1.0)
    verts, tris, stats = grass_lod_triangles(
        blades, cam, origin, world, time=0.3, lod_distance=6.0,
        chunk_size=4.0)

    n = blades["position"].shape[0]
    assert verts.shape[0] == n * (2 * (LOD0_SEGMENTS + 1)
                                  + 2 * (LOD1_SEGMENTS + 1))
    vis = int(stats["visible_blades"])
    total = int(jnp.sum(blades["valid"]))
    assert 0 < vis < total, f"culling should drop some blades ({vis}/{total})"
    assert int(stats["lod0_blades"]) > 0 and int(stats["lod1_blades"]) > 0
    assert int(stats["visible_chunks"]) < 64  # 8x8 grid, some culled

    # Triangle areas: visible blades contribute area; total degenerate count
    # matches culled + other-LOD copies.
    v = np.asarray(verts)
    t = np.asarray(tris)
    e1 = v[t[:, 1]] - v[t[:, 0]]
    e2 = v[t[:, 2]] - v[t[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    assert (area > 1e-9).sum() > 0
    tris_per_blade0 = 2 * LOD0_SEGMENTS
    tris_per_blade1 = 2 * LOD1_SEGMENTS
    live_expected_max = (int(stats["lod0_blades"]) * tris_per_blade0
                         + int(stats["lod1_blades"]) * tris_per_blade1)
    assert (area > 1e-9).sum() <= live_expected_max

    # Blades behind the camera (x < 14) are culled: their LOD0 tris are all
    # degenerate.
    pos = np.asarray(blades["position"])
    valid = np.asarray(blades["valid"])
    behind = valid & (pos[:, 0] < 12.0)
    if behind.any():
        bi = np.nonzero(behind)[0][0]
        per_v0 = 2 * (LOD0_SEGMENTS + 1)
        sl = slice(bi * tris_per_blade0, (bi + 1) * tris_per_blade0)
        assert (area[sl] < 1e-9).all(), "behind-camera blade not culled"


def test_multi_layer_placement_and_instancing():
    """Layered placement: exclusive layer membership, per-layer masks,
    weighted mesh variants, host instancing (reference placement layers,
    src/terrain/proc_placement.h:13-36)."""
    from d3d12renderer_jax.render import mesh as mesh_mod
    from d3d12renderer_jax.terrain.placement import (
        generate_placement_layers, instantiate_placement,
    )

    # Height ramp 0..4 across x so height bands split the layers.
    r = 64
    h = jnp.broadcast_to(jnp.linspace(0.0, 4.0, r)[None, :], (r, r))
    layers = [
        dict(min_height=2.0, density=0.9, mesh_weights=[3.0, 1.0],
             scale_range=(0.5, 0.8)),           # high band: "trees"
        dict(max_height=2.0, density=0.5),      # low band: "rocks"
    ]
    out = generate_placement_layers(
        h, (0.0, 0.0, 0.0), 32.0 / (r - 1), 32.0, jax.random.PRNGKey(2),
        layers, points_per_side=32)
    assert len(out) == 2
    v0 = np.asarray(out[0]["valid"])
    v1 = np.asarray(out[1]["valid"])
    assert v0.sum() > 10 and v1.sum() > 10
    assert not (v0 & v1).any(), "layers must be exclusive"
    y0 = np.asarray(out[0]["position"])[v0, 1]
    y1 = np.asarray(out[1]["position"])[v1, 1]
    assert (y0 >= 2.0 - 1e-4).all() and (y1 <= 2.0 + 1e-4).all()
    mi = np.asarray(out[0]["mesh_index"])[v0]
    assert set(np.unique(mi)) <= {0, 1}
    assert (mi == 0).sum() > (mi == 1).sum(), "3:1 weights should skew"
    s0 = np.asarray(out[0]["scale"])[v0]
    assert s0.min() >= 0.5 - 1e-5 and s0.max() <= 0.8 + 1e-5

    inst = instantiate_placement(
        out[0],
        [lambda: mesh_mod.ico_sphere(1.0, 0),
         lambda: mesh_mod.box((0.5, 0.5, 0.5))],
        material_ids=[3, 4], max_instances=8)
    assert 0 < len(inst) <= 8
    proto_counts = {len(mesh_mod.ico_sphere(1.0, 0).positions),
                    len(mesh_mod.box((0.5, 0.5, 0.5)).positions)}
    for m, mat in inst:
        assert mat in (3, 4)
        assert len(m.positions) in proto_counts
        # Instance sits at its placement point (translated away from origin).
        assert np.linalg.norm(m.positions.mean(0)) > 0.1
