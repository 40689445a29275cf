"""Renderer tests: BVH correctness vs brute force, path tracer sanity."""

import pytest
import math

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at, generate_rays
from d3d12renderer_jax.render.pathtracer import (
    Materials, PathTracerSettings, Scene, default_sky, render, sky_radiance,
)


def make_scene():
    ground = mesh_mod.quad(half=20.0)
    sphere = mesh_mod.ico_sphere(1.0, 3).transformed(translate=(0, 1.0, 0))
    box = mesh_mod.box((0.7, 0.7, 0.7)).transformed(translate=(2.2, 0.7, -0.5))
    bvh = bvh_mod.build_bvh([(ground, 0), (sphere, 1), (box, 2)])
    mats = Materials(
        albedo=jnp.array([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2], [0.2, 0.4, 0.8]]),
        emissive=jnp.zeros((3, 3)),
        roughness=jnp.array([0.8, 0.3, 0.6]),
        metallic=jnp.array([0.0, 0.0, 0.0]),
    )
    return Scene(bvh=bvh, materials=mats, sky=default_sky())


def brute_force_hit(mesh_list, o, d):
    """Numpy reference: closest hit over all triangles (the device-vs-host
    comparison pattern from the reference's bitonic sort self-test,
    SURVEY.md §4.1)."""
    best_t = np.full(o.shape[0], np.inf)
    for mesh, _ in mesh_list:
        p = mesh.positions
        for tri in mesh.indices:
            v0, v1, v2 = p[tri[0]], p[tri[1]], p[tri[2]]
            e1, e2 = v1 - v0, v2 - v0
            pvec = np.cross(d, e2)
            det = (e1 * pvec).sum(-1)
            ok = np.abs(det) > 1e-9
            inv = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
            tvec = o - v0
            u = (tvec * pvec).sum(-1) * inv
            qvec = np.cross(tvec, e1)
            v = (d * qvec).sum(-1) * inv
            t = (e2 * qvec).sum(-1) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
            best_t = np.where(hit & (t < best_t), t, best_t)
    return best_t


def test_bvh_matches_brute_force():
    ground = mesh_mod.quad(half=5.0)
    sphere = mesh_mod.ico_sphere(1.0, 1).transformed(translate=(0, 1.0, 0))
    meshes = [(ground, 0), (sphere, 1)]
    bvh = bvh_mod.build_bvh(meshes)

    rng = np.random.default_rng(0)
    o = np.array([[0.0, 3.0, 5.0]]).repeat(64, 0).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:, 1] -= 0.5  # bias downward so many rays hit
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    res = jax.jit(lambda o, d: bvh_mod.closest_hit(bvh, o, d))(
        jnp.asarray(o), jnp.asarray(d)
    )
    t_ref = brute_force_hit(meshes, o, d)
    t_dev = np.where(np.asarray(res["hit"]), np.asarray(res["t"]), np.inf)
    np.testing.assert_allclose(t_dev, t_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_render_produces_plausible_image():
    scene = make_scene()
    cam = look_at(eye=(5, 3, 6), target=(0.5, 0.8, 0), aspect=1.0,
                  v_fov=math.radians(50))
    img = jax.jit(
        lambda k: render(scene, cam, 64, 64,
                         PathTracerSettings(recursion_depth=2), spp=4, key=k)
    )(jax.random.PRNGKey(0))
    img = np.asarray(img)
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    # Sky visible somewhere (bright) and shadowed ground darker.
    assert img.max() > 0.2
    # Image is not constant.
    assert img.std() > 0.01


def test_sky_sun_disc():
    sky = default_sky()
    d = sky.sun_direction[None, :]
    up = jnp.array([[0.0, 1.0, 0.0]])
    sun = sky_radiance(sky, d)
    zen = sky_radiance(sky, up)
    assert float(sun[0, 0]) > float(zen[0, 0]) * 5


def test_primitive_meshes_valid():
    for mesh in [mesh_mod.box(), mesh_mod.uv_sphere(), mesh_mod.ico_sphere(),
                 mesh_mod.capsule(), mesh_mod.cylinder(), mesh_mod.torus(),
                 mesh_mod.arrow(), mesh_mod.mace(), mesh_mod.hollow_cylinder()]:
        assert np.isfinite(mesh.positions).all()
        assert mesh.indices.max() < len(mesh.positions)
        n = np.linalg.norm(mesh.normals, axis=-1)
        np.testing.assert_allclose(n, 1.0, atol=1e-4)


def test_dense_path_matches_bvh_traversal():
    """The dense intersector and the skip-link traversal must agree."""
    from d3d12renderer_jax.render import bvh as bvh_mod

    ground = mesh_mod.quad(half=5.0)
    sphere = mesh_mod.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0))
    meshes = [(ground, 0), (sphere, 1)]
    loop_bvh = bvh_mod.build_bvh(meshes)
    dense_bvh = loop_bvh.replace(dense=bvh_mod.build_dense(loop_bvh))
    assert loop_bvh.dense is None

    rng = np.random.default_rng(1)
    o = np.array([[0.0, 3.0, 5.0]]).repeat(128, 0).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d[:, 1] -= 0.6
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    r1 = jax.jit(lambda o, d: bvh_mod.closest_hit(dense_bvh, o, d))(
        jnp.asarray(o), jnp.asarray(d))
    r2 = jax.jit(lambda o, d: bvh_mod.closest_hit(loop_bvh, o, d))(
        jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(r1["hit"]), np.asarray(r2["hit"]))
    hit = np.asarray(r1["hit"])
    np.testing.assert_allclose(np.asarray(r1["t"])[hit],
                               np.asarray(r2["t"])[hit], rtol=1e-3, atol=1e-3)


def test_native_bvh_builder_matches_numpy(monkeypatch):
    """The C++ median-split builder (native/mesh_ops.cpp bvh_build) and the
    NumPy fallback produce the same tree: identical node layout/bounds/skip
    links, and the same triangle SET per leaf (within-leaf order may differ
    — nth_element vs argsort tie handling — which cannot change any ray
    result)."""
    from d3d12renderer_jax.assets.native import native_available
    from d3d12renderer_jax.render import bvh as bvh_mod
    from d3d12renderer_jax.render import mesh as mesh_mod

    if not native_available():
        pytest.skip("no native toolchain")
    meshes = [(mesh_mod.uv_sphere(0.7, 14, 20), 0),
              (mesh_mod.box((0.4, 0.3, 0.5)).transformed(
                  translate=(1.5, 0.4, 0.0)), 1),
              (mesh_mod.quad(6.0), 2)]
    monkeypatch.setenv("D3D12_NATIVE_BVH", "1")
    bn = bvh_mod.build_bvh(meshes, cache=False)
    monkeypatch.setenv("D3D12_NATIVE_BVH", "0")
    bp = bvh_mod.build_bvh(meshes, cache=False)

    for f in ("node_min", "node_max", "node_first", "node_count",
              "node_miss"):
        np.testing.assert_array_equal(np.asarray(getattr(bn, f)),
                                      np.asarray(getattr(bp, f)), err_msg=f)
    # Same triangles in each leaf (compare as sets via sorted v0 rows).
    first = np.asarray(bn.node_first)
    count = np.asarray(bn.node_count)
    vn, vp = np.asarray(bn.tri_v0), np.asarray(bp.tri_v0)
    for f, c in zip(first[count > 0], count[count > 0]):
        a = np.sort(vn[f:f + c].round(5).view([("", vn.dtype)] * 3), axis=0)
        b = np.sort(vp[f:f + c].round(5).view([("", vp.dtype)] * 3), axis=0)
        np.testing.assert_array_equal(a, b)


def test_bvh_content_hash_cache(tmp_path, monkeypatch):
    """Disk-cached BVH (the BLAS-cache analogue of the reference's
    .cache.bin derived data) reproduces every array bit-exactly and
    invalidates when geometry changes."""
    from d3d12renderer_jax.render import bvh as bvh_mod
    from d3d12renderer_jax.render import mesh as mesh_mod

    monkeypatch.setenv("D3D12_BVH_CACHE_DIR", str(tmp_path))
    meshes = [(mesh_mod.uv_sphere(0.7, 12, 16), 0),
              (mesh_mod.box((0.4, 0.4, 0.4)).transformed(
                  translate=(1.5, 0.4, 0.0)), 1)]
    b1 = bvh_mod.build_bvh(meshes, cache=True)
    files = list(tmp_path.glob("*.npz"))
    assert len(files) == 1
    b2 = bvh_mod.build_bvh(meshes, cache=True)
    for f in bvh_mod._BVH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(b1, f)),
                                      np.asarray(getattr(b2, f)))
    assert b1.dense is None and b2.dense is None

    # Different geometry -> different key (no false hit).
    meshes2 = [(mesh_mod.uv_sphere(0.71, 12, 16), 0), meshes[1]]
    b3 = bvh_mod.build_bvh(meshes2, cache=True)
    assert len(list(tmp_path.glob("*.npz"))) == 2
    assert not np.array_equal(np.asarray(b3.tri_v0), np.asarray(b1.tri_v0))


def test_native_bvh_builder_edge_cases():
    """Structural invariants of the native builder on degenerate inputs:
    single triangle, all-identical centroids (total ties), collinear
    centroids, leaf_size=1."""
    from d3d12renderer_jax.assets.native import (
        bvh_build_arrays, native_available,
    )

    if not native_available():
        pytest.skip("no native toolchain")

    def check(lo, hi, cent, leaf=4):
        r = bvh_build_arrays(lo, hi, cent, leaf)
        assert r is not None
        nm, nx, nf, ncnt, miss, perm = r
        t = len(perm)
        assert sorted(perm.tolist()) == list(range(t))
        leaves = sorted((f, c) for f, c in zip(nf, ncnt) if c > 0)
        pos = 0
        for f, c in leaves:  # leaves tile [0, t) contiguously in DFS order
            assert f == pos
            pos += c
        assert pos == t
        assert 0 <= miss.min() and miss.max() <= len(nm)

    rng = np.random.default_rng(0)
    check(np.zeros((1, 3)), np.ones((1, 3)), np.full((1, 3), 0.5))
    T = 400
    check(np.zeros((T, 3)), np.ones((T, 3)), np.zeros((T, 3)))
    c = rng.uniform(-5, 5, (T, 3))
    e = rng.uniform(0, 0.1, (T, 3))
    check(c - e, c + e, c)
    check(c - e, c + e, c, leaf=1)
    c2 = np.zeros((T, 3))
    c2[:, 0] = np.arange(T)
    check(c2 - 0.1, c2 + 0.1, c2)
