"""The two XLA ray paths of render/bvh.py against a NumPy brute force.

closest_hit takes the all-pairs dense scan for BVHs with dense tables (the
per-frame instance shells) and the skip-link traversal for built BVHs; both
must report the nearest triangle, its t and barycentrics, honour t_max, and
report misses as tri = -1.  any_hit rides on the same paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod


def _scene():
    ground = mesh_mod.quad(half=5.0)
    sphere = mesh_mod.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0))
    box = mesh_mod.box((0.5, 0.5, 0.5)).transformed(translate=(2.0, 0.5, 0.0))
    return [(ground, 0), (sphere, 1), (box, 2)]


def _rays(n=96, seed=0):
    """Rays from above the scene, a quarter of them aimed at the sky."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.5, 3.0, 5.0]], np.float32), (n, 1))
    o += rng.uniform(-0.5, 0.5, o.shape).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.4
    d[: n // 4, 1] = np.abs(d[: n // 4, 1]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _brute_force(bvh, o, d, t_max):
    """Nearest (t, tri, u, v) per ray over the BVH's triangle soup, in
    float64 Moller-Trumbore; tri = -1 and t = inf on a miss."""
    v0 = np.asarray(bvh.tri_v0, np.float64)[None]
    e1 = np.asarray(bvh.tri_e1, np.float64)[None]
    e2 = np.asarray(bvh.tri_e2, np.float64)[None]
    valid = np.asarray(bvh.tri_valid)[None]
    o = o.astype(np.float64)[:, None]
    d = d.astype(np.float64)[:, None]
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    inv = 1.0 / np.where(np.abs(det) > 1e-12, det, np.inf)
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (valid & (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0)
          & (u + v <= 1) & (t > 1e-4) & (t < np.asarray(t_max)[..., None]))
    t = np.where(ok, t, np.inf)
    tri = np.argmin(t, -1)
    rows = np.arange(len(tri))
    t_best = t[rows, tri]
    hit = np.isfinite(t_best)
    return (t_best, np.where(hit, tri, -1), u[rows, tri], v[rows, tri])


@pytest.fixture(scope="module")
def bvhs():
    b = bvh_mod.build_bvh(_scene())
    return {"dense": b.replace(dense=bvh_mod.build_dense(b)), "traverse": b}


@pytest.mark.parametrize("path", ["dense", "traverse"])
@pytest.mark.parametrize("t_max", [1e30, 4.0])
def test_closest_hit_matches_brute_force(bvhs, path, t_max):
    b = bvhs[path]
    assert (b.dense is not None) == (path == "dense")
    o, d = _rays()
    res = jax.jit(lambda o, d: bvh_mod.closest_hit(b, o, d, t_max=t_max))(
        jnp.asarray(o), jnp.asarray(d))
    t_ref, tri_ref, u_ref, v_ref = _brute_force(b, o, d, t_max)
    hit = np.asarray(res["hit"])
    np.testing.assert_array_equal(hit, tri_ref >= 0)
    assert 0 < hit.sum() < len(hit)  # hits and misses both covered
    np.testing.assert_array_equal(np.asarray(res["tri"])[~hit], -1)
    np.testing.assert_allclose(np.asarray(res["t"])[hit], t_ref[hit],
                               rtol=1e-4, atol=1e-4)
    # The same triangle, up to ties between triangles that share the hit
    # point (edges, the box's coplanar halves): compare barycentric hit
    # points instead of ids there.
    same = np.asarray(res["tri"])[hit] == tri_ref[hit]
    assert same.mean() > 0.95
    uv = np.asarray(res["uv"])[hit][same]
    np.testing.assert_allclose(uv[:, 0], u_ref[hit][same], atol=1e-3)
    np.testing.assert_allclose(uv[:, 1], v_ref[hit][same], atol=1e-3)


@pytest.mark.parametrize("path", ["dense", "traverse"])
def test_any_hit_is_closest_hit_within_t_max(bvhs, path):
    b = bvhs[path]
    o, d = _rays(seed=3)
    t_max = np.linspace(0.5, 8.0, len(o)).astype(np.float32)
    blocked = jax.jit(lambda o, d, t: bvh_mod.any_hit(b, o, d, t))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    t_ref = _brute_force(b, o, d, np.full(len(o), 1e30))[0]
    np.testing.assert_array_equal(np.asarray(blocked), t_ref < t_max)


def test_built_bvh_traverses_and_instance_shells_scan():
    """build_bvh makes no dense tables (its tree is traversed); the
    per-frame instance shell, whose 1-node tree is no hierarchy, carries
    them, and closest_hit on it matches the built BVH's traversal."""
    from d3d12renderer_jax.render.instances import (
        build_instanced, retransform,
    )

    meshes = _scene()
    b = bvh_mod.build_bvh(meshes, cache=False)
    assert b.dense is None
    n = len(meshes)
    inst = build_instanced(meshes, list(range(n)))
    shell = retransform(inst, jnp.zeros((n, 3)),
                        jnp.tile(jnp.array([[0.0, 0.0, 0.0, 1.0]]), (n, 1)))
    assert shell.dense is not None
    o, d = _rays(seed=7)
    hit_s = bvh_mod.closest_hit(shell, jnp.asarray(o), jnp.asarray(d))
    hit_b = bvh_mod.closest_hit(b, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(hit_s["hit"]),
                                  np.asarray(hit_b["hit"]))
    h = np.asarray(hit_b["hit"])
    np.testing.assert_allclose(np.asarray(hit_s["t"])[h],
                               np.asarray(hit_b["t"])[h], rtol=1e-4, atol=1e-4)
