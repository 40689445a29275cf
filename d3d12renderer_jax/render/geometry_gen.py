"""Compute-generated geometry demos: meta-balls isosurface + Koch fractal.

Reference: src/rendering/mesh_shader.cpp:13-25 — two mesh-shader demos: a
Koch-fractal amplification shader and marching-cubes meta-balls (lookup table
mesh_shader.cpp:25, shaders/mesh_shaders/*).  Without mesh shaders, the
idiomatic equivalent (SURVEY.md §2.40) is compute-style geometry generation:
the meta-ball isosurface is extracted with surface nets (table-free dual
contouring — one fully-vectorized pass over the field), and the Koch fractal
is generated by vectorized edge subdivision.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def metaball_field(centers, radii, resolution=32, extent=2.0):
    """(R, R, R) scalar field sum(r_i^2 / |x - c_i|^2) - 1 (classic
    meta-balls; isosurface at 0)."""
    g = jnp.linspace(-extent, extent, resolution)
    gx, gy, gz = jnp.meshgrid(g, g, g, indexing="ij")
    p = jnp.stack([gx, gy, gz], -1)                        # (R,R,R,3)
    d2 = jnp.sum(
        (p[..., None, :] - centers[None, None, None]) ** 2, -1
    )                                                      # (R,R,R,B)
    field = jnp.sum(radii[None, None, None] ** 2
                    / jnp.maximum(d2, 1e-6), -1) - 1.0
    return field, p


def surface_nets(field, positions):
    """Table-free isosurface extraction (naive surface nets).

    field (R,R,R) signed values; positions (R,R,R,3).  Returns fixed-shape
    (verts (C,3), vert_valid (C,), quads (E,4), quad_valid (E,)) where C =
    cells, E = crossing-edge slots — masked, jit-friendly geometry like every
    other fixed-shape table in this framework."""
    r = field.shape[0]
    c = r - 1
    inside = field > 0.0

    # Cell corner samples (C^3, 8).
    def cell(f):
        return jnp.stack([
            f[:-1, :-1, :-1], f[1:, :-1, :-1], f[:-1, 1:, :-1], f[1:, 1:, :-1],
            f[:-1, :-1, 1:], f[1:, :-1, 1:], f[:-1, 1:, 1:], f[1:, 1:, 1:],
        ], -1)

    corners = cell(field)                                   # (c,c,c,8)
    corner_pos = jnp.stack([
        positions[:-1, :-1, :-1], positions[1:, :-1, :-1],
        positions[:-1, 1:, :-1], positions[1:, 1:, :-1],
        positions[:-1, :-1, 1:], positions[1:, :-1, 1:],
        positions[:-1, 1:, 1:], positions[1:, 1:, 1:],
    ], -2)                                                   # (c,c,c,8,3)

    sign = corners > 0
    crossing = jnp.any(sign, -1) & ~jnp.all(sign, -1)        # (c,c,c)

    # Vertex per crossing cell: field-weighted average of edge crossings
    # approximated by the |f|-weighted corner centroid (standard naive nets).
    wgt = 1.0 / (jnp.abs(corners) + 1e-4)
    verts = jnp.sum(corner_pos * wgt[..., None], -2) / jnp.sum(
        wgt, -1)[..., None]
    verts = verts.reshape(-1, 3)
    vert_valid = crossing.reshape(-1)

    def cell_index(i, j, k):
        return (i * c + j) * c + k

    # Quads across crossing edges: for each interior lattice edge along each
    # axis, if the field sign differs, connect the 4 cells sharing the edge.
    quads = []
    quad_valid = []
    ii, jj, kk = jnp.meshgrid(jnp.arange(1, c), jnp.arange(1, c),
                              jnp.arange(1, c), indexing="ij")
    for axis in range(3):
        # Edge from sample (i,j,k) to sample +1 along `axis`.
        f0 = field[1:c, 1:c, 1:c]
        f1 = jnp.roll(field, -1, axis)[1:c, 1:c, 1:c]
        crossed = (f0 > 0) != (f1 > 0)
        flip = f0 > 0
        if axis == 0:
            cells = [(ii, jj - 1, kk - 1), (ii, jj, kk - 1),
                     (ii, jj, kk), (ii, jj - 1, kk)]
        elif axis == 1:
            cells = [(ii - 1, jj, kk - 1), (ii, jj, kk - 1),
                     (ii, jj, kk), (ii - 1, jj, kk)]
        else:
            cells = [(ii - 1, jj - 1, kk), (ii, jj - 1, kk),
                     (ii, jj, kk), (ii - 1, jj, kk)]
        q = jnp.stack([cell_index(*cix) for cix in cells], -1)
        # Orient by sign for consistent winding.
        q = jnp.where(flip[..., None], q[..., ::-1], q)
        quads.append(q.reshape(-1, 4))
        quad_valid.append(crossed.reshape(-1))
    return verts, vert_valid, jnp.concatenate(quads), jnp.concatenate(quad_valid)


def metaballs_mesh(centers, radii, resolution=32, extent=2.0):
    """Host-side wrapper: jitted extraction -> compact numpy MeshData."""
    from .mesh import MeshData

    field, pos = metaball_field(jnp.asarray(centers, jnp.float32),
                                jnp.asarray(radii, jnp.float32),
                                resolution, extent)
    verts, vv, quads, qv = jax.jit(surface_nets)(field, pos)
    verts = np.asarray(verts)
    quads = np.asarray(quads)[np.asarray(qv)]
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])

    used = np.unique(tris)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    p = verts[used].astype(np.float32)
    t = remap[tris].astype(np.int32)

    from ..assets.loaders import generate_normals

    mesh = MeshData(p, np.zeros_like(p),
                    np.zeros((len(p), 2), np.float32), t)
    return generate_normals(mesh)


def koch_snowflake(iterations=4, radius=1.0):
    """2D Koch snowflake outline by vectorized edge subdivision
    (reference: the Koch AS/MS demo).  Returns (N, 2) closed polyline."""
    ang = np.array([math.pi / 2 + i * 2 * math.pi / 3 for i in range(3)])
    pts = np.stack([np.cos(ang), np.sin(ang)], -1) * radius
    for _ in range(iterations):
        a = pts
        b = np.roll(pts, -1, 0)
        d = b - a
        p1 = a + d / 3
        p2 = a + d * 2 / 3
        # Outward bump: rotate d/3 by -60 deg.
        rot = np.array([[math.cos(-math.pi / 3), -math.sin(-math.pi / 3)],
                        [math.sin(-math.pi / 3), math.cos(-math.pi / 3)]])
        tip = p1 + (d / 3) @ rot.T
        pts = np.stack([a, p1, tip, p2], 1).reshape(-1, 2)
    return pts.astype(np.float32)


def koch_fractal_3d(iterations=3, radius=1.0, height=0.1):
    """Extrude the snowflake into a render mesh (top face only, like the demo
    geometry)."""
    from .mesh import MeshData

    outline = koch_snowflake(iterations, radius)
    n = len(outline)
    center = outline.mean(0)
    p = np.concatenate([
        np.concatenate([outline, np.full((n, 1), height)], -1),
        [[center[0], center[1], height]],
    ]).astype(np.float32)[:, [0, 2, 1]]  # XZ plane, Y up
    tris = np.stack([
        np.full(n, n), np.arange(n), np.roll(np.arange(n), -1),
    ], -1).astype(np.int32)
    normals = np.tile([0, 1, 0], (n + 1, 1)).astype(np.float32)
    uv = np.zeros((n + 1, 2), np.float32)
    return MeshData(p, normals, uv, tris)
