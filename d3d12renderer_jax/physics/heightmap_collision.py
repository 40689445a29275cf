"""Triangle-exact heightfield collision via min-max mip descent.

Reference: src/physics/heightmap_collision.cpp:509 — the collider's AABB
descends a min-max mip pyramid over the height grid to find candidate cells,
then tests the collider against those cells' two triangles.  This catches
cliffs and overhang-free sharp features that the bilinear tangent-plane
path (physics/collide.py _vs_terrain_manifolds) smooths over.

Design: the descent runs with FIXED shapes — a (K,) candidate-cell table
per level, expanded 4x and re-compacted with top_k each step (the bucketed
padding + overflow recipe, SURVEY.md §7 hard part 2).  Vertex-vs-triangle
tests are batched over (collider vertices x candidate cells x 2 triangles).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

MIP_CANDIDATES = 16   # cells kept per level during the descent


def build_minmax_mips(heights):
    """Min/max pyramid over leaf CELLS (a cell spans 4 corner samples).

    heights (R0, R1) -> list of (lo, hi) from leaf level (P, P) up to (1, 1),
    P = next power of two >= max(R0, R1) - 1.  Padding cells get +inf/-inf so
    they never overlap a collider's y-range."""
    h = jnp.asarray(heights)
    lo = jnp.minimum(jnp.minimum(h[:-1, :-1], h[1:, :-1]),
                     jnp.minimum(h[:-1, 1:], h[1:, 1:]))
    hi = jnp.maximum(jnp.maximum(h[:-1, :-1], h[1:, :-1]),
                     jnp.maximum(h[:-1, 1:], h[1:, 1:]))
    cells = max(lo.shape)
    p = 1
    while p < cells:
        p *= 2
    lo = jnp.pad(lo, ((0, p - lo.shape[0]), (0, p - lo.shape[1])),
                 constant_values=jnp.inf)
    hi = jnp.pad(hi, ((0, p - hi.shape[0]), (0, p - hi.shape[1])),
                 constant_values=-jnp.inf)
    levels = [(lo, hi)]
    while levels[-1][0].shape[0] > 1:
        l, g = levels[-1]
        l = jnp.minimum(jnp.minimum(l[0::2, 0::2], l[1::2, 0::2]),
                        jnp.minimum(l[0::2, 1::2], l[1::2, 1::2]))
        g = jnp.maximum(jnp.maximum(g[0::2, 0::2], g[1::2, 0::2]),
                        jnp.maximum(g[0::2, 1::2], g[1::2, 1::2]))
        levels.append((l, g))
    return levels[::-1]   # coarse (1,1) first


def _descend(levels, origin, cell, lo3, hi3, k=MIP_CANDIDATES):
    """AABB (lo3, hi3) -> (cells (K, 2) leaf indices, valid (K,), overflow).

    Fixed-iteration coarse->fine expansion; each level keeps at most K
    overlapping cells."""
    # Collider AABB in leaf-cell units.
    u0 = (lo3[0] - origin[0]) / cell
    u1 = (hi3[0] - origin[0]) / cell
    v0 = (lo3[2] - origin[2]) / cell
    v1 = (hi3[2] - origin[2]) / cell
    y0 = lo3[1] - origin[1]
    y1 = hi3[1] - origin[1]

    n_levels = len(levels)
    ci = jnp.zeros((k, 2), jnp.int32)         # level-0 has one cell (0, 0)
    valid = jnp.zeros((k,), bool).at[0].set(True)
    overflow = jnp.zeros((), jnp.int32)

    for lev in range(1, n_levels):
        lo_map, hi_map = levels[lev]
        scale = 2 ** (n_levels - 1 - lev)     # leaf cells per cell at lev
        # Expand each candidate into its 4 children.
        child = (ci[:, None, :] * 2
                 + jnp.array([[0, 0], [0, 1], [1, 0], [1, 1]],
                             jnp.int32)[None, :, :]).reshape(-1, 2)  # (4K, 2)
        cvalid = jnp.repeat(valid, 4)
        cu0 = child[:, 0].astype(jnp.float32) * scale
        cv0 = child[:, 1].astype(jnp.float32) * scale
        in_u = (cu0 <= u1) & (cu0 + scale >= u0)
        in_v = (cv0 <= v1) & (cv0 + scale >= v0)
        clo = lo_map[child[:, 0], child[:, 1]]
        chi = hi_map[child[:, 0], child[:, 1]]
        in_y = (clo <= y1) & (chi >= y0)
        keep = cvalid & in_u & in_v & in_y

        count = jnp.sum(keep)
        overflow = overflow + jnp.maximum(count - k, 0)
        score = jnp.where(keep, 4 * k - jnp.arange(4 * k), 0)
        _, sel = jax.lax.top_k(score, k)
        ci = child[sel]
        valid = keep[sel]
    return ci, valid, overflow


def _candidate_tris(heights, levels, origin, cell, lo3, hi3):
    """AABB -> candidate terrain triangles via the mip descent.

    Returns (tv (2K,3,3) world triangle vertices, tvalid (2K,), n (2K,3)
    upward unit normals, overflow ()).  Triangulation matches
    terrain.heightmap_mesh: cell (i,j) splits into [(i,j),(i+1,j),(i,j+1)]
    and [(i,j+1),(i+1,j),(i+1,j+1)]."""
    cells, cvalid, overflow = _descend(levels, origin, cell, lo3, hi3)

    r0, r1 = heights.shape
    i = jnp.clip(cells[:, 0], 0, r0 - 2)
    j = jnp.clip(cells[:, 1], 0, r1 - 2)
    # Cell corner positions (K, 3) each.
    def corner(di, dj):
        x = origin[0] + (i + di).astype(jnp.float32) * cell
        z = origin[2] + (j + dj).astype(jnp.float32) * cell
        y = origin[1] + heights[i + di, j + dj]
        return jnp.stack([x, y, z], -1)

    p00, p10, p01, p11 = corner(0, 0), corner(1, 0), corner(0, 1), corner(1, 1)
    # (K, 2, 3, 3) triangle vertices.
    tris = jnp.stack([
        jnp.stack([p00, p10, p01], 1),
        jnp.stack([p01, p10, p11], 1),
    ], 1)
    tv = tris.reshape(-1, 3, 3)                       # (2K, 3, 3)
    tvalid = jnp.repeat(cvalid, 2)

    a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]
    n = jnp.cross(b - a, c - a)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    n = jnp.where(n[:, 1:2] < 0, -n, n)               # upward
    return tv, tvalid, n, overflow


def vertex_vs_terrain_triangles(heights, levels, origin, cell, verts, vmask):
    """Deepest <=4 vertex-vs-triangle contacts of one vertex cloud vs one
    heightfield.  Returns (points (4,3), depths (4,), mask (4,), normal (3,),
    overflow ()) — overflow > 0 means the mip descent dropped candidate cells
    (collider AABB spans more than MIP_CANDIDATES cells at some level) and
    the caller should fall back to the tangent-plane manifold for this row."""
    big = jnp.where(vmask[:, None], verts, jnp.inf)
    small = jnp.where(vmask[:, None], verts, -jnp.inf)
    lo3 = jnp.min(big, axis=0)
    hi3 = jnp.max(small, axis=0)
    tv, tvalid, n, overflow = _candidate_tris(
        heights, levels, origin, cell, lo3, hi3)
    a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]

    # Vertex-in-triangle (xz projection) via 2D barycentrics.
    v2 = verts[:, None, ::2]                          # (V, 1, 2) x,z
    a2, b2, c2 = a[None, :, ::2], b[None, :, ::2], c[None, :, ::2]
    d00 = b2 - a2
    d01 = c2 - a2
    dp = v2 - a2
    den = d00[..., 0] * d01[..., 1] - d00[..., 1] * d01[..., 0]
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    bu = (dp[..., 0] * d01[..., 1] - dp[..., 1] * d01[..., 0]) / den
    bv = (d00[..., 0] * dp[..., 1] - d00[..., 1] * dp[..., 0]) / den
    inside = (bu >= -1e-4) & (bv >= -1e-4) & (bu + bv <= 1.0 + 1e-4)

    depth = jnp.sum(n[None] * (a[None] - verts[:, None]), -1)   # below plane
    ok = inside & (depth > 0) & tvalid[None, :] & vmask[:, None]
    depth = jnp.where(ok, depth, -jnp.inf)

    flat_d = depth.reshape(-1)
    vals, sel = jax.lax.top_k(flat_d, 4)
    vi = sel // depth.shape[1]
    ti = sel % depth.shape[1]
    points = verts[vi]
    mask = vals > 0
    depths = jnp.where(mask, vals, 0.0)
    # The manifold format carries ONE normal per row; contacts straddling a
    # ridge may touch triangles with different normals, so blend the selected
    # contacts' triangle normals weighted by depth (deepest dominates).
    w = jnp.where(mask, vals, 0.0)[:, None]
    blended = jnp.sum(w * n[ti], axis=0)
    blen = jnp.linalg.norm(blended)
    normal = jnp.where(blen > 1e-9, blended / jnp.maximum(blen, 1e-9), n[ti[0]])
    return points, depths, mask, normal, overflow


def convex_vs_terrain_triangles(heights, levels, origin, cell, verts, vmask,
                                col_ref):
    """Full convex-vs-triangle contacts: vertex tests + GJK/EPA per triangle.

    The vertex test alone misses edge/face cases — a wide flat hull
    straddling a sharp ridge has no vertex below any triangle, yet the crest
    penetrates the hull's bottom face (reference handles the general collider
    surface, src/physics/heightmap_collision.cpp:509).  Here each candidate
    triangle additionally runs batched GJK/EPA against the collider (the
    triangle as a 3-vertex hull), which produces exactly those
    edge-edge / face-vertex contacts; the deepest 4 across both sources form
    the manifold.

    `col_ref` is ONE ShapeRef row (unbatched leaves) for the collider.
    Returns (points (4,3), depths (4,), mask (4,), normal (3,), overflow ())
    like vertex_vs_terrain_triangles."""
    from .gjk import ShapeRef, gjk_epa_contact
    from .types import SHAPE_HULL

    big = jnp.where(vmask[:, None], verts, jnp.inf)
    small = jnp.where(vmask[:, None], verts, -jnp.inf)
    lo3 = jnp.min(big, axis=0)
    hi3 = jnp.max(small, axis=0)
    tv, tvalid, n, overflow = _candidate_tris(
        heights, levels, origin, cell, lo3, hi3)
    a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]
    nt = tv.shape[0]                                   # 2K triangles

    # --- vertex-vs-triangle table (same math as the vertex path) ----------
    v2 = verts[:, None, ::2]
    a2, b2, c2 = a[None, :, ::2], b[None, :, ::2], c[None, :, ::2]
    d00 = b2 - a2
    d01 = c2 - a2
    dp = v2 - a2
    den = d00[..., 0] * d01[..., 1] - d00[..., 1] * d01[..., 0]
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    bu = (dp[..., 0] * d01[..., 1] - dp[..., 1] * d01[..., 0]) / den
    bv = (d00[..., 0] * dp[..., 1] - d00[..., 1] * dp[..., 0]) / den
    inside = (bu >= -1e-4) & (bv >= -1e-4) & (bu + bv <= 1.0 + 1e-4)
    vdepth = jnp.sum(n[None] * (a[None] - verts[:, None]), -1)
    vok = inside & (vdepth > 0) & tvalid[None, :] & vmask[:, None]
    flat_d = jnp.where(vok, vdepth, -jnp.inf).reshape(-1)   # (V*2K,)

    # --- GJK/EPA: collider vs each candidate triangle ---------------------
    def bcast(x):
        return jnp.broadcast_to(x, (nt,) + x.shape)

    tri_ref = ShapeRef(
        shape_type=jnp.full((nt,), SHAPE_HULL, jnp.int32),
        size=jnp.zeros((nt, 3)),
        pos=jnp.zeros((nt, 3)),
        rot=jnp.broadcast_to(jnp.array([0.0, 0.0, 0.0, 1.0]), (nt, 4)),
        hull_verts=tv,                                  # world coords, pos=0
        hull_mask=jnp.ones((nt, 3), bool),
        margin=jnp.zeros((nt,)),
    )
    col_b = ShapeRef(*[bcast(leaf) for leaf in col_ref])
    # normal tri->collider (a->b) points off the terrain surface.
    g_n, g_p, g_d, g_hit = gjk_epa_contact(tri_ref, col_b)
    g_n = g_n.reshape(nt, 3)
    g_p = g_p.reshape(nt, 3)
    g_d = g_d.reshape(nt)
    # Half-space consistency: keep only contacts pushing out of the terrain
    # surface (rejects pop-through-the-bottom MTDs of the zero-thickness
    # triangle treated as a solid hull).
    g_ok = (g_hit.reshape(nt) & tvalid & (g_d > 0)
            & (jnp.sum(g_n * n, -1) > 0.0))
    g_dm = jnp.where(g_ok, g_d, -jnp.inf)

    # --- merge: deepest 4 across both sources -----------------------------
    all_d = jnp.concatenate([flat_d, g_dm])
    vals, sel = jax.lax.top_k(all_d, 4)
    is_g = sel >= flat_d.shape[0]
    vsel = jnp.minimum(sel, flat_d.shape[0] - 1)
    vi = vsel // nt
    ti = vsel % nt
    gsel = jnp.clip(sel - flat_d.shape[0], 0, nt - 1)
    points = jnp.where(is_g[:, None], g_p[gsel], verts[vi])
    per_n = jnp.where(is_g[:, None], g_n[gsel], n[ti])
    mask = vals > 0
    depths = jnp.where(mask, vals, 0.0)
    w = jnp.where(mask, vals, 0.0)[:, None]
    blended = jnp.sum(w * per_n, axis=0)
    blen = jnp.linalg.norm(blended)
    normal = jnp.where(blen > 1e-9, blended / jnp.maximum(blen, 1e-9),
                       per_n[0])
    return points, depths, mask, normal, overflow
