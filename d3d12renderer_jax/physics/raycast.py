"""Exact ray-vs-primitive intersection + scene ray cast.

Reference: the ray tests in src/physics/bounding_volumes.cpp
(rayIntersectsSphere/Capsule/Cylinder/AABB/OBB/Hull, ~line 60-420) used by
the editor's mouse picking and physics.cpp:555 testPhysicsInteraction.

Shape: every primitive test is branch-free and batched over a
trailing collider axis; the hull test replaces the reference's per-face
plane clipping (hulls here are stored as padded vertex clouds, not face
lists) with fixed-iteration conservative advancement — sphere-tracing the
ray against the point-to-hull distance from the batched GJK in gjk.py.

`ray_cast` dispatches per shape type over STATIC segments (the same
compile-time-specialization trick as collide.py), so each scene compiles
only the kernels its collider mix needs.  It requires a concrete (host)
archetype — close over `arch` when jitting, as physics_step does.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import maths as m
from .gjk import ShapeRef, gjk
from .types import (
    SHAPE_BOX,
    SHAPE_CAPSULE,
    SHAPE_CYLINDER,
    SHAPE_HULL,
    SHAPE_SPHERE,
    BodyState,
    SceneArchetype,
)

_INF = 1e30
_HULL_TRACE_STEPS = 48


class RayHit(NamedTuple):
    """Nearest hit along the ray.  `kind` is 0=collider, 1=plane, 2=terrain;
    `index` indexes into that table; `body` is the owning body (-1 for
    static geometry).  On a miss `hit` is False and t = 1e30."""

    hit: jnp.ndarray      # () bool
    t: jnp.ndarray        # () float
    point: jnp.ndarray    # (3,)
    normal: jnp.ndarray   # (3,)
    kind: jnp.ndarray     # () int32
    index: jnp.ndarray    # () int32
    body: jnp.ndarray     # () int32


def _miss_like(t):
    return jnp.where(jnp.isfinite(t) & (t >= 0.0), t, _INF)


def ray_vs_sphere(o, d, center, radius):
    """(t, normal) of the first hit with the sphere surface; t=1e30 on miss.
    Rays starting inside report the exit point (matching the reference's
    convention of returning the positive root)."""
    oc = o - center
    b = jnp.sum(oc * d, -1)
    c = jnp.sum(oc * oc, -1) - radius * radius
    disc = b * b - c
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0, t1 = -b - s, -b + s
    t = jnp.where(t0 > 1e-6, t0, t1)
    t = jnp.where(disc >= 0.0, _miss_like(t), _INF)
    n = m.noz(o + d * t[..., None] - center)
    return t, n


def ray_vs_capsule(o, d, p0, p1, radius):
    """Capsule between hemisphere centers p0/p1: infinite-cylinder side hit
    clipped to the segment, plus the two cap spheres."""
    axis = m.noz(p1 - p0)
    oc = o - p0
    d_perp = d - axis * jnp.sum(d * axis, -1, keepdims=True)
    oc_perp = oc - axis * jnp.sum(oc * axis, -1, keepdims=True)
    a = jnp.sum(d_perp * d_perp, -1)
    b = jnp.sum(oc_perp * d_perp, -1)
    c = jnp.sum(oc_perp * oc_perp, -1) - radius * radius
    disc = b * b - a * c
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    safe_a = jnp.maximum(a, 1e-12)
    t0 = (-b - s) / safe_a
    t1 = (-b + s) / safe_a
    t_side = jnp.where(t0 > 1e-6, t0, t1)
    # Clip the side hit to lie between the hemisphere centers.
    h = jnp.sum((o + d * t_side[..., None] - p0) * axis, -1)
    seg_len = m.length(p1 - p0)
    on_side = (disc >= 0.0) & (a > 1e-12) & (h >= 0.0) & (h <= seg_len)
    t_side = jnp.where(on_side, _miss_like(t_side), _INF)

    t_a, n_a = ray_vs_sphere(o, d, p0, radius)
    t_b, n_b = ray_vs_sphere(o, d, p1, radius)
    t_cap = jnp.minimum(t_a, t_b)
    n_cap = jnp.where((t_a <= t_b)[..., None], n_a, n_b)

    t = jnp.minimum(t_side, t_cap)
    foot = p0 + axis * h[..., None]
    n_side = m.noz(o + d * t_side[..., None] - foot)
    n = jnp.where((t_side <= t_cap)[..., None], n_side, n_cap)
    return t, n


def ray_vs_box(o, d, pos, rot, half):
    """OBB slab test in the collider's local frame (reference:
    rayIntersectsAABB specialized by the OBB transform)."""
    ol = m.quat_inv_rotate(rot, o - pos)
    dl = m.quat_inv_rotate(rot, d)
    inv = 1.0 / jnp.where(jnp.abs(dl) < 1e-12,
                          jnp.where(dl >= 0, 1e-12, -1e-12), dl)
    t_lo = (-half - ol) * inv
    t_hi = (half - ol) * inv
    t_near = jnp.max(jnp.minimum(t_lo, t_hi), -1)
    t_far = jnp.min(jnp.maximum(t_lo, t_hi), -1)
    inside = t_near <= 1e-6
    t = jnp.where(inside, t_far, t_near)
    ok = (t_near <= t_far) & (t_far > 1e-6)
    t = jnp.where(ok, _miss_like(t), _INF)
    # Normal: axis of the active slab at the hit point.
    p_local = ol + dl * t[..., None]
    ax = jnp.argmax(jnp.abs(p_local / jnp.maximum(half, 1e-9)), -1)
    n_local = (jnp.eye(3, dtype=o.dtype)[ax]
               * jnp.sign(jnp.take_along_axis(p_local, ax[..., None], -1)))
    n = m.quat_rotate(rot, jnp.where(inside[..., None], -n_local, n_local))
    return t, n


def ray_vs_cylinder(o, d, pos, rot, radius, half_len):
    """Finite Y-axis cylinder: side surface clipped to |y| <= half_len plus
    the two cap disks."""
    ol = m.quat_inv_rotate(rot, o - pos)
    dl = m.quat_inv_rotate(rot, d)
    a = dl[..., 0] ** 2 + dl[..., 2] ** 2
    b = ol[..., 0] * dl[..., 0] + ol[..., 2] * dl[..., 2]
    c = ol[..., 0] ** 2 + ol[..., 2] ** 2 - radius * radius
    disc = b * b - a * c
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    safe_a = jnp.maximum(a, 1e-12)
    t0 = (-b - s) / safe_a
    t1 = (-b + s) / safe_a
    t_side = jnp.where(t0 > 1e-6, t0, t1)
    y = ol[..., 1] + dl[..., 1] * t_side
    on_side = (disc >= 0.0) & (a > 1e-12) & (jnp.abs(y) <= half_len)
    t_side = jnp.where(on_side, _miss_like(t_side), _INF)
    p_side = ol + dl * t_side[..., None]
    n_side = m.noz(p_side * jnp.array([1.0, 0.0, 1.0], o.dtype))

    # Cap disks at y = ±half_len.
    safe_dy = jnp.where(jnp.abs(dl[..., 1]) < 1e-12,
                        jnp.where(dl[..., 1] >= 0, 1e-12, -1e-12), dl[..., 1])
    t_caps, n_caps = [], []
    for sign in (1.0, -1.0):
        t_c = (sign * half_len - ol[..., 1]) / safe_dy
        p_c = ol + dl * t_c[..., None]
        in_disk = (p_c[..., 0] ** 2 + p_c[..., 2] ** 2 <= radius * radius)
        t_c = jnp.where(in_disk & (t_c > 1e-6), t_c, _INF)
        t_caps.append(t_c)
        n_caps.append(jnp.broadcast_to(
            jnp.array([0.0, sign, 0.0], o.dtype), p_c.shape))
    t_cap = jnp.minimum(t_caps[0], t_caps[1])
    n_cap = jnp.where((t_caps[0] <= t_caps[1])[..., None],
                      n_caps[0], n_caps[1])

    t = jnp.minimum(t_side, t_cap)
    n_local = jnp.where((t_side <= t_cap)[..., None], n_side, n_cap)
    return t, m.quat_rotate(rot, n_local)


def ray_vs_hull(o, d, pos, rot, hull_verts, hull_mask, max_t=100.0):
    """Convex hull (padded vertex cloud) via conservative advancement:
    sphere-trace the point `o + t d` against the GJK point-to-hull distance.
    Fixed _HULL_TRACE_STEPS outer iterations; batched over leading axes of
    `pos`.  The surface normal is the closing direction on the last
    separated step (exact in the limit, matching the reference's face-plane
    normal for face hits)."""
    rows = pos.shape[:-1]
    zeros3 = jnp.zeros(rows + (3,), pos.dtype)
    hull = ShapeRef(
        shape_type=jnp.broadcast_to(jnp.int32(SHAPE_HULL), rows),
        size=zeros3,
        pos=pos, rot=rot,
        hull_verts=hull_verts, hull_mask=hull_mask,
        margin=jnp.zeros(rows, pos.dtype),
    )

    def probe(t):
        q = o + d * t[..., None]
        pt = ShapeRef(
            shape_type=jnp.broadcast_to(jnp.int32(SHAPE_SPHERE), rows),
            size=zeros3,
            pos=jnp.broadcast_to(q, rows + (3,)),
            rot=jnp.broadcast_to(m.QUAT_IDENTITY, rows + (4,)),
            hull_verts=jnp.zeros(rows + (1, 3), pos.dtype),
            hull_mask=jnp.zeros(rows + (1,), bool),
            margin=jnp.zeros(rows, pos.dtype),
        )
        r = gjk(pt, hull)
        return r["distance"], r["closest"]

    t = jnp.zeros(rows, pos.dtype)
    n = jnp.broadcast_to(-d, rows + (3,))
    done = jnp.zeros(rows, bool)

    def body(_, carry):
        t, n, done = carry
        dist, closest = probe(t)
        arrived = dist < 1e-4
        # `closest` points from the hull witness to the probe point = the
        # outward normal direction while still separated.
        n = jnp.where((arrived | done)[..., None], n, m.noz(closest))
        # Advance by the free distance along the ray (conservative: the hull
        # is convex and static, so the ray can move the full distance).
        t = jnp.where(done | arrived, t, t + dist)
        done = done | arrived | (t > max_t)
        return t, n, done

    t, n, done = jax.lax.fori_loop(0, _HULL_TRACE_STEPS, body, (t, n, done))
    dist, _ = probe(t)
    hit = (dist < 1e-3) & (t <= max_t) & (t > 1e-6)
    return jnp.where(hit, t, _INF), n


def ray_vs_plane(o, d, normal, offset):
    """Half-space boundary dot(n, x) = offset, front faces only."""
    denom = jnp.sum(normal * d, -1)
    t = (offset - jnp.sum(normal * o, -1)) / jnp.where(
        jnp.abs(denom) < 1e-12, -1e-12, denom)
    ok = (denom < -1e-9) & (t > 1e-6)
    return jnp.where(ok, t, _INF), normal


def ray_vs_heightfield(o, d, heights, origin, cell, max_t=200.0, steps=96):
    """Fixed-step raymarch with sign-change bisection refinement against the
    bilinear surface (the render-side analog of the physics mip descent;
    reference: heightmap_collision.cpp:509)."""
    from ..terrain.heightmap import sample_height_bilinear

    ts = jnp.linspace(0.0, max_t, steps)
    p = o[None, :] + d[None, :] * ts[:, None]
    h, _ = sample_height_bilinear(heights, origin, cell, p[:, 0], p[:, 2])
    above = p[:, 1] > h
    crossing = above[:-1] & ~above[1:]
    first = jnp.argmax(crossing)
    found = jnp.any(crossing)
    lo = ts[first]
    hi = ts[jnp.minimum(first + 1, steps - 1)]

    def bisect_step(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        q = o + d * mid
        hm, _ = sample_height_bilinear(heights, origin, cell, q[0], q[2])
        below = q[1] <= hm
        return jnp.where(below, lo, mid), jnp.where(below, mid, hi)

    lo, hi = jax.lax.fori_loop(0, 16, bisect_step, (lo, hi))
    t = 0.5 * (lo + hi)
    q = o + d * t
    _, n = sample_height_bilinear(heights, origin, cell, q[0], q[2])
    return jnp.where(found, t, _INF), n


def ray_cast(arch: SceneArchetype, state: BodyState, origin, direction,
             max_t: float = 1e6) -> RayHit:
    """Nearest exact hit among all colliders, static planes, and terrains.

    Requires a concrete `arch` (per-shape dispatch is specialized at trace
    time from the host copy of col_type, like collide.py's segments).
    """
    o = jnp.asarray(origin, jnp.float32)
    d = m.noz(jnp.asarray(direction, jnp.float32))
    shapes = np.asarray(jax.device_get(arch.col_type))
    ncol = shapes.shape[0]
    wpos, wrot = _world_poses(arch, state)

    t_all = jnp.full((ncol,), _INF)
    n_all = jnp.zeros((ncol, 3))
    for stype in (SHAPE_SPHERE, SHAPE_CAPSULE, SHAPE_BOX, SHAPE_CYLINDER,
                  SHAPE_HULL):
        idx = np.nonzero(shapes == stype)[0]
        if idx.size == 0:
            continue
        cp, cr = wpos[idx], wrot[idx]
        size = arch.col_size[idx]
        if stype == SHAPE_SPHERE:
            t, n = ray_vs_sphere(o, d, cp, size[:, 0])
        elif stype == SHAPE_CAPSULE:
            axis = m.quat_rotate(cr, jnp.array([0.0, 1.0, 0.0]))
            p0 = cp - axis * size[:, 1:2]
            p1 = cp + axis * size[:, 1:2]
            t, n = ray_vs_capsule(o, d, p0, p1, size[:, 0])
        elif stype == SHAPE_BOX:
            t, n = ray_vs_box(o, d, cp, cr, size)
        elif stype == SHAPE_CYLINDER:
            t, n = ray_vs_cylinder(o, d, cp, cr, size[:, 0], size[:, 1])
        else:
            t, n = ray_vs_hull(o, d, cp, cr, arch.col_hull_verts[idx],
                               arch.col_hull_mask[idx],
                               max_t=min(max_t, 1e3))
        t_all = t_all.at[idx].set(t)
        n_all = n_all.at[idx].set(n)

    cand_t = [t_all]
    cand_n = [n_all]
    cand_kind = [jnp.zeros((ncol,), jnp.int32)]
    cand_index = [jnp.arange(ncol, dtype=jnp.int32)]
    cand_body = [arch.col_body.astype(jnp.int32)]

    if arch.num_planes:
        tp, np_ = ray_vs_plane(o, d, arch.plane_normal, arch.plane_offset)
        g = arch.plane_normal.shape[0]
        cand_t.append(tp)
        cand_n.append(np_)
        cand_kind.append(jnp.full((g,), 1, jnp.int32))
        cand_index.append(jnp.arange(g, dtype=jnp.int32))
        cand_body.append(jnp.full((g,), -1, jnp.int32))

    for ti in range(arch.num_terrains):
        tt, tn = ray_vs_heightfield(
            o, d, arch.terrain_height[ti], arch.terrain_origin[ti],
            arch.terrain_cell[ti], max_t=min(max_t, 500.0))
        cand_t.append(tt[None])
        cand_n.append(tn[None])
        cand_kind.append(jnp.full((1,), 2, jnp.int32))
        cand_index.append(jnp.full((1,), ti, jnp.int32))
        cand_body.append(jnp.full((1,), -1, jnp.int32))

    ts = jnp.concatenate(cand_t)
    ts = jnp.where(ts <= max_t, ts, _INF)
    ns = jnp.concatenate(cand_n)
    kinds = jnp.concatenate(cand_kind)
    indices = jnp.concatenate(cand_index)
    bodies = jnp.concatenate(cand_body)

    best = jnp.argmin(ts)
    t = ts[best]
    hit = t < _INF
    return RayHit(
        hit=hit,
        t=t,
        point=o + d * t,
        normal=m.noz(ns[best]),
        kind=kinds[best],
        index=indices[best],
        body=jnp.where(hit, bodies[best], -1).astype(jnp.int32),
    )


def _world_poses(arch, state):
    from .collide import collider_world_poses

    return collider_world_poses(arch, state)
