"""Vectorized narrow-phase collision: candidate pair tables -> 4-point contact manifolds.

The reference dispatches a 6x6 collider-type matrix per overlapping pair
(reference: src/physics/collision_narrow.cpp:374-1558).  Here every (typeA,typeB)
bucket is a fixed-shape batched kernel over its static candidate-pair table; a
boolean mask plays the role of the reference's dynamic broadphase output.  Contact
conventions match the reference: the manifold normal points from shape A toward
shape B, penetration depth is >= 0 when touching, and contact points sit midway
between the two surfaces (reference: src/physics/collision_narrow.cpp:394-396).

Friction/restitution combine as sqrt(fA*fB) and max(rA,rB)
(reference: src/physics/collision_narrow.cpp:2234-2235).
"""

from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core import maths as m
from .types import MAX_CONTACT_POINTS


@struct.dataclass
class ContactTable:
    """Flattened, solver-ready contact manifolds (one row per candidate pair)."""

    body_a: jnp.ndarray      # (P,) int32
    body_b: jnp.ndarray      # (P,) int32
    normal: jnp.ndarray      # (P, 3) from A toward B
    point: jnp.ndarray       # (P, 4, 3)
    depth: jnp.ndarray       # (P, 4)  >= 0 where pmask
    pmask: jnp.ndarray       # (P, 4) bool, per-point active
    friction: jnp.ndarray    # (P,)
    restitution: jnp.ndarray # (P,)
    active: jnp.ndarray      # (P,) bool = valid & any(pmask)


def combine_materials(fa, fb, ra, rb):
    friction = jnp.clip(jnp.sqrt(fa * fb), 0.0, 1.0)
    restitution = jnp.clip(jnp.maximum(ra, rb), 0.0, 1.0)
    return friction, restitution


def _pad_points(points, depths, masks):
    """Stack per-point candidate lists (lists of (P,3)/(P,)) into (P,4,*) arrays,
    keeping the 4 deepest active candidates when more are supplied."""
    pts = jnp.stack(points, axis=-2)           # (P, K, 3)
    dep = jnp.stack(depths, axis=-1)           # (P, K)
    msk = jnp.stack(masks, axis=-1)            # (P, K)
    k = pts.shape[-2]
    if k < MAX_CONTACT_POINTS:
        pad = MAX_CONTACT_POINTS - k
        pts = jnp.concatenate([pts, jnp.zeros(pts.shape[:-2] + (pad, 3), pts.dtype)], axis=-2)
        dep = jnp.concatenate([dep, jnp.zeros(dep.shape[:-1] + (pad,), dep.dtype)], axis=-1)
        msk = jnp.concatenate([msk, jnp.zeros(msk.shape[:-1] + (pad,), bool)], axis=-1)
    elif k > MAX_CONTACT_POINTS:
        score = jnp.where(msk, dep, -jnp.inf)
        _, idx = jax_top_k(score, MAX_CONTACT_POINTS)
        pts = jnp.take_along_axis(pts, idx[..., None], axis=-2)
        dep = jnp.take_along_axis(dep, idx, axis=-1)
        msk = jnp.take_along_axis(msk, idx, axis=-1)
    return pts, dep, msk


def jax_top_k(x, k):
    """Top-k by iterated masked argmax (k is 4 here): k reductions in place
    of lax.top_k."""
    import jax

    kk = x.shape[-1]
    if k >= kk:
        return jax.lax.top_k(x, k)
    s = x
    vals, idxs = [], []
    lane = jnp.arange(kk)
    for _ in range(k):
        i = jnp.argmax(s, -1)
        vals.append(jnp.take_along_axis(s, i[..., None], -1)[..., 0])
        idxs.append(i)
        s = jnp.where(lane == i[..., None], -jnp.inf, s)
    return jnp.stack(vals, -1), jnp.stack(idxs, -1)


# ---------------------------------------------------------------------------
# vs static plane (the static world).  A = plane, B = collider.
# Normal = plane normal (A -> B).
# ---------------------------------------------------------------------------

def sphere_vs_plane(center, radius, n, offset):
    """center (P,3), radius (P,), plane n (P,3) unit, offset (P,). 1 point."""
    dist = m.dot(n, center) - offset
    depth = radius - dist
    hit = depth >= 0.0
    point = center - n * (dist + 0.5 * depth)[..., None]  # midway between surfaces
    return point[..., None, :], depth[..., None], hit[..., None]


def points_vs_plane(pts, n, offset):
    """Generic point-cloud-vs-plane: pts (P,K,3). Returns K candidates."""
    dist = jnp.einsum("...kj,...j->...k", pts, n) - offset[..., None]
    depth = -dist
    hit = depth >= 0.0
    point = pts + n[..., None, :] * (0.5 * depth)[..., :, None]
    return point, depth, hit


def hull_vs_plane(world_verts, vert_mask, n, offset):
    """Convex hull vs plane: up to 4 deepest vertices form the manifold.

    world_verts (P,V,3), vert_mask (P,V), n (P,3), offset (P,)."""
    d = jnp.einsum("...vj,...j->...v", world_verts, n) - offset[..., None]
    d = jnp.where(vert_mask, d, jnp.inf)
    depth_all = -d
    top, idx = jax_top_k(depth_all, 4)
    pts = jnp.take_along_axis(world_verts, idx[..., None], axis=-2)
    pts = pts + n[..., None, :] * (0.5 * jnp.maximum(top, 0.0))[..., None]
    msk = top >= 0.0
    return pts, top, msk


def capsule_vs_plane(p0, p1, radius, n, offset):
    """Two endpoint spheres -> up to 2 contact points."""
    pt0, d0, h0 = sphere_vs_plane(p0, radius, n, offset)
    pt1, d1, h1 = sphere_vs_plane(p1, radius, n, offset)
    return (
        jnp.concatenate([pt0, pt1], axis=-2),
        jnp.concatenate([d0, d1], axis=-1),
        jnp.concatenate([h0, h1], axis=-1),
    )


_BOX_CORNERS = jnp.array(
    [
        [-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
    ],
    dtype=jnp.float32,
)


def box_corners(center, rot, half):
    """(P,3),(P,4),(P,3) -> (P,8,3) world-space corners."""
    local = _BOX_CORNERS * half[..., None, :]
    return center[..., None, :] + m.quat_rotate(rot[..., None, :], local)


def box_vs_plane(center, rot, half, n, offset):
    corners = box_corners(center, rot, half)            # (P,8,3)
    point, depth, hit = points_vs_plane(corners, n, offset)
    return _pad_points(
        [point[..., k, :] for k in range(8)],
        [depth[..., k] for k in range(8)],
        [hit[..., k] for k in range(8)],
    )


def cylinder_vs_plane(center, rot, radius, half_len, n, offset):
    """Rim extreme points of both caps (up to 4 candidates)."""
    axis = m.quat_rotate(rot, jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), center.shape))
    cap0 = center - axis * half_len[..., None]
    cap1 = center + axis * half_len[..., None]
    # Rim direction: component of -n perpendicular to axis.
    d = m.noz(-(n - axis * m.dot(n, axis)[..., None]))
    cands = [cap0 + d * radius[..., None], cap1 + d * radius[..., None],
             cap0 - d * radius[..., None], cap1 - d * radius[..., None]]
    point, depth, hit = points_vs_plane(jnp.stack(cands, axis=-2), n, offset)
    return _pad_points(
        [point[..., k, :] for k in range(4)],
        [depth[..., k] for k in range(4)],
        [hit[..., k] for k in range(4)],
    )


# ---------------------------------------------------------------------------
# dynamic pair kernels
# ---------------------------------------------------------------------------

def sphere_vs_sphere(ca, ra, cb, rb):
    """Reference: src/physics/collision_narrow.cpp:374-400."""
    n = cb - ca
    rsum = ra + rb
    sq = m.squared_length(n)
    hit = sq <= rsum * rsum
    dist = jnp.sqrt(jnp.maximum(sq, 1e-16))
    normal = jnp.where(
        (sq < 1e-12)[..., None],
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), n.shape),
        n / dist[..., None],
    )
    depth = rsum - dist
    point = 0.5 * (ca + normal * ra[..., None] + cb - normal * rb[..., None])
    return normal, point[..., None, :], depth[..., None], hit[..., None]


def closest_point_segment(p, a, b):
    ab = b - a
    t = jnp.clip(m.dot(p - a, ab) / jnp.maximum(m.squared_length(ab), 1e-12), 0.0, 1.0)
    return a + ab * t[..., None]


def closest_points_segment_segment(p1, q1, p2, q2):
    """Vectorized closest points between segments [p1,q1] and [p2,q2]."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = m.squared_length(d1)
    e = m.squared_length(d2)
    f = m.dot(d2, r)
    c = m.dot(d1, r)
    b = m.dot(d1, d2)
    denom = a * e - b * b
    s = jnp.where(denom > 1e-12, jnp.clip((b * f - c * e) / jnp.maximum(denom, 1e-12), 0.0, 1.0), 0.0)
    t = (b * s + f) / jnp.maximum(e, 1e-12)
    t_cl = jnp.clip(t, 0.0, 1.0)
    # recompute s for clamped t
    s = jnp.where(
        (t != t_cl), jnp.clip((t_cl * b - c) / jnp.maximum(a, 1e-12), 0.0, 1.0), s
    )
    c1 = p1 + d1 * s[..., None]
    c2 = p2 + d2 * t_cl[..., None]
    return c1, c2


def sphere_vs_capsule(c, r, p0, p1, rc):
    cp = closest_point_segment(c, p0, p1)
    return sphere_vs_sphere(c, r, cp, rc)


def capsule_vs_capsule(a0, a1, ra, b0, b1, rb):
    ca, cb = closest_points_segment_segment(a0, a1, b0, b1)
    return sphere_vs_sphere(ca, ra, cb, rb)


def _closest_point_on_box(local_p, half):
    """Closest point on (possibly containing) box to local point; returns
    (closest_local, normal_local pointing from box surface toward p, depth)."""
    clamped = jnp.clip(local_p, -half, half)
    delta = local_p - clamped
    outside_sq = m.squared_length(delta)
    outside = outside_sq > 1e-12

    # Inside case: push out along axis of least penetration.
    dist_to_face = half - jnp.abs(local_p)                 # (P,3) >= 0 when inside
    axis = jnp.argmin(dist_to_face, axis=-1)
    sign = jnp.sign(jnp.take_along_axis(local_p, axis[..., None], axis=-1))[..., 0]
    sign = jnp.where(sign == 0.0, 1.0, sign)
    inside_normal = jnp.eye(3, dtype=local_p.dtype)[axis] * sign[..., None]
    inside_closest = local_p + inside_normal * jnp.take_along_axis(
        dist_to_face, axis[..., None], axis=-1
    )
    out_dist = jnp.sqrt(jnp.maximum(outside_sq, 1e-16))
    outside_normal = delta / out_dist[..., None]

    closest = jnp.where(outside[..., None], clamped, inside_closest)
    normal = jnp.where(outside[..., None], outside_normal, inside_normal)
    # signed distance of p from box surface: positive outside
    sdist = jnp.where(
        outside, out_dist, -jnp.take_along_axis(dist_to_face, axis[..., None], axis=-1)[..., 0]
    )
    return closest, normal, sdist


def sphere_vs_box(c, r, box_center, box_rot, half):
    """Sphere A vs box B. Returns manifold with normal A->B."""
    local_c = m.quat_inv_rotate(box_rot, c - box_center)
    closest_l, normal_l, sdist = _closest_point_on_box(local_c, half)
    depth = r - sdist
    hit = depth >= 0.0
    closest_w = box_center + m.quat_rotate(box_rot, closest_l)
    n_box_to_sphere = m.quat_rotate(box_rot, normal_l)
    normal = -n_box_to_sphere  # A(sphere) -> B(box)
    # midway between sphere surface point and box surface point
    sphere_surf = c - n_box_to_sphere * r[..., None]
    point = 0.5 * (closest_w + sphere_surf)
    return normal, point[..., None, :], depth[..., None], hit[..., None]


def _closest_t_segment_box(a0, a1, half, iters=24):
    """Exact param t* of the segment point closest to the origin-centered box.

    a0/a1 (P,3) in box-local coordinates.  dist(seg(t), box) is convex in t
    (distance-to-convex-set composed with an affine map), so its derivative
    g(t) = (p(t) - clamp(p(t))) . d is monotone — bisect it in a fixed loop
    (vectorizes over the pair axis; the reference's scalar equivalent is the
    capsule branch of src/physics/collision_narrow.cpp)."""
    d = a1 - a0

    def g(t):
        p = a0 + d * t[..., None]
        delta = p - jnp.clip(p, -half, half)
        return m.dot(delta, d)

    lo = jnp.zeros(a0.shape[:-1], a0.dtype)
    hi = jnp.ones(a0.shape[:-1], a0.dtype)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        gm = g(mid)
        lo = jnp.where(gm < 0.0, mid, lo)
        hi = jnp.where(gm < 0.0, hi, mid)
    t = 0.5 * (lo + hi)
    # Endpoint minima: g(0) >= 0 -> t*=0; g(1) <= 0 -> t*=1.
    t = jnp.where(g(jnp.zeros_like(t)) >= 0.0, 0.0, t)
    return jnp.where(g(jnp.ones_like(t)) <= 0.0, 1.0, t)


def capsule_vs_box(p0, p1, r, box_center, box_rot, half):
    """Exact capsule-vs-box manifold (replaces the round-4 3-probe-sphere
    approximation; reference: the dedicated clipped capsule manifolds of
    src/physics/collision_narrow.cpp:374-1558).

    Hit/no-hit and the deepest contact are EXACT: the closest segment point
    to the box is found by bisecting the convex distance derivative, and
    probed with the exact sphere-box test.  Manifold construction:

      * probes at both endpoints and at t* (agreeing-normal probes only),
      * when the contact normal aligns with a box face, the segment is
        additionally CLIPPED against that face's rectangle (Liang-Barsky)
        and the two clipped endpoints join the candidate set with their
        linear depths — the 2-point line manifold that makes a capsule
        resting on a face (or lying along an edge) stack stably instead of
        jittering on probe points.

    Normal convention: A(capsule) -> B(box).
    """
    a0 = m.quat_inv_rotate(box_rot, p0 - box_center)   # box-local
    a1 = m.quat_inv_rotate(box_rot, p1 - box_center)
    t_star = _closest_t_segment_box(a0, a1, half)
    p_star = p0 + (p1 - p0) * t_star[..., None]

    # Exact single-point probes (world space).
    normals, points, depths, hits = [], [], [], []
    for probe in (p0, p1, p_star):
        n, pt, d, h = sphere_vs_box(probe, r, box_center, box_rot, half)
        normals.append(n)
        points.append(pt[..., 0, :])
        depths.append(d[..., 0])
        hits.append(h[..., 0])
    dep3 = jnp.stack(depths, axis=-1)                  # (P,3)
    msk3 = jnp.stack(hits, axis=-1)
    best = jnp.argmax(jnp.where(msk3, dep3, -jnp.inf), axis=-1)
    normal = jnp.take_along_axis(
        jnp.stack(normals, axis=-2), best[..., None, None], axis=-2
    )[..., 0, :]
    # Drop probes whose own normal disagrees with the manifold normal
    # (corner probes of a face-resting capsule would otherwise add
    # sideways-pushing points).
    agree = jnp.einsum(
        "...kj,...j->...k", jnp.stack(normals, axis=-2), normal) > 0.94
    msk3 = msk3 & agree

    # Face-clip candidates: normal in box-local, pick the dominant axis.
    n_local = m.quat_inv_rotate(box_rot, -normal)      # box -> capsule dir
    k = jnp.argmax(jnp.abs(n_local), axis=-1)          # (P,)
    s = jnp.sign(jnp.take_along_axis(n_local, k[..., None], axis=-1))[..., 0]
    s = jnp.where(s == 0.0, 1.0, s)
    axis_k = jnp.take_along_axis(n_local, k[..., None], axis=-1)[..., 0]
    is_face = jnp.abs(axis_k) > 0.94                   # ~20 deg tolerance

    u_axis = (k + 1) % 3
    v_axis = (k + 2) % 3

    def comp(vec, idx):
        return jnp.take_along_axis(vec, idx[..., None], axis=-1)[..., 0]

    h_k = comp(half, k)
    h_u = comp(half, u_axis)
    h_v = comp(half, v_axis)
    u0, u1 = comp(a0, u_axis), comp(a1, u_axis)
    v0, v1 = comp(a0, v_axis), comp(a1, v_axis)
    z0, z1 = comp(a0, k) * s, comp(a1, k) * s

    # Liang-Barsky clip of the (u, v) segment against the face footprint
    # |u|<=h_u, |v|<=h_v.  Beyond the footprint the closest box feature is
    # an edge whose contact normal differs from the face normal, so those
    # points stay with the exact probes instead of the face manifold.
    t_lo = jnp.zeros_like(u0)
    t_hi = jnp.ones_like(u0)
    for c0, c1, lim in ((u0, u1, h_u), (v0, v1, h_v)):
        dcomp = c1 - c0
        dsafe = jnp.where(jnp.abs(dcomp) < 1e-12, 1e-12, dcomp)
        ta = (-lim - c0) / dsafe
        tb = (lim - c0) / dsafe
        enter = jnp.minimum(ta, tb)
        exit_ = jnp.maximum(ta, tb)
        par_in = jnp.abs(dcomp) < 1e-12
        inside0 = jnp.abs(c0) <= lim
        t_lo = jnp.where(par_in, jnp.where(inside0, t_lo, 1.0),
                         jnp.maximum(t_lo, enter))
        t_hi = jnp.where(par_in, jnp.where(inside0, t_hi, 0.0),
                         jnp.minimum(t_hi, exit_))
    clip_ok = t_hi >= t_lo

    def face_point(t):
        """Clipped candidate at param t: world point + linear depth."""
        z = z0 + (z1 - z0) * t
        depth = r - (z - h_k)                          # sdist = s*z - h_k
        seg_w = p0 + (p1 - p0) * t[..., None]
        # Midway between capsule surface and face plane along the normal.
        pt = seg_w + normal * (0.5 * (z - h_k + r))[..., None] * jnp.where(
            is_face, 1.0, 0.0)[..., None]
        return pt, depth

    fp0, fd0 = face_point(t_lo)
    fp1, fd1 = face_point(t_hi)
    fmask0 = is_face & clip_ok & (fd0 >= 0.0)
    fmask1 = is_face & clip_ok & (fd1 >= 0.0) & (t_hi > t_lo + 1e-6)

    any_hit = jnp.any(msk3, axis=-1)
    pts, dep, msk = _pad_points(
        points + [fp0, fp1],
        depths + [fd0, fd1],
        [h & any_hit for h in
         (msk3[..., 0], msk3[..., 1], msk3[..., 2])] + [
            fmask0 & any_hit, fmask1 & any_hit],
    )
    return normal, pts, dep, msk


def _clip_quad_rect(quad, lim_u, lim_v):
    """Order-free convex clip of a cyclic quad against the rect |u|<=lim_u, |v|<=lim_v.

    Returns all 24 candidate vertices of the clipped polygon with validity masks:
      * the 4 quad vertices that lie inside the rect,
      * the 4 rect corners that lie inside the quad,
      * up to 16 quad-edge x rect-edge intersection points.
    The true clipped polygon's vertices are a subset of these candidates, which is
    all the manifold builder needs (it keeps the 4 deepest).  quad: (P,4,2) in
    cyclic order; lim_u/lim_v: (P,).
    """
    # (a) quad verts inside rect
    in_rect = (jnp.abs(quad[..., 0]) <= lim_u[..., None] + 1e-6) & (
        jnp.abs(quad[..., 1]) <= lim_v[..., None] + 1e-6
    )

    # (b) rect corners inside quad (convex, cyclic order; sign-consistent cross test)
    corner_signs = jnp.array(
        [[1.0, 1.0], [1.0, -1.0], [-1.0, -1.0], [-1.0, 1.0]], dtype=quad.dtype
    )
    corners = jnp.stack(
        [corner_signs[:, 0] * lim_u[..., None], corner_signs[:, 1] * lim_v[..., None]],
        axis=-1,
    )                                                           # (P,4,2)
    nxt = jnp.roll(jnp.arange(4), -1)
    e = quad[..., nxt, :] - quad                                # (P,4,2) edges
    # cross_{c,k} = e_k × (corner_c - quad_k)
    d = corners[..., :, None, :] - quad[..., None, :, :]        # (P,4c,4k,2)
    cross = e[..., None, :, 0] * d[..., 1] - e[..., None, :, 1] * d[..., 0]
    in_quad = jnp.all(cross >= -1e-9, axis=-1) | jnp.all(cross <= 1e-9, axis=-1)

    # (c) quad edges x rect edges
    inters = []
    imasks = []
    for axis, lim, other_lim in ((0, lim_u, lim_v), (1, lim_v, lim_u)):
        for sign in (1.0, -1.0):
            u0 = quad[..., axis]
            u1 = quad[..., nxt, axis]
            target = sign * lim[..., None]
            denom = u1 - u0
            t = (target - u0) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
            valid = (t >= 0.0) & (t <= 1.0) & (jnp.abs(denom) >= 1e-12)
            pt = quad + (quad[..., nxt, :] - quad) * t[..., None]
            other = pt[..., 1 - axis]
            valid = valid & (jnp.abs(other) <= other_lim[..., None] + 1e-6)
            inters.append(pt)
            imasks.append(valid)

    all_pts = jnp.concatenate([quad, corners] + inters, axis=-2)    # (P,24,2)
    all_msk = jnp.concatenate([in_rect, in_quad] + imasks, axis=-1)
    return all_pts, all_msk


def box_vs_box(ca, ra, ha, cb, rb, hb):
    """SAT box-box with face clipping (reference: src/physics/collision_sat.h and
    the box-box branch of src/physics/collision_narrow.cpp).

    15 separating-axis tests (6 faces + 9 edge pairs); the minimum-penetration
    axis selects either a face manifold (incident face clipped against the
    reference face, up to 4 deepest points) or an edge-edge contact point.
    Face axes are preferred over edge axes within a 5% tolerance to stabilize
    stacking.  All branches are computed and selected with `where` so the
    function vectorizes over the pair axis.  Normal convention: A -> B.
    """
    Ra = m.quat_to_mat3(ra)          # (P,3,3): columns are A's axes in world
    Rb = m.quat_to_mat3(rb)
    t = cb - ca                      # (P,3)

    axes_a = [Ra[..., :, i] for i in range(3)]
    axes_b = [Rb[..., :, i] for i in range(3)]

    def face_pen(L, which):
        proj_a = sum(ha[..., i, None] * jnp.abs(m.dot(axes_a[i], L))[..., None] for i in range(3))[..., 0]
        proj_b = sum(hb[..., i, None] * jnp.abs(m.dot(axes_b[i], L))[..., None] for i in range(3))[..., 0]
        return proj_a + proj_b - jnp.abs(m.dot(t, L))

    pens = []
    axes_list = []
    for i in range(3):
        pens.append(face_pen(axes_a[i], "a"))
        axes_list.append(axes_a[i])
    for i in range(3):
        pens.append(face_pen(axes_b[i], "b"))
        axes_list.append(axes_b[i])

    edge_pens = []
    edge_axes = []
    for i in range(3):
        for j in range(3):
            L = jnp.cross(axes_a[i], axes_b[j])
            ll = m.length(L)
            ok = ll > 1e-6
            Ln = L / jnp.maximum(ll, 1e-6)[..., None]
            pen = face_pen(Ln, "e")
            edge_pens.append(jnp.where(ok, pen, jnp.inf))
            edge_axes.append(Ln)

    face_pen_all = jnp.stack(pens, axis=-1)              # (P,6)
    edge_pen_all = jnp.stack(edge_pens, axis=-1)         # (P,9)
    overlap = jnp.all(face_pen_all >= 0.0, axis=-1) & jnp.all(
        jnp.where(jnp.isinf(edge_pen_all), 0.0, edge_pen_all) >= 0.0, axis=-1
    )

    best_face = jnp.argmin(face_pen_all, axis=-1)        # (P,)
    best_face_pen = jnp.min(face_pen_all, axis=-1)
    best_edge = jnp.argmin(edge_pen_all, axis=-1)
    best_edge_pen = jnp.min(edge_pen_all, axis=-1)
    # Face preference (standard SAT bias; stabilizes resting stacks).
    use_edge = best_edge_pen < 0.95 * best_face_pen - 1e-4

    face_axes = jnp.stack(axes_list, axis=-2)            # (P,6,3)
    n_face = jnp.take_along_axis(face_axes, best_face[..., None, None], axis=-2)[..., 0, :]
    edge_axes_arr = jnp.stack(edge_axes, axis=-2)        # (P,9,3)
    n_edge = jnp.take_along_axis(edge_axes_arr, best_edge[..., None, None], axis=-2)[..., 0, :]

    # Orient A -> B.
    def orient(n):
        s = jnp.where(m.dot(n, t) >= 0.0, 1.0, -1.0)
        return n * s[..., None]

    n_face = orient(n_face)
    n_edge = orient(n_edge)
    ref_is_a = best_face < 3                             # reference face on box A

    # ---- face manifold: clip incident face against reference face ------
    # Work in the reference box local frame.
    ref_c = jnp.where(ref_is_a[..., None], ca, cb)
    ref_R = jnp.where(ref_is_a[..., None, None], Ra, Rb)
    ref_h = jnp.where(ref_is_a[..., None], ha, hb)
    inc_c = jnp.where(ref_is_a[..., None], cb, ca)
    inc_R = jnp.where(ref_is_a[..., None, None], Rb, Ra)
    inc_h = jnp.where(ref_is_a[..., None], hb, ha)
    # Normal pointing from reference box toward incident box:
    n_ref_out = jnp.where(ref_is_a[..., None], n_face, -n_face)

    # reference local coordinates
    n_local = jnp.einsum("...ij,...i->...j", ref_R, n_ref_out)   # R^T n
    ref_axis = jnp.argmax(jnp.abs(n_local), axis=-1)             # (P,)
    ref_sign = jnp.sign(
        jnp.take_along_axis(n_local, ref_axis[..., None], axis=-1)
    )[..., 0]
    ref_sign = jnp.where(ref_sign == 0.0, 1.0, ref_sign)
    u_axis = (ref_axis + 1) % 3
    v_axis = (ref_axis + 2) % 3

    # incident box in reference local frame
    inc_c_l = jnp.einsum("...ij,...i->...j", ref_R, inc_c - ref_c)
    inc_R_l = jnp.einsum("...ij,...ik->...jk", ref_R, inc_R)     # R_ref^T R_inc

    # incident face: the face of the incident box whose outward normal most
    # opposes n_ref_out (in ref local coords = -n_local direction)
    dots = jnp.einsum("...jk,...j->...k", inc_R_l, n_local)      # (P,3): axis_k · n
    inc_axis = jnp.argmax(jnp.abs(dots), axis=-1)
    inc_sign = -jnp.sign(
        jnp.take_along_axis(dots, inc_axis[..., None], axis=-1)
    )[..., 0]
    inc_sign = jnp.where(inc_sign == 0.0, 1.0, inc_sign)

    def col(Rl, idx):  # (P,3,3),(P,) -> (P,3) column idx
        return jnp.take_along_axis(Rl, idx[..., None, None], axis=-1)[..., 0]

    inc_n_l = col(inc_R_l, inc_axis) * inc_sign[..., None]
    inc_u_axis = (inc_axis + 1) % 3
    inc_v_axis = (inc_axis + 2) % 3
    inc_u = col(inc_R_l, inc_u_axis)
    inc_v = col(inc_R_l, inc_v_axis)
    h_n = jnp.take_along_axis(inc_h, inc_axis[..., None], axis=-1)[..., 0]
    h_u = jnp.take_along_axis(inc_h, inc_u_axis[..., None], axis=-1)[..., 0]
    h_v = jnp.take_along_axis(inc_h, inc_v_axis[..., None], axis=-1)[..., 0]

    face_center = inc_c_l + inc_n_l * h_n[..., None]
    signs2 = jnp.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=ca.dtype)
    inc_verts = (
        face_center[..., None, :]
        + signs2[..., 0, None] * inc_u[..., None, :] * h_u[..., None, None]
        + signs2[..., 1, None] * inc_v[..., None, :] * h_v[..., None, None]
    )                                                            # (P,4,3)

    # 2D coords in (u_axis, v_axis) plane of reference box + height along ref_axis
    vu = jnp.take_along_axis(inc_verts, u_axis[..., None, None], axis=-1)[..., 0]
    vv = jnp.take_along_axis(inc_verts, v_axis[..., None, None], axis=-1)[..., 0]
    quad = jnp.stack([vu, vv], axis=-1)                          # (P,4,2)
    lim_u = jnp.take_along_axis(ref_h, u_axis[..., None], axis=-1)[..., 0]
    lim_v = jnp.take_along_axis(ref_h, v_axis[..., None], axis=-1)[..., 0]
    verts2, vmask = _clip_quad_rect(quad, lim_u, lim_v)          # (P,24,2)

    # Recover height of clipped points on the incident face plane:
    # the incident face is a plane in ref-local space: point = face_center +
    # a*inc_u + b*inc_v.  Solve 2x2 system for (a,b) from (u,v) coords.
    iu_u = jnp.take_along_axis(inc_u, u_axis[..., None], axis=-1)[..., 0]
    iu_v = jnp.take_along_axis(inc_u, v_axis[..., None], axis=-1)[..., 0]
    iv_u = jnp.take_along_axis(inc_v, u_axis[..., None], axis=-1)[..., 0]
    iv_v = jnp.take_along_axis(inc_v, v_axis[..., None], axis=-1)[..., 0]
    fc_u = jnp.take_along_axis(face_center, u_axis[..., None], axis=-1)[..., 0]
    fc_v = jnp.take_along_axis(face_center, v_axis[..., None], axis=-1)[..., 0]
    det = iu_u * iv_v - iu_v * iv_u
    det = jnp.where(jnp.abs(det) < 1e-9, jnp.where(det < 0, -1e-9, 1e-9), det)
    du = verts2[..., 0] - fc_u[..., None]
    dv = verts2[..., 1] - fc_v[..., None]
    a = (du * iv_v[..., None] - dv * iv_u[..., None]) / det[..., None]
    bcoef = (-du * iu_v[..., None] + dv * iu_u[..., None]) / det[..., None]
    iu_n = jnp.take_along_axis(inc_u, ref_axis[..., None], axis=-1)[..., 0]
    iv_n = jnp.take_along_axis(inc_v, ref_axis[..., None], axis=-1)[..., 0]
    fc_n = jnp.take_along_axis(face_center, ref_axis[..., None], axis=-1)[..., 0]
    height = fc_n[..., None] + a * iu_n[..., None] + bcoef * iv_n[..., None]

    lim_n = jnp.take_along_axis(ref_h, ref_axis[..., None], axis=-1)[..., 0]
    # depth of each clipped point below the reference face
    depth_face = (lim_n[..., None] - height * ref_sign[..., None])
    pmask_face = vmask & (depth_face >= 0.0)

    # keep 4 deepest
    score = jnp.where(pmask_face, depth_face, -jnp.inf)
    _, top_idx = jax_top_k(score, MAX_CONTACT_POINTS)
    depth4 = jnp.take_along_axis(depth_face, top_idx, axis=-1)
    mask4 = jnp.take_along_axis(pmask_face, top_idx, axis=-1)
    u4 = jnp.take_along_axis(verts2[..., 0], top_idx, axis=-1)
    v4 = jnp.take_along_axis(verts2[..., 1], top_idx, axis=-1)
    h4 = jnp.take_along_axis(height, top_idx, axis=-1)
    # midway-between-surfaces convention: shift half the depth toward the face
    h4_mid = h4 + 0.5 * depth4 * ref_sign[..., None]

    # assemble ref-local 3D points then to world
    pts_local = jnp.zeros(u4.shape + (3,), ca.dtype)
    pts_local = _scatter_axis(pts_local, u_axis, u4)
    pts_local = _scatter_axis(pts_local, v_axis, v4)
    pts_local = _scatter_axis(pts_local, ref_axis, h4_mid)
    pts_face = ref_c[..., None, :] + jnp.einsum("...ij,...kj->...ki", ref_R, pts_local)

    # ---- edge-edge contact ---------------------------------------------
    # Supporting edges: on A, the edge along axis i* most anti-parallel to n.
    def support_edge(axes, hvec, center, n_dir, edge_axis_idx):
        # endpoints of the edge on the box along edge_axis_idx, located at the
        # support corner in the other two axes w.r.t. n_dir
        e_dir = jnp.take_along_axis(
            jnp.stack(axes, axis=-2), edge_axis_idx[..., None, None], axis=-2
        )[..., 0, :]
        corner = center
        for i in range(3):
            ai = axes[i]
            hi = hvec[..., i]
            s = jnp.where(m.dot(ai, n_dir) >= 0.0, 1.0, -1.0)
            contrib = ai * (s * hi)[..., None]
            skip = edge_axis_idx == i
            corner = corner + jnp.where(skip[..., None], 0.0, contrib)
        he = jnp.take_along_axis(hvec, edge_axis_idx[..., None], axis=-1)[..., 0]
        return corner - e_dir * he[..., None], corner + e_dir * he[..., None]

    edge_i = best_edge // 3
    edge_j = best_edge % 3
    a0, a1 = support_edge(axes_a, ha, ca, n_edge, edge_i)
    b0, b1 = support_edge(axes_b, hb, cb, -n_edge, edge_j)
    pa_e, pb_e = closest_points_segment_segment(a0, a1, b0, b1)
    pt_edge = 0.5 * (pa_e + pb_e)

    # ---- select --------------------------------------------------------
    normal = jnp.where(use_edge[..., None], n_edge, n_face)
    pen = jnp.where(use_edge, best_edge_pen, best_face_pen)
    pts = jnp.where(use_edge[..., None, None], pt_edge[..., None, :], pts_face)
    dep = jnp.where(
        use_edge[..., None],
        jnp.concatenate(
            [pen[..., None], jnp.zeros(pen.shape + (3,), pen.dtype)], axis=-1
        ),
        depth4,
    )
    first_only = jnp.concatenate(
        [jnp.ones(pen.shape + (1,), bool), jnp.zeros(pen.shape + (3,), bool)], axis=-1
    )
    msk = jnp.where(use_edge[..., None], first_only, mask4)
    msk = msk & overlap[..., None] & (dep >= 0.0)
    return normal, pts, dep, msk


def _scatter_axis(arr, axis_idx, values):
    """arr (...,K,3), axis_idx (...,), values (...,K): write values into
    component axis_idx of each 3-vector."""
    onehot = jnp.eye(3, dtype=arr.dtype)[axis_idx]        # (...,3)
    return arr + onehot[..., None, :] * values[..., None]
