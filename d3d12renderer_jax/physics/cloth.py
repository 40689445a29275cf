"""Grid cloth: XPBD-style velocity/position/drift iterations, wind, fixed rows.

Behavior mirrors the reference cloth (reference: src/physics/cloth.cpp:180
simulate; constraint topology cloth.cpp:55-80: stretch/shear/bend;
solve formulas cloth.cpp:288-319; defaults physics.h:390-392 —
0 velocity / 1 position / 0 drift iterations; damping 1/(1+dt*d)).

Design: the particle grid is a (Y, X, 3) array and every constraint group
(6 directions) is solved as a fully-vectorized shifted-slice update.  The
reference solves constraints sequentially (Gauss-Seidel over its insertion
order); here each direction is split into two interleaved colors whose pairs
are particle-disjoint, so a color solves in parallel with exact Gauss-Seidel
semantics within our ordering.  A leading batch axis (vmap) steps many cloths.

Cloth-vs-sphere/capsule collision (BASELINE.json config 3) is a positional
projection pass — the reference has no cloth collision; this is an extension.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import maths as m

GRAVITY = -9.81


@struct.dataclass
class ClothState:
    positions: jnp.ndarray       # (..., Y, X, 3)
    prev_positions: jnp.ndarray  # (..., Y, X, 3)
    velocities: jnp.ndarray      # (..., Y, X, 3)
    forces: jnp.ndarray          # (..., Y, X, 3)


@struct.dataclass
class ClothParams:
    inv_mass: jnp.ndarray        # (Y, X)
    # Per-group rest distance and inverse-mass-sum scale (1/stiffness folded in
    # at solve time like the reference's recalculateProperties).
    stiffness: float = 0.5
    damping: float = 0.3
    gravity_factor: float = 1.0
    width: float = struct.field(pytree_node=False, default=1.0)
    height: float = struct.field(pytree_node=False, default=1.0)


# Constraint groups: (dy, dx) offsets — stretch, shear, bend
# (reference: cloth.cpp:55-80 addConstraint calls).
GROUPS = [(0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0)]


def create_cloth(
    width: float,
    height: float,
    grid_x: int,
    grid_y: int,
    total_mass: float,
    stiffness: float = 0.5,
    damping: float = 0.3,
    gravity_factor: float = 1.0,
    fix_top_row: bool = True,
) -> Tuple[ClothParams, ClothState]:
    """Cloth in the local XZ plane, top row optionally pinned
    (reference: cloth.cpp ctor; particle layout getParticlePosition:124-130)."""
    ys, xs = np.meshgrid(
        np.arange(grid_y, dtype=np.float32), np.arange(grid_x, dtype=np.float32),
        indexing="ij",
    )
    rel_x = xs / (grid_x - 1)
    rel_y = ys / (grid_y - 1)
    pos = np.stack(
        [rel_x * width - width * 0.5,
         np.zeros_like(rel_x),
         -rel_y * height],
        axis=-1,
    ).astype(np.float32)

    inv_mass = np.full((grid_y, grid_x), grid_x * grid_y / total_mass, np.float32)
    if fix_top_row:
        inv_mass[0, :] = 0.0

    params = ClothParams(
        inv_mass=jnp.asarray(inv_mass),
        stiffness=stiffness, damping=damping, gravity_factor=gravity_factor,
        width=width, height=height,
    )
    p = jnp.asarray(pos)
    z = jnp.zeros_like(p)
    state = ClothState(positions=p, prev_positions=p, velocities=z, forces=z)
    return params, state


def _group_slices(arr, dy, dx):
    """(a, b) views for constraint group (dy, dx); both (Y-|dy|, X-|dx|, 3)."""
    if dx >= 0:
        a = arr[..., : arr.shape[-3] - dy, : arr.shape[-2] - dx, :]
        b = arr[..., dy:, dx:, :]
    else:
        a = arr[..., : arr.shape[-3] - dy, -dx:, :]
        b = arr[..., dy:, : arr.shape[-2] + dx, :]
    return a, b


def _pad_back(delta, shape, dy, dx):
    """Zero-pad a (Y-|dy|, X-|dx|, 3) delta back to the full grid at the 'a'
    (start) anchor (or 'b' with pad_b)."""
    pads = [(0, 0)] * (delta.ndim - 3)
    if dx >= 0:
        pa = pads + [(0, dy), (0, dx), (0, 0)]
        pb = pads + [(dy, 0), (dx, 0), (0, 0)]
    else:
        pa = pads + [(0, dy), (-dx, 0), (0, 0)]
        pb = pads + [(dy, 0), (0, -dx), (0, 0)]
    return jnp.pad(delta, pa), jnp.pad(delta, pb)


def _color_mask(shape_yx, dy, dx):
    """Two masks splitting group (dy,dx) pairs into particle-disjoint colors."""
    y = jax.lax.broadcasted_iota(jnp.int32, shape_yx, 0)
    x = jax.lax.broadcasted_iota(jnp.int32, shape_yx, 1)
    if dy > 0:
        c = (y // dy) % 2
    else:
        c = (x // abs(dx)) % 2
    return (c == 0), (c == 1)


def _rest_distance(params: ClothParams, grid_y, grid_x, dy, dx):
    sx = params.width / (grid_x - 1)
    sy = params.height / (grid_y - 1)
    return math.sqrt((dx * sx) ** 2 + (dy * sy) ** 2)


def _solve_positions_once(positions, params: ClothParams):
    """One Gauss-Seidel sweep over all groups/colors
    (reference formula: cloth.cpp:300-319 solvePositions)."""
    gy, gx = params.inv_mass.shape
    inv_stiff = 1.0 / jnp.clip(params.stiffness, 0.01, 1.0)
    im = params.inv_mass[..., :, :, None]

    for (dy, dx) in GROUPS:
        rest = _rest_distance(params, gy, gx, dy, dx)
        rest_sq = rest * rest
        ima, imb = _group_slices(im, dy, dx)
        inv_mass_sum = (ima[..., 0] + imb[..., 0]) * inv_stiff
        masks = _color_mask((gy - abs(dy), gx - abs(dx)), dy, dx)
        for mask in masks:
            pa, pb = _group_slices(positions, dy, dx)
            delta = pb - pa
            len_sq = jnp.sum(delta * delta, axis=-1)
            denom = inv_mass_sum * (rest_sq + len_sq)
            active = (inv_mass_sum > 0) & (rest_sq + len_sq > 1e-5) & mask
            k = jnp.where(active, (rest_sq - len_sq) / jnp.where(denom == 0, 1.0, denom), 0.0)
            corr = delta * k[..., None]
            da, db = _pad_back(corr, positions.shape, dy, dx)
            positions = positions - da * im + db * im
    return positions


def _solve_velocities_once(velocities, prev_positions, params: ClothParams):
    """reference: cloth.cpp:288-298 solveVelocities (gradient from prev pos)."""
    gy, gx = params.inv_mass.shape
    inv_stiff = 1.0 / jnp.clip(params.stiffness, 0.01, 1.0)
    im = params.inv_mass[..., :, :, None]
    for (dy, dx) in GROUPS:
        ima, imb = _group_slices(im, dy, dx)
        inv_mass_sum = (ima[..., 0] + imb[..., 0]) * inv_stiff
        ga, gb = _group_slices(prev_positions, dy, dx)
        grad = gb - ga
        denom = jnp.sum(grad * grad, axis=-1) * inv_mass_sum
        inv_scaled = jnp.where(denom != 0, 1.0 / jnp.where(denom == 0, 1.0, denom), 0.0)
        masks = _color_mask((gy - abs(dy), gx - abs(dx)), dy, dx)
        for mask in masks:
            va, vb = _group_slices(velocities, dy, dx)
            j = -jnp.sum(grad * (va - vb), axis=-1) * inv_scaled
            j = jnp.where(mask, j, 0.0)
            corr = grad * j[..., None]
            da, db = _pad_back(corr, velocities.shape, dy, dx)
            velocities = velocities + da * im - db * im
    return velocities


def apply_wind(state: ClothState, force) -> ClothState:
    """Per-quad normal-projected wind force (reference: cloth.cpp:137-172)."""
    p = state.positions
    tl = p[..., :-1, :-1, :]
    tr = p[..., :-1, 1:, :]
    bl = p[..., 1:, :-1, :]
    br = p[..., 1:, 1:, :]
    force = jnp.asarray(force, p.dtype)

    def tri_force(a, b, c):
        n = jnp.cross(b - a, c - a)
        f = n * jnp.sum(m.noz(n) * force, axis=-1, keepdims=True)
        return f / 3.0

    f1 = tri_force(tl, bl, tr)   # (Y-1, X-1, 3) applied to tl, tr, bl
    f2 = tri_force(br, tr, bl)   # applied to br, tr, bl

    acc = jnp.zeros_like(p)
    pads = [(0, 0)] * (p.ndim - 3)
    acc = acc + jnp.pad(f1 + f2, pads + [(0, 1), (1, 0), (0, 0)])  # tr
    acc = acc + jnp.pad(f1 + f2, pads + [(1, 0), (0, 1), (0, 0)])  # bl
    acc = acc + jnp.pad(f1, pads + [(0, 1), (0, 1), (0, 0)])       # tl
    acc = acc + jnp.pad(f2, pads + [(1, 0), (1, 0), (0, 0)])       # br
    return state.replace(forces=state.forces + acc)


def collide_spheres(positions, centers, radii, margin=0.0):
    """Project particles out of spheres. centers (..., S, 3), radii (..., S)."""
    d = positions[..., None, :] - centers[..., None, None, :, :]
    dist = jnp.linalg.norm(d + 1e-9, axis=-1)            # (..., Y, X, S)
    pen = (radii[..., None, None, :] + margin) - dist
    push = jnp.maximum(pen, 0.0)[..., None] * (d / dist[..., None])
    return positions + jnp.sum(push, axis=-2)


def collide_capsules(positions, p0, p1, radii, margin=0.0):
    """Project particles out of capsules given segment endpoints (..., S, 3)."""
    a = p0[..., None, None, :, :]
    b = p1[..., None, None, :, :]
    p = positions[..., None, :]
    ab = b - a
    t = jnp.clip(
        jnp.sum((p - a) * ab, -1) / jnp.maximum(jnp.sum(ab * ab, -1), 1e-9),
        0.0, 1.0,
    )
    closest = a + t[..., None] * ab
    d = p - closest
    dist = jnp.linalg.norm(d + 1e-9, axis=-1)
    pen = (radii[..., None, None, :] + margin) - dist
    push = jnp.maximum(pen, 0.0)[..., None] * (d / dist[..., None])
    return positions + jnp.sum(push, axis=-2)


def simulate(
    params: ClothParams,
    state: ClothState,
    dt: float,
    velocity_iterations: int = 0,
    position_iterations: int = 1,
    drift_iterations: int = 0,
    collide_fn=None,
) -> ClothState:
    """One cloth step (reference: cloth.cpp:180-285 simulate).

    `collide_fn(positions) -> positions` runs inside the position phase
    (e.g. partial(collide_spheres, centers=..., radii=...))."""
    im = params.inv_mass[..., None]
    vel = state.velocities
    vel = vel + jnp.asarray([0.0, GRAVITY * dt * params.gravity_factor, 0.0]) * (
        (params.inv_mass > 0)[..., None]
    )
    vel = vel + state.forces * im * dt
    prev = state.positions
    pos = prev + vel * dt
    inv_dt = 1.0 / dt if dt > 1e-5 else 1.0

    for _ in range(velocity_iterations):
        vel = _solve_velocities_once(vel, prev, params)
    if velocity_iterations > 0:
        pos = prev + vel * dt

    for _ in range(position_iterations):
        pos = _solve_positions_once(pos, params)
        if collide_fn is not None:
            pos = collide_fn(pos)
    if position_iterations > 0:
        vel = (pos - prev) * inv_dt

    if drift_iterations > 0:
        drift_prev = pos
        for _ in range(drift_iterations):
            pos = _solve_positions_once(pos, params)
            if collide_fn is not None:
                pos = collide_fn(pos)
        vel = vel + (pos - drift_prev) * inv_dt

    vel = vel / (1.0 + dt * params.damping)
    return ClothState(
        positions=pos, prev_positions=prev, velocities=vel,
        forces=jnp.zeros_like(state.forces),
    )


def cloth_triangle_indices(grid_y: int, grid_x: int) -> np.ndarray:
    """(T, 3) triangle index list for rendering (reference: cloth.cpp
    cloth_render_component::getRenderData)."""
    tris = []
    for y in range(grid_y - 1):
        for x in range(grid_x - 1):
            tl = y * grid_x + x
            tr = tl + 1
            bl = tl + grid_x
            br = bl + 1
            tris.append([tl, bl, br])
            tris.append([tl, br, tr])
    return np.array(tris, np.int32)
