"""Procedural placement on terrain: jittered-grid point generation with
density masking and prefix-sum compaction.

Reference: src/terrain/proc_placement.h:13 + shaders/proc_placement/
generate_points_cs.hlsl (Poisson-ish points on terrain, slope/height masks,
prefix-sum compaction into per-mesh draw lists).  Here: one jitted
function; "compaction" keeps fixed shapes and returns a validity mask plus a
stable partition order (masked sort), since dynamic shapes can't jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .heightmap import sample_height_bilinear


@partial(jax.jit, static_argnames=("points_per_side",))
def generate_placement_points(
    heights,                 # (R, R)
    origin,                  # (3,)
    cell_size: float,
    world_size: float,
    key,
    points_per_side: int = 64,
    min_height: float = -1e9,
    max_height: float = 1e9,
    max_slope_y: float = 0.7,     # min surface normal y (steepness cutoff)
    density: float = 1.0,
):
    """Returns dict of (N,) arrays: position (N,3), normal (N,3), rotation
    angle (N,), scale (N,), valid (N,), order (N,) — `order` lists valid
    indices first (the fixed-shape analogue of prefix-sum compaction)."""
    n = points_per_side
    key_j, key_r, key_s, key_d = jax.random.split(key, 4)
    cell = world_size / n
    ij = jnp.stack(jnp.meshgrid(jnp.arange(n), jnp.arange(n), indexing="ij"),
                   -1).reshape(-1, 2).astype(jnp.float32)
    jitter = jax.random.uniform(key_j, (n * n, 2))
    xz = (ij + jitter) * cell
    x = origin[0] + xz[:, 0]
    z = origin[2] + xz[:, 1]

    h, normal = sample_height_bilinear(heights, origin, cell_size, x, z)
    pos = jnp.stack([x, h, z], -1)

    keep = (
        (h >= min_height) & (h <= max_height)
        & (normal[:, 1] >= max_slope_y)
        & (jax.random.uniform(key_d, (n * n,)) < density)
    )
    order = jnp.argsort(~keep, stable=True)
    return {
        "position": pos,
        "normal": normal,
        "rotation": jax.random.uniform(key_r, (n * n,)) * 2 * jnp.pi,
        "scale": jax.random.uniform(key_s, (n * n,), minval=0.7, maxval=1.3),
        "valid": keep,
        "count": jnp.sum(keep),
        "order": order,
    }


def generate_placement_layers(heights, origin, cell_size, world_size, key,
                              layers, points_per_side=64):
    """Multi-layer placement: each layer owns masks, density, and a weighted
    set of meshes (reference: placement layers with up to 4 meshes each +
    density channels, src/terrain/proc_placement.h:13-36).

    `layers`: list of dicts with optional keys min_height / max_height /
    max_slope_y / density / mesh_weights (relative weights of the layer's
    mesh variants) / scale_range.  All layers share one jittered grid, and a
    point belongs to at most ONE layer (earlier layers win), so meshes never
    z-fight.  Returns a list of per-layer dicts: the generate_placement_points
    fields plus `mesh_index` (weighted variant choice per point)."""
    base_key, choice_key = jax.random.split(key)
    pts = generate_placement_points(
        heights, jnp.asarray(origin, jnp.float32), cell_size, world_size,
        base_key, points_per_side=points_per_side,
        max_slope_y=-1.0, density=1.0,
    )
    n = pts["position"].shape[0]
    h = pts["position"][:, 1]
    ny = pts["normal"][:, 1]
    claimed = jnp.zeros((n,), bool)
    out = []
    for i, layer in enumerate(layers):
        k_d, k_c, choice_key = jax.random.split(
            jax.random.fold_in(choice_key, i), 3)
        keep = (
            pts["valid"]
            & ~claimed
            & (h >= layer.get("min_height", -1e9))
            & (h <= layer.get("max_height", 1e9))
            & (ny >= layer.get("max_slope_y", 0.7))
            & (jax.random.uniform(k_d, (n,)) < layer.get("density", 1.0))
        )
        claimed = claimed | keep
        w = jnp.asarray(layer.get("mesh_weights", [1.0]), jnp.float32)
        mesh_index = jax.random.choice(
            k_c, w.shape[0], (n,), p=w / jnp.sum(w))
        lo, hi = layer.get("scale_range", (0.7, 1.3))
        scale = lo + (hi - lo) * (pts["scale"] - 0.7) / 0.6
        out.append({
            **pts,
            "valid": keep,
            "count": jnp.sum(keep),
            "order": jnp.argsort(~keep, stable=True),
            "mesh_index": mesh_index,
            "scale": scale,
        })
    return out


def instantiate_placement(layer, mesh_builders, material_ids=None,
                          max_instances=None):
    """Host-side expansion of one placement layer into transformed meshes.

    `mesh_builders`: list of zero-arg callables (or MeshData) — the layer's
    mesh variants, indexed by `mesh_index`.  Returns [(MeshData, mat_id)]
    for build_bvh, instances yaw-rotated about +y and uniformly scaled
    (the indirect-draw instance expansion of the reference,
    shaders/proc_placement/*)."""
    import numpy as np

    valid = np.asarray(layer["valid"])
    order = np.asarray(layer["order"])[: int(valid.sum())]
    if max_instances is not None:
        order = order[:max_instances]
    pos = np.asarray(layer["position"])
    rot = np.asarray(layer["rotation"])
    scl = np.asarray(layer["scale"])
    midx = np.asarray(layer["mesh_index"])
    protos = []
    for b in mesh_builders:
        protos.append(b() if callable(b) else b)
    if material_ids is None:
        material_ids = [0] * len(protos)
    out = []
    for i in order:
        m = protos[int(midx[i]) % len(protos)]
        half = np.sin(rot[i] * 0.5)
        quat = (0.0, float(half), 0.0, float(np.cos(rot[i] * 0.5)))
        out.append((
            m.transformed(translate=tuple(pos[i]), rotate=quat,
                          scale=float(scl[i])),
            material_ids[int(midx[i]) % len(protos)],
        ))
    return out
