"""Debug visualization: wire primitives, unlit overlays, outlines.

Reference: src/rendering/debug_visualization.h:16-40 (wire spheres/cones/
boxes, position-color pipelines), src/rendering/outline.h:6 (stencil-based
outlines, shaders/outline/*).  Here debug draws are line-segment lists
splatted onto the rendered image; outlines come from the G-buffer object-id
edges (the stencil equivalent).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import maths as m
from .camera import Camera


def wire_box(center, half_extents, rotation=None):
    """12 edges of a box -> (12, 2, 3) segment list."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half_extents, np.float32)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * h
    if rotation is not None:
        x, y, z, w = rotation
        rm = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        corners = corners @ rm.T
    corners = corners + c
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.stack([[corners[a], corners[b]] for a, b in edges])


def wire_sphere(center, radius, segments=24):
    """3 great circles -> (3*segments, 2, 3)."""
    c = np.asarray(center, np.float32)
    segs = []
    for axis in range(3):
        ts = np.linspace(0, 2 * math.pi, segments + 1)
        u = np.zeros(3)
        v = np.zeros(3)
        u[(axis + 1) % 3] = 1
        v[(axis + 2) % 3] = 1
        pts = c + radius * (np.outer(np.cos(ts), u) + np.outer(np.sin(ts), v))
        segs.extend([[pts[i], pts[i + 1]] for i in range(segments)])
    return np.stack(segs).astype(np.float32)


def wire_cone(apex, direction, angle, length, segments=16):
    """Cone outline (reference: debug cone for spot lights)."""
    apex = np.asarray(apex, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    t = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(d, t)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)
    r = math.tan(angle) * length
    base = apex + d * length
    ts = np.linspace(0, 2 * math.pi, segments + 1)
    ring = base + r * (np.outer(np.cos(ts), u) + np.outer(np.sin(ts), v))
    segs = [[ring[i], ring[i + 1]] for i in range(segments)]
    for i in range(0, segments, max(segments // 4, 1)):
        segs.append([apex, ring[i]])
    return np.stack(segs).astype(np.float32)


def rasterize_lines(image, segments, color, camera: Camera, samples=48):
    """Splat world-space segments onto an (H, W, 3) image (the position-color
    debug pipeline equivalent).  segments (S, 2, 3)."""
    h, w, _ = image.shape
    segments = jnp.asarray(segments)
    t = jnp.linspace(0.0, 1.0, samples)
    pts = (segments[:, 0][:, None, :] * (1 - t)[None, :, None]
           + segments[:, 1][:, None, :] * t[None, :, None]).reshape(-1, 3)
    vp = m.quat_inv_rotate(camera.rotation[None], pts - camera.position)
    z = -vp[:, 2]
    tan_half = math.tan(camera.v_fov * 0.5)
    valid = z > camera.near
    u = vp[:, 0] / jnp.maximum(z, 1e-6) / (tan_half * camera.aspect)
    v = -vp[:, 1] / jnp.maximum(z, 1e-6) / tan_half
    px = ((u * 0.5 + 0.5) * (w - 1)).astype(jnp.int32)
    py = ((v * 0.5 + 0.5) * (h - 1)).astype(jnp.int32)
    inside = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    px = jnp.clip(px, 0, w - 1)
    py = jnp.clip(py, 0, h - 1)
    col = jnp.asarray(color, image.dtype)
    return image.at[py, px].set(
        jnp.where(inside[:, None], col, image[py, px]))


def object_outlines(object_id, thickness=1):
    """Edge mask from G-buffer object ids (the stencil-outline equivalent,
    reference: outline.h marker stencil + dilate)."""
    edges = jnp.zeros(object_id.shape, bool)
    for dy, dx in ((0, 1), (1, 0)):
        edges = edges | (m.roll2(object_id, dy, dx) != object_id)
    for _ in range(thickness - 1):
        acc = edges
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = acc | m.roll2(edges, dy, dx)
        edges = acc
    return edges


def draw_outlines(image, object_id, selected_id, color=(1.0, 0.6, 0.1)):
    """Highlight one object's silhouette (reference: editor selection
    outlines)."""
    mask = object_id == selected_id
    edge = jnp.zeros_like(mask)
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        edge = edge | (mask != m.roll2(mask, dy, dx))
    return jnp.where(edge[..., None], jnp.asarray(color, image.dtype), image)
