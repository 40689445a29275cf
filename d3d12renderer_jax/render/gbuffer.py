"""G-buffer generation: the depth-prepass equivalent.

Reference: depth prepass writes depth + screen velocities + object IDs
(src/rendering/depth_prepass.h, shaders/geometry/depth_only_*.hlsl).
Primary-ray visibility against the scene BVH (or the software rasterizer,
ops/raster.py) is the equivalent (SURVEY.md §7 stage 6) and produces the identical
G-buffer contract: depth, world/view position, normal, material attributes,
object id, and motion vectors for TAA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import maths as m
from . import bvh as bvh_mod
from .camera import Camera, generate_rays
from .pathtracer import Scene


@struct.dataclass
class GBuffer:
    depth: jnp.ndarray        # (H, W) linear view depth (+inf on sky)
    world_pos: jnp.ndarray    # (H, W, 3)
    view_pos: jnp.ndarray     # (H, W, 3) right-handed view space (-z forward)
    normal: jnp.ndarray       # (H, W, 3) world
    view_normal: jnp.ndarray  # (H, W, 3)
    albedo: jnp.ndarray       # (H, W, 3)
    roughness: jnp.ndarray    # (H, W)
    metallic: jnp.ndarray     # (H, W)
    emissive: jnp.ndarray     # (H, W, 3)
    object_id: jnp.ndarray    # (H, W) int32 (triangle material id; -1 sky)
    motion: jnp.ndarray       # (H, W, 2) pixel offset to previous frame
    hit: jnp.ndarray          # (H, W) bool


def _world_to_view(camera: Camera, p):
    return m.quat_inv_rotate(camera.rotation, p - camera.position)


def _view_to_pixel(camera: Camera, v, width, height):
    import math
    tan_half = math.tan(camera.v_fov * 0.5)
    z = jnp.maximum(-v[..., 2], 1e-6)
    u = v[..., 0] / (z * tan_half * camera.aspect)
    w_ = -v[..., 1] / (z * tan_half)
    px = (u * 0.5 + 0.5) * width
    py = (w_ * 0.5 + 0.5) * height
    return jnp.stack([px, py], -1)


def render_gbuffer(scene: Scene, camera: Camera, width: int, height: int,
                   prev_camera: Optional[Camera] = None,
                   jitter_key=None, max_steps=512,
                   primary: str = "ray") -> GBuffer:
    """primary="ray": per-pixel jittered primary rays against the BVH.
    primary="raster": the tile-binned 2DH rasterizer (ops/raster.py);
    sub-pixel AA jitter becomes ONE per-frame offset (TAA-style), matching
    hardware rasterization."""
    if primary == "raster":
        import jax

        from ..ops import raster as rp
        if jitter_key is not None:
            jit2 = jax.random.uniform(jitter_key, (2,))
        else:
            jit2 = jnp.full((2,), 0.5)
        res = rp.closest_hit_raster(scene.bvh, camera, width, height,
                                    jitter=jit2)
        # One materialization: every G-buffer field consumes res, and
        # without a fence XLA can rematerialize raster work per consumer.
        res = dict(zip(res.keys(), jax.lax.optimization_barrier(
            tuple(res.values()))))
        o, d = generate_rays(camera, width, height, offset=jit2)
    else:
        o, d = generate_rays(camera, width, height, key=jitter_key)
        res = bvh_mod.closest_hit(scene.bvh, o, d, max_steps=max_steps)
    # One packed row gather serves normals/uv/material constants in place
    # of separate per-attribute fetches.
    n, gn, uv, mat, albedo, rough, metal, emissive = \
        bvh_mod.hit_attributes_shaded(scene.bvh, scene.materials, res,
                                      table=scene.attr_table)

    hit = res["hit"]
    t = jnp.where(hit, res["t"], jnp.inf)
    wp = o + d * jnp.where(hit, res["t"], 1e6)[:, None]
    flip = jnp.sum(gn * d, -1) > 0
    gn = jnp.where(flip[:, None], -gn, gn)
    n = jnp.where((jnp.sum(n * gn, -1) < 0)[:, None], -n, n)

    vp = _world_to_view(camera, wp)
    vn = m.quat_inv_rotate(camera.rotation[None], n)

    # Motion vectors: pixel now minus pixel in the previous camera
    # (reference: screen velocities in the depth prepass).
    if prev_camera is not None:
        vp_prev = _world_to_view(prev_camera, wp)
        pix_prev = _view_to_pixel(prev_camera, vp_prev, width, height)
        pix_now = _view_to_pixel(camera, vp, width, height)
        motion = pix_prev - pix_now
    else:
        motion = jnp.zeros((height * width, 2))

    def img(x, ch=None):
        shape = (height, width) if ch is None else (height, width, ch)
        return x.reshape(shape)

    return GBuffer(
        depth=img(jnp.where(hit, -vp[:, 2], jnp.inf)),
        world_pos=img(wp, 3),
        view_pos=img(vp, 3),
        normal=img(n, 3),
        view_normal=img(vn, 3),
        albedo=img(jnp.where(hit[:, None], albedo, 0.0), 3),
        roughness=img(jnp.where(hit, rough, 1.0)),
        metallic=img(jnp.where(hit, metal, 0.0)),
        emissive=img(jnp.where(hit[:, None], emissive, 0.0), 3),
        object_id=img(jnp.where(hit, mat, -1)),
        motion=img(motion, 2),
        hit=img(hit),
    )
