"""Transparent water pass over the opaque frame.

Reference: the transparent render pass (src/rendering/render_pass.h:100) and
water rendering (src/terrain/water.h:16 + shaders/water/water_ps.hlsl):
a normal-perturbed plane blending depth-based water color with a refracted
sample of the opaque color buffer and a Fresnel-weighted reflection.

Form: a pure image pass — intersect each primary ray with the water
plane; where it hits before the opaque surface, composite refraction
(offset opaque sample), absorption color by water depth, and reflected sky.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import maths as m
from ..terrain.water import water_color, water_normal
from .camera import Camera
from .gbuffer import GBuffer
from .pathtracer import Sky, sky_radiance


def water_pass(color, gb: GBuffer, camera: Camera, sky: Sky,
               water_height: float = 0.0, time: float = 0.0,
               refraction_strength: float = 12.0):
    """Composite a water plane at `water_height` into the lit frame.

    color (H, W, 3) opaque frame; gb the matching G-buffer."""
    h, w, _ = color.shape
    o = camera.position
    d = m.noz(gb.world_pos - o)

    denom = d[..., 1]
    t_w = (water_height - o[1]) / jnp.where(jnp.abs(denom) < 1e-6, -1e-6, denom)
    t_opaque = jnp.where(gb.hit, jnp.linalg.norm(gb.world_pos - o, axis=-1),
                         jnp.inf)
    covered = (t_w > 0) & (t_w < t_opaque) & (o[1] > water_height)

    p = o + d * t_w[..., None]
    n = water_normal(p[..., 0], p[..., 2], time)

    # Refraction: shift the opaque sample by the normal's xz wobble
    # (reference: water_ps refraction offset of the opaque color buffer).
    px = jnp.clip(
        jnp.arange(w)[None, :] + jnp.round(
            n[..., 0] * refraction_strength).astype(jnp.int32), 0, w - 1)
    py = jnp.clip(
        jnp.arange(h)[:, None] + jnp.round(
            n[..., 2] * refraction_strength).astype(jnp.int32), 0, h - 1)
    refracted = color[py, px]

    # Depth-based absorption between the surface and the opaque hit below it.
    below = jnp.where(jnp.isfinite(t_opaque), t_opaque - t_w, 1e3)
    depth_below = below * jnp.maximum(-d[..., 1], 0.05)
    tint = water_color(depth_below)
    absorb = jnp.exp(-depth_below[..., None] * 0.8)
    body = refracted * absorb + tint * (1 - absorb)

    # Fresnel-weighted sky reflection off the perturbed normal.
    refl_dir = d - 2 * jnp.sum(d * n, -1, keepdims=True) * n
    refl = sky_radiance(sky, refl_dir.reshape(-1, 3)).reshape(h, w, 3)
    cos_t = jnp.clip(jnp.sum(-d * n, -1), 0.0, 1.0)
    fresnel = 0.02 + 0.98 * (1.0 - cos_t) ** 5
    surface = body * (1 - fresnel[..., None]) + refl * fresnel[..., None]

    return jnp.where(covered[..., None], surface, color)
