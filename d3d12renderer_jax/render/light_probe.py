"""Dynamic diffuse GI: light-probe grid (DDGI-style).

Reference: src/rendering/light_probe.h:11-52 + shaders/light_probe/* — a probe
grid traces per-probe rays each frame, updates octahedral irradiance and
depth (mean/mean^2) atlases with hysteresis, and shading samples 8 probes
trilinearly with Chebyshev visibility weighting.

Design: all probes' rays form one batched BVH traversal; octahedral
update is a masked scatter-free accumulation (texel-direction dot weighting).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import maths as m
from . import bvh as bvh_mod
from .pathtracer import Scene, sky_radiance

IRRADIANCE_RES = 8   # octahedral texels per probe (reference: 8x8 irradiance)
DEPTH_RES = 16       # reference: 16x16 depth
HYSTERESIS = 0.97    # temporal blend (reference probe update hysteresis)


@struct.dataclass
class LightProbeGrid:
    origin: jnp.ndarray        # (3,)
    spacing: jnp.ndarray       # (3,)
    dims: Tuple[int, int, int] = struct.field(pytree_node=False)
    irradiance: jnp.ndarray = None   # (P, R, R, 3)
    depth: jnp.ndarray = None        # (P, Rd, Rd, 2) mean / mean^2

    @property
    def num_probes(self):
        nx, ny, nz = self.dims
        return nx * ny * nz


def create_probe_grid(origin, extent, dims=(6, 3, 6)) -> LightProbeGrid:
    nx, ny, nz = dims
    spacing = jnp.asarray(extent) / jnp.asarray(
        [max(nx - 1, 1), max(ny - 1, 1), max(nz - 1, 1)], jnp.float32)
    p = nx * ny * nz
    return LightProbeGrid(
        origin=jnp.asarray(origin, jnp.float32),
        spacing=spacing,
        dims=dims,
        irradiance=jnp.zeros((p, IRRADIANCE_RES, IRRADIANCE_RES, 3)),
        depth=jnp.zeros((p, DEPTH_RES, DEPTH_RES, 2)),
    )


def probe_positions(grid: LightProbeGrid):
    nx, ny, nz = grid.dims
    ii = jnp.stack(jnp.meshgrid(jnp.arange(nx), jnp.arange(ny), jnp.arange(nz),
                                indexing="ij"), -1).reshape(-1, 3)
    return grid.origin + ii.astype(jnp.float32) * grid.spacing


# Octahedral mapping (reference: light_probe.hlsli octahedral encode/decode).

def oct_decode(uv):
    """uv in [-1,1]^2 -> unit direction."""
    x, y = uv[..., 0], uv[..., 1]
    z = 1.0 - jnp.abs(x) - jnp.abs(y)
    sx = jnp.where(x >= 0, 1.0, -1.0)
    sy = jnp.where(y >= 0, 1.0, -1.0)
    xf = jnp.where(z < 0, (1 - jnp.abs(y)) * sx, x)
    yf = jnp.where(z < 0, (1 - jnp.abs(x)) * sy, y)
    d = jnp.stack([xf, yf, z], -1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def _texel_dirs(res):
    u = (jnp.arange(res) + 0.5) / res * 2 - 1
    gu, gv = jnp.meshgrid(u, u, indexing="ij")
    return oct_decode(jnp.stack([gu, gv], -1))   # (R, R, 3)


def update_probes(grid: LightProbeGrid, scene: Scene, key,
                  rays_per_probe: int = 64, max_steps: int = 256,
                  sun_visibility: bool = True) -> LightProbeGrid:
    """One probe-update pass (reference: light_probe_trace_rts.hlsl +
    update_irradiance/update_depth compute shaders)."""
    pos = probe_positions(grid)                               # (P, 3)
    p = pos.shape[0]

    # Spherical Fibonacci ray set, rotated per update by the key.
    i = jnp.arange(rays_per_probe, dtype=jnp.float32) + 0.5
    phi0 = jax.random.uniform(key) * 2 * math.pi
    phi = i * (math.pi * (3.0 - math.sqrt(5.0))) + phi0
    cos_t = 1.0 - 2.0 * i / rays_per_probe
    sin_t = jnp.sqrt(jnp.maximum(1 - cos_t ** 2, 0))
    dirs = jnp.stack([sin_t * jnp.cos(phi), cos_t, sin_t * jnp.sin(phi)], -1)

    o = jnp.repeat(pos, rays_per_probe, axis=0)               # (P*R, 3)
    d = jnp.tile(dirs, (p, 1))
    res = bvh_mod.closest_hit(scene.bvh, o, d, max_steps=max_steps)
    n, gn, uv, mat = bvh_mod.hit_attributes(scene.bvh, res)
    hit = res["hit"]
    t = jnp.where(hit, res["t"], 1e4)

    # Shade hits: albedo * (sun + sky ambient) — single-bounce like the
    # reference's probe trace shader.
    albedo = scene.materials.albedo[mat]
    gn = jnp.where((jnp.sum(gn * d, -1) > 0)[:, None], -gn, gn)
    sun_l = scene.sky.sun_direction
    ndl = jnp.maximum(jnp.sum(gn * sun_l, -1), 0.0)
    if sun_visibility:
        hp = o + d * t[:, None] + gn * 1e-2
        blocked = bvh_mod.any_hit(scene.bvh, hp,
                                  jnp.broadcast_to(sun_l, hp.shape),
                                  t_max=jnp.full(hp.shape[0], 1e4),
                                  max_steps=max_steps)
        ndl = ndl * (~blocked)
    direct = albedo * (scene.sky.sun_radiance * 0.05) * ndl[:, None]
    ambient = albedo * (scene.sky.horizon * 0.3)
    radiance = jnp.where(hit[:, None], direct + ambient, sky_radiance(scene.sky, d))

    radiance = radiance.reshape(p, rays_per_probe, 3)
    dist = t.reshape(p, rays_per_probe)

    # Irradiance atlas update: texel dir cosine-weighted sum over rays.
    tex_dirs = _texel_dirs(IRRADIANCE_RES).reshape(-1, 3)       # (T, 3)
    w = jnp.maximum(jnp.einsum("td,prd->ptr", tex_dirs, jnp.broadcast_to(
        dirs, (p, rays_per_probe, 3))), 0.0)                     # (P, T, R)
    num = jnp.einsum("ptr,prc->ptc", w, radiance)
    den = jnp.maximum(jnp.sum(w, -1), 1e-4)
    new_irr = (num / den[..., None]).reshape(
        p, IRRADIANCE_RES, IRRADIANCE_RES, 3)

    # Depth atlas: power-cosine weighted mean / mean^2 distances.
    tex_dirs_d = _texel_dirs(DEPTH_RES).reshape(-1, 3)
    wd = jnp.maximum(jnp.einsum("td,prd->ptr", tex_dirs_d, jnp.broadcast_to(
        dirs, (p, rays_per_probe, 3))), 0.0) ** 8
    dend = jnp.maximum(jnp.sum(wd, -1), 1e-4)
    mean = jnp.einsum("ptr,pr->pt", wd, dist) / dend
    mean2 = jnp.einsum("ptr,pr->pt", wd, dist * dist) / dend
    new_depth = jnp.stack([mean, mean2], -1).reshape(
        p, DEPTH_RES, DEPTH_RES, 2)

    first = jnp.all(grid.irradiance == 0)
    h = jnp.where(first, 0.0, HYSTERESIS)
    return grid.replace(
        irradiance=grid.irradiance * h + new_irr * (1 - h),
        depth=grid.depth * h + new_depth * (1 - h),
    )


def _oct_encode(d):
    l1 = jnp.sum(jnp.abs(d), -1, keepdims=True)
    v = d / jnp.maximum(l1, 1e-9)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    sx = jnp.where(x >= 0, 1.0, -1.0)
    sy = jnp.where(y >= 0, 1.0, -1.0)
    xe = jnp.where(z < 0, (1 - jnp.abs(y)) * sx, x)
    ye = jnp.where(z < 0, (1 - jnp.abs(x)) * sy, y)
    return jnp.stack([xe, ye], -1)


def _atlas_lookup(atlas, probe_idx, d, res):
    uv = (_oct_encode(d) * 0.5 + 0.5) * (res - 1)
    iu = jnp.clip(uv[..., 0].astype(jnp.int32), 0, res - 1)
    iv = jnp.clip(uv[..., 1].astype(jnp.int32), 0, res - 1)
    return atlas[probe_idx, iu, iv]


def sample_irradiance(grid: LightProbeGrid, position, normal):
    """Trilinear 8-probe sample with Chebyshev visibility
    (reference: light_probe.hlsli sampleIrradianceAtPosition)."""
    nx, ny, nz = grid.dims
    rel = (position - grid.origin) / grid.spacing
    base = jnp.clip(jnp.floor(rel).astype(jnp.int32),
                    0, jnp.asarray([nx - 2, ny - 2, nz - 2]))
    frac = jnp.clip(rel - base, 0.0, 1.0)

    total = jnp.zeros(position.shape[:-1] + (3,))
    wsum = jnp.zeros(position.shape[:-1])
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx3 = base + jnp.asarray([dx, dy, dz])
                pidx = (idx3[..., 0] * ny + idx3[..., 1]) * nz + idx3[..., 2]
                ppos = grid.origin + idx3.astype(jnp.float32) * grid.spacing
                to_probe = ppos - position
                dist = jnp.linalg.norm(to_probe + 1e-9, axis=-1)
                pdir = to_probe / dist[..., None]

                tw = (
                    (frac[..., 0] if dx else 1 - frac[..., 0])
                    * (frac[..., 1] if dy else 1 - frac[..., 1])
                    * (frac[..., 2] if dz else 1 - frac[..., 2])
                )
                # Backface probe rejection.
                facing = jnp.maximum(jnp.sum(pdir * normal, -1), 0.0) ** 0.5
                # Chebyshev visibility from the depth atlas.
                md = _atlas_lookup(grid.depth, pidx, -pdir, DEPTH_RES)
                mean, mean2 = md[..., 0], md[..., 1]
                var = jnp.maximum(mean2 - mean * mean, 1e-4)
                cheb = var / (var + jnp.maximum(dist - mean, 0.0) ** 2)
                vis = jnp.where(dist > mean, jnp.clip(cheb, 0.05, 1.0), 1.0)

                w = tw * facing * vis + 1e-6
                irr = _atlas_lookup(grid.irradiance, pidx, normal,
                                    IRRADIANCE_RES)
                total = total + irr * w[..., None]
                wsum = wsum + w
    return total / jnp.maximum(wsum[..., None], 1e-6)
