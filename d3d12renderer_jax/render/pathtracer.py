"""Progressive wavefront path tracer.

Feature parity with the reference DXR path tracer (reference:
src/rendering/path_tracing.h:5-25: <=4 bounce depth, russian roulette after N
bounces, thin-lens DoF, optional direct-light sampling with multiple
importance sampling, progressive accumulation path_tracing.cpp numAveragedFrames;
shading model reference: shaders/common/brdf.hlsli Cook-Torrance GGX +
Lambert, shaders/raytracing/path_tracing_rts.hlsl).

Design: wavefront over all pixels — each bounce is one fully-vectorized
closest-hit traversal + shade + next-ray generation over R = W*H rays, with a
live mask instead of divergent early exits.  Benchmarked in Mrays/sec
(BASELINE.json target: >= 50 Mrays/sec at 1080p).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from typing import TYPE_CHECKING

from ..core import maths as m
from . import bvh as bvh_mod
from .bvh import BVH
from .camera import Camera, generate_rays

if TYPE_CHECKING:  # lights.py imports our BRDF helpers; avoid the cycle
    from .lights import PointLights


@struct.dataclass
class Materials:
    albedo: jnp.ndarray      # (M, 3)
    emissive: jnp.ndarray    # (M, 3)
    roughness: jnp.ndarray   # (M,)
    metallic: jnp.ndarray    # (M,)
    # Optional albedo textures: a square atlas stack + per-material index
    # (-1 = untextured).  Reference: pbr_material albedo maps with tint
    # (src/rendering/pbr_material.h:25-60).
    texture_atlas: jnp.ndarray = None    # (K, R, R, 3) or None
    albedo_texture: jnp.ndarray = None   # (M,) int32 or None


def sample_albedo(materials: "Materials", mat, uv):
    """Per-hit albedo: constant tint x optional texture sample (wrap)."""
    base = materials.albedo[mat]
    if materials.texture_atlas is None:
        return base
    ti = materials.albedo_texture[mat]
    has = ti >= 0
    t = jnp.maximum(ti, 0)
    r = materials.texture_atlas.shape[1]
    u = jnp.mod(uv[..., 0], 1.0)
    v = jnp.mod(uv[..., 1], 1.0)
    px = jnp.clip((u * (r - 1)).astype(jnp.int32), 0, r - 1)
    py = jnp.clip((v * (r - 1)).astype(jnp.int32), 0, r - 1)
    tex = materials.texture_atlas[t, py, px]
    return jnp.where(has[..., None], base * tex, base)


@struct.dataclass
class Sky:
    """Sky environment: procedural sun disc + gradient, or a textured
    cubemap (reference: both paths, shaders/sky/sky_procedural_ps.hlsl and
    sky_texture_ps.hlsl; selected per frame by main_renderer)."""

    sun_direction: jnp.ndarray   # (3,) direction TOWARD the sun
    sun_radiance: jnp.ndarray    # (3,)
    zenith: jnp.ndarray          # (3,)
    horizon: jnp.ndarray         # (3,)
    ground: jnp.ndarray          # (3,)
    # Optional (6, R, R, 3) cubemap (+X -X +Y -Y +Z -Z); when present it
    # replaces the gradient (the sun disc still adds on top).
    cubemap: jnp.ndarray = None
    # Optional Preetham analytic daylight (reference:
    # shaders/sky/sky_procedural_ps.hlsl): scalar turbidity (2-10) selects
    # the Perez model; None keeps the simple gradient.  `preetham_scale`
    # maps zenith luminance (kcd/m^2) into the scene's radiance units.
    turbidity: jnp.ndarray = None
    preetham_scale: jnp.ndarray = None


def sample_cubemap(cube, d):
    """Sample a (6, R, R, 3) cubemap with directions d (..., 3), bilinear
    within the selected face (reference samples with trilinear; HDR suns
    alias visibly with nearest)."""
    r = cube.shape[1]
    ax, ay, az = jnp.abs(d[..., 0]), jnp.abs(d[..., 1]), jnp.abs(d[..., 2])
    # Face selection by major axis.
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = jnp.where(
        is_x, jnp.where(d[..., 0] > 0, 0, 1),
        jnp.where(is_y, jnp.where(d[..., 1] > 0, 2, 3),
                  jnp.where(d[..., 2] > 0, 4, 5)),
    )
    major = jnp.where(is_x, d[..., 0], jnp.where(is_y, d[..., 1], d[..., 2]))
    # Standard cubemap (s, t) per face.
    sc = jnp.where(
        is_x, -jnp.sign(d[..., 0]) * d[..., 2],
        jnp.where(is_y, d[..., 0], jnp.sign(d[..., 2]) * d[..., 0]),
    )
    tc = jnp.where(is_y, jnp.sign(d[..., 1]) * d[..., 2], -d[..., 1])
    inv = 1.0 / jnp.maximum(jnp.abs(major), 1e-9)
    u = jnp.clip((sc * inv * 0.5 + 0.5) * (r - 1), 0.0, r - 1.0)
    v = jnp.clip((tc * inv * 0.5 + 0.5) * (r - 1), 0.0, r - 1.0)
    u0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, r - 2)
    v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, r - 2)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    c00 = cube[face, v0, u0]
    c01 = cube[face, v0, u0 + 1]
    c10 = cube[face, v0 + 1, u0]
    c11 = cube[face, v0 + 1, u0 + 1]
    return ((1 - fv) * ((1 - fu) * c00 + fu * c01)
            + fv * ((1 - fu) * c10 + fu * c11))


@struct.dataclass
class Scene:
    bvh: BVH
    materials: Materials
    sky: Sky
    # Optional local lights for next-event estimation (reference samples a
    # random point light per bounce alongside the sun:
    # shaders/raytracing/path_tracing_rts.hlsl:341-366).  Shares the raster
    # pipeline's PointLights table (position, radiance color, falloff radius).
    point_lights: Optional["PointLights"] = None
    # Precomputed (T, 28) packed shading-attribute table (see
    # bvh.hit_attributes_shaded).  Frame-INVARIANT (bvh + materials only),
    # so construct scenes with `with_shading_table()` for per-frame rendering.
    attr_table: Optional[jnp.ndarray] = None

    def with_shading_table(self) -> "Scene":
        from . import bvh as bvh_mod

        return self.replace(attr_table=bvh_mod.build_shading_table(
            self.bvh, self.materials))


@struct.dataclass
class PathTracerSettings:
    """Reference: path_tracer_settings (src/rendering/path_tracing.h:5-25)."""

    recursion_depth: int = struct.field(pytree_node=False, default=3)
    start_russian_roulette_after: int = struct.field(pytree_node=False, default=3)
    use_thin_lens: bool = struct.field(pytree_node=False, default=False)
    f_number: float = struct.field(pytree_node=False, default=32.0)
    focal_length: float = struct.field(pytree_node=False, default=1.0)
    enable_direct_lighting: bool = struct.field(pytree_node=False, default=True)
    light_intensity_scale: float = struct.field(pytree_node=False, default=1.0)
    multiple_importance_sampling: bool = struct.field(pytree_node=False, default=True)
    max_traversal_steps: int = struct.field(pytree_node=False, default=512)
    # Physical emitter radius used for sphere-light solid-angle sampling
    # (reference: path_tracing.h:22 pointLightRadius = 0.1f).
    point_light_radius: float = struct.field(pytree_node=False, default=0.1)


def default_sky(sun_direction=(-0.6, 0.8, -0.3)) -> Sky:
    d = np.asarray(sun_direction, np.float64)
    d = d / np.linalg.norm(d)
    return Sky(
        sun_direction=jnp.asarray(d, jnp.float32),
        sun_radiance=jnp.asarray([50.0, 47.0, 42.0]),
        zenith=jnp.asarray([0.25, 0.45, 0.85]),
        horizon=jnp.asarray([0.65, 0.75, 0.9]),
        ground=jnp.asarray([0.25, 0.22, 0.2]),
    )


def preetham_sky(sun_direction=(-0.6, 0.8, -0.3), turbidity: float = 3.0,
                 scale: float = 0.03, **kw) -> Sky:
    """Preetham analytic daylight sky (reference:
    shaders/sky/sky_procedural_ps.hlsl — the procedural sky path)."""
    base = default_sky(sun_direction)
    return base.replace(turbidity=jnp.asarray(turbidity, jnp.float32),
                        preetham_scale=jnp.asarray(scale, jnp.float32), **kw)


def _perez(theta_cos, gamma, gamma_cos, coeff):
    a, b, c, e, f = coeff
    return ((1.0 + a * jnp.exp(b / jnp.maximum(theta_cos, 0.01)))
            * (1.0 + c * jnp.exp(e * gamma) + f * gamma_cos ** 2))


def _preetham_radiance(sun_dir, turbidity, scale, d):
    """Perez-function xyY daylight model (Preetham, Shirley, Smits 1999),
    evaluated per direction -> linear sRGB radiance.  Directions below the
    horizon clamp to the horizon band (callers blend ground)."""
    t = turbidity
    # Perez coefficients (A..E) for Y, x, y as linear functions of T.
    cy = (0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
          0.1206 * t - 2.5771, -0.0670 * t + 0.3703)
    cx = (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
          -0.0641 * t - 0.8989, -0.0033 * t + 0.0452)
    cyy = (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
           -0.0441 * t - 1.6537, -0.0109 * t + 0.0529)

    cos_ts = jnp.clip(sun_dir[1], -1.0, 1.0)
    theta_s = jnp.arccos(jnp.clip(cos_ts, 0.0, 1.0))
    # Zenith values.
    chi = (4.0 / 9.0 - t / 120.0) * (jnp.pi - 2.0 * theta_s)
    yz = ((4.0453 * t - 4.9710) * jnp.tan(chi) - 0.2155 * t + 2.4192)
    yz = jnp.maximum(yz, 1e-3)
    th = jnp.stack([theta_s ** 3, theta_s ** 2, theta_s,
                    jnp.ones_like(theta_s)])
    tv = jnp.stack([t * t, t, jnp.ones_like(t)])
    mx = jnp.array([[0.00166, -0.02903, 0.11693],
                    [-0.00375, 0.06377, -0.21196],
                    [0.00209, -0.03202, 0.06052],
                    [0.0, 0.00394, 0.25886]], jnp.float32)
    my = jnp.array([[0.00275, -0.04214, 0.15346],
                    [-0.00610, 0.08970, -0.26756],
                    [0.00317, -0.04153, 0.06670],
                    [0.0, 0.00516, 0.26688]], jnp.float32)
    xz = th @ mx @ tv
    yyz = th @ my @ tv

    cos_t = jnp.clip(d[..., 1], 0.01, 1.0)   # clamp below-horizon to band
    cos_g = jnp.clip(jnp.sum(d * sun_dir, -1), -1.0, 1.0)
    gamma = jnp.arccos(cos_g)

    def ratio(coeff, zen):
        return zen * (_perez(cos_t, gamma, cos_g, coeff)
                      / _perez(jnp.ones_like(theta_s), theta_s, cos_ts,
                               coeff))

    lum = ratio(cy, yz) * scale
    x = ratio(cx, xz)
    y = ratio(cyy, yyz)
    # xyY -> XYZ -> linear sRGB.
    ys = jnp.maximum(y, 1e-4)
    big_x = x * lum / ys
    big_z = (1.0 - x - ys) * lum / ys
    xyz = jnp.stack([big_x, lum, big_z], -1)
    m = jnp.array([[3.2406, -1.5372, -0.4986],
                   [-0.9689, 1.8758, 0.0415],
                   [0.0557, -0.2040, 1.0570]], jnp.float32)
    return jnp.maximum(xyz @ m.T, 0.0)


def sky_radiance(sky: Sky, d):
    """Environment lookup for a miss direction (R, 3): textured cubemap when
    present, Preetham analytic when `turbidity` is set, procedural gradient
    otherwise (reference: textured / procedural sky selection,
    render_algorithms.cpp texturedSky / proceduralSky)."""
    cos_sun = jnp.sum(d * sky.sun_direction, -1, keepdims=True)
    sun = jnp.where(cos_sun > 0.9995, sky.sun_radiance, 0.0)
    if sky.cubemap is not None:
        return sample_cubemap(sky.cubemap, d) + sun
    y = d[..., 1:2]
    if sky.turbidity is not None:
        col = _preetham_radiance(sky.sun_direction, sky.turbidity,
                                 sky.preetham_scale, d)
        fade = jnp.clip(y / 0.02, 0.0, 1.0)     # horizon band -> ground
        col = col * fade + sky.ground * (1.0 - fade)
        return col + sun
    t = jnp.clip(y, 0.0, 1.0) ** 0.6
    col = sky.horizon * (1 - t) + sky.zenith * t
    col = jnp.where(y < 0, sky.ground, col)
    return col + sun


# --------------------------------------------------------------------------
# GGX BRDF (reference: shaders/common/brdf.hlsli)
# --------------------------------------------------------------------------

def _fresnel_schlick(cos_t, f0):
    return f0 + (1.0 - f0) * jnp.clip(1.0 - cos_t, 0.0, 1.0)[..., None] ** 5


def _ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(jnp.pi * denom * denom, 1e-8)


def _smith_g(n_dot_v, n_dot_l, alpha):
    k = alpha * alpha / 2.0
    gv = n_dot_v / jnp.maximum(n_dot_v * (1 - k) + k, 1e-8)
    gl = n_dot_l / jnp.maximum(n_dot_l * (1 - k) + k, 1e-8)
    return gv * gl


def eval_brdf(n, v, l, albedo, roughness, metallic):
    """Cook-Torrance specular + Lambert diffuse.  Returns (f, pdf_bsdf)."""
    alpha = jnp.maximum(roughness * roughness, 1e-3)
    h = m.noz(v + l)
    n_dot_v = jnp.maximum(jnp.sum(n * v, -1), 1e-4)
    n_dot_l = jnp.maximum(jnp.sum(n * l, -1), 0.0)
    n_dot_h = jnp.clip(jnp.sum(n * h, -1), 0.0, 1.0)
    v_dot_h = jnp.maximum(jnp.sum(v * h, -1), 1e-4)

    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    F = _fresnel_schlick(v_dot_h, f0)
    D = _ggx_d(n_dot_h, alpha)
    G = _smith_g(n_dot_v, n_dot_l, alpha)
    spec = F * (D * G / jnp.maximum(4.0 * n_dot_v * n_dot_l, 1e-8))[..., None]
    diff = albedo * (1.0 - metallic[..., None]) * (1.0 - F) / jnp.pi

    f = (diff + spec) * n_dot_l[..., None]

    # Mixed pdf matching the sampler below (0.5 diffuse / 0.5 GGX when lit).
    pdf_diff = n_dot_l / jnp.pi
    pdf_spec = D * n_dot_h / jnp.maximum(4.0 * v_dot_h, 1e-8)
    pdf = 0.5 * pdf_diff + 0.5 * pdf_spec
    return f, pdf


def _onb(n):
    t1, t2 = m.orthonormal_basis(n)
    return t1, t2


def sample_brdf(key, n, v, albedo, roughness, metallic):
    """Sample the mixed diffuse/GGX lobe.  Returns (l, f_over_pdf_weight)."""
    k1, k2, k3 = jax.random.split(key, 3)
    r = n.shape[0]
    u1 = jax.random.uniform(k1, (r,))
    u2 = jax.random.uniform(k2, (r,))
    pick_spec = jax.random.uniform(k3, (r,)) < 0.5

    t1, t2 = _onb(n)
    alpha = jnp.maximum(roughness * roughness, 1e-3)

    # Cosine-weighted diffuse direction.
    rad = jnp.sqrt(u1)
    phi = 2 * jnp.pi * u2
    ld = (t1 * (rad * jnp.cos(phi))[:, None]
          + t2 * (rad * jnp.sin(phi))[:, None]
          + n * jnp.sqrt(jnp.maximum(1 - u1, 0.0))[:, None])

    # GGX half-vector sample, reflect view.
    cos_t = jnp.sqrt((1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    h = (t1 * (sin_t * jnp.cos(phi))[:, None]
         + t2 * (sin_t * jnp.sin(phi))[:, None]
         + n * cos_t[:, None])
    ls = 2.0 * jnp.sum(v * h, -1, keepdims=True) * h - v

    l = jnp.where(pick_spec[:, None], ls, ld)
    l = m.noz(l)
    f, pdf = eval_brdf(n, v, l, albedo, roughness, metallic)
    w = jnp.where((pdf > 1e-8)[:, None], f / jnp.maximum(pdf, 1e-8)[:, None], 0.0)
    valid = jnp.sum(l * n, -1) > 0
    return l, jnp.where(valid[:, None], w, 0.0), pdf


SUN_COS_CONE = 0.9995
SUN_PDF = 1.0 / (2.0 * jnp.pi * (1.0 - SUN_COS_CONE))


def _sample_sun(key, sky: Sky):
    """Uniform direction in the sun cone."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1)
    u2 = jax.random.uniform(k2)
    cos_t = 1.0 - u1 * (1.0 - SUN_COS_CONE)
    sin_t = jnp.sqrt(jnp.maximum(1 - cos_t * cos_t, 0.0))
    phi = 2 * jnp.pi * u2
    t1, t2 = m.orthonormal_basis(sky.sun_direction)
    return (t1 * sin_t * jnp.cos(phi) + t2 * sin_t * jnp.sin(phi)
            + sky.sun_direction * cos_t)


def atrium_render_scene(detail: float = 1.4) -> Scene:
    """The atrium benchmark scene (render/mesh.atrium_scene; ~257k
    triangles at detail 1.4) with its six materials and the default sky,
    shading table built."""
    from . import mesh as mesh_mod

    bvh = bvh_mod.build_bvh(mesh_mod.atrium_scene(detail))
    mats = Materials(
        albedo=jnp.array([[0.55, 0.5, 0.45], [0.7, 0.66, 0.6],
                          [0.75, 0.72, 0.65], [0.6, 0.58, 0.52],
                          [0.9, 0.88, 0.85], [0.6, 0.15, 0.12]]),
        emissive=jnp.zeros((6, 3)),
        roughness=jnp.array([0.6, 0.7, 0.55, 0.65, 0.15, 0.8]),
        metallic=jnp.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0]),
    )
    return Scene(bvh=bvh, materials=mats, sky=default_sky()).with_shading_table()


def trace_sample(scene: Scene, settings: PathTracerSettings,
                 origin, direction, key, with_stats: bool = False):
    """One radiance sample per ray.  origin/direction (R, 3).

    With `with_stats`, also returns the number of USEFUL rays traced
    (alive closest-hit rays + unmasked NEE shadow rays) — the numerator of
    the end-to-end Mrays/s metric.  Dead wavefront rows and masked shadow
    rows are excluded AND suppressed (t_max = 0), so the count matches the
    work the kernels actually do."""
    r = origin.shape[0]
    radiance = jnp.zeros((r, 3))
    throughput = jnp.ones((r, 3))
    alive = jnp.ones((r,), bool)
    rays_traced = jnp.zeros((), jnp.float32)
    o, d = origin, direction

    for bounce in range(settings.recursion_depth + 1):
        key, k_hit, k_rr, k_sun = jax.random.split(key, 4)
        # Dead rows get t_max = 0: every hit test rejects them (no result
        # is read from them).
        t_cap = 1e30 if bounce == 0 else jnp.where(alive, 1e30, 0.0)
        res = bvh_mod.closest_hit(
            scene.bvh, o, d, t_max=t_cap,
            max_steps=settings.max_traversal_steps,
        )
        hit = res["hit"] & alive
        rays_traced = rays_traced + (r if bounce == 0
                                     else jnp.sum(alive.astype(jnp.float32)))

        # Miss: environment.
        env = sky_radiance(scene.sky, d)
        radiance = radiance + jnp.where(
            (alive & ~res["hit"])[:, None], throughput * env, 0.0
        )

        # One packed row gather for geometry + material attributes
        # (bvh.hit_attributes_shaded).
        n, gn, uv, mat, albedo, rough, metal, emissive = \
            bvh_mod.hit_attributes_shaded(scene.bvh, scene.materials, res,
                                          table=scene.attr_table)

        # Two-sided shading: orient the geometric normal against the ray, then
        # align the interpolated normal with it (winding-robust).
        flip = jnp.sum(gn * d, -1) > 0
        gn = jnp.where(flip[:, None], -gn, gn)
        n = jnp.where((jnp.sum(n * gn, -1) < 0)[:, None], -n, n)

        p = o + d * res["t"][:, None] + gn * 1e-3
        v = -d

        radiance = radiance + jnp.where(
            hit[:, None], throughput * emissive, 0.0
        )

        # Next-event estimation toward the sun (reference
        # enableDirectLighting + MIS, path_tracing.h:20,24).
        if settings.enable_direct_lighting:
            l_sun = _sample_sun(k_sun, scene.sky)
            l_sun = jnp.broadcast_to(l_sun, (r, 3))
            facing = jnp.sum(n * l_sun, -1) > 0
            need_sun = hit & facing
            shadowed = bvh_mod.any_hit(
                scene.bvh, p, l_sun,
                t_max=jnp.where(need_sun, 1e30, 0.0),
                max_steps=settings.max_traversal_steps,
            )
            rays_traced = rays_traced + jnp.sum(need_sun.astype(jnp.float32))
            f, pdf_b = eval_brdf(n, v, l_sun, albedo, rough, metal)
            if settings.multiple_importance_sampling:
                w_mis = SUN_PDF / (SUN_PDF + pdf_b)
            else:
                w_mis = jnp.ones_like(pdf_b)
            contrib = (throughput * f * scene.sky.sun_radiance
                       * (w_mis / SUN_PDF)[:, None]
                       * settings.light_intensity_scale)
            radiance = radiance + jnp.where(
                (hit & facing & ~shadowed)[:, None], contrib, 0.0
            )

        # Next-event estimation toward one random point light per ray
        # (reference: path_tracing_rts.hlsl:341-366 — uniform light pick,
        # random point on the emitter sphere, solid-angle pdf halved for the
        # visible hemisphere, balance-heuristic MIS against the BSDF pdf).
        if settings.enable_direct_lighting and scene.point_lights is not None:
            pls = scene.point_lights
            nl = pls.position.shape[0]
            key, k_li, k_sp = jax.random.split(key, 3)
            # Uniform pick over the VALID lights only: a padded table would
            # otherwise waste samples on invalid rows.  rank -> index of the
            # rank-th valid light via the running count.
            n_valid = jnp.maximum(jnp.sum(pls.valid.astype(jnp.int32)), 1)
            rank = jax.random.randint(k_li, (r,), 0, n_valid)
            li = jnp.searchsorted(jnp.cumsum(pls.valid.astype(jnp.int32)),
                                  rank + 1)
            li = jnp.clip(li, 0, nl - 1)
            sp = m.noz(jax.random.normal(k_sp, (r, 3)))
            lp = pls.position[li] + sp * settings.point_light_radius
            to_l = lp - p
            dist = jnp.maximum(jnp.linalg.norm(to_l, axis=-1), 1e-5)
            l_pt = to_l / dist[:, None]
            # Reference falloff (light_source.hlsli:14-22 getAttenuation).
            rel = jnp.minimum(dist / jnp.maximum(pls.radius[li], 1e-5), 1.0)
            dd = dist / jnp.maximum(1.0 - rel * rel, 1e-6)
            att = 1.0 / (dd * dd + 1.0)
            # Solid angle of the emitter sphere (math.hlsli:20-28), halved:
            # a full-sphere surface sample maps two points to each cap
            # direction, doubling the direction pdf.
            s = jnp.minimum(settings.point_light_radius / dist, 1.0)
            omega = 2.0 * jnp.pi * (1.0 - jnp.sqrt(jnp.maximum(1 - s * s, 0.0)))
            pdf_l = 1.0 / jnp.maximum(0.5 * omega * n_valid, 1e-8)
            facing_pt = jnp.sum(n * l_pt, -1) > 0
            need_pt = hit & facing_pt & pls.valid[li]
            shadowed_pt = bvh_mod.any_hit(
                scene.bvh, p, l_pt,
                t_max=jnp.where(need_pt,
                                jnp.maximum(dist - 1e-3, 1e-4), 0.0),
                max_steps=settings.max_traversal_steps,
            )
            rays_traced = rays_traced + jnp.sum(need_pt.astype(jnp.float32))
            f_pt, pdf_b_pt = eval_brdf(n, v, l_pt, albedo, rough, metal)
            if settings.multiple_importance_sampling:
                w_mis_pt = pdf_l / (pdf_l + pdf_b_pt)
            else:
                w_mis_pt = jnp.ones_like(pdf_l)
            contrib_pt = (throughput * f_pt * pls.color[li]
                          * (att * w_mis_pt / pdf_l)[:, None]
                          * settings.light_intensity_scale)
            ok_pt = hit & facing_pt & ~shadowed_pt & pls.valid[li]
            radiance = radiance + jnp.where(ok_pt[:, None], contrib_pt, 0.0)

        if bounce == settings.recursion_depth:
            break

        # Sample next direction.
        key, k_bsdf = jax.random.split(key)
        l, w, pdf = sample_brdf(k_bsdf, n, v, albedo, rough, metal)
        # MIS for the sun hit via BSDF sampling: weight the env sun disc on
        # the NEXT miss by pdf_b/(pdf_b+sun_pdf).  Approximated by removing
        # the sun from the gradient-env since NEE already integrates it.
        throughput = throughput * w
        alive = hit & (jnp.max(w, -1) > 0)
        o, d = p, l

        # Russian roulette (reference: startRussianRouletteAfter).
        if bounce >= settings.start_russian_roulette_after:
            q = jnp.clip(jnp.max(throughput, -1), 0.05, 1.0)
            survive = jax.random.uniform(k_rr, (r,)) < q
            throughput = throughput / q[:, None]
            alive = alive & survive

    if with_stats:
        return radiance, rays_traced
    return radiance


def _tile_perm(width: int, height: int, tile: int = 32):
    """Pixel-major -> tile-major permutation (and inverse), as constants.

    Rays of one 32x32-pixel tile are neighbours in the wavefront, a far
    tighter beam than a 1024-pixel scanline strip.  Bounce rays inherit the
    coherence (their origins are the tile's hit points)."""
    import numpy as np
    ys, xs = np.mgrid[0:height, 0:width]
    tiles_x = -(-width // tile)
    tile_id = (ys // tile) * tiles_x + (xs // tile)
    perm = np.lexsort((xs.ravel(), ys.ravel(), tile_id.ravel()))
    inv = np.argsort(perm)
    return perm, inv


def render(scene: Scene, camera: Camera, width: int, height: int,
           settings: PathTracerSettings = PathTracerSettings(),
           spp: int = 8, key: Optional[jnp.ndarray] = None,
           with_stats: bool = False):
    """Render an (H, W, 3) linear-radiance image with `spp` samples/pixel.

    Progressive accumulation (reference: numAveragedFrames) = calling this
    repeatedly with different keys and averaging.  With `with_stats`,
    returns (image, rays_traced) where rays_traced counts every useful ray
    the frame dispatched (closest + NEE shadow, all bounces, all samples)
    — the numerator of the end-to-end Mrays/s benchmark."""
    key = key if key is not None else jax.random.PRNGKey(0)
    perm, inv = _tile_perm(width, height)

    def one_sample(k):
        k_cam, k_trace = jax.random.split(k)
        f_num = settings.f_number if settings.use_thin_lens else 0.0
        o, d = generate_rays(camera, width, height, key=k_cam,
                             f_number=f_num, focal_length=settings.focal_length)
        rad, nrays = trace_sample(scene, settings, o[perm], d[perm], k_trace,
                                  with_stats=True)
        return rad[inv], nrays

    def body(i, carry):
        acc, rays = carry
        rad, nrays = one_sample(jax.random.fold_in(key, i))
        return acc + rad, rays + nrays

    img, rays = jax.lax.fori_loop(
        0, spp, body,
        (jnp.zeros((height * width, 3)), jnp.zeros((), jnp.float32)))
    img = (img / spp).reshape(height, width, 3)
    if with_stats:
        return img, rays
    return img


def tonemap_filmic(x):
    """ACES-ish filmic curve (reference: tonemap filmic
    src/rendering/render_algorithms.h:96-118 aces_filmic defaults)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = jnp.maximum(x, 0.0)
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def to_srgb_u8(img):
    img = tonemap_filmic(img)
    img = jnp.where(img <= 0.0031308, img * 12.92,
                    1.055 * img ** (1 / 2.4) - 0.055)
    return (jnp.clip(img, 0, 1) * 255).astype(jnp.uint8)
