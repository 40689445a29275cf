"""The frame pipeline: main_renderer's frame graph as one jitted function.

Reference: src/rendering/main_renderer.h:110 + .cpp:758-1040 endFrame —
shadow maps -> depth prepass (+velocities) -> sky -> HBAO -> SSR -> SSS ->
opaque PBR -> TAA -> bloom -> tonemap -> sharpen, recorded on 4 CPU threads
with async-compute fences.  Here the whole graph is ONE jit program; XLA
owns scheduling (no command lists, fences, or barriers — SURVEY.md §2.16-26),
and the three renderer modes (rasterized / path traced / visualization) pick
the program.

`renderer_spec` (immutable allow-flags) vs `renderer_settings` (live tunables)
mirrors main_renderer.h:28-64,100-108.
"""

from __future__ import annotations

import math
from time import perf_counter as _perf_counter
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import maths as m
from . import post
from .camera import Camera, halton
from .gbuffer import GBuffer, render_gbuffer
from .lights import (
    PointLights, SpotLights, cull_lights_tiled, eval_brdf_pixel,
    shade_point_lights, shade_spot_lights,
)
from .pathtracer import Scene, sky_radiance
from .shadows import SunShadowMaps, fit_cascades, render_sun_shadow_maps, \
    sample_sun_shadow
from . import bvh as bvh_mod


def rt_reflections(scene: Scene, gb: GBuffer, camera: Camera,
                   max_roughness: float = 0.6):
    """One-bounce ray-traced specular reflections (reference:
    src/rendering/raytraced_reflections.cpp + rt_reflections_rts.hlsl).

    Traces mirror rays from every opaque hit, shades the hit with sun NEE
    (shadow ray) + sky-hemisphere ambient, and returns (radiance, mask).
    Feeds the same resolve as SSR: pipeline blends by SSR confidence, RT
    filling where the screen-space march found nothing."""
    h, w = gb.depth.shape
    v = m.noz(camera.position - gb.world_pos)
    n = gb.normal
    d = m.noz(2.0 * jnp.sum(n * v, -1, keepdims=True) * n - v)
    o = gb.world_pos + n * 1e-3

    active = gb.hit & (gb.roughness < max_roughness)
    o_f = o.reshape(-1, 3)
    d_f = d.reshape(-1, 3)
    res = bvh_mod.closest_hit(scene.bvh, o_f, d_f)
    hn, _, huv, hmat = bvh_mod.hit_attributes(scene.bvh, res)
    hp = o_f + d_f * res["t"][:, None]

    from .pathtracer import sample_albedo
    albedo = sample_albedo(scene.materials, hmat, huv)
    to_sun = m.noz(scene.sky.sun_direction)  # sun_direction points at the sun
    ndl = jnp.maximum(jnp.sum(hn * to_sun, -1), 0.0)
    shadowed = bvh_mod.any_hit(scene.bvh, hp + hn * 1e-3,
                               jnp.broadcast_to(to_sun, hp.shape), 1e4)
    sun = (scene.sky.sun_radiance * 0.05) * ndl[:, None] \
        * (~shadowed)[:, None] / jnp.pi
    up = jnp.clip(hn[:, 1:2] * 0.5 + 0.5, 0.0, 1.0)
    ambient = scene.sky.horizon * (1 - up) + scene.sky.zenith * up
    lit = albedo * (sun + ambient * 0.35) + scene.materials.emissive[hmat]

    sky = sky_radiance(scene.sky, d_f)
    radiance = jnp.where(res["hit"][:, None], lit, sky)
    radiance = radiance.reshape(h, w, 3)
    return jnp.where(active[..., None], radiance, 0.0), active


@struct.dataclass
class RendererSettings:
    """Live-tunable settings (reference: renderer_settings,
    main_renderer.h:28-64)."""

    # Primary visibility: "ray" (BVH primary rays) or "raster" (the
    # tile-binned 2DH rasterizer, ops/raster.py).  The reference rasterizes its depth
    # prepass in hardware (src/rendering/depth_prepass.h).
    primary: str = struct.field(pytree_node=False, default="ray")
    enable_ao: bool = struct.field(pytree_node=False, default=True)
    enable_sss: bool = struct.field(pytree_node=False, default=False)
    enable_ssr: bool = struct.field(pytree_node=False, default=True)
    enable_taa: bool = struct.field(pytree_node=False, default=True)
    enable_bloom: bool = struct.field(pytree_node=False, default=True)
    enable_sharpen: bool = struct.field(pytree_node=False, default=True)
    enable_shadows: bool = struct.field(pytree_node=False, default=True)
    enable_rt_reflections: bool = struct.field(pytree_node=False, default=False)
    # Run AO/SSS/SSR at half resolution with temporal accumulation and a
    # bilateral depth-aware upsample (the reference's default:
    # main_renderer.cpp:78,91).  False = full-res single-frame.
    half_res_effects: bool = struct.field(pytree_node=False, default=False)
    hbao: post.HBAOSettings = post.HBAOSettings()
    sss: post.SSSSettings = post.SSSSettings()
    ssr: post.SSRSettings = post.SSRSettings()
    taa: post.TAASettings = post.TAASettings()
    bloom: post.BloomSettings = post.BloomSettings(threshold=3.0, strength=0.3)
    sharpen: post.SharpenSettings = post.SharpenSettings()
    tonemap: post.TonemapSettings = post.TonemapSettings()
    ambient_strength: float = 0.35


@struct.dataclass
class FrameState:
    """Temporal resources carried between frames (reference: the renderer's
    history textures, main_renderer.h:218-255 — TAA color history plus
    half-res AO/SSS/SSR accumulation buffers)."""

    history: jnp.ndarray          # (H, W, 3) TAA history (pre-tonemap)
    frame_index: jnp.ndarray      # ()
    ao_history: jnp.ndarray = None    # (H/2, W/2)
    sss_history: jnp.ndarray = None   # (H/2, W/2)
    ssr_history: jnp.ndarray = None   # (H/2, W/2, 3)
    ssr_conf_history: jnp.ndarray = None  # (H/2, W/2)


def initial_frame_state(width: int, height: int) -> FrameState:
    h2, w2 = height // 2, width // 2
    return FrameState(
        history=jnp.zeros((height, width, 3)),
        frame_index=jnp.zeros((), jnp.int32),
        ao_history=jnp.ones((h2, w2)),
        sss_history=jnp.ones((h2, w2)),
        ssr_history=jnp.zeros((h2, w2, 3)),
        ssr_conf_history=jnp.zeros((h2, w2)),
    )


# ---------------------------------------------------------------------------
# Frame stages.  Module level with explicit arguments so the per-pass jits
# have STABLE function identity: frame 2+ hits the in-process jit cache
# instead of retracing (closures rebuilt per call would miss every frame).
# `settings`/width/height are static jit args (RendererSettings is a frozen
# hashable struct); everything frame-varying is a pytree argument.
# ---------------------------------------------------------------------------


def _pass_fn(static=("settings", "width", "height")):
    def deco(fn):
        fn._jit = jax.jit(fn, static_argnames=static)
        return fn
    return deco


def _half_ctx(gb, frame_state):
    vp_low = post.downsample2(gb.view_pos)
    n_low = m.noz(post.downsample2(gb.view_normal))
    depth_full = jnp.abs(gb.view_pos[..., 2])
    depth_low = jnp.abs(vp_low[..., 2])
    motion_low = post.downsample2(gb.motion) * 0.5
    first = (frame_state.frame_index == 0) if frame_state is not None \
        else None
    return vp_low, n_low, depth_full, depth_low, motion_low, first


@_pass_fn()
def _stage_gbuffer(scene, camera, prev_camera, decals, key, *, settings,
                   width, height):
    gb = render_gbuffer(scene, camera, width, height,
                        prev_camera=prev_camera, jitter_key=key,
                        primary=settings.primary)
    # Decal projection into the G-buffer (reference: tiled decal culling +
    # projection in the opaque pass).
    if decals is not None:
        from .decals import apply_decals
        gb = apply_decals(gb, decals)
    return gb


@_pass_fn()
def _stage_effects(scene, camera, shadow_maps, gb, frame_state, key, *,
                   settings, width, height):
    """Sun shadow term + AO + contact shadows.  Half-res path (reference
    default): compute at H/2 x W/2, temporally accumulate against the
    motion-reprojected history, then bilateral depth-aware upsample
    (main_renderer.cpp:78,91)."""
    half = settings.half_res_effects
    sun_dir = -scene.sky.sun_direction
    hist_updates = {}
    if settings.enable_shadows and shadow_maps is not None:
        lit, _ = sample_sun_shadow(shadow_maps, gb.world_pos)
    else:
        lit = jnp.ones((height, width))
    if half:
        (vp_low, n_low, depth_full, depth_low, motion_low,
         first) = _half_ctx(gb, frame_state)

    if settings.enable_ao:
        if half:
            ao_low = post.hbao(vp_low, n_low, settings.hbao, key=key)
            if frame_state is not None and frame_state.ao_history is not None:
                ao_low = post.temporal_accumulate(
                    ao_low, frame_state.ao_history, motion_low, first=first)
                hist_updates["ao_history"] = ao_low
            ao = post.bilateral_upsample(ao_low, depth_low, depth_full)
        else:
            ao = post.hbao(gb.view_pos, gb.view_normal, settings.hbao,
                           key=key)
    else:
        ao = jnp.ones((height, width))

    if settings.enable_sss:
        sun_view = m.quat_inv_rotate(camera.rotation, -sun_dir)
        if half:
            sss_low = post.screen_space_shadows(
                vp_low, sun_view, depth_low, settings.sss)
            if frame_state is not None and frame_state.sss_history is not None:
                sss_low = post.temporal_accumulate(
                    sss_low, frame_state.sss_history, motion_low, first=first)
                hist_updates["sss_history"] = sss_low
            sss = post.bilateral_upsample(sss_low, depth_low, depth_full)
        else:
            sss = post.screen_space_shadows(gb.view_pos, sun_view,
                                            gb.depth, settings.sss)
        lit = lit * sss
    return lit, ao, hist_updates


@_pass_fn()
def _stage_opaque(scene, camera, gb, lit, ao, point_lights,
                  point_shadow_maps, spot_lights, spot_shadow_maps,
                  probe_grid, *, settings, width, height):
    sun_dir = -scene.sky.sun_direction
    v = m.noz(camera.position - gb.world_pos)
    sun_l = -sun_dir
    f_sun = eval_brdf_pixel(gb.normal, v,
                            jnp.broadcast_to(sun_l, gb.normal.shape),
                            gb.albedo, gb.roughness, gb.metallic)
    sun_radiance = scene.sky.sun_radiance * 0.05  # disc -> irradiance
    color = f_sun * sun_radiance * lit[..., None]

    # Ambient: DDGI probe-grid irradiance when a grid is supplied
    # (reference: opaque-pass ambient sampling of the probe atlases,
    # main_renderer.cpp:917-925 + light_probe.hlsli); sky-tinted hemisphere
    # fallback otherwise (IBL path available via ibl.py).
    if probe_grid is not None:
        from .light_probe import sample_irradiance
        ambient = sample_irradiance(probe_grid, gb.world_pos, gb.normal)
    else:
        up = jnp.clip(gb.normal[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
        ambient = (scene.sky.horizon * (1 - up) + scene.sky.zenith * up)
    color = color + gb.albedo * ambient * settings.ambient_strength \
        * ao[..., None]
    color = color + gb.emissive

    if point_lights is not None:
        if point_shadow_maps is not None:
            # Shadow-casting point lights shade per light with dual-
            # hemisphere sampling (reference: point_shadow_info path).
            from .lights import shade_point_lights_shadowed
            color = color + shade_point_lights_shadowed(
                gb, point_lights, camera, point_shadow_maps)
        else:
            tile_lists, _ = cull_lights_tiled(gb.view_pos, point_lights,
                                              camera, width, height)
            color = color + shade_point_lights(gb, point_lights,
                                               tile_lists, camera)
    if spot_lights is not None:
        color = color + shade_spot_lights(gb, spot_lights, camera,
                                          shadow_maps=spot_shadow_maps)
    return color, ambient


@_pass_fn(static=("settings",))
def _stage_reflections(scene, camera, color, gb, frame_state, *, settings):
    """SSR resolve with RT rays filling SSR misses (reference: SSR |
    RT-reflections selection in main_renderer.cpp:439-470; here both can
    run — RT radiance replaces the reflection where the screen-space march
    found no confidence)."""
    half = settings.half_res_effects
    hist2 = {}
    rt_refl = None
    if settings.enable_rt_reflections:
        rt_refl, rt_mask = rt_reflections(scene, gb, camera)
    if settings.enable_ssr or rt_refl is not None:
        f0 = 0.04 * (1 - gb.metallic[..., None]) \
            + gb.albedo * gb.metallic[..., None]
        if settings.enable_ssr:
            if half:
                (vp_low, n_low, depth_full, depth_low, motion_low,
                 first) = _half_ctx(gb, frame_state)
                refl_low, conf_low = post.ssr(
                    post.downsample2(color), vp_low, n_low,
                    post.downsample2(gb.roughness), settings.ssr,
                    tan_half=math.tan(camera.v_fov * 0.5),
                    aspect=camera.aspect)
                if (frame_state is not None
                        and frame_state.ssr_history is not None):
                    refl_low = post.temporal_accumulate(
                        refl_low, frame_state.ssr_history, motion_low,
                        first=first)
                    conf_low = post.temporal_accumulate(
                        conf_low, frame_state.ssr_conf_history,
                        motion_low, first=first)
                    hist2["ssr_history"] = refl_low
                    hist2["ssr_conf_history"] = conf_low
                refl = post.bilateral_upsample(refl_low, depth_low,
                                               depth_full)
                conf = post.bilateral_upsample(conf_low, depth_low,
                                               depth_full)
            else:
                refl, conf = post.ssr(color, gb.view_pos, gb.view_normal,
                                      gb.roughness, settings.ssr,
                                      tan_half=math.tan(camera.v_fov * 0.5),
                                      aspect=camera.aspect)
        else:
            refl = jnp.zeros_like(color)
            conf = jnp.zeros(color.shape[:-1])
        if rt_refl is not None:
            refl = refl * conf[..., None] \
                + rt_refl * (1.0 - conf[..., None]) * rt_mask[..., None]
            color = color + refl * f0
        else:
            color = color + refl * conf[..., None] * f0
    return color, rt_refl, hist2


@_pass_fn()
def _stage_compose(scene, camera, color, gb, transparent_objects,
                   water_height, time, *, settings, width, height):
    """Sky for misses, then transparent pass + water (reference:
    transparent_render_pass, render_pass.h:100 — depth-keyed sort after
    opaque, before TAA)."""
    d = m.noz(gb.world_pos - camera.position)
    sky = sky_radiance(scene.sky, d.reshape(-1, 3)).reshape(height, width, 3)
    color = jnp.where(gb.hit[..., None], color, sky)
    if transparent_objects:
        from .transparent import transparent_pass
        color = transparent_pass(color, gb, camera, transparent_objects,
                                 sky=scene.sky)
    if water_height is not None:
        from .water_pass import water_pass
        color = water_pass(color, gb, camera, scene.sky,
                           water_height=water_height, time=time)
    return color


@_pass_fn(static=("settings",))
def _stage_taa(color, gb, frame_state, hist_updates, *, settings):
    if frame_state is None:
        return color, frame_state
    first_frame = frame_state.frame_index == 0
    if settings.enable_taa:
        blended = post.taa(color, frame_state.history, gb.motion,
                           settings.taa)
        color = jnp.where(first_frame, color, blended)
    new_state = frame_state.replace(
        history=color, frame_index=frame_state.frame_index + 1,
        **hist_updates)
    return color, new_state


@_pass_fn(static=("settings",))
def _stage_post(color, *, settings):
    if settings.enable_bloom:
        color = post.bloom(color, settings.bloom)
    ldr = post.tonemap_uncharted2(color, settings.tonemap)
    if settings.enable_sharpen:
        ldr = post.sharpen(ldr, settings.sharpen)
    return ldr


# ---------------------------------------------------------------------------
# Grouped dispatch: three module-level programs instead of ~8 per-pass ones.
# Fewer dispatch boundaries than per-pass, smaller modules than the fused
# frame.  Numerically identical to the other modes (parity-tested).
# ---------------------------------------------------------------------------


@_pass_fn()
def _group_geometry(scene, camera, prev_camera, decals, key, shadow_maps,
                    frame_state, *, settings, width, height):
    gb = _stage_gbuffer(scene, camera, prev_camera, decals, key,
                        settings=settings, width=width, height=height)
    lit, ao, hist_updates = _stage_effects(
        scene, camera, shadow_maps, gb, frame_state, key,
        settings=settings, width=width, height=height)
    return gb, lit, ao, hist_updates


@_pass_fn()
def _group_shading(scene, camera, gb, lit, ao, point_lights,
                   point_shadow_maps, spot_lights, spot_shadow_maps,
                   probe_grid, frame_state, transparent_objects,
                   water_height, time, *, settings, width, height):
    color, ambient = _stage_opaque(
        scene, camera, gb, lit, ao, point_lights, point_shadow_maps,
        spot_lights, spot_shadow_maps, probe_grid,
        settings=settings, width=width, height=height)
    color, rt_refl, hist2 = _stage_reflections(
        scene, camera, color, gb, frame_state, settings=settings)
    color = _stage_compose(
        scene, camera, color, gb, transparent_objects, water_height, time,
        settings=settings, width=width, height=height)
    return color, ambient, rt_refl, hist2


@_pass_fn(static=("settings",))
def _group_resolve(color, gb, frame_state, hist_updates, *, settings):
    color, new_state = _stage_taa(color, gb, frame_state, hist_updates,
                                  settings=settings)
    ldr = _stage_post(color, settings=settings)
    return ldr, new_state, color


def render_frame(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    settings: RendererSettings = RendererSettings(),
    point_lights: Optional[PointLights] = None,
    spot_lights: Optional[SpotLights] = None,
    shadow_maps: Optional[SunShadowMaps] = None,
    spot_shadow_maps=None,
    point_shadow_maps=None,
    frame_state: Optional[FrameState] = None,
    prev_camera: Optional[Camera] = None,
    probe_grid=None,
    transparent_objects=None,
    decals=None,
    water_height=None,
    time=0.0,
    key=None,
    dispatch: str = "fused",
    profile_stages: bool = False,
):
    """One rasterized-mode frame.  Returns (ldr_image, new_frame_state, aux).

    aux exposes intermediate targets for inspection like the reference editor
    panels (editor.h:45-51): ao, shadow, ssr confidence, gbuffer.

    The frame is organized as stages with optimization_barrier fences at
    their seams (the analog of the reference's per-pass resource barriers,
    dx_barrier_batcher.h:9, and its multi-command-list frame,
    main_renderer.cpp:876-901).  ``dispatch``:

    - "fused" (default): one traced program — call under your own jax.jit.
      Lowest per-frame overhead; XLA fuses within each fenced stage.
    - "per_pass": each stage runs as its OWN jit dispatch.  Call WITHOUT an
      outer jit.  Several small modules instead of one frame-sized one, at
      one dispatch per stage.
    - "grouped": three module-level programs (geometry+effects / shading /
      resolve).  Call WITHOUT an outer jit.  Fewer dispatch boundaries than
      per_pass, smaller modules than fused — numerically identical to
      both."""
    if dispatch == "grouped":
        times = {} if profile_stages else None

        def timed(name, fn, *a, **kw):
            if times is None:
                return fn(*a, **kw)
            t0 = _perf_counter()
            out = fn(*a, **kw)
            jax.block_until_ready(out)
            times[name] = times.get(name, 0.0) + _perf_counter() - t0
            return out

        time = jnp.asarray(time, jnp.float32)
        gb, lit, ao, hist_updates = timed(
            "geometry", _group_geometry._jit,
            scene, camera, prev_camera, decals, key, shadow_maps,
            frame_state, settings=settings, width=width, height=height)
        color, ambient, rt_refl, hist2 = timed(
            "shading", _group_shading._jit,
            scene, camera, gb, lit, ao, point_lights, point_shadow_maps,
            spot_lights, spot_shadow_maps, probe_grid, frame_state,
            transparent_objects, water_height, time,
            settings=settings, width=width, height=height)
        hist_updates = dict(hist_updates)
        hist_updates.update(hist2)
        ldr, new_state, hdr = timed(
            "resolve", _group_resolve._jit,
            color, gb, frame_state, hist_updates, settings=settings)
        aux = {"ao": ao, "shadow": lit, "gbuffer": gb, "ambient": ambient,
               "hdr": hdr}
        if rt_refl is not None:
            aux["rt_reflections"] = rt_refl
        if times is not None:
            aux["stage_seconds"] = times
        return ldr, new_state, aux

    per_pass = dispatch == "per_pass"
    # Stage seams need a fence only inside ONE traced program (the fused
    # path), where it pins the pass boundaries the way the reference's
    # resource barriers do.  In per_pass mode every stage is already its own
    # compiled module — an eager optimization_barrier there is a real extra
    # device dispatch per seam, so skip it.
    fence = (lambda x: x) if per_pass else jax.lax.optimization_barrier
    stage_times = {} if (per_pass and profile_stages) else None

    def _run(fn, *args, **static_kw):
        """Run a stage inline (fused: one traced program) or as its own jit
        dispatch (per_pass).  Stages are module-level functions, so the
        per-pass jit cache is hit on every frame after the first."""
        if per_pass:
            if stage_times is not None:
                import time as _time
                t0 = _time.perf_counter()
                out = fn._jit(*args, **static_kw)
                jax.block_until_ready(out)
                name = fn.__name__.replace("_stage_", "")
                stage_times[name] = (stage_times.get(name, 0.0)
                                     + _time.perf_counter() - t0)
                return out
            return fn._jit(*args, **static_kw)
        return fn(*args, **static_kw)

    time = jnp.asarray(time, jnp.float32)
    gb = fence(_run(_stage_gbuffer, scene, camera, prev_camera, decals, key,
                    settings=settings, width=width, height=height))
    lit, ao, hist_updates = _run(
        _stage_effects, scene, camera, shadow_maps, gb, frame_state, key,
        settings=settings, width=width, height=height)
    lit, ao = fence((lit, ao))
    color, ambient = _run(
        _stage_opaque, scene, camera, gb, lit, ao, point_lights,
        point_shadow_maps, spot_lights, spot_shadow_maps, probe_grid,
        settings=settings, width=width, height=height)
    color = fence(color)
    color, rt_refl, hist2 = _run(
        _stage_reflections, scene, camera, color, gb, frame_state,
        settings=settings)
    hist_updates.update(hist2)
    color = fence(color)
    color = fence(_run(
        _stage_compose, scene, camera, color, gb, transparent_objects,
        water_height, time, settings=settings, width=width, height=height))
    color, new_state = _run(_stage_taa, color, gb, frame_state, hist_updates,
                            settings=settings)
    color = fence(color)
    ldr = _run(_stage_post, color, settings=settings)

    # "hdr" is the pre-tonemap radiance buffer (the reference's HDR16F
    # intermediate, src/rendering/render_utils.h) — dump via
    # assets.image_io.save_exr for post-stack debugging.
    aux = {"ao": ao, "shadow": lit, "gbuffer": gb, "ambient": ambient,
           "hdr": color}
    if rt_refl is not None:
        aux["rt_reflections"] = rt_refl
    if stage_times is not None:
        jax.block_until_ready(ldr)
        aux["stage_seconds"] = stage_times
    return ldr, new_state, aux


def render_frame_with_shadows(scene: Scene, camera: Camera, width, height,
                              settings: RendererSettings = RendererSettings(),
                              shadow_resolution=512, **kw):
    """Convenience: fit + render cascades, then the frame."""
    if kw.get("dispatch") in ("per_pass", "grouped"):
        # Own dispatch for the cascade fit + renders, mirroring the
        # per-stage split inside render_frame (stable jit identity: frame 2+
        # reuses the compiled program).  fit_cascades MUST be jitted here:
        # eagerly it is ~30 tiny device ops, each a host round-trip.
        t0 = _perf_counter() if kw.get("profile_stages") else None
        maps = _fit_cascades_jit(camera.position, scene.sky.sun_direction)
        maps = _render_sun_shadow_maps_jit(scene.bvh, maps,
                                           resolution=shadow_resolution)
        if t0 is not None:
            jax.block_until_ready(maps)
            shadow_s = _perf_counter() - t0
            out = render_frame(scene, camera, width, height, settings,
                               shadow_maps=maps, **kw)
            out[2].setdefault("stage_seconds", {})["shadows"] = shadow_s
            return out
    else:
        maps = fit_cascades(camera.position, -scene.sky.sun_direction)
        maps = render_sun_shadow_maps(scene.bvh, maps,
                                      resolution=shadow_resolution)
    return render_frame(scene, camera, width, height, settings,
                        shadow_maps=maps, **kw)


_fit_cascades_jit = jax.jit(lambda pos, sun: fit_cascades(pos, -sun))
_render_sun_shadow_maps_jit = jax.jit(
    render_sun_shadow_maps, static_argnames=("resolution", "max_steps"))


CASCADE_COLORS = jnp.array([
    [1.0, 0.3, 0.3], [0.3, 1.0, 0.3], [0.3, 0.3, 1.0], [1.0, 1.0, 0.3],
])


def render_mode(scene: Scene, camera: Camera, width: int, height: int,
                mode: str = "rasterized", settings=None, spp: int = 8,
                key=None, **kw):
    """The renderer's three modes (reference: main_renderer.h:83-90 —
    rasterized / visualize_sun_shadow_cascades / path_traced)."""
    if mode == "rasterized":
        return render_frame_with_shadows(
            scene, camera, width, height, settings or RendererSettings(),
            key=key, **kw)[0]
    if mode == "path_traced":
        from .pathtracer import PathTracerSettings, render, tonemap_filmic

        img = render(scene, camera, width, height,
                     settings or PathTracerSettings(), spp=spp, key=key)
        return tonemap_filmic(img)
    if mode == "visualize_cascades":
        from .gbuffer import render_gbuffer

        gb = render_gbuffer(scene, camera, width, height)
        maps = fit_cascades(camera.position, -scene.sky.sun_direction)
        maps = render_sun_shadow_maps(scene.bvh, maps, resolution=256)
        lit, cascade = sample_sun_shadow(maps, gb.world_pos)
        tint = CASCADE_COLORS[jnp.clip(cascade, 0, 3)]
        base = gb.albedo * lit[..., None]
        out = jnp.where((cascade >= 0)[..., None], base * 0.4 + tint * 0.6,
                        base)
        return jnp.where(gb.hit[..., None], out, 0.0)
    raise ValueError(f"unknown renderer mode {mode!r}")
