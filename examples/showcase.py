"""The "everything on" demo frame — the Sponza-equivalent default scene
(reference: src/application.cpp:106+ builds terrain + water + grass + trees +
physics objects + lights; this composes every subsystem into ONE frame):

  terrain (LOD chunks + splat texture) · water · grass · trees ·
  physics-settled boxes/spheres · sun CSM + spot + point shadows from one
  atlas · DDGI probe ambient · RT reflections blended with SSR · decals ·
  a transparent glass slab · GPU-style fire particles splatted additively ·
  half-res temporal AO · TAA · bloom · tonemap · sharpen.

Usage: python examples/showcase.py [--size 256]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math
import os
import time

parser = argparse.ArgumentParser()
parser.add_argument("--size", type=int, default=256)
parser.add_argument("--out", default="showcase.png")
parser.add_argument("--physics-steps", type=int, default=180)
parser.add_argument("--dispatch", default="fused", choices=["fused", "per_pass", "grouped"])
parser.add_argument("--audio", default=None, metavar="OUT.WAV",
                    help="mix collision-impact sounds from the physics "
                         "settle into a stereo WAV")
parser.add_argument("--envmap", default=None,
                    help="HDR equirect .hdr/.exr for the textured sky; "
                         "'procedural' for the gradient sky; default: the "
                         "committed examples/data/studio.hdr")
args = parser.parse_args()

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings
from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.decals import make_decals
from d3d12renderer_jax.render.light_probe import (
    create_probe_grid, update_probes,
)
from d3d12renderer_jax.render.lights import SpotLights, make_point_lights
from d3d12renderer_jax.render.pathtracer import Materials, Scene, default_sky
from d3d12renderer_jax.render.pipeline import (
    RendererSettings, initial_frame_state, render_frame,
)
from d3d12renderer_jax.render.shadows import ShadowAtlas
from d3d12renderer_jax.render.transparent import TransparentObject
from d3d12renderer_jax.particles import systems as psys
from d3d12renderer_jax.terrain.grass import (
    generate_grass_blades, grass_lod_triangles,
)
from d3d12renderer_jax.terrain.placement import (
    generate_placement_layers, instantiate_placement,
)
from d3d12renderer_jax.terrain.heightmap import (
    generate_heightmap, sample_height_bilinear, shade_splat, splat_weights,
    terrain_lod_chunks,
)

SIZE = args.size
WORLD = 48.0
RES = 65
CELL = WORLD / (RES - 1)
ORIGIN = (-WORLD / 2, 0.0, -WORLD / 2)

t_start = time.time()

# --- terrain ---------------------------------------------------------------
heights = generate_heightmap(resolution=RES, world_size=WORLD, amplitude=5.0,
                             noise_scale=0.06, seed=7)
heights_np = np.asarray(heights)
cam_pos = (0.0, 7.5, -16.0)
chunks = terrain_lod_chunks(heights_np, ORIGIN, CELL, chunk_cells=16,
                            camera_pos=cam_pos)
splat = shade_splat(splat_weights(heights, CELL),
                    [[0.20, 0.42, 0.12], [0.38, 0.35, 0.33],
                     [0.88, 0.88, 0.92]])
splat_tex = jnp.asarray(np.asarray(splat), jnp.float32)

def sample_h(x, z):
    h, _ = sample_height_bilinear(heights, ORIGIN, CELL, jnp.asarray(x),
                                  jnp.asarray(z))
    return float(h)

# --- physics: drop boxes and spheres onto the terrain -----------------------
pb = SceneBuilder()
pb.add_terrain(heights_np, origin=ORIGIN, cell_size=CELL, friction=0.7)
rng = np.random.default_rng(0)
phys_shapes = []
for i in range(6):
    x, z = rng.uniform(-6, 6, 2)
    body = pb.add_body(position=(x, sample_h(x, z) + 3.0 + i * 0.5, z))
    if i % 2 == 0:
        pb.add_box_collider(body, (0.45, 0.45, 0.45), friction=0.7)
        phys_shapes.append(("box", body))
    else:
        pb.add_sphere_collider(body, 0.45, friction=0.7)
        phys_shapes.append(("sphere", body))
arch, pstate = pb.finalize()
settings_p = PhysicsSettings()
impacts = []            # (time, position, speed) from collision-begin events
if args.audio:
    # Per-substep collision events (reference: per-internal-step collision
    # callbacks with contact velocity, physics.cpp:1037).
    step_ev = jax.jit(lambda s, pa: physics_step(
        arch, s, settings_p, 1 / 60, num_substeps=2,
        collect_events=True, prev_active=pa))
    prev_active = None
    for f in range(args.physics_steps):
        pstate, contacts, ev = step_ev(pstate, prev_active)
        prev_active = ev.active
        begin = np.asarray(ev.begin)
        if begin.any():
            speeds = np.asarray(ev.approach_speed)[begin]
            pts = np.asarray(contacts.point[:, 0])[begin]
            for p, s in zip(pts, speeds):
                if s > 0.8:
                    impacts.append((f / 60.0, tuple(map(float, p)), float(s)))
else:
    step = jax.jit(lambda s: physics_step(arch, s, settings_p, 1 / 60,
                                          num_substeps=2)[0])
    for _ in range(args.physics_steps):
        pstate = step(pstate)
pstate = jax.device_get(pstate)

if args.audio:
    # Collision-begin events -> 3D impact sounds -> offline WAV mixdown
    # (reference: impact-sound callbacks, application.cpp:231-240).
    from d3d12renderer_jax.audio.audio import AudioEngine, impact_synth
    from d3d12renderer_jax.audio.mixdown import mixdown, write_wav

    eng = AudioEngine()
    eng.set_listener(cam_pos, forward=(0, -0.25, 1))
    eng.set_reverb("mountains")
    t_prev = 0.0
    for i, (t, p, s) in enumerate(impacts):
        eng.advance(t - t_prev)
        t_prev = t
        eng.play_synth(impact_synth(s, seed=i), "sfx",
                       volume=min(1.0, 0.25 + s / 10.0), position=p)
    dur = args.physics_steps / 60.0 + 0.5
    write_wav(args.audio, mixdown(eng, dur))
    print(f"audio: {len(impacts)} impact events -> {args.audio} "
          f"({dur:.1f}s)")
print(f"physics settled ({args.physics_steps} frames): "
      f"heights {np.asarray(pstate.pos)[:, 1].round(2)}")

# --- compose render meshes ---------------------------------------------------
meshes = []            # (MeshData, material_id)
MAT_TERRAIN = 0
for mesh, lod, _ in chunks:
    meshes.append((mesh, MAT_TERRAIN))

# Trees: trunk + canopy through the procedural-placement layer pipeline
# (reference placement layers, src/terrain/proc_placement.h:13-36): height/
# slope masks keep trees off the peaks, yaw + scale vary per instance.
tree_layer = generate_placement_layers(
    heights, ORIGIN, CELL, WORLD, jax.random.PRNGKey(11),
    [dict(max_height=3.4, max_slope_y=0.65, density=0.055,
          scale_range=(0.85, 1.2))],
    points_per_side=12,
)[0]
print(f"placement: {int(tree_layer['count'])} trees")
trunk_proto = mesh_mod.cylinder(0.18, 1.2, slices=8).transformed(
    translate=(0.0, 1.2, 0.0))
canopy_proto = mesh_mod.ico_sphere(1.0, 1).transformed(
    translate=(0.0, 2.8, 0.0))
meshes += instantiate_placement(tree_layer, [trunk_proto],
                                material_ids=[2], max_instances=8)
meshes += instantiate_placement(tree_layer, [canopy_proto],
                                material_ids=[3], max_instances=8)

# Grass blades: per-chunk frustum culling + distance LOD (reference grass
# chunk pipeline, src/terrain/grass.h:21-39) — culled/far blades collapse to
# zero-area triangles, so shapes stay fixed.
blades = generate_grass_blades(heights, ORIGIN, CELL, WORLD,
                               jax.random.PRNGKey(3), blades_per_side=28,
                               density=0.6)
grass_cam = look_at(eye=cam_pos, target=(0.0, 1.5, 0.0), aspect=1.0,
                    v_fov=math.radians(50))
gverts, gtris, gstats = grass_lod_triangles(
    blades, grass_cam, ORIGIN, WORLD, time=0.4, lod_distance=18.0)
print(f"grass: {int(gstats['visible_blades'])} visible blades in "
      f"{int(gstats['visible_chunks'])} chunks "
      f"(LOD0 {int(gstats['lod0_blades'])} / LOD1 {int(gstats['lod1_blades'])})")
g_mesh = mesh_mod.MeshData(
    positions=np.asarray(gverts, np.float32),
    normals=np.tile(np.array([[0, 1, 0]], np.float32), (len(gverts), 1)),
    uvs=np.zeros((len(gverts), 2), np.float32),
    indices=np.asarray(gtris, np.int32),
)
meshes.append((g_mesh, 4))

# Physics-settled objects.
for (kind, body), pos, rot in zip(phys_shapes, np.asarray(pstate.pos),
                                  np.asarray(pstate.rot)):
    if kind == "box":
        mesh = mesh_mod.box((0.45, 0.45, 0.45)).transformed(
            translate=tuple(pos), rotate=tuple(rot))
        meshes.append((mesh, 5))
    else:
        mesh = mesh_mod.ico_sphere(0.45, 2).transformed(translate=tuple(pos))
        meshes.append((mesh, 6))

scene_bvh = bvh_mod.build_bvh(meshes)
print(f"scene: {int(np.asarray(scene_bvh.tri_valid).sum())} triangles, "
      f"{len(meshes)} meshes, {len(chunks)} terrain LOD chunks")

mats = Materials(
    albedo=jnp.array([
        [1.0, 1.0, 1.0],      # 0 terrain (tinted by splat texture)
        [0.5, 0.5, 0.5],      # 1 unused
        [0.45, 0.3, 0.18],    # 2 trunk
        [0.15, 0.4, 0.12],    # 3 canopy
        [0.25, 0.5, 0.15],    # 4 grass
        [0.7, 0.25, 0.2],     # 5 boxes
        [0.9, 0.9, 0.95],     # 6 spheres (metal)
    ]),
    emissive=jnp.zeros((7, 3)),
    roughness=jnp.array([0.9, 0.5, 0.8, 0.7, 0.6, 0.5, 0.15]),
    metallic=jnp.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]),
    texture_atlas=splat_tex[None],
    albedo_texture=jnp.array([0, -1, -1, -1, -1, -1, -1], jnp.int32),
)
# Textured HDR sky: a real .hdr environment map (RGBE, committed under
# examples/data/) decoded through the float image cache and projected to a
# cubemap (reference: textured sky + pbr_environment.h:19 IBL chain).
sky = default_sky()
if args.envmap != "procedural":
    from d3d12renderer_jax.assets.cache import load_image_cached
    from d3d12renderer_jax.assets.envmap import (
        DEFAULT_SUN, ensure_demo_envmap,
    )
    from d3d12renderer_jax.render.ibl import equirect_to_cubemap

    envmap_path = args.envmap or ensure_demo_envmap(
        os.path.join(os.path.dirname(__file__), "data", "studio.hdr"))
    env_mips, env_cached = load_image_cached(envmap_path)
    env = jnp.asarray(env_mips[0])
    sun_d = np.asarray(DEFAULT_SUN) / np.linalg.norm(DEFAULT_SUN)
    sky = sky.replace(cubemap=equirect_to_cubemap(env, 128),
                      sun_direction=jnp.asarray(sun_d, jnp.float32))
    print(f"HDR envmap: {envmap_path} {env.shape[0]}x{env.shape[1]} "
          f"(max radiance {float(env.max()):.0f}, cached={env_cached})")
scene = Scene(bvh=scene_bvh, materials=mats, sky=sky)
cam = look_at(eye=cam_pos, target=(0.0, 1.5, 0.0), aspect=1.0,
              v_fov=math.radians(50))

# --- shadows: sun CSM + spot + point from ONE atlas --------------------------
atlas = ShadowAtlas(size=4096)
sun_maps = atlas.update_sun(scene_bvh, jnp.asarray(cam_pos),
                            -scene.sky.sun_direction, resolution=384)
spot_pos, spot_dir = (5.0, 9.0, -4.0), (-0.4, -0.85, 0.35)
smap = atlas.update_spot(scene_bvh, 0, spot_pos, spot_dir, 0.65, 28.0,
                         resolution=256)
ppos = (-4.0, sample_h(-4.0, 2.0) + 2.5, 2.0)
pmap = atlas.update_point(scene_bvh, 0, ppos, 16.0, resolution=192)
print(f"shadow atlas: {len(atlas.viewports)} viewports, "
      f"{atlas.cache.misses} rendered")

points = make_point_lights([ppos], [(30.0, 22.0, 12.0)], [16.0])
spots = SpotLights(
    position=jnp.array([spot_pos]),
    direction=jnp.asarray(np.array([spot_dir]) / np.linalg.norm(spot_dir)),
    color=jnp.array([[45.0, 42.0, 38.0]]),
    distance=jnp.array([28.0]), inner_cos=jnp.array([0.85]),
    outer_cos=jnp.array([0.65]), valid=jnp.array([True]),
)

# --- DDGI probes -------------------------------------------------------------
grid = create_probe_grid(origin=(-12.0, 0.5, -12.0), extent=(24.0, 8.0, 24.0),
                         dims=(5, 3, 5))
for i in range(2):
    grid = update_probes(grid, scene, jax.random.PRNGKey(40 + i),
                         rays_per_probe=32)

# --- decals ------------------------------------------------------------------
y0 = sample_h(2.0, -3.0)
decals = make_decals(
    positions=[(2.0, y0, -3.0)],
    rotations=[(0.7071, 0.0, 0.0, 0.7071)],   # project straight down
    half_extents=[(1.2, 1.2, 2.0)],
    albedos=[(0.05, 0.05, 0.06)],             # scorch mark
)

# --- transparent glass slab ---------------------------------------------------
gx, gz = 3.0, 3.0
glass = TransparentObject(
    bvh=bvh_mod.build_bvh([(mesh_mod.box((1.2, 1.0, 0.08)).transformed(
        translate=(gx, sample_h(gx, gz) + 1.2, gz)), 0)]),
    color=(0.5, 0.8, 0.7), alpha=0.35)

# --- fire particles (simulated, then splatted additively) ---------------------
fire_origin = (-2.0, sample_h(-2.0, -2.0) + 0.2, -2.0)
fire = psys.make_fire_system(origin=fire_origin, capacity=256)
pp_state = fire["create"](jax.random.PRNGKey(9))
sim = jax.jit(lambda s: fire["step"](s, 1 / 60.0))
for _ in range(45):
    pp_state = sim(pp_state)


def splat_particles(img, camera, positions, alive, color, radius_px=2):
    """Additive screen splats — the GPU particle composite (reference:
    particle billboards with additive blend)."""
    from d3d12renderer_jax.core import maths as m

    h, w, _ = img.shape
    view = m.quat_inv_rotate(camera.rotation[None],
                             positions - camera.position)
    z = jnp.maximum(-view[:, 2], 1e-3)       # camera looks down -Z
    half_h = jnp.tan(camera.v_fov / 2)
    u = (view[:, 0] / (z * half_h * camera.aspect)) * 0.5 + 0.5
    v = (-view[:, 1] / (z * half_h)) * 0.5 + 0.5
    px = jnp.clip((u * (w - 1)).astype(jnp.int32), 0, w - 1)
    py = jnp.clip((v * (h - 1)).astype(jnp.int32), 0, h - 1)
    ok = alive & (-view[:, 2] > 0.1) & (u > 0) & (u < 1) & (v > 0) & (v < 1)
    out = img
    for dy in range(-radius_px, radius_px + 1):
        for dx in range(-radius_px, radius_px + 1):
            yy = jnp.clip(py + dy, 0, h - 1)
            xx = jnp.clip(px + dx, 0, w - 1)
            out = out.at[yy, xx].add(
                jnp.where(ok[:, None], color, 0.0) * 0.5)
    return out


# --- the frame ----------------------------------------------------------------
rs = RendererSettings(enable_sss=True, enable_rt_reflections=True,
                      half_res_effects=True)
fs = initial_frame_state(SIZE, SIZE)
water_h = 0.9

_frame = lambda st, key, dispatch: render_frame(
    scene, cam, SIZE, SIZE, rs,
    point_lights=points, spot_lights=spots,
    shadow_maps=sun_maps, spot_shadow_maps=[smap], point_shadow_maps=[pmap],
    probe_grid=grid, transparent_objects=[glass], decals=decals,
    water_height=water_h, frame_state=st, key=key, dispatch=dispatch)
if args.dispatch in ("per_pass", "grouped"):
    fn = lambda st, key: _frame(st, key, args.dispatch)
else:
    fn = jax.jit(lambda st, key: _frame(st, key, "fused"))

t0 = time.time()
ldr, fs, aux = fn(fs, jax.random.PRNGKey(0))
ldr.block_until_ready()
print(f"frame compile+run: {time.time() - t0:.1f}s")
for i in range(1, 3):
    t0 = time.time()
    ldr, fs, aux = fn(fs, jax.random.PRNGKey(i))
    ldr.block_until_ready()
print(f"steady frame: {(time.time() - t0) * 1e3:.0f} ms")

# Particles composite after tonemap (emissive overlay).
ldr = splat_particles(ldr, cam, pp_state.position, pp_state.alive,
                      jnp.array([1.0, 0.45, 0.1]))

from PIL import Image

arr = np.asarray((jnp.clip(ldr, 0, 1) * 255).astype(jnp.uint8))
Image.fromarray(arr).save(args.out)
print(f"wrote {args.out}; total {time.time() - t_start:.0f}s; "
      f"mean luma {arr.mean():.1f}; particles alive "
      f"{int(np.asarray(pp_state.alive).sum())}")
