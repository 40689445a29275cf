"""Animated flythrough: physics running UNDER the raster pipeline while an
orbiting camera films it — the closest offline analogue of the reference's
interactive 1920x1080 editor session (src/main.cpp:121: update loop stepping
physics + rendering every frame).

Per frame, fully on device: physics step -> instance retransform (the
per-frame TLAS rebuild, render/instances.py) -> full raster frame (shadows,
tiled lights, AO, SSR, TAA with a MOVING camera via prev_camera motion
vectors, bloom, tonemap).  Writes an animated GIF + reports ms/frame.

Usage: python examples/flythrough.py [--size 256] [--frames 48]
                                     [--out flythrough.gif]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math
import time

parser = argparse.ArgumentParser()
parser.add_argument("--size", type=int, default=256)
parser.add_argument("--frames", type=int, default=48)
parser.add_argument("--out", default="flythrough.gif")
parser.add_argument("--dispatch", default="fused",
                    choices=["fused", "per_pass", "grouped"])
args = parser.parse_args()

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.physics import builder, step as pstep
from d3d12renderer_jax.physics.types import PhysicsSettings
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.instances import build_instanced, retransform
from d3d12renderer_jax.render.lights import make_point_lights
from d3d12renderer_jax.render.pathtracer import Materials, Scene, default_sky
from d3d12renderer_jax.render.pipeline import (
    RendererSettings, initial_frame_state, render_frame_with_shadows,
)

# --- physics: a pile of boxes + spheres tumbling onto the ground ------------
b = builder.SceneBuilder()
b.add_static_plane((0, 1, 0), 0.0, friction=0.8)
rng = np.random.default_rng(4)
kinds = []
for i in range(18):
    kind = "box" if i % 3 else "sphere"
    pos = (float(rng.uniform(-1.6, 1.6)), 1.2 + 0.75 * i,
           float(rng.uniform(-1.6, 1.6)))
    body = b.add_body(position=pos)
    if kind == "box":
        b.add_box_collider(body, (0.35, 0.35, 0.35), friction=0.7)
    else:
        b.add_sphere_collider(body, radius=0.33, restitution=0.35)
    kinds.append(kind)
arch, state = b.finalize()
settings_p = PhysicsSettings()

# --- render geometry: per-mesh soups packed once (BLAS), posed per frame ----
box_mesh = mesh_mod.box((0.35, 0.35, 0.35))
sph_mesh = mesh_mod.ico_sphere(0.33, 2)
ground = mesh_mod.quad(half=12.0)
meshes = [(box_mesh, 1), (sph_mesh, 2), (ground, 0)]
instance_mesh = [0 if k == "box" else 1 for k in kinds] + [2]
iscene = build_instanced(meshes, instance_mesh)
mats = Materials(
    albedo=jnp.array([[0.45, 0.45, 0.45], [0.75, 0.22, 0.16],
                      [0.2, 0.38, 0.8]]),
    emissive=jnp.zeros((3, 3)),
    roughness=jnp.array([0.75, 0.45, 0.25]),
    metallic=jnp.array([0.0, 0.0, 0.0]),
)
sky = default_sky()
lights = make_point_lights([[3.0, 2.5, 3.0]], [[30.0, 12.0, 6.0]], [9.0])
W = H = args.size
static_pose = (jnp.zeros((1, 3)), jnp.array([[0.0, 0.0, 0.0, 1.0]]))


@jax.jit
def advance(state):
    """One display frame of physics (two 120 Hz substeps) + the TLAS-style
    instance retransform — one dispatch, no host round trips."""
    state, _ = pstep.physics_step(arch, state, settings_p, 1 / 60.0, 2)
    pos = jnp.concatenate([state.pos, static_pose[0]])
    rot = jnp.concatenate([state.rot, static_pose[1]])
    return state, retransform(iscene, pos, rot)


def camera_at(f):
    t = f / max(args.frames, 1)
    th = 2 * math.pi * t
    eye = (6.5 * math.cos(th), 2.6 + 1.2 * math.sin(2 * th),
           6.5 * math.sin(th))
    return look_at(eye=eye, target=(0.0, 0.9, 0.0), aspect=W / H,
                   v_fov=math.radians(48))


if args.dispatch == "fused":
    _render = jax.jit(lambda scene, cam, prev, st, k: render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(), shadow_resolution=256,
        point_lights=lights, frame_state=st, prev_camera=prev, key=k))
else:
    _render = lambda scene, cam, prev, st, k: render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(), shadow_resolution=256,
        point_lights=lights, frame_state=st, prev_camera=prev, key=k,
        dispatch=args.dispatch)

fstate = initial_frame_state(W, H)
frames = []
prev_cam = None
t_compile = t_steady = 0.0
for f in range(args.frames):
    t0 = time.time()
    state, bvh = advance(state)
    cam = camera_at(f)
    scene = Scene(bvh=bvh, materials=mats, sky=sky)
    # prev=cam on frame 0 (zero motion) keeps the jit signature stable.
    ldr, fstate, _ = _render(scene, cam, prev_cam or cam, fstate,
                             jax.random.PRNGKey(f))
    ldr.block_until_ready()
    prev_cam = cam
    dt = time.time() - t0
    if f == 0:
        t_compile = dt
    else:
        t_steady += dt
    frames.append(np.asarray((jnp.clip(ldr, 0, 1) * 255).astype(jnp.uint8)))

ms = t_steady / max(args.frames - 1, 1) * 1000
print(f"compile+frame0: {t_compile:.1f}s; steady: {ms:.0f} ms/frame "
      f"({W}x{H}, {args.frames} frames, dispatch={args.dispatch})")

from PIL import Image

imgs = [Image.fromarray(fr) for fr in frames]
imgs[0].save(args.out, save_all=True, append_images=imgs[1:], duration=50,
             loop=0)
heights = np.asarray(state.pos)[:, 1]
print(f"wrote {args.out}; final body heights "
      f"min {heights.min():.2f} / max {heights.max():.2f}")
