"""Render one frame through the full raster-equivalent pipeline
(G-buffer, CSM shadows, tiled lights, HBAO, SSR, TAA, bloom, tonemap).

Usage: python examples/raster_frame.py [--size 512] [--out frame.png]
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
parser.add_argument("--size", type=int, default=512)
parser.add_argument("--width", type=int, default=None,
                    help="overrides --size (e.g. 1920)")
parser.add_argument("--height", type=int, default=None,
                    help="overrides --size (e.g. 1080)")
parser.add_argument("--profile-stages", action="store_true",
                    help="per-pass wall-time breakdown (per_pass dispatch)")
parser.add_argument("--out", default="frame.png")
parser.add_argument("--dump-exr", default=None, metavar="PATH",
                    help="also write the pre-tonemap HDR buffer as an EXR")
parser.add_argument("--frames", type=int, default=4)
parser.add_argument("--dispatch", default="fused",
                    choices=["fused", "per_pass", "grouped"],
                    help="fused: one program under jit; per_pass / grouped: "
                         "one program per stage / per stage group")
args = parser.parse_args()

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.lights import make_point_lights
from d3d12renderer_jax.render.pathtracer import Materials, Scene, default_sky
from d3d12renderer_jax.render.pipeline import (
    RendererSettings, initial_frame_state, render_frame_with_shadows,
)
from d3d12renderer_jax.render.post import to_srgb

ground = mesh_mod.quad(half=30.0)
sphere = mesh_mod.ico_sphere(1.0, 3).transformed(translate=(0, 1.0, 0))
metal = mesh_mod.ico_sphere(0.8, 3).transformed(translate=(-2.2, 0.8, 0.6))
box = mesh_mod.box((0.7, 0.7, 0.7)).transformed(
    translate=(2.2, 0.7, -0.5), rotate=(0, math.sin(0.3), 0, math.cos(0.3)))
torus = mesh_mod.torus(0.9, 0.3).transformed(translate=(0.8, 0.3, 2.2))

bvh = bvh_mod.build_bvh([(ground, 0), (sphere, 1), (metal, 2), (box, 3),
                         (torus, 4)])
mats = Materials(
    albedo=jnp.array([[0.45, 0.45, 0.45], [0.75, 0.15, 0.12],
                      [0.95, 0.93, 0.88], [0.15, 0.3, 0.75], [0.2, 0.7, 0.3]]),
    emissive=jnp.zeros((5, 3)),
    roughness=jnp.array([0.7, 0.35, 0.12, 0.5, 0.4]),
    metallic=jnp.array([0.0, 0.0, 1.0, 0.0, 0.0]),
)
W = args.width or args.size
H = args.height or args.size
scene = Scene(bvh=bvh, materials=mats, sky=default_sky())
cam = look_at(eye=(6, 3.2, 7), target=(0, 0.8, 0), aspect=W / H,
              v_fov=math.radians(45))
lights = make_point_lights([[2.5, 2.0, 2.5], [-3.0, 1.5, -1.0]],
                           [[40.0, 10.0, 5.0], [5.0, 10.0, 40.0]],
                           [8.0, 8.0])

state = initial_frame_state(W, H)
if args.dispatch in ("per_pass", "grouped"):
    fn = lambda st, k: render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(),
        shadow_resolution=512, point_lights=lights, frame_state=st, key=k,
        dispatch=args.dispatch, profile_stages=args.profile_stages)
else:
    fn = jax.jit(lambda st, k: render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(),
        shadow_resolution=512, point_lights=lights, frame_state=st, key=k))

t0 = time.time()
ldr, state, aux = fn(state, jax.random.PRNGKey(0))
ldr.block_until_ready()
t1 = time.time()
for i in range(1, args.frames):
    ldr, state, aux = fn(state, jax.random.PRNGKey(i))
ldr.block_until_ready()
t2 = time.time()

print(f"compile+frame: {t1 - t0:.1f}s; steady: "
      f"{(t2 - t1) / max(args.frames - 1, 1) * 1000:.0f} ms/frame "
      f"({W}x{H})")
if args.profile_stages and "stage_seconds" in aux:
    frame_wall = (t2 - t1) / max(args.frames - 1, 1)
    stages = dict(aux["stage_seconds"])
    stages["(dispatch gaps)"] = max(frame_wall - sum(stages.values()), 0.0)
    print("per-pass breakdown (last frame, device-blocked per stage):")
    for name, s in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:16s} {s * 1000:8.2f} ms  "
              f"({s / frame_wall * 100:4.1f}%)")

from PIL import Image

arr = np.asarray((jnp.clip(ldr, 0, 1) * 255).astype(jnp.uint8))
Image.fromarray(arr).save(args.out)
if args.dump_exr:
    from d3d12renderer_jax.assets.image_io import save_exr

    save_exr(args.dump_exr, np.asarray(aux["hdr"]), half=True)
    print(f"wrote pre-tonemap HDR to {args.dump_exr}")
print(f"wrote {args.out}; mean luma {arr.mean():.1f}, "
      f"ao min {float(aux['ao'].min()):.2f}, "
      f"shadowed px {(np.asarray(aux['shadow']) < 0.5).mean() * 100:.0f}%")
