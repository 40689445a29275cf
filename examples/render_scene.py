"""Path-trace a demo scene to PNG.

Usage: python examples/render_scene.py [--size 512] [--spp 16]
                                       [--out render.png]
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
parser.add_argument("--spp", type=int, default=16)
parser.add_argument("--out", default="render.png")
parser.add_argument("--point-lights", action="store_true",
                    help="add two local point lights (NEE + MIS path)")
args = parser.parse_args()

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.pathtracer import (
    Materials, PathTracerSettings, Scene, default_sky, render, to_srgb_u8,
)

ground = mesh_mod.quad(half=30.0)
sphere = mesh_mod.ico_sphere(1.0, 3).transformed(translate=(0, 1.0, 0))
metal = mesh_mod.ico_sphere(0.8, 3).transformed(translate=(-2.2, 0.8, 0.6))
box = mesh_mod.box((0.7, 0.7, 0.7)).transformed(
    translate=(2.2, 0.7, -0.5),
    rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3)),
)
torus = mesh_mod.torus(0.9, 0.3).transformed(translate=(0.8, 0.3, 2.2))

bvh = bvh_mod.build_bvh([(ground, 0), (sphere, 1), (metal, 2), (box, 3), (torus, 4)])
mats = Materials(
    albedo=jnp.array([
        [0.45, 0.45, 0.45],
        [0.75, 0.15, 0.12],
        [0.95, 0.93, 0.88],
        [0.15, 0.3, 0.75],
        [0.2, 0.7, 0.3],
    ]),
    emissive=jnp.zeros((5, 3)),
    roughness=jnp.array([0.7, 0.35, 0.12, 0.5, 0.4]),
    metallic=jnp.array([0.0, 0.0, 1.0, 0.0, 0.0]),
)
point_lights = None
if args.point_lights:
    from d3d12renderer_jax.render.lights import make_point_lights

    point_lights = make_point_lights(
        positions=[[-1.0, 2.5, 2.0], [2.8, 2.0, 1.5]],
        colors=[[9000.0, 7000.0, 4000.0], [2000.0, 4000.0, 9000.0]],
        radii=[18.0, 18.0],
    )
scene = Scene(bvh=bvh, materials=mats, sky=default_sky(),
              point_lights=point_lights)
cam = look_at(eye=(6, 3.2, 7), target=(0, 0.8, 0), aspect=1.0,
              v_fov=math.radians(45))

settings = PathTracerSettings(recursion_depth=3)
fn = jax.jit(lambda k: render(scene, cam, args.size, args.size, settings,
                              spp=args.spp, key=k))

t0 = time.time()
img = fn(jax.random.PRNGKey(0))
img.block_until_ready()
t1 = time.time()
img = fn(jax.random.PRNGKey(1))
img.block_until_ready()
t2 = time.time()

rays = args.size * args.size * args.spp * (settings.recursion_depth + 1) * 2
print(f"compile+render: {t1 - t0:.1f}s; steady render: {t2 - t1:.2f}s "
      f"(~{rays / (t2 - t1) / 1e6:.1f} Mrays/s incl. shadow rays)")

from PIL import Image

arr = np.asarray(to_srgb_u8(img))
Image.fromarray(arr).save(args.out)
print(f"wrote {args.out} ({args.size}x{args.size}, {args.spp} spp), "
      f"mean luma {arr.mean():.1f}")
