"""Vehicle-on-terrain driving demo: the gear-train vehicle drives across a
procedural heightfield (round-1 ROADMAP item 4; reference scene analog:
the vehicle demo on the reference's terrain, src/physics/vehicle.cpp:303 +
terrain/heightmap_collider.h:13).

Usage: python examples/vehicle_terrain.py [--seconds 6]
       [--render drive.png]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

parser = argparse.ArgumentParser()
parser.add_argument("--seconds", type=float, default=6.0)
parser.add_argument("--throttle", type=float, default=10.0)
parser.add_argument("--render", default=None)
args = parser.parse_args()

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.models.vehicle import build_vehicle, drive_overrides
from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings
from d3d12renderer_jax.terrain.heightmap import (
    generate_heightmap, sample_height_bilinear,
)

DT = 1.0 / 60.0
SETTINGS = PhysicsSettings(frame_rate=60, contact_mode="split_jacobi")

# Gentle rolling terrain (amplitude small vs wheel radius so the gear train
# keeps meshing).
heights = generate_heightmap(resolution=49, world_size=48.0, amplitude=1.2,
                             noise_scale=0.05, seed=11)
origin = (-24.0, 0.0, -24.0)
cell = 1.0

b = SceneBuilder()
b.add_terrain(np.asarray(heights), origin=origin, cell_size=cell,
              friction=1.0)
h0, _ = sample_height_bilinear(heights, origin, cell, jnp.asarray(0.0),
                               jnp.asarray(0.0))
info = build_vehicle(b, position=(0.0, float(h0) + 0.85, 0.0))
arch, state = b.finalize()

overrides = drive_overrides(arch, info, throttle_velocity=args.throttle,
                            steering_angle=0.0)
step = jax.jit(lambda s: physics_step(arch, s, SETTINGS, DT,
                                      motor_overrides=overrides)[0])

frames = int(args.seconds / DT)
t0 = time.time()
state = step(state)
jax.block_until_ready(state.pos)
print(f"compile + first frame: {time.time() - t0:.1f}s on "
      f"{jax.devices()[0].platform}")

t0 = time.time()
start = np.asarray(jax.device_get(state.pos[info.bodies['motor']]))
for _ in range(frames - 1):
    state = step(state)
jax.block_until_ready(state.pos)
final = jax.device_get(state)
end = np.asarray(final.pos[info.bodies["motor"]])

dist = float(np.linalg.norm((end - start)[[0, 2]]))
ty, _ = sample_height_bilinear(heights, origin, cell,
                               jnp.asarray(float(end[0])),
                               jnp.asarray(float(end[2])))
print(f"{frames} frames in {time.time() - t0:.1f}s "
      f"({frames / max(time.time() - t0, 1e-9):.0f} fps)")
print(f"drove {dist:.2f} m across the terrain; chassis at "
      f"{end.round(2)} (ground {float(ty):.2f})")
print(f"clearance above terrain: {end[1] - float(ty):.2f} m; "
      f"all finite: {np.isfinite(final.pos).all()}")

if args.render:
    from PIL import Image

    from d3d12renderer_jax.render.physics_viz import render_physics_state

    img = render_physics_state(
        arch, final, eye=(end[0] + 5.0, end[1] + 3.5, end[2] + 6.0),
        target=tuple(end), size=256, spp=6)
    Image.fromarray(img).save(args.render)
    print(f"wrote {args.render}")
