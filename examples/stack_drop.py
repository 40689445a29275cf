"""Demo: drop a small pile of boxes and spheres onto the ground plane.

Usage: python examples/stack_drop.py [--batch N] [--steps N]
Prints a trajectory summary; the final resting heights demonstrate contact
generation + the sequential-impulse solver end-to-end.
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

parser = argparse.ArgumentParser()
parser.add_argument("--batch", type=int, default=0, help="0 = single scene")
parser.add_argument("--steps", type=int, default=400)
args = parser.parse_args()

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.physics import builder, step
from d3d12renderer_jax.physics.types import PhysicsSettings

b = builder.SceneBuilder()
b.add_static_plane((0, 1, 0), 0.0, friction=0.8)
for i in range(3):
    body = b.add_body(position=(0, 0.5 + 1.05 * i, 0))
    b.add_box_collider(body, (0.5, 0.5, 0.5))
sph = b.add_body(position=(2.0, 3.0, 0))
b.add_sphere_collider(sph, radius=0.4, restitution=0.5)
arch, state = b.finalize()

settings = PhysicsSettings()
h = 1.0 / settings.frame_rate

if args.batch:
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (args.batch,) + x.shape), state
    )
    stepper = jax.jit(
        lambda s: jax.vmap(lambda q: step.physics_step(arch, q, settings, h, 1)[0])(s)
    )
else:
    stepper = jax.jit(lambda s: step.physics_step(arch, s, settings, h, 1)[0])

t0 = time.time()
state = stepper(state)
jax.block_until_ready(state)
print(f"compile + first step: {time.time() - t0:.2f}s on {jax.devices()[0].platform}")

t0 = time.time()
for i in range(args.steps):
    state = stepper(state)
jax.block_until_ready(state)
el = time.time() - t0
n_scenes = args.batch if args.batch else 1
print(f"{args.steps} steps x {n_scenes} scenes in {el:.2f}s "
      f"({args.steps * n_scenes / el:,.0f} scene-steps/s)")

pos = np.asarray(state.pos)
if args.batch:
    pos = pos[0]
print("final body heights:", np.round(pos[:, 1], 3))
print("expected: boxes ~[0.5, 1.5, 2.5], sphere ~0.4")
