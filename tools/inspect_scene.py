"""CLI scene inspector: the headless editor substitute.

Reference: the editor is the reference's inspection harness (src/editor/
editor.cpp hierarchy/inspector panels, SURVEY.md §2.81 — replaced by
CLI/notebook tooling).  Prints the entity tree with components, physics
compilation stats, and optionally renders a view to PNG.

Usage:
  python tools/inspect_scene.py scene.yaml [--render out.png] [--size 256]
      [--eye 6,4,8] [--target 0,1,0]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import sys

parser = argparse.ArgumentParser()
parser.add_argument("scene", help="scene YAML file")
parser.add_argument("--render", default=None, help="write a PNG view")
parser.add_argument("--size", type=int, default=256)
parser.add_argument("--spp", type=int, default=8)
parser.add_argument("--eye", default="6,4,8")
parser.add_argument("--target", default="0,1,0")
args = parser.parse_args()

import jax
import math

import numpy as np

from d3d12renderer_jax.scene.scene import Scene


def vec(s):
    return tuple(float(x) for x in s.split(","))


scene = Scene.load_yaml(args.scene)

print(f"Scene: {args.scene}")
print(f"  planes: {len(scene.planes)}")
entities = list(scene.view())
print(f"  entities: {len(entities)}")
for ent, _ in entities:
    comps = [k for k in scene._components if ent.has(k)]
    print(f"    [{ent.id:3d}] {ent.name:<24} {', '.join(comps)}")
    for k in comps:
        v = ent.get(k)
        if k == "collider":
            for c in v:
                print(f"          collider: {c.shape} size={c.size} "
                      f"density={c.density}")
        elif k == "transform":
            print(f"          at {tuple(round(x, 3) for x in v.position)}")

arch, state, mapping = scene.compile_physics()
print(f"  physics: {arch.num_bodies} bodies, {arch.num_colliders} colliders, "
      f"{arch.num_planes} planes, {arch.num_terrains} terrains")
total_pairs = sum(b.body_a.shape[0] for b in arch.contact_buckets)
print(f"           {arch.vs_plane_collider.shape[0]} plane rows, "
      f"{total_pairs} pair rows, "
      f"{len(arch.contact_color_indices)} contact colors")
for t in arch.joints:
    print(f"           {t.body_a.shape[0]} {t.kind} joints")

if args.render:
    from PIL import Image

    from d3d12renderer_jax.render.camera import look_at
    from d3d12renderer_jax.render.pathtracer import (
        PathTracerSettings, render, to_srgb_u8,
    )

    rscene = scene.build_render_scene(body_state=state, mapping=mapping)
    cam = look_at(eye=vec(args.eye), target=vec(args.target), aspect=1.0,
                  v_fov=math.radians(50))
    img = render(rscene, cam, args.size, args.size,
                 PathTracerSettings(recursion_depth=2), spp=args.spp,
                 key=jax.random.PRNGKey(0))
    Image.fromarray(np.asarray(to_srgb_u8(img))).save(args.render)
    print(f"  wrote {args.render}")
