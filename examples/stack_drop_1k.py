"""BASELINE config 1: box/sphere stack drop at 1k bodies, contacts only.

A jittered grid of boxes and spheres drops onto a ground plane and settles.
Candidate pairs come from the runtime dense-AABB broadphase
(physics/broadphase.py — the batched replacement for the reference's
sort-and-prune, src/physics/collision_broad.cpp:297-447); contacts solve in
mass-splitting Jacobi mode.

Usage: python examples/stack_drop_1k.py [--bodies 1000] [--steps 300]
       [--batch 1]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time


def build_scene(num_bodies: int, seed: int = 0):
    import numpy as np
    from d3d12renderer_jax.physics.builder import SceneBuilder

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.6, restitution=0.0)

    side = int(round(num_bodies ** (1.0 / 3.0)))
    while side * side * side < num_bodies:
        side += 1
    spacing = 1.15
    count = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if count >= num_bodies:
                    break
                jitter = rng.uniform(-0.05, 0.05, 3)
                pos = (
                    (ix - side / 2) * spacing + jitter[0],
                    1.0 + iy * spacing + jitter[1],
                    (iz - side / 2) * spacing + jitter[2],
                )
                body = b.add_body(position=pos, mass=1.0)
                if (ix + iy + iz) % 2 == 0:
                    b.add_box_collider(body, (0.5, 0.5, 0.5),
                                       friction=0.6, restitution=0.1)
                else:
                    b.add_sphere_collider(body, 0.5,
                                          friction=0.6, restitution=0.1)
                count += 1
    # Sweep window 160 covers the widest same-axis slab of the 10x10x10 grid
    # (overflow counter = 0); row cap 16 bounds per-collider partners;
    # 4096-candidate / 3072-active budgets fit the measured contact counts
    # (~1.7k active at rest) with 2x headroom.
    return b.finalize(broadphase="sap", sap_neighbors=160,
                      sap_max_contacts=4096, sap_active_budget=3072)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--bodies", type=int, default=1000)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--iterations", type=int, default=30)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    from d3d12renderer_jax.physics.step import physics_step
    from d3d12renderer_jax.physics.types import PhysicsSettings

    arch, state0 = build_scene(args.bodies)
    settings = PhysicsSettings(
        frame_rate=120, solver_iterations=args.iterations,
        contact_mode="split_jacobi",
    )

    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (args.batch,) + x.shape), state0)

    @jax.jit
    def run_chunk(st):
        def body(st, _):
            st = jax.vmap(
                lambda s: physics_step(arch, s, settings, 1.0 / 60.0)[0]
            )(st)
            return st, None
        st, _ = jax.lax.scan(body, st, None, length=chunk)
        return st

    chunk = 25
    t0 = time.perf_counter()
    st = run_chunk(batched)
    jax.block_until_ready(st.pos)
    print(f"compile + first {chunk} steps: {time.perf_counter() - t0:.1f}s "
          f"on {jax.devices()[0].platform}")

    t0 = time.perf_counter()
    done = chunk
    while done < args.steps:
        st = run_chunk(st)
        done += chunk
    jax.block_until_ready(st.pos)
    dt = time.perf_counter() - t0
    steps = (done - chunk) * args.batch
    print(f"{done - chunk} steps x {args.batch} scenes in {dt:.2f}s "
          f"({steps / dt:,.1f} scene-steps/s, "
          f"{steps * args.bodies / dt / 1e6:,.2f}M body-steps/s)")

    ys = st.pos[..., 1]
    print(f"heights: min {float(ys.min()):.3f} max {float(ys.max()):.3f} "
          f"mean {float(ys.mean()):.3f}")
    assert float(ys.min()) > -0.2, "bodies sank through the floor"
    assert float(jnp.abs(st.pos).max()) < 100.0, "explosion"
    speed = jnp.linalg.norm(st.vel, axis=-1)
    print(f"speed: mean {float(speed.mean()):.3f} max {float(speed.max()):.3f}")


if __name__ == "__main__":
    main()
