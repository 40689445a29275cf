"""Benchmark on one NVIDIA GPU: locomotion env throughput and the other
main-path legs, all in this one process.

Headline: ragdoll-locomotion env throughput (env-steps/s).  A batch of full
locomotion environments (14-body ragdoll, 13 motored joints, contacts vs
ground, reward + auto-reset) steps with a random policy; steady state only,
compilation excluded.  The other legs:

  * rays: closest-hit throughput (Mrays/s) of 1080p-class tile-ordered
    primary rays on the 53k-triangle sphere grid and on the ~257k-triangle
    atrium, through render.bvh.closest_hit;
  * physics: the 1k-body stack (split Jacobi) and the 16-part gear vehicle,
    both batched x8, in scene-steps/s;
  * pt_e2e: a depth-3, 1-spp path trace of the atrium at 1080p, in
    Mrays/s over every ray the frame traced;
  * raster: render_frame of the atrium at 1080p with raster primary
    visibility and sun cascades, in ms/frame.

The output is one JSON line, tagged with the device (platform, device_kind,
count) and the card's name and power limit.  Without a GPU the bench refuses
to run.

Usage: python bench.py [--smoke] [--batch N] [--steps N]
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _best_of(fn, reps=3):
    """Seconds of the fastest of `reps` calls of fn (each blocks)."""
    import jax

    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def bench_loco(batch=4096, steps=200, steps_per_chunk=50):
    """Steady-state env-steps/s of LocoEnv at `batch` envs."""
    import jax

    from d3d12renderer_jax.learning.loco_env import (
        ACTION_SIZE, LocoEnv, make_vec_env,
    )

    env = LocoEnv()
    reset, step = make_vec_env(env, batch)
    steps_per_chunk = min(steps, steps_per_chunk)
    num_chunks = max(1, steps // steps_per_chunk)

    @jax.jit
    def run_chunk(env_state, key):
        def body(carry, _):
            env_state, key = carry
            key, k = jax.random.split(key)
            actions = jax.random.uniform(
                k, (batch, ACTION_SIZE), minval=-0.5, maxval=0.5)
            _, env_state, reward, _ = step(env_state, actions)
            return (env_state, key), reward.mean()

        (env_state, key), rewards = jax.lax.scan(
            body, (env_state, key), None, length=steps_per_chunk)
        return env_state, key, rewards.mean()

    key = jax.random.PRNGKey(0)
    _, env_state = reset(key)
    jax.block_until_ready(run_chunk(env_state, key))  # compile
    t0 = time.perf_counter()
    for _ in range(num_chunks):
        env_state, key, r = run_chunk(env_state, key)
    jax.block_until_ready(r)
    elapsed = time.perf_counter() - t0
    return {
        "value": num_chunks * steps_per_chunk * batch / elapsed,
        "batch": batch,
        "mean_reward": float(r),
    }


def _primary_rays(width, height, eye):
    """Tile-ordered pinhole rays from `eye` looking down +z."""
    import jax.numpy as jnp
    import numpy as np

    from d3d12renderer_jax.render.pathtracer import _tile_perm

    xs = (np.arange(width) + 0.5) / width * 2 - 1
    ys = (np.arange(height) + 0.5) / height * 2 - 1
    d = np.stack(np.broadcast_arrays(
        xs[None, :] * 0.9, -ys[:, None] * 0.55, np.full((height, width), 1.0),
    ), -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d = d[_tile_perm(width, height)[0]]
    o = np.broadcast_to(np.asarray(eye, np.float32), d.shape)
    return jnp.asarray(o), jnp.asarray(d)


def bench_rays(width=1920, height=1088, grid=(16, 26), atrium_detail=1.4):
    """Closest-hit Mrays/s through render.bvh.closest_hit."""
    import jax
    import numpy as np

    from d3d12renderer_jax.render import bvh as bvh_mod
    from d3d12renderer_jax.render.mesh import atrium_scene, sphere_grid_scene

    out = {}
    o, d = _primary_rays(width, height, (0.0, 1.5, -9.0))
    for name, meshes in (("53k", sphere_grid_scene(*grid)),
                         ("atrium", atrium_scene(atrium_detail))):
        b = bvh_mod.build_bvh(meshes)
        f = jax.jit(lambda o, d, b=b: bvh_mod.closest_hit(b, o, d))
        jax.block_until_ready(f(o, d))
        best = _best_of(lambda: f(o, d))
        key = "" if name == "53k" else "_atrium"
        out["ray_mrays_per_sec" + key] = width * height / best / 1e6
        out["ray_scene_tris" + key] = int(np.asarray(b.tri_valid).sum())
    return out


def _batched_physics(arch, state0, settings, batch, steps, overrides=None,
                     chunk=25):
    """(final state, scene-steps/s) of `steps` 60 Hz steps at `batch`."""
    import jax
    import jax.numpy as jnp

    from d3d12renderer_jax.physics.step import physics_step

    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), state0)
    chunk = min(chunk, steps)

    @jax.jit
    def run_chunk(st):
        def body(st, _):
            return jax.vmap(lambda s: physics_step(
                arch, s, settings, 1.0 / 60.0,
                motor_overrides=overrides)[0])(st), None
        return jax.lax.scan(body, st, None, length=chunk)[0]

    st = jax.block_until_ready(run_chunk(st))  # compile
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        st = run_chunk(st)
        done += chunk
    jax.block_until_ready(st.pos)
    return st, done * batch / (time.perf_counter() - t0)


def bench_physics(batch=8, steps=100, bodies=1000):
    """The 1k-body stack (BASELINE config 1) and the gear vehicle (config
    4), each batched x`batch`."""
    import jax.numpy as jnp

    from d3d12renderer_jax.models.vehicle import build_vehicle, drive_overrides
    from d3d12renderer_jax.physics.builder import SceneBuilder
    from d3d12renderer_jax.physics.types import PhysicsSettings
    from examples.stack_drop_1k import build_scene

    arch, state0 = build_scene(bodies)
    st, sps = _batched_physics(
        arch, state0, PhysicsSettings(frame_rate=120, solver_iterations=30,
                                      contact_mode="split_jacobi"),
        batch, steps)
    out = {
        "stack_scene_steps_per_sec": sps,
        "stack_body_steps_per_sec": sps * bodies,
        "stack_batch": batch,
        "stack_ok": bool(float(st.pos[..., 1].min()) > -0.2),
    }

    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0)
    info = build_vehicle(b, position=(0.0, 0.85, 0.0))
    arch, state0 = b.finalize()
    overrides = drive_overrides(arch, info, throttle_velocity=10.0,
                                steering_angle=0.0)
    st, sps = _batched_physics(
        arch, state0, PhysicsSettings(frame_rate=60,
                                      contact_mode="split_jacobi"),
        batch, steps, overrides)
    motor = info.bodies["motor"]
    out.update({
        "vehicle_steps_per_sec": sps,
        "vehicle_batch": batch,
        "vehicle_drove_m": float(jnp.linalg.norm(
            (st.pos[0, motor] - state0.pos[motor])[jnp.array([0, 2])])),
    })
    return out


def _atrium(width, height, detail):
    from d3d12renderer_jax.render.camera import look_at
    from d3d12renderer_jax.render.pathtracer import atrium_render_scene

    cam = look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0),
                  v_fov=math.radians(60), aspect=width / height)
    return atrium_render_scene(detail), cam


def bench_pt_e2e(width=1920, height=1080, detail=1.4, depth=3):
    """Depth-3 path trace of the atrium: Mrays/s over every useful ray the
    frame dispatched (primary + bounce closest-hit + NEE shadow)."""
    import jax

    from d3d12renderer_jax.render import pathtracer as pt

    scene, cam = _atrium(width, height, detail)
    settings = pt.PathTracerSettings(recursion_depth=depth)
    f = jax.jit(lambda k: pt.render(scene, cam, width, height, settings,
                                    spp=1, key=k, with_stats=True))
    _, nrays = jax.block_until_ready(f(jax.random.PRNGKey(0)))
    best = _best_of(lambda: f(jax.random.PRNGKey(1)))
    return {
        "pt_mrays_e2e": float(nrays) / best / 1e6,
        "pt_e2e_rays_per_frame": int(nrays),
        "pt_e2e_frame_ms": best * 1e3,
    }


def bench_raster_frame(width=1920, height=1080, detail=1.4,
                       shadow_resolution=512, frames=5):
    """render_frame of the atrium: raster primary visibility, sun cascades
    (rendered once up front, as for a static scene and sun), AO, SSR, TAA,
    bloom, tonemap; steady-state ms/frame."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from d3d12renderer_jax.render.pipeline import (
        RendererSettings, _fit_cascades_jit, _render_sun_shadow_maps_jit,
        initial_frame_state, render_frame,
    )

    scene, cam = _atrium(width, height, detail)
    maps = _fit_cascades_jit(cam.position, scene.sky.sun_direction)
    maps = _render_sun_shadow_maps_jit(scene.bvh, maps,
                                       resolution=shadow_resolution)
    settings = RendererSettings(primary="raster", half_res_effects=True)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def frame(fs, i):
        ldr, fs, _ = render_frame(
            scene, cam, width, height, settings, shadow_maps=maps,
            frame_state=fs, prev_camera=cam, key=jax.random.fold_in(key, i))
        return ldr, fs

    ldr, fs = jax.block_until_ready(frame(initial_frame_state(width, height),
                                          0))
    best = math.inf
    for rep in range(3):
        t0 = time.perf_counter()
        for i in range(frames):
            ldr, fs = frame(fs, rep * frames + i + 1)
        jax.block_until_ready(ldr)
        best = min(best, (time.perf_counter() - t0) / frames)
    return {
        "raster_1080p_atrium_ms": best * 1e3,
        "raster_atrium_tris": int(np.asarray(scene.bvh.tri_valid).sum()),
        "raster_frame_mean": float(jnp.mean(ldr)),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke", action="store_true",
                        help="the headline leg only, at 64 envs x 20 steps")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    args = parser.parse_args()

    import jax

    from d3d12renderer_jax.core.profiling import card_line

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    batch = args.batch or (64 if args.smoke else 4096)
    steps = args.steps or (20 if args.smoke else 200)

    loco = bench_loco(batch, steps)
    legs = {}
    if not args.smoke:
        for leg in (bench_rays, bench_physics, bench_pt_e2e,
                    bench_raster_frame):
            legs.update(leg())
    print(json.dumps({
        "metric": "loco_env_steps_per_sec",
        "value": loco["value"],
        "unit": "env-steps/s",
        "batch": loco["batch"],
        "mean_reward": loco["mean_reward"],
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card_line(),
        **legs,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
