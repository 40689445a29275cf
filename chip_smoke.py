"""Smoke run of the main path on one NVIDIA GPU, through the user entry points.

Phases, all in this one process:
  (a) LocoEnv at 4096 envs stepped through make_vec_env, then 3 make_ppo
      iterations at 4096 envs x 64 rollout steps;
  (b) physics_step on the 1k-body stack (split Jacobi, batch 8, 100
      substeps) and on the 16-part gear vehicle (batch 8);
  (c) render_frame at 1920x1080 on the atrium (~257k triangles) with sun
      cascades, and a depth-3, 1-spp path trace of the same view.

Each phase prints its compile seconds, run seconds and its check; any failed
check raises and the script exits non-zero.  The last line is one JSON object
naming the device.  Without a GPU the script refuses to run.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # only the 4-GPU data-parallel path

Weights and data are random, made from --seed.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Locomotion reward: DReCon imitation of the standing pose, 4 terms each in
# [0, 1] times a fall factor in [0, 1].  A random policy (0.3-sigma normal
# actions, as examples/loco_rollout.py) averages 1-2.3 over its first 30
# steps; the first step alone averages about 2.4.
REWARD_RANGE = (0.0, 4.0)
ROLLOUT_REWARD_BAND = (1.0, 2.3)
# Mean LDR luminance of the 1080p atrium frame: lit stone under sky and sun,
# neither black nor blown out.
FRAME_LUMA_BAND = (0.05, 0.9)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(f"check failed: {what}")
    return what


def timed(fn, *args):
    """(out, compile_s, run_s): the first call compiles and runs, the second
    runs the same shapes again."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    run = time.perf_counter() - t0
    return out, max(first - run, 0.0), run


def report(name, compile_s, run_s, checks):
    log(f"phase {name}: compile {compile_s:.2f} s, run {run_s:.3f} s, "
        f"check: {'; '.join(checks)}")


# -- (a) locomotion ---------------------------------------------------------


def phase_loco_env(num_envs=4096, steps=30, seed=0):
    """A random-policy rollout of `steps` env steps in one jitted scan."""
    import jax
    import jax.numpy as jnp

    from d3d12renderer_jax.learning.loco_env import (
        ACTION_SIZE, LocoEnv, make_vec_env,
    )

    env = LocoEnv()
    reset, step = make_vec_env(env, num_envs)
    key = jax.random.PRNGKey(seed)
    _, st0 = reset(key)

    @jax.jit
    def rollout(st, key):
        def body(st, k):
            obs, st, reward, _ = step(
                st, 0.3 * jax.random.normal(k, (num_envs, ACTION_SIZE)))
            return st, (jnp.isfinite(obs).all(), reward)
        return jax.lax.scan(body, st, jax.random.split(key, steps))[1]

    (obs_ok, rewards), c, r = timed(rollout, st0, jax.random.fold_in(key, 1))
    first_lo, first_hi = float(rewards[0].min()), float(rewards[0].max())
    mean = float(rewards.mean())
    checks = [
        check(bool(obs_ok.all()), "obs finite"),
        check(bool(jnp.isfinite(rewards).all()), "rewards finite"),
        check(REWARD_RANGE[0] <= first_lo and first_hi <= REWARD_RANGE[1],
              f"first-step rewards in [{first_lo:.3f}, {first_hi:.3f}] "
              f"within {REWARD_RANGE}"),
        check(ROLLOUT_REWARD_BAND[0] <= mean <= ROLLOUT_REWARD_BAND[1],
              f"{steps}-step mean reward {mean:.3f} within "
              f"{ROLLOUT_REWARD_BAND}"),
    ]
    report(f"loco_env[{num_envs} envs x {steps} steps, "
           f"{num_envs * steps / r:.0f} env-steps/s]", c, r, checks)
    return {"first_reward": float(rewards[0].mean()), "mean_reward": mean}


def phase_ppo(num_envs=4096, rollout_steps=64, iterations=3, seed=0,
              minibatches=8, epochs=10):
    import jax
    import numpy as np

    from d3d12renderer_jax.learning.loco_env import LocoEnv
    from d3d12renderer_jax.learning.ppo import PPOConfig, make_ppo

    env = LocoEnv()
    init, train, _ = make_ppo(env, PPOConfig(
        num_envs=num_envs, rollout_steps=rollout_steps,
        minibatches=minibatches, epochs=epochs))
    state = init(jax.random.PRNGKey(seed))
    times, losses = [], []
    for _ in range(iterations):
        t0 = time.perf_counter()
        state, metrics = train(state)
        metrics = jax.device_get(metrics)
        times.append(time.perf_counter() - t0)
        losses.append((float(metrics["pg_loss"]), float(metrics["vf_loss"]),
                       float(metrics["entropy"])))
    run = min(times[1:]) if len(times) > 1 else times[0]
    checks = [check(bool(np.isfinite(losses).all()),
                    f"losses finite over {iterations} iterations "
                    f"(last pg {losses[-1][0]:.4f} vf {losses[-1][1]:.4f})")]
    report(f"ppo[{num_envs} envs x {rollout_steps} steps]",
           max(times[0] - run, 0.0), run, checks)
    return {"losses": losses}


# -- (b) runtime physics ----------------------------------------------------


def _batched_steps(arch, state0, settings, batch, steps, overrides=None):
    import jax
    import jax.numpy as jnp

    from d3d12renderer_jax.physics.step import physics_step

    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), state0)

    @jax.jit
    def run(st):
        def body(st, _):
            return jax.vmap(lambda s: physics_step(
                arch, s, settings, 1.0 / 60.0,
                motor_overrides=overrides)[0])(st), None
        return jax.lax.scan(body, st, None, length=steps)[0]

    return timed(run, st)


def phase_stack(bodies=1000, batch=8, substeps=100):
    import jax.numpy as jnp

    from d3d12renderer_jax.physics.types import PhysicsSettings
    from examples.stack_drop_1k import build_scene

    arch, state0 = build_scene(bodies)
    settings = PhysicsSettings(frame_rate=120, solver_iterations=30,
                               contact_mode="split_jacobi")
    # 120 Hz physics under 60 Hz steps: two substeps per step.
    st, c, r = _batched_steps(arch, state0, settings, batch, substeps // 2)
    ymin = float(st.pos[..., 1].min())
    checks = [check(bool(jnp.isfinite(st.pos).all()), "positions finite"),
              check(ymin > -0.2, f"min y {ymin:.3f} > -0.2")]
    report(f"stack[{bodies} bodies x {batch}, {substeps} substeps]", c, r,
           checks)
    return {"min_y": ymin}


def phase_vehicle(batch=8, steps=100):
    import jax.numpy as jnp

    from d3d12renderer_jax.models.vehicle import build_vehicle, drive_overrides
    from d3d12renderer_jax.physics.builder import SceneBuilder
    from d3d12renderer_jax.physics.types import PhysicsSettings

    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0)
    info = build_vehicle(b, position=(0.0, 0.85, 0.0))
    arch, state0 = b.finalize()
    overrides = drive_overrides(arch, info, throttle_velocity=10.0,
                                steering_angle=0.0)
    settings = PhysicsSettings(frame_rate=60, contact_mode="split_jacobi")
    st, c, r = _batched_steps(arch, state0, settings, batch, steps, overrides)
    motor = info.bodies["motor"]
    drove = float(jnp.min(jnp.linalg.norm(
        (st.pos[:, motor] - state0.pos[motor])[:, jnp.array([0, 2])], axis=-1)))
    checks = [check(bool(jnp.isfinite(st.pos).all()), "positions finite"),
              check(drove > 0.0, f"every vehicle drove, least {drove:.3f} m")]
    report(f"vehicle[x{batch}, {steps} steps]", c, r, checks)
    return {"drove_m": drove}


# -- (c) renderer -----------------------------------------------------------


def _atrium_view(width, height, detail):
    from d3d12renderer_jax.render.camera import look_at
    from d3d12renderer_jax.render.pathtracer import atrium_render_scene

    scene = atrium_render_scene(detail)
    cam = look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0),
                  v_fov=math.radians(60), aspect=width / height)
    return scene, cam


def phase_render_frame(width=1920, height=1080, detail=1.4,
                       shadow_resolution=512):
    import jax
    import jax.numpy as jnp

    from d3d12renderer_jax.render.pipeline import (
        RendererSettings, _fit_cascades_jit, _render_sun_shadow_maps_jit,
        initial_frame_state, render_frame,
    )

    scene, cam = _atrium_view(width, height, detail)
    t0 = time.perf_counter()
    maps = _fit_cascades_jit(cam.position, scene.sky.sun_direction)
    maps = _render_sun_shadow_maps_jit(scene.bvh, maps,
                                       resolution=shadow_resolution)
    jax.block_until_ready(maps)
    shadow_s = time.perf_counter() - t0
    settings = RendererSettings(primary="raster", half_res_effects=True)

    @jax.jit
    def frame(fs, key):
        ldr, fs, aux = render_frame(scene, cam, width, height, settings,
                                    shadow_maps=maps, frame_state=fs,
                                    prev_camera=cam, key=key)
        return ldr, aux["shadow"]

    fs = initial_frame_state(width, height)
    (ldr, shadow), c, r = timed(frame, fs, jax.random.PRNGKey(0))
    luma = float(jnp.mean(ldr @ jnp.array([0.2126, 0.7152, 0.0722])))
    depth = maps.depth
    checks = [
        check(ldr.shape == (height, width, 3), f"frame {ldr.shape}"),
        check(bool(jnp.isfinite(ldr).all()), "frame finite"),
        check(FRAME_LUMA_BAND[0] <= luma <= FRAME_LUMA_BAND[1],
              f"mean luminance {luma:.4f} within {FRAME_LUMA_BAND}"),
        check(depth.shape[1] == shadow_resolution
              and bool(jnp.isfinite(depth).any()),
              f"{depth.shape[0]} sun cascades at {shadow_resolution}^2 "
              f"rendered in {shadow_s:.2f} s"),
        check(float(shadow.min()) < 0.5 < float(shadow.max()),
              "frame has shadowed and sunlit pixels"),
    ]
    report(f"render_frame[{width}x{height}, "
           f"{int(scene.bvh.tri_valid.sum())} tris]", c, r, checks)
    return {"luma": luma}


def phase_pathtrace(width=1920, height=1080, detail=1.4, depth=3):
    import jax
    import jax.numpy as jnp

    from d3d12renderer_jax.render import pathtracer as pt

    scene, cam = _atrium_view(width, height, detail)
    f = jax.jit(lambda k: pt.render(
        scene, cam, width, height, pt.PathTracerSettings(recursion_depth=depth),
        spp=1, key=k, with_stats=True))
    (img, nrays), c, r = timed(f, jax.random.PRNGKey(0))
    nrays = float(nrays)
    checks = [
        check(img.shape == (height, width, 3), f"image {img.shape}"),
        check(bool(jnp.isfinite(img).all()), "image finite"),
        check(nrays > 0, f"{nrays:.0f} rays traced "
              f"({nrays / r / 1e6:.2f} Mrays/s)"),
    ]
    report(f"pathtrace[{width}x{height}, depth {depth}, 1 spp]", c, r, checks)
    return {"rays": nrays}


# -- four cards -------------------------------------------------------------


def phase_distributed_ppo(n_devices=4, num_envs=4096, rollout_steps=64,
                          iterations=3, seed=0, minibatches=8, epochs=10):
    """make_distributed_ppo over `n_devices` cards, `num_envs` envs each;
    the replicated params must stay bit-identical on every card."""
    import jax
    import numpy as np

    from d3d12renderer_jax.learning.loco_env import LocoEnv
    from d3d12renderer_jax.learning.ppo import PPOConfig
    from d3d12renderer_jax.parallel.data_parallel import (
        make_distributed_ppo, make_mesh,
    )

    mesh = make_mesh(n_devices)
    init, train, _ = make_distributed_ppo(
        LocoEnv(), PPOConfig(num_envs=num_envs, rollout_steps=rollout_steps,
                             minibatches=minibatches, epochs=epochs), mesh)
    state = init(jax.random.PRNGKey(seed))
    times, losses = [], []
    for _ in range(iterations):
        t0 = time.perf_counter()
        state, metrics = train(state)
        metrics = jax.device_get(metrics)
        times.append(time.perf_counter() - t0)
        losses.append((float(metrics["pg_loss"]), float(metrics["vf_loss"])))
    identical = all(
        all(np.array_equal(np.asarray(s.data),
                           np.asarray(leaf.addressable_shards[0].data))
            for s in leaf.addressable_shards)
        for leaf in jax.tree_util.tree_leaves(state.params))
    n_shards = len(jax.tree_util.tree_leaves(state.params)[0]
                   .addressable_shards)
    run = min(times[1:]) if len(times) > 1 else times[0]
    checks = [
        check(bool(np.isfinite(losses).all()), "losses finite"),
        check(identical and n_shards == n_devices,
              f"params bit-identical on all {n_shards} devices"),
    ]
    report(f"distributed_ppo[{n_devices} x {num_envs} envs]",
           max(times[0] - run, 0.0), run, checks)
    return {"losses": losses}


def phase_sharded_pathtrace(n_devices=4, width=1920, height=1080, detail=1.4,
                            depth=3, seed=3):
    """pathtrace_sharded against the same bands traced on one card with the
    same keys, and against pathtracer.render's mean radiance."""
    import jax
    import jax.numpy as jnp

    from d3d12renderer_jax.parallel.data_parallel import make_mesh
    from d3d12renderer_jax.parallel.eval_render import pathtrace_sharded
    from d3d12renderer_jax.render import pathtracer as pt
    from d3d12renderer_jax.render.camera import generate_rays

    scene, cam = _atrium_view(width, height, detail)
    settings = pt.PathTracerSettings(recursion_depth=depth)
    key = jax.random.PRNGKey(seed)
    mesh = make_mesh(n_devices)
    # pathtrace_sharded jits per call: one timed call, compile included.
    t0 = time.perf_counter()
    frame = jax.block_until_ready(pathtrace_sharded(
        scene, cam, width, height, mesh, settings=settings, spp=1, key=key))
    total = time.perf_counter() - t0

    # One card, band by band, with pathtrace_sharded's keys.
    k_cam, k_trace = jax.random.split(key)
    o, d = generate_rays(cam, width, height, key=k_cam)
    shard_keys = jax.random.split(k_trace, n_devices)
    rows = o.shape[0] // n_devices
    band = jax.jit(lambda o, d, k: pt.trace_sample(
        scene, settings, o, d, jax.random.fold_in(k, 0)))
    ref = jnp.concatenate([
        jax.device_get(band(o[i * rows:(i + 1) * rows],
                            d[i * rows:(i + 1) * rows], shard_keys[i]))
        for i in range(n_devices)]).reshape(height, width, 3)
    single = jax.jit(lambda k: pt.render(scene, cam, width, height, settings,
                                         spp=1, key=k))(key)
    frame = jax.device_get(frame)
    diff = jnp.abs(jnp.asarray(frame) - ref)
    off = float(jnp.mean(diff > 1e-3 * (1.0 + jnp.abs(ref))))
    mean_s, mean_1 = float(jnp.mean(frame)), float(jnp.mean(single))
    checks = [
        check(bool(jnp.isfinite(frame).all()), "frame finite"),
        check(off <= 1e-3, f"{off:.2e} of values differ from the one-card "
              "bands by > 1e-3 relative (<= 1e-3 allowed)"),
        check(abs(mean_s - mean_1) <= 0.02 * abs(mean_1),
              f"mean radiance {mean_s:.5f} vs pathtracer.render "
              f"{mean_1:.5f} (within 2%)"),
    ]
    log(f"phase pathtrace_sharded[{n_devices} devices, {width}x{height}]: "
        f"compile + run {total:.2f} s, check: {'; '.join(checks)}")
    return {"off_fraction": off}


# -- driver -------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-GPU data-parallel PPO and the "
                             "sharded path trace")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax

    from d3d12renderer_jax.core.profiling import card_line

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    log(card_line())
    log(f"device_kind: {devices[0].device_kind}, devices: {len(devices)}")

    if args.four_cards:
        phase_distributed_ppo(n_devices=4, seed=args.seed)
        phase_sharded_pathtrace(n_devices=4, seed=args.seed + 3)
    else:
        phase_loco_env(seed=args.seed)
        phase_ppo(seed=args.seed)
        phase_stack()
        phase_vehicle()
        phase_render_frame()
        phase_pathtrace()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
