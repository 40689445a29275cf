"""Train the ragdoll locomotion policy with on-device PPO.

The on-device replacement for the reference's learn_locomotion.py
(SubprocVecEnv + stable-baselines3): rollouts and updates run in one jit
program; data parallelism over a device mesh via --mesh.

Usage:
  python examples/train_locomotion.py [--iterations 50] [--envs 256]
      [--mesh N] [--logdir tmp/loco]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import os
import time

parser = argparse.ArgumentParser()
parser.add_argument("--iterations", type=int, default=20)
parser.add_argument("--envs", type=int, default=128)
parser.add_argument("--rollout", type=int, default=64)
parser.add_argument("--lr", type=float, default=None,
                    help="override the reference learning rate (2.5e-5, "
                         "tuned for 16-env minibatches; large on-chip "
                         "batches can take more)")
parser.add_argument("--ent-coef", type=float, default=None)
parser.add_argument("--mesh", type=int, default=0, help="data-parallel devices")
parser.add_argument("--logdir", default="tmp/loco")
parser.add_argument("--eval-render", default=None,
                    help="after training, path-trace env 0's final pose to "
                         "this PNG (BASELINE config 5's eval-render leg)")
args = parser.parse_args()

import jax
import numpy as np

from d3d12renderer_jax.learning.loco_env import LocoEnv
from d3d12renderer_jax.learning.monitor import MonitorCSV, summarize
from d3d12renderer_jax.learning.ppo import PPOConfig, make_ppo
from d3d12renderer_jax.utils.checkpoint import CheckpointManager

os.makedirs(args.logdir, exist_ok=True)
env = LocoEnv()
config = PPOConfig(num_envs=args.envs, rollout_steps=args.rollout,
                   minibatches=8, epochs=4)
if args.lr is not None:
    config = config.replace(learning_rate=args.lr)
if args.ent_coef is not None:
    config = config.replace(ent_coef=args.ent_coef)

if args.mesh > 1:
    from d3d12renderer_jax.parallel.data_parallel import (
        make_distributed_ppo, make_mesh,
    )
    mesh = make_mesh(args.mesh)
    init, train_iteration, _ = make_distributed_ppo(env, config, mesh)
    print(f"data-parallel over {args.mesh} devices, "
          f"{args.envs * args.mesh} envs total")
else:
    init, train_iteration, _ = make_ppo(env, config)

state = init(jax.random.PRNGKey(0))
ckpts = CheckpointManager(os.path.join(args.logdir, "checkpoints"))
monitor = MonitorCSV(os.path.join(args.logdir, "episodes.csv"))

steps_per_iter = args.envs * args.rollout * max(args.mesh, 1)
t0 = time.time()
iter_times = []
for it in range(args.iterations):
    t_it = time.time()
    state, metrics = train_iteration(state)
    r = float(metrics["reward_mean"])  # device sync: bounds the iteration
    iter_times.append(time.time() - t_it)
    if it % 5 == 0 or it == args.iterations - 1:
        dt = time.time() - t0
        sps = steps_per_iter * (it + 1) / dt
        stats = jax.device_get(state.stats)
        ep = summarize(stats)
        print(f"iter {it:4d}  reward/step {r:.3f}  "
              f"ep-return {ep['mean_return']:.1f} ({int(ep['episodes'])} eps)  "
              f"done-rate {float(metrics['episode_done_rate']):.4f}  "
              f"vf_loss {float(metrics['vf_loss']):.4f}  "
              f"{sps:,.0f} env-steps/s")
        monitor.write(steps_per_iter * (it + 1), stats)
        ckpts.save(it, state.params, metric=r)

print(f"trained {args.iterations * steps_per_iter:,} env-steps "
      f"in {time.time() - t0:.1f}s; checkpoints in {args.logdir}")
if len(iter_times) > 3:
    # Steady-state throughput: drop the compile iteration and report the
    # median-of-rest (robust to host hiccups), the number BASELINE's
    # "env-steps/s incl. updates" target refers to.
    import statistics
    steady = sorted(iter_times[1:])
    med = statistics.median(steady)
    print(f"steady-state: {steps_per_iter / med:,.0f} env-steps/s incl. "
          f"updates (median iter {med * 1e3:.0f} ms; "
          f"best {steps_per_iter / steady[0]:,.0f}/s)")

if args.eval_render:
    from PIL import Image

    from d3d12renderer_jax.render.physics_viz import render_physics_state

    env_state = jax.device_get(state.env_state)
    bodies0 = jax.tree_util.tree_map(lambda x: x[0], env_state.bodies)
    t0 = time.time()
    img = render_physics_state(env.arch, bodies0, eye=(4.0, 2.5, 5.0),
                               target=(0.0, 0.9, 0.0), size=256, spp=8)
    Image.fromarray(img).save(args.eval_render)
    print(f"eval render: wrote {args.eval_render} "
          f"({time.time() - t0:.1f}s, mean luma {img.mean():.1f})")
