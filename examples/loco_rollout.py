"""Random-policy rollout of the batched ragdoll locomotion env.

Usage: python examples/loco_rollout.py [--batch 16] [--steps 120]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` / `python tools/x.py` without installing
# the package (the repo root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

parser = argparse.ArgumentParser()
parser.add_argument("--batch", type=int, default=16)
parser.add_argument("--steps", type=int, default=120)
args = parser.parse_args()

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.learning.loco_env import ACTION_SIZE, LocoEnv, make_vec_env

env = LocoEnv()
reset, step = make_vec_env(env, args.batch)

key = jax.random.PRNGKey(0)
obs, st = reset(key)

t0 = time.time()
rewards, dones = [], 0
for i in range(args.steps):
    key, k = jax.random.split(key)
    actions = 0.3 * jax.random.normal(k, (args.batch, ACTION_SIZE))
    obs, st, r, d = step(st, actions)
    rewards.append(float(r.mean()))
    dones += int(d.sum())
jax.block_until_ready(obs)
dt = time.time() - t0

print(f"{args.steps} steps x {args.batch} envs in {dt:.2f}s "
      f"({args.steps * args.batch / dt:,.0f} env-steps/s incl. compile)")
print(f"mean reward: {np.mean(rewards):.3f}  first/last: "
      f"{rewards[0]:.3f}/{rewards[-1]:.3f}  episode terminations: {dones}")
print(f"obs finite: {bool(jnp.isfinite(obs).all())}")
