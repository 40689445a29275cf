"""Vectorized DReCon-style ragdoll locomotion environment, fully on-device.

Replaces the reference's C++ physics DLL + ctypes gym wrapper + SubprocVecEnv
process pool (reference: src/learning/learned_locomotion.cpp:395-489,
learning/loco_env.py:7-62, learning/util.py:30-47) with a pure-JAX env whose
batch axis is `jax.vmap` — thousands of ragdolls per device, shardable across a
device mesh with data parallelism.

State (66): cog velocity, 6 body-part positions+velocities in the torso ground
frame, last smoothed action (reference: learned_locomotion.h:41-64).
Action (27): per cone-twist {twist target, swing target, swing axis angle} x 7,
per hinge {target angle} x 6 (reference: learned_locomotion.h:17-33).
Reward: DReCon imitation of the standing pose + fall factor
(reference: learned_locomotion.cpp:343-365 getReward).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import maths as m
from ..models import ragdoll as rd
from ..physics.builder import SceneBuilder
from ..physics.step import physics_step
from ..physics.types import BodyState, PhysicsSettings

NUM_PARTS = 14
ACTION_SIZE = rd.NUM_CONE_TWIST * 3 + rd.NUM_HINGE  # 27
STATE_SIZE = 3 + 6 * 6 + ACTION_SIZE                # 66

ACTION_SMOOTHING = 0.1   # reference: learned_locomotion.cpp:95
POKE_PROBABILITY = 0.02  # reference: learned_locomotion.cpp:459
POKE_STRENGTH = 1000.0   # reference: physics.h:404 testPhysicsInteraction default
FRAME_RATE = 60          # reference: learned_locomotion.cpp:470

# State observation parts, struct order (reference: learned_locomotion.h:41-64).
OBS_PARTS = ["left_toes", "right_toes", "torso", "head",
             "left_lower_arm", "right_lower_arm"]


@struct.dataclass
class EnvState:
    bodies: BodyState
    last_action: jnp.ndarray   # (27,) smoothed
    rng: jnp.ndarray           # PRNG key
    steps: jnp.ndarray         # () int32


class LocoEnv:
    """Single-environment definition; `reset`/`step` are pure and vmap-able."""

    def __init__(self, settings: Optional[PhysicsSettings] = None,
                 self_collision: bool = False):
        b = SceneBuilder()
        b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0, restitution=0.1)
        info = rd.build_humanoid_ragdoll(
            b, hip_position=(0.0, 1.25, 0.0), self_collision=self_collision
        )
        self.arch, self._state0 = b.finalize()
        self.info = info
        self.settings = settings or PhysicsSettings(frame_rate=FRAME_RATE)

        # Joint-table bookkeeping: builder groups joints by kind (sorted);
        # rows within each table keep insertion order == ragdoll.h order.
        self._table_index = {t.kind: k for k, t in enumerate(self.arch.joints)}
        self._num_tables = len(self.arch.joints)

        self.part_idx = jnp.asarray(np.array(info.body_indices, np.int32))
        self.parent_idx = jnp.asarray(np.array(rd.BODY_PART_PARENTS, np.int32))
        self.local_points = jnp.asarray(info.local_points)  # (14,6,3)
        self.obs_part_slots = jnp.asarray(np.array(
            [rd.BODY_PARTS.index(n) for n in OBS_PARTS], np.int32))

        # Imitation targets from the initial standing pose
        # (reference: training_locomotion::reset, getBodyPartTarget).
        p0 = self._state0
        pts0 = self._world_points(p0)                 # (14,6,3)
        self.target_points = pts0
        self.target_velocities = jnp.zeros_like(pts0)
        q0 = p0.rot[self.part_idx]                    # (14,4)
        qp0 = jnp.where(
            (self.parent_idx >= 0)[:, None],
            p0.rot[self.part_idx[jnp.maximum(self.parent_idx, 0)]],
            jnp.zeros((NUM_PARTS, 4)).at[:, 3].set(1.0),
        )
        self.target_local_rot = m.quat_mul(q0, m.quat_conj(qp0))  # (14,4)
        head = rd.BODY_PARTS.index("head")
        self.head_target_height = float(p0.pos[self.part_idx[head], 1])
        self.torso_velocity_target = jnp.zeros(3)

    # -- helpers -----------------------------------------------------------

    def _world_points(self, bodies: BodyState):
        """World positions of the 6 sample points of each part.

        transformPosition(bodyTransform, p) with COG state:
        world = cog + R (p_local - local_cog)."""
        idx = self.part_idx
        cog = bodies.pos[idx]            # (14,3)
        rot = bodies.rot[idx]            # (14,4)
        lc = self.arch.local_cog[idx]    # (14,3)
        rel = self.local_points - lc[:, None, :]
        return cog[:, None, :] + m.quat_rotate(rot[:, None, :], rel)

    def _coordinate_origin(self, bodies: BodyState):
        """Torso COG projected to the ground, identity rotation
        (reference: learned_locomotion.cpp:113 getCoordinateSystem)."""
        torso = bodies.pos[self.part_idx[0]]
        return torso * jnp.array([1.0, 0.0, 1.0])

    def _get_obs(self, bodies: BodyState, last_action):
        origin = self._coordinate_origin(bodies)
        torso_vel = bodies.vel[self.part_idx[0]]
        slots = self.obs_part_slots
        pos = bodies.pos[self.part_idx[slots]] - origin   # (6,3)
        vel = bodies.vel[self.part_idx[slots]]            # (6,3)
        pv = jnp.concatenate([pos, vel], axis=-1).reshape(-1)  # (36,)
        return jnp.concatenate([torso_vel, pv, last_action])

    def _has_fallen(self, bodies: BodyState):
        head_y = bodies.pos[self.part_idx[rd.BODY_PARTS.index("head")], 1]
        return head_y < 1.0

    def _reward(self, bodies: BodyState):
        """reference: training_locomotion::getReward (learned_locomotion.cpp:343)."""
        idx = self.part_idx
        pts = self._world_points(bodies)                       # (14,6,3)
        pos_err = jnp.sum(jnp.linalg.norm(pts - self.target_points, axis=-1))

        cog = bodies.pos[idx]
        vel = bodies.vel[idx]
        omega = bodies.omega[idx]
        pt_vel = vel[:, None, :] + jnp.cross(
            omega[:, None, :], pts - cog[:, None, :]
        )
        vel_err = jnp.sum(jnp.linalg.norm(pt_vel - self.target_velocities, axis=-1))

        q = bodies.rot[idx]
        qp = jnp.where(
            (self.parent_idx >= 0)[:, None],
            bodies.rot[idx[jnp.maximum(self.parent_idx, 0)]],
            jnp.zeros((NUM_PARTS, 4)).at[:, 3].set(1.0),
        )
        local = m.quat_mul(q, m.quat_conj(qp))
        diff = m.quat_mul(self.target_local_rot, m.quat_conj(local))
        rot_err = jnp.sum(2.0 * jnp.arccos(jnp.clip(diff[..., 3], -1.0, 1.0)))

        vcm_err = m.length(bodies.vel[idx[0]] - self.torso_velocity_target)

        n = float(NUM_PARTS)
        rp = jnp.exp(-10.0 / n * pos_err)
        rv = jnp.exp(-1.0 / n * vel_err)
        rlocal = jnp.exp(-10.0 / n * rot_err)
        rvcm = jnp.exp(-vcm_err)

        head_y = bodies.pos[idx[rd.BODY_PARTS.index("head")], 1]
        fall = jnp.clip(1.3 - 1.4 * (self.head_target_height - head_y), 0.0, 1.0)
        return fall * (rp + rv + rlocal + rvcm)

    def _motor_overrides(self, smoothed_action):
        """Works for per-scene (27,) and batched (..., 27) actions."""
        lead = smoothed_action.shape[:-1]
        ct = smoothed_action[..., : rd.NUM_CONE_TWIST * 3].reshape(
            lead + (rd.NUM_CONE_TWIST, 3))
        hinge = smoothed_action[..., rd.NUM_CONE_TWIST * 3:]
        overrides = [None] * self._num_tables
        overrides[self._table_index["cone_twist"]] = {
            "twist_target": ct[..., 0],
            "swing_target": ct[..., 1],
            "swing_axis_angle": ct[..., 2],
        }
        overrides[self._table_index["hinge"]] = {"motor_target": hinge}
        return tuple(overrides)

    def _maybe_poke(self, bodies: BodyState, key):
        """Random horizontal impulse poke on one body part
        (reference: learned_locomotion.cpp:459-467 + physics.cpp:555)."""
        k1, k2, k3 = jax.random.split(key, 3)
        do = jax.random.uniform(k1) < POKE_PROBABILITY
        part = jax.random.randint(k2, (), 0, NUM_PARTS)
        theta = jax.random.uniform(k3, minval=0.0, maxval=2.0 * jnp.pi)
        direction = jnp.array([jnp.cos(theta), 0.0, jnp.sin(theta)])
        body = self.part_idx[part]
        point = bodies.pos[body] + jnp.array([0.0, 0.2, 0.0])
        force = direction * POKE_STRENGTH * do
        torque = jnp.cross(point - bodies.pos[body], force)
        return bodies.replace(
            force=bodies.force.at[body].add(force),
            torque=bodies.torque.at[body].add(torque),
        )

    # -- public API --------------------------------------------------------

    def reset(self, key) -> Tuple[jnp.ndarray, EnvState]:
        zero_action = jnp.zeros(ACTION_SIZE)
        env_state = EnvState(
            bodies=self._state0,
            last_action=zero_action,
            rng=key,
            steps=jnp.zeros((), jnp.int32),
        )
        return self._get_obs(self._state0, zero_action), env_state

    def _step_core(self, bodies: BodyState, smoothed):
        """Physics + done/reward/obs + body auto-reset for one scene."""
        bodies, _ = physics_step(
            self.arch, bodies, self.settings, 1.0 / FRAME_RATE,
            motor_overrides=self._motor_overrides(smoothed),
        )
        done = self._has_fallen(bodies)
        reward = jnp.where(done, 0.0, self._reward(bodies))
        obs = self._get_obs(bodies, smoothed)

        # Auto-reset (vectorized-env convention, like the reference's VecEnv).
        bodies = jax.tree_util.tree_map(
            lambda a, b: jnp.where(done, a, b), self._state0, bodies
        )
        obs = jnp.where(
            done, self._get_obs(self._state0, jnp.zeros(ACTION_SIZE)), obs)
        return bodies, obs, reward, done

    def step(self, env_state: EnvState, action) -> Tuple[
        jnp.ndarray, EnvState, jnp.ndarray, jnp.ndarray
    ]:
        """One 60 Hz control step: action smoothing, a random poke, then
        physics, observation, reward and the fall check (_step_core).
        Auto-resets the bodies when the ragdoll has fallen."""
        rng, poke_key = jax.random.split(env_state.rng)
        smoothed = env_state.last_action + ACTION_SMOOTHING * (
            action - env_state.last_action
        )
        bodies = self._maybe_poke(env_state.bodies, poke_key)
        bodies, obs, reward, done = self._step_core(bodies, smoothed)
        smoothed = jnp.where(done, jnp.zeros_like(smoothed), smoothed)
        env_state = EnvState(
            bodies=bodies, last_action=smoothed, rng=rng,
            steps=jnp.where(done, 0, env_state.steps + 1),
        )
        return obs, env_state, reward, done

    def action_limits(self):
        """Per-dimension action bounds from joint limits
        (reference: learned_locomotion.cpp:365-427 getPhysicsRanges/getLimits)."""
        lo, hi = [], []
        ct_table = self.arch.joints[self._table_index["cone_twist"]]
        h_table = self.arch.joints[self._table_index["hinge"]]
        tl = np.asarray(ct_table.params["twist_limit"])
        sl = np.asarray(ct_table.params["swing_limit"])
        for i in range(rd.NUM_CONE_TWIST):
            t = tl[i] if tl[i] >= 0 else np.pi
            s = sl[i] if sl[i] >= 0 else np.pi
            lo += [-t, -s, -np.pi]
            hi += [t, s, np.pi]
        mn = np.asarray(h_table.params["min_limit"])
        mx = np.asarray(h_table.params["max_limit"])
        for i in range(rd.NUM_HINGE):
            lo.append(mn[i] if mn[i] <= 0 else -np.pi)
            hi.append(mx[i] if mx[i] >= 0 else np.pi)
        return np.array(lo, np.float32), np.array(hi, np.float32)


def make_vec_env(env: LocoEnv, batch_size: int):
    """Jitted batched reset/step over a leading env axis (vmap)."""

    @jax.jit
    def reset(key):
        keys = jax.random.split(key, batch_size)
        return jax.vmap(env.reset)(keys)

    @jax.jit
    def step(env_state, actions):
        return jax.vmap(env.step)(env_state, actions)

    return reset, step
