"""Skeletal animation: skeletons, clip sampling, blending, root motion.

Reference: src/animation/animation.h:46-152 — skeleton (joints with parent
indices + inverse bind), keyframe sampling with interpolation, clip blending,
root-motion extraction.  Design: clips are resampled on import to a
UNIFORM key grid so sampling is a closed-form gather + lerp/nlerp over all
joints at once (no per-joint binary search), and forward kinematics runs as a
fixed sequence of per-depth-level batched transform compositions.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import maths as m


@struct.dataclass
class Skeleton:
    parent: jnp.ndarray          # (J,) int32, -1 for roots
    inv_bind_pos: jnp.ndarray    # (J, 3)
    inv_bind_rot: jnp.ndarray    # (J, 4)
    # Topological levels for vectorized FK: joints sorted by depth.
    level_order: Tuple[jnp.ndarray, ...] = struct.field(pytree_node=False)

    @property
    def num_joints(self):
        return self.parent.shape[0]


@struct.dataclass
class AnimationClip:
    """Uniform-rate keyframes: (J, K, ...) arrays, `duration` seconds."""

    positions: jnp.ndarray       # (J, K, 3)
    rotations: jnp.ndarray       # (J, K, 4)
    scales: jnp.ndarray          # (J, K)
    duration: float = struct.field(pytree_node=False)
    looping: bool = struct.field(pytree_node=False, default=True)


@struct.dataclass
class LocalPose:
    position: jnp.ndarray        # (J, 3)
    rotation: jnp.ndarray        # (J, 4)
    scale: jnp.ndarray           # (J,)


def make_skeleton(parents: List[int], bind_pos: np.ndarray,
                  bind_rot: Optional[np.ndarray] = None) -> Skeleton:
    """Build from parent list + bind LOCAL transforms; computes inverse bind."""
    j = len(parents)
    bind_rot = bind_rot if bind_rot is not None else np.tile(
        [0, 0, 0, 1.0], (j, 1))
    # World bind transforms by walking parents (host side).
    wp = np.zeros((j, 3))
    wr = np.zeros((j, 4))
    for i in range(j):
        p = parents[i]
        if p < 0:
            wp[i], wr[i] = bind_pos[i], bind_rot[i]
        else:
            wr[i] = _qmul_np(wr[p], bind_rot[i])
            wp[i] = wp[p] + _qrot_np(wr[p], bind_pos[i])
    inv_rot = np.stack([-wr[:, 0], -wr[:, 1], -wr[:, 2], wr[:, 3]], -1)
    inv_pos = np.stack([_qrot_np(inv_rot[i], -wp[i]) for i in range(j)])

    # Depth levels.
    depth = np.zeros(j, np.int32)
    for i in range(j):
        if parents[i] >= 0:
            depth[i] = depth[parents[i]] + 1
    levels = tuple(
        jnp.asarray(np.nonzero(depth == d)[0].astype(np.int32))
        for d in range(depth.max() + 1)
    )
    return Skeleton(
        parent=jnp.asarray(np.array(parents, np.int32)),
        inv_bind_pos=jnp.asarray(inv_pos.astype(np.float32)),
        inv_bind_rot=jnp.asarray(inv_rot.astype(np.float32)),
        level_order=levels,
    )


def _qmul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _qrot_np(q, v):
    u = q[:3]
    w = q[3]
    return 2 * (u @ v) * u + (w * w - u @ u) * v + 2 * w * np.cross(u, v)


def sample_clip(clip: AnimationClip, t) -> LocalPose:
    """Sample all joint tracks at time t (reference: animation.h sampling +
    lerp/slerp between keys; nlerp here, standard for game runtimes)."""
    k = clip.positions.shape[1]
    tt = jnp.where(clip.looping, jnp.mod(t, clip.duration),
                   jnp.clip(t, 0.0, clip.duration))
    f = tt / clip.duration * (k - 1)
    i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, k - 2)
    i1 = i0 + 1
    a = (f - i0)[..., None]

    p = clip.positions[:, i0] * (1 - a) + clip.positions[:, i1] * a
    q0 = clip.rotations[:, i0]
    q1 = clip.rotations[:, i1]
    # nlerp with hemisphere correction.
    sign = jnp.where(jnp.sum(q0 * q1, -1, keepdims=True) < 0, -1.0, 1.0)
    q = m.normalize(q0 * (1 - a) + q1 * sign * a)
    s = clip.scales[:, i0] * (1 - a[..., 0]) + clip.scales[:, i1] * a[..., 0]
    return LocalPose(position=p, rotation=q, scale=s)


def blend_poses(a: LocalPose, b: LocalPose, alpha) -> LocalPose:
    """reference: animation.h blend between two sampled poses."""
    sign = jnp.where(jnp.sum(a.rotation * b.rotation, -1, keepdims=True) < 0,
                     -1.0, 1.0)
    return LocalPose(
        position=a.position * (1 - alpha) + b.position * alpha,
        rotation=m.normalize(a.rotation * (1 - alpha) + b.rotation * sign * alpha),
        scale=a.scale * (1 - alpha) + b.scale * alpha,
    )


def forward_kinematics(skel: Skeleton, pose: LocalPose):
    """Local pose -> world-space joint transforms (pos (J,3), rot (J,4)).

    Sequential over depth levels, vectorized within each level."""
    wp = pose.position
    wr = pose.rotation
    for level in skel.level_order[1:]:
        par = skel.parent[level]
        new_r = m.quat_mul(wr[par], pose.rotation[level])
        new_p = wp[par] + m.quat_rotate(wr[par], pose.position[level])
        wr = wr.at[level].set(new_r)
        wp = wp.at[level].set(new_p)
    return wp, wr


def skinning_transforms(skel: Skeleton, world_pos, world_rot):
    """Per-joint (rot, pos) mapping BIND space -> world (world * inverseBind)."""
    rot = m.quat_mul(world_rot, skel.inv_bind_rot)
    pos = world_pos + m.quat_rotate(world_rot, skel.inv_bind_pos)
    return pos, rot


def extract_root_motion(clip: AnimationClip, root_joint: int = 0):
    """Split the root track into a returned motion delta and an in-place clip
    (reference: animation.h root motion extraction)."""
    root_p = clip.positions[root_joint]                      # (K, 3)
    ground = root_p * jnp.array([1.0, 0.0, 1.0])
    in_place = clip.positions.at[root_joint].set(root_p - ground)
    return clip.replace(positions=in_place), ground
