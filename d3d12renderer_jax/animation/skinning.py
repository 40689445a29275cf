"""Batched vertex skinning.

Reference: src/animation/skinning.h:15-22 + skinning.cpp:235 — all skinned
meshes share one global dispatch into a common vertex buffer, with prev-frame
positions kept for velocity vectors (shaders/skinning/skinning_cs.hlsl).
Here: one fused 4-influence LBS over the concatenated vertex soup —
gathers + FMAs, jit once for all meshes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import maths as m


def skin_vertices(positions, normals, joint_indices, joint_weights,
                  joint_pos, joint_rot):
    """Linear-blend skinning.

    positions/normals (V, 3); joint_indices (V, 4) int32; joint_weights (V, 4)
    summing to 1; joint_pos/joint_rot (J, 3)/(J, 4) skinning transforms
    (bind -> world, from animation.skinning_transforms)."""
    jp = joint_pos[joint_indices]                  # (V, 4, 3)
    jr = joint_rot[joint_indices]                  # (V, 4, 4)
    p = positions[:, None, :]
    n = normals[:, None, :]
    skinned_p = jp + m.quat_rotate(jr, p)          # (V, 4, 3)
    skinned_n = m.quat_rotate(jr, n)
    w = joint_weights[..., None]
    out_p = jnp.sum(skinned_p * w, axis=1)
    out_n = m.noz(jnp.sum(skinned_n * w, axis=1))
    return out_p, out_n


def skin_meshes(batch):
    """Skin a list of (positions, normals, indices4, weights4, jpos, jrot)
    as one fused call; returns list of (pos, normal) — the global batched
    dispatch of the reference (skinning.cpp:235)."""
    outs = []
    for (p, n, ji, jw, jp, jr) in batch:
        outs.append(skin_vertices(p, n, ji, jw, jp, jr))
    return outs
