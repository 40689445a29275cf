"""Two-level scene instancing: static meshes + per-frame instance transforms.

Reference: BLAS per mesh built once (src/rendering/raytracing.h:41) and a
TLAS of instance transforms rebuilt every frame
(src/rendering/raytracing_tlas.h:10-26, application.cpp:655-665).

Equivalent here: per-mesh triangle soups are packed once into a fixed buffer;
each frame, a jitted function applies the instance poses (e.g. straight from
physics BodyState) and rebuilds the dense plane tables ON DEVICE — the
per-frame cost is elementwise math over the triangle buffer, no host round
trip, so sim -> eval render stays on the device (BASELINE config 5).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import maths as m
from .bvh import BVH, DenseTris, build_dense
from .mesh import MeshData


@struct.dataclass
class InstancedScene:
    """Static per-instance triangle buffer with per-triangle instance ids."""

    v0: jnp.ndarray          # (T, 3) mesh-local
    v1: jnp.ndarray          # (T, 3)
    v2: jnp.ndarray          # (T, 3)
    n0: jnp.ndarray          # (T, 3)
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray         # (T, 2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    material: jnp.ndarray    # (T,)
    instance: jnp.ndarray    # (T,) int32 instance id per triangle
    valid: jnp.ndarray       # (T,)


def build_instanced(meshes: List[Tuple[MeshData, int]],
                    instance_mesh: Sequence[int]) -> InstancedScene:
    """`meshes[k]` = (mesh, material); `instance_mesh[i]` = mesh index of
    instance i.  Triangles are replicated per instance ONCE at build (the
    BLAS packing); only transforms change per frame."""
    v0s, v1s, v2s, n0s, n1s, n2s, u0s, u1s, u2s, mats, inst = \
        [], [], [], [], [], [], [], [], [], [], []
    for i, mesh_id in enumerate(instance_mesh):
        mesh, mat = meshes[mesh_id]
        p, n, uv, idx = (mesh.positions, mesh.normals, mesh.uvs, mesh.indices)
        v0s.append(p[idx[:, 0]])
        v1s.append(p[idx[:, 1]])
        v2s.append(p[idx[:, 2]])
        n0s.append(n[idx[:, 0]])
        n1s.append(n[idx[:, 1]])
        n2s.append(n[idx[:, 2]])
        u0s.append(uv[idx[:, 0]])
        u1s.append(uv[idx[:, 1]])
        u2s.append(uv[idx[:, 2]])
        mats.append(np.full(len(idx), mat, np.int32))
        inst.append(np.full(len(idx), i, np.int32))

    def cat(xs):
        return jnp.asarray(np.concatenate(xs).astype(np.float32))

    t = sum(len(x) for x in mats)
    pad = (-t) % 512

    def padf(x, w):
        x = np.concatenate(x).astype(np.float32)
        return jnp.asarray(np.concatenate([x, np.zeros((pad, w), np.float32)]))

    return InstancedScene(
        v0=padf(v0s, 3), v1=padf(v1s, 3), v2=padf(v2s, 3),
        n0=padf(n0s, 3), n1=padf(n1s, 3), n2=padf(n2s, 3),
        uv0=padf(u0s, 2), uv1=padf(u1s, 2), uv2=padf(u2s, 2),
        material=jnp.asarray(np.concatenate(
            [np.concatenate(mats), np.zeros(pad, np.int32)])),
        instance=jnp.asarray(np.concatenate(
            [np.concatenate(inst), np.zeros(pad, np.int32)])),
        valid=jnp.asarray(np.concatenate(
            [np.ones(t, bool), np.zeros(pad, bool)])),
    )


def retransform(scene: InstancedScene, positions, rotations,
                scales=None) -> BVH:
    """Per-frame 'TLAS rebuild': apply instance poses and produce a BVH pytree
    whose dense tables drive closest_hit.  positions (I, 3), rotations (I, 4);
    all device-side, jit-friendly."""
    inst = scene.instance
    pos = positions[inst]
    rot = rotations[inst]
    s = (scales[inst][:, None] if scales is not None else 1.0)

    def xf(v):
        return pos + m.quat_rotate(rot, v * s)

    def xd(n):
        return m.quat_rotate(rot, n)

    v0 = xf(scene.v0)
    v1 = xf(scene.v1)
    v2 = xf(scene.v2)

    shell = BVH(
        node_min=jnp.zeros((1, 3)), node_max=jnp.zeros((1, 3)),
        node_first=jnp.zeros((1,), jnp.int32),
        node_count=jnp.zeros((1,), jnp.int32),
        node_miss=jnp.ones((1,), jnp.int32),
        tri_v0=v0, tri_e1=v1 - v0, tri_e2=v2 - v0,
        tri_n0=xd(scene.n0), tri_n1=xd(scene.n1), tri_n2=xd(scene.n2),
        tri_uv0=scene.uv0, tri_uv1=scene.uv1, tri_uv2=scene.uv2,
        tri_material=scene.material, tri_valid=scene.valid,
    )
    return shell.replace(dense=build_dense(shell))


def render_bodies(scene: InstancedScene, body_state, materials, sky,
                  camera, width, height, spp=4,
                  settings=None, key=None):
    """Physics state -> image, fully on device: retransform + path trace."""
    from .pathtracer import PathTracerSettings, Scene, render

    bvh = retransform(scene, body_state.pos, body_state.rot)
    rscene = Scene(bvh=bvh, materials=materials, sky=sky)
    return render(rscene, camera, width, height,
                  settings or PathTracerSettings(recursion_depth=2),
                  spp=spp, key=key)
