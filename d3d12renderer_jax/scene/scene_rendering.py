"""Per-entity render submission: frustum culling + instance batching.

Reference: src/scene/scene_rendering.cpp:907 renderScene — per-frame walk of
renderable entities: frustum-cull, split static/dynamic/animated, batch
instances by mesh (getOffsetsPerMesh, scene_rendering.cpp:79), and emit
sorted draw commands.  Here culling is one vectorized test over all
instances; "batching by mesh" is the static triangle packing of
render/instances.py; the submission output is a visibility mask consumed by
the instanced retransform (invisible instances collapse to a degenerate
point, costing nothing in the dense intersector).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import maths as m
from ..render.camera import Camera
from ..render.instances import InstancedScene, build_instanced
from ..render.mesh import MeshData


def frustum_planes(camera: Camera):
    """(6, 4) world-space frustum planes (nx,ny,nz,d), inward normals
    (reference: core/camera.h frustum plane extraction)."""
    import numpy as _np

    pos = np.asarray(camera.position, np.float64)
    x, y, z, w = np.asarray(camera.rotation, np.float64)
    rm = _np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    right, up, back = rm[:, 0], rm[:, 1], rm[:, 2]
    fwd = -back
    tan_v = math.tan(camera.v_fov / 2)
    tan_h = tan_v * camera.aspect

    def plane(n):
        n = n / np.linalg.norm(n)
        return np.concatenate([n, [-n @ pos]])

    # Side planes from the frustum edge directions (inward normals).
    dir_r = fwd + right * tan_h
    dir_l = fwd - right * tan_h
    dir_t = fwd + up * tan_v
    dir_b = fwd - up * tan_v
    planes = [
        plane(fwd),                    # near (through the camera position)
        plane(np.cross(up, dir_r)),    # right
        plane(np.cross(dir_l, up)),    # left
        plane(np.cross(dir_t, right)),  # top
        plane(np.cross(right, dir_b)),  # bottom
    ]
    return jnp.asarray(np.stack(planes), jnp.float32)


def cull_spheres(planes, centers, radii):
    """(I,) visibility of bounding spheres vs frustum planes — the vectorized
    equivalent of the per-entity frustum test (scene_rendering.cpp:350)."""
    d = jnp.einsum("pk,ik->pi", planes[:, :3], centers) + planes[:, 3:4]
    return jnp.all(d > -radii[None, :], axis=0)


class RenderSubmission:
    """Host-side assembly of the per-frame draw set from scene components."""

    def __init__(self, scene):
        from . import components as C
        from ..render.pathtracer import Materials

        prims = self._prims()
        self.entity_ids: List[int] = []
        self.mesh_keys: List = []
        meshes: List[Tuple[MeshData, int]] = []
        mesh_index: Dict = {}
        instance_mesh: List[int] = []
        mats: List = []
        bound_radius: List[float] = []

        for ent, (tf, mesh) in scene.view("transform", "mesh"):
            if mesh.primitive is None:
                continue
            mat = ent.get("material") or C.Material()
            key = (mesh.primitive, tuple(sorted(mesh.params.items())), len(mats))
            geo = prims[mesh.primitive](**mesh.params)
            mesh_index[key] = len(meshes)
            meshes.append((geo, len(mats)))
            mats.append(mat)
            instance_mesh.append(mesh_index[key])
            self.entity_ids.append(ent.id)
            bound_radius.append(
                float(np.linalg.norm(geo.positions, axis=-1).max())
                * float(tf.scale))

        self.instanced = build_instanced(meshes, instance_mesh)
        self.materials = Materials(
            albedo=jnp.asarray(np.array([mt.albedo for mt in mats], np.float32)),
            emissive=jnp.asarray(np.array([mt.emissive for mt in mats], np.float32)),
            roughness=jnp.asarray(np.array([mt.roughness for mt in mats], np.float32)),
            metallic=jnp.asarray(np.array([mt.metallic for mt in mats], np.float32)),
        )
        self.bound_radius = jnp.asarray(np.array(bound_radius, np.float32))
        self._static_pose = self._poses_from_scene(scene)

    @staticmethod
    def _prims():
        from ..render import mesh as mesh_mod

        return {
            "quad": mesh_mod.quad, "box": mesh_mod.box,
            "sphere": mesh_mod.ico_sphere, "uv_sphere": mesh_mod.uv_sphere,
            "capsule": mesh_mod.capsule, "cylinder": mesh_mod.cylinder,
            "torus": mesh_mod.torus, "arrow": mesh_mod.arrow,
            "mace": mesh_mod.mace, "hollow_cylinder": mesh_mod.hollow_cylinder,
        }

    def _poses_from_scene(self, scene):
        pos, rot = [], []
        for eid in self.entity_ids:
            tf = scene.entity(eid).get("transform")
            pos.append(tf.position)
            rot.append(tf.rotation)
        return (jnp.asarray(np.array(pos, np.float32)),
                jnp.asarray(np.array(rot, np.float32)))

    def instance_poses(self, body_state=None, mapping=None):
        """Instance poses: physics-driven entities take simulated poses
        (the dynamic/static split of renderScene)."""
        pos, rot = self._static_pose
        if body_state is not None and mapping:
            idx = np.array(
                [mapping.get(eid, -1) for eid in self.entity_ids], np.int32)
            has = idx >= 0
            gather = jnp.asarray(np.maximum(idx, 0))
            hasj = jnp.asarray(has)
            pos = jnp.where(hasj[:, None], body_state.pos[gather], pos)
            rot = jnp.where(hasj[:, None], body_state.rot[gather], rot)
        return pos, rot

    def visible_bvh(self, camera: Camera, pos, rot):
        """Frustum-culled per-frame BVH: culled instances collapse to a point
        (zero-area triangles never hit)."""
        from ..render.instances import retransform

        planes = frustum_planes(camera)
        vis = cull_spheres(planes, pos, self.bound_radius)
        scale = jnp.where(vis, 1.0, 0.0)
        return retransform(self.instanced, pos, rot, scales=scale), vis
