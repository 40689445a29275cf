"""Entity scene: the ECS-equivalent authoring layer.

Replaces the reference's EnTT-backed game_scene (reference:
src/scene/scene.h:231-385 — createEntity/addComponent/view/clone) with a
host-side registry whose `compile()` lowers everything into the fixed-shape
device tables (physics SceneArchetype + render scene), per the "state, not
objects" design stance (SURVEY.md §7).

Component hooks fire on add_component like the reference's EnTT hooks
(scene.h:38-94): colliders accumulate per-entity, rigid bodies trigger mass
recomputation at compile, cloth pins fixed vertices.

Serialization: YAML save/load of the full entity description (reference:
src/scene/serialization_yaml.cpp:363,454) — components are dataclasses so
reflection is free.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..physics.builder import SceneBuilder
from ..physics import cloth as cloth_mod
from . import components as C


class Entity:
    """Handle into a Scene (reference: scene_entity, src/scene/scene.h:26)."""

    def __init__(self, scene: "Scene", eid: int):
        self.scene = scene
        self.id = eid

    def add_component(self, comp) -> "Entity":
        kind = comp.component_name
        store = self.scene._components.setdefault(kind, {})
        if kind in ("collider", "joint"):
            store.setdefault(self.id, []).append(comp)
        else:
            store[self.id] = comp
        return self

    def get(self, kind: str):
        v = self.scene._components.get(kind, {}).get(self.id)
        return v

    def has(self, kind: str) -> bool:
        return self.id in self.scene._components.get(kind, {})

    @property
    def name(self) -> str:
        return self.scene._names.get(self.id, f"entity{self.id}")

    def __repr__(self):
        return f"Entity({self.name})"


class Scene:
    """reference: game_scene (src/scene/scene.h:231)."""

    def __init__(self):
        self._next_id = 0
        self._entities: List[int] = []
        self._names: Dict[int, str] = {}
        self._components: Dict[str, Dict[int, Any]] = {}
        self.planes: List[Tuple] = []  # static world planes

    # -- entity management (reference: scene.h createEntity/deleteEntity) ----

    def create_entity(self, name: str = "") -> Entity:
        eid = self._next_id
        self._next_id += 1
        self._entities.append(eid)
        self._names[eid] = name or f"entity{eid}"
        return Entity(self, eid)

    def delete_entity(self, entity: Entity):
        self._entities.remove(entity.id)
        self._names.pop(entity.id, None)
        for store in self._components.values():
            store.pop(entity.id, None)

    def entity(self, eid: int) -> Entity:
        return Entity(self, eid)

    def add_static_plane(self, normal, offset, friction=0.8, restitution=0.0):
        self.planes.append((tuple(normal), float(offset), friction, restitution))

    # -- views (reference: scene.h view/group) -------------------------------

    def view(self, *kinds: str) -> Iterator[Tuple[Entity, tuple]]:
        """Iterate entities having ALL the given component kinds."""
        if not kinds:
            for eid in self._entities:
                yield Entity(self, eid), ()
            return
        stores = [self._components.get(k, {}) for k in kinds]
        for eid in self._entities:
            if all(eid in s for s in stores):
                yield Entity(self, eid), tuple(s[eid] for s in stores)

    def count(self, kind: str) -> int:
        return len(self._components.get(kind, {}))

    # -- play-mode cloning (reference: scene.h:359 cloneTo) ------------------

    def clone(self) -> "Scene":
        return copy.deepcopy(self)

    # -- compilation to device tables ----------------------------------------

    def compile_physics(self):
        """Lower physics components into (SceneArchetype, BodyState, mapping).

        mapping[entity_id] -> body index; static colliders (no rigid_body)
        attach to a kinematic body."""
        b = SceneBuilder()
        for (n, off, fr, re) in self.planes:
            b.add_static_plane(n, off, fr, re)

        mapping: Dict[int, int] = {}
        for ent, (tf,) in self.view("transform"):
            colliders = ent.get("collider")
            rb = ent.get("rigid_body")
            if not colliders and rb is None:
                continue
            body = b.add_body(
                position=tf.position, rotation=tf.rotation,
                kinematic=(rb.kinematic if rb else True),
                mass=(rb.mass if rb else None),
                gravity_factor=(rb.gravity_factor if rb else 1.0),
                linear_damping=(rb.linear_damping if rb else 0.4),
                angular_damping=(rb.angular_damping if rb else 0.4),
            )
            mapping[ent.id] = body
            for col in colliders or []:
                self._add_collider(b, body, col)

        # Joint components (reference: constraint creation from the editor,
        # physics.cpp:147-330).  Resolved after every body exists; a joint
        # whose `other` entity has no body attaches to the static world
        # body via a kinematic anchor error.
        for ent, (tf,) in self.view("transform"):
            for j in ent.get("joint") or []:
                a = mapping.get(ent.id)
                if a is None:
                    raise ValueError(
                        f"entity {ent.name} has a joint but no rigid body")
                if j.other not in mapping:
                    raise ValueError(
                        f"joint on {ent.name}: other entity {j.other} has "
                        f"no rigid body")
                bb = mapping[j.other]
                mtype = 1.0 if j.motor_type == "position" else 0.0
                idx = None
                if j.kind == "distance":
                    idx = b.add_distance_joint(
                        a, bb, j.anchor, j.anchor_b or j.anchor,
                        length=j.length)
                elif j.kind == "ball":
                    idx = b.add_ball_joint(a, bb, j.anchor)
                elif j.kind == "fixed":
                    idx = b.add_fixed_joint(a, bb, j.anchor)
                elif j.kind == "hinge":
                    idx = b.add_hinge_joint(
                        a, bb, j.anchor, j.axis,
                        min_limit=j.limit_min, max_limit=j.limit_max,
                        motor_type=mtype, motor_target=j.motor_target,
                        max_torque=(j.motor_max if j.motor_max > 0
                                    else None))
                elif j.kind == "cone_twist":
                    idx = b.add_cone_twist_joint(
                        a, bb, j.anchor, j.axis,
                        swing_limit=j.swing_limit,
                        twist_limit=j.twist_limit,
                        twist_motor_type=mtype,
                        twist_target=j.motor_target,
                        max_twist_torque=(j.motor_max if j.motor_max > 0
                                          else None))
                elif j.kind == "slider":
                    idx = b.add_slider_joint(
                        a, bb, j.anchor, j.axis,
                        neg_limit=j.limit_min, pos_limit=j.limit_max,
                        motor_type=mtype, motor_target=j.motor_target,
                        max_force=(j.motor_max if j.motor_max > 0
                                   else None))
                else:
                    raise ValueError(f"unknown joint kind {j.kind!r}")
                if j.collide_connected:
                    b.set_collide_connected(idx)

        arch, state = b.finalize()
        return arch, state, mapping

    @staticmethod
    def _add_collider(b: SceneBuilder, body: int, col: C.Collider):
        s = col.size
        kw = dict(density=col.density, friction=col.friction,
                  restitution=col.restitution)
        if col.shape == "sphere":
            b.add_sphere_collider(body, radius=s[0], center=col.center, **kw)
        elif col.shape == "capsule":
            b.add_capsule_collider(body, radius=s[0], half_length=s[1],
                                   center=col.center, rotation=col.rotation, **kw)
        elif col.shape == "box":
            b.add_box_collider(body, half_extents=s, center=col.center,
                               rotation=col.rotation, **kw)
        elif col.shape == "cylinder":
            b.add_cylinder_collider(body, radius=s[0], half_length=s[1],
                                    center=col.center, rotation=col.rotation, **kw)
        elif col.shape == "hull":
            b.add_hull_collider(body, col.points, center=col.center,
                                rotation=col.rotation, **kw)
        else:
            raise ValueError(f"unknown collider shape {col.shape!r}")

    def compile_cloths(self):
        """(ClothParams, ClothState, entity ids) for every cloth component."""
        out = []
        for ent, (tf, cl) in self.view("transform", "cloth"):
            params, state = cloth_mod.create_cloth(
                cl.width, cl.height, cl.grid_x, cl.grid_y, cl.total_mass,
                cl.stiffness, cl.damping, cl.gravity_factor, cl.fix_top_row,
            )
            offset = np.asarray(tf.position, np.float32)
            state = state.replace(
                positions=state.positions + offset,
                prev_positions=state.prev_positions + offset,
            )
            out.append((ent.id, params, state))
        return out

    def build_render_scene(self, body_state=None, mapping=None):
        """Assemble (BVH, Materials, Sky) from mesh+material components.

        With `body_state`+`mapping`, physics-driven entities render at their
        simulated poses (reference: per-frame TLAS rebuild,
        application.cpp:655-665)."""
        import jax.numpy as jnp

        from ..render import bvh as bvh_mod
        from ..render import mesh as mesh_mod
        from ..render.pathtracer import Materials, Scene as RScene, default_sky, Sky

        prims = {
            "quad": mesh_mod.quad, "box": mesh_mod.box,
            "sphere": mesh_mod.ico_sphere, "uv_sphere": mesh_mod.uv_sphere,
            "capsule": mesh_mod.capsule, "cylinder": mesh_mod.cylinder,
            "torus": mesh_mod.torus, "arrow": mesh_mod.arrow,
            "mace": mesh_mod.mace, "hollow_cylinder": mesh_mod.hollow_cylinder,
        }

        mats: List[C.Material] = []
        mat_index: Dict[int, int] = {}
        meshes = []
        for ent, (tf, mesh) in self.view("transform", "mesh"):
            if mesh.primitive is None:
                continue
            mat = ent.get("material") or C.Material()
            key = ent.id
            mat_index[key] = len(mats)
            mats.append(mat)

            geo = prims[mesh.primitive](**mesh.params)
            pos, rot = tf.position, tf.rotation
            if body_state is not None and mapping and ent.id in mapping:
                bi = mapping[ent.id]
                pos = np.asarray(body_state.pos[bi])
                rot = np.asarray(body_state.rot[bi])
            geo = geo.transformed(translate=pos, rotate=rot, scale=tf.scale)
            meshes.append((geo, mat_index[key]))

        sun = None
        for ent, (dl,) in self.view("directional_light"):
            sun = dl
        sky = default_sky(tuple(-d for d in sun.direction)) if sun else default_sky()
        if sun:
            sky = sky.replace(
                sun_radiance=jnp.asarray(sun.color) * sun.intensity
            )

        bvh = bvh_mod.build_bvh(meshes)
        materials = Materials(
            albedo=jnp.asarray(np.array([m.albedo for m in mats], np.float32)),
            emissive=jnp.asarray(np.array([m.emissive for m in mats], np.float32)),
            roughness=jnp.asarray(np.array([m.roughness for m in mats], np.float32)),
            metallic=jnp.asarray(np.array([m.metallic for m in mats], np.float32)),
        )
        return RScene(bvh=bvh, materials=materials, sky=sky)

    # -- serialization (reference: serialization_yaml.cpp:363,454) -----------

    def save_yaml(self, path: str):
        doc = {"planes": [list(p[0]) + [p[1], p[2], p[3]] for p in self.planes],
               "entities": []}
        for eid in self._entities:
            ent = {"name": self._names[eid], "components": {}}
            for kind, store in self._components.items():
                if eid not in store:
                    continue
                v = store[eid]
                if kind in ("collider", "joint"):
                    ent["components"][kind] = [C.to_plain(c) for c in v]
                else:
                    ent["components"][kind] = C.to_plain(v)
            doc["entities"].append(ent)
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)

    @classmethod
    def load_yaml(cls, path: str) -> "Scene":
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f)
        scene = cls()
        for p in doc.get("planes", []):
            scene.add_static_plane(p[:3], p[3], p[4], p[5])
        for ed in doc.get("entities", []):
            ent = scene.create_entity(ed.get("name", ""))
            for kind, data in ed.get("components", {}).items():
                if kind in ("collider", "joint"):
                    for cd in data:
                        ent.add_component(C.from_plain(kind, cd))
                else:
                    ent.add_component(C.from_plain(kind, data))
        return scene
