"""Core physics data structures.

The reference engine iterates an EnTT registry of rigid-body / collider / constraint
components every step (reference: src/physics/physics.cpp:1180-1360).  This
design instead *compiles* a scene into fixed-shape structure-of-arrays tables once
(`SceneArchetype`), and the per-step dynamic state is a small pytree (`BodyState`)
with an optional leading batch axis so thousands of scenes step in parallel — the
batched replacement for both EnTT iteration and the reference's 8-wide AVX2 constraint
batches (reference: src/physics/constraints.h:12).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp
import numpy as np
from ..core import struct

# Shape type ids (reference collider types: src/physics/bounding_volumes.h sphere/
# capsule/cylinder/aabb/obb/hull; planes are the static world in our build).
SHAPE_SPHERE = 0
SHAPE_CAPSULE = 1
SHAPE_BOX = 2
SHAPE_CYLINDER = 3
SHAPE_HULL = 4

SHAPE_NAMES = {
    SHAPE_SPHERE: "sphere",
    SHAPE_CAPSULE: "capsule",
    SHAPE_BOX: "box",
    SHAPE_CYLINDER: "cylinder",
    SHAPE_HULL: "hull",
}

# Max contact points in a manifold (reference: src/physics/collision_narrow.h
# contact_manifold holds up to 4 contacts).
MAX_CONTACT_POINTS = 4

# Padded convex-hull vertex capacity per collider.
MAX_HULL_VERTS = 32


@struct.dataclass
class BodyState:
    """Dynamic rigid-body state. All arrays shaped (..., N, k).

    Positions are at the center of gravity, matching the reference's
    rigid_body_global_state (reference: src/physics/rigid_body.cpp:97-98).
    """

    pos: jnp.ndarray        # (..., N, 3) COG position
    rot: jnp.ndarray        # (..., N, 4) orientation quaternion (x,y,z,w)
    vel: jnp.ndarray        # (..., N, 3) linear velocity
    omega: jnp.ndarray      # (..., N, 3) angular velocity
    force: jnp.ndarray      # (..., N, 3) per-step force accumulator
    torque: jnp.ndarray     # (..., N, 3) per-step torque accumulator

    @property
    def num_bodies(self):
        return self.pos.shape[-2]


@struct.dataclass
class ContactBucket:
    """Static candidate-pair table for one (typeA, typeB) narrowphase kernel.

    Pairs are enumerated at scene-compile time from collider/body topology, so the
    narrowphase is a fixed-shape masked sweep (the reference's dynamic broadphase
    output becomes a runtime 'overlapping' mask over this static table).
    """

    collider_a: jnp.ndarray   # (P,) int32 collider indices
    collider_b: jnp.ndarray   # (P,) int32
    body_a: jnp.ndarray       # (P,) int32 body indices (N = static world body)
    body_b: jnp.ndarray       # (P,) int32
    color: jnp.ndarray        # (P,) int32 solver color (colored mode only)
    valid: jnp.ndarray        # (P,) bool — False for padding rows

    type_a: int = struct.field(pytree_node=False)
    type_b: int = struct.field(pytree_node=False)
    num_colors: int = struct.field(pytree_node=False)


@struct.dataclass
class JointTable:
    """Static per-type joint table; parameter layout depends on joint type."""

    body_a: jnp.ndarray       # (J,) int32
    body_b: jnp.ndarray       # (J,) int32
    color: jnp.ndarray        # (J,) int32
    valid: jnp.ndarray        # (J,) bool
    params: Dict[str, jnp.ndarray]  # type-specific parameter arrays, each (J, ...)

    kind: str = struct.field(pytree_node=False)
    num_colors: int = struct.field(pytree_node=False)


@struct.dataclass
class SceneArchetype:
    """Compiled static scene description (bodies, colliders, pairs, joints).

    Shared by every scene instance in a batch (vmap in_axes=None).
    The last body slot (index num_bodies) is the static "world" body with zero
    inverse mass, mirroring the reference's dummy rigid body
    (reference: src/physics/physics.cpp:1280 dummyRigidBodyIndex).
    """

    # Bodies — (N+1,) arrays including the static world slot.
    inv_mass: jnp.ndarray          # (N+1,)
    inv_inertia: jnp.ndarray       # (N+1, 3, 3) local-space inverse inertia
    gravity_factor: jnp.ndarray    # (N+1,)
    linear_damping: jnp.ndarray    # (N+1,)
    angular_damping: jnp.ndarray   # (N+1,)
    local_cog: jnp.ndarray         # (N+1, 3)

    # Colliders — (C,) arrays.
    col_body: jnp.ndarray          # (C,) int32 owning body (N = static world)
    col_type: jnp.ndarray          # (C,) int32 shape type
    col_local_pos: jnp.ndarray     # (C, 3) collider frame in body frame
    col_local_rot: jnp.ndarray     # (C, 4)
    col_size: jnp.ndarray          # (C, 3) canonical shape params
    col_friction: jnp.ndarray      # (C,)
    col_restitution: jnp.ndarray   # (C,)
    # Conservative radius of bounding sphere around collider origin, for broadphase.
    col_bound_radius: jnp.ndarray  # (C,)
    # Convex hull vertex buffer (collider-local), padded; all-False mask for
    # non-hull colliders (reference hull geometry:
    # src/physics/bounding_volumes.cpp boundingHullGeometries).
    col_hull_verts: jnp.ndarray    # (C, MAX_HULL_VERTS, 3)
    col_hull_mask: jnp.ndarray     # (C, MAX_HULL_VERTS)

    # Ground planes (static world geometry): normal/offset, plane dot(n,x) = offset.
    plane_normal: jnp.ndarray      # (G, 3)
    plane_offset: jnp.ndarray      # (G,)
    plane_friction: jnp.ndarray    # (G,)
    plane_restitution: jnp.ndarray # (G,)

    # Collider-vs-plane candidate rows: every dynamic collider × every plane.
    vs_plane_collider: jnp.ndarray # (Q,) int32
    vs_plane_plane: jnp.ndarray    # (Q,) int32
    vs_plane_body: jnp.ndarray     # (Q,) int32
    vs_plane_color: jnp.ndarray    # (Q,) int32
    vs_plane_valid: jnp.ndarray    # (Q,) bool

    # Heightfield terrains (reference: terrain/heightmap_collider.h:13 — the
    # min-max mip descent becomes a local-tangent-plane lookup per collider).
    terrain_height: jnp.ndarray      # (T, R, R)
    terrain_origin: jnp.ndarray      # (T, 3)
    terrain_cell: jnp.ndarray        # (T,)
    terrain_friction: jnp.ndarray    # (T,)
    terrain_restitution: jnp.ndarray # (T,)
    vs_terrain_collider: jnp.ndarray # (Q2,) int32
    vs_terrain_terrain: jnp.ndarray  # (Q2,) int32
    vs_terrain_body: jnp.ndarray     # (Q2,) int32
    vs_terrain_valid: jnp.ndarray    # (Q2,) bool
    # Non-collision interactions (reference: physics.cpp:952 force fields +
    # triggers; trigger/collision begin/end events physics.cpp:1037).
    ff_center: jnp.ndarray         # (F, 3) force-field sphere centers
    ff_radius: jnp.ndarray         # (F,)
    ff_force: jnp.ndarray          # (F, 3)
    trigger_center: jnp.ndarray    # (TR, 3)
    trigger_radius: jnp.ndarray    # (TR,)

    contact_buckets: Tuple[ContactBucket, ...]
    joints: Tuple[JointTable, ...]
    # Ragged per-color row-index lists into the flattened contact table
    # (plane rows first, then buckets in order).  Rows sharing a color touch
    # disjoint dynamic bodies -> parallel solve within a color is exact.
    contact_color_indices: Tuple[jnp.ndarray, ...]
    # Same per joint table.
    joint_color_indices: Tuple[Tuple[jnp.ndarray, ...], ...]

    num_bodies: int = struct.field(pytree_node=False)
    num_colliders: int = struct.field(pytree_node=False)
    num_planes: int = struct.field(pytree_node=False)
    num_terrains: int = struct.field(pytree_node=False)
    vs_plane_num_colors: int = struct.field(pytree_node=False)
    # Static (shape_type, start, end) segments: vs-plane/terrain rows are
    # sorted by collider type at build time so each segment runs ONLY its own
    # narrowphase kernel (instead of evaluating all five and selecting).
    vs_plane_segments: Tuple[Tuple[int, int, int], ...] = struct.field(
        pytree_node=False, default=())
    vs_terrain_segments: Tuple[Tuple[int, int, int], ...] = struct.field(
        pytree_node=False, default=())

    # Runtime broadphase (physics/broadphase.py; reference SAP:
    # src/physics/collision_broad.cpp:297).  0 = compile-time buckets only.
    # When > 0, collider-collider pairs come from a dense AABB-overlap +
    # top-K compaction each substep; requires contact_mode="split_jacobi".
    sap_neighbors: int = struct.field(pytree_node=False, default=0)
    # Fixed active-contact budget the candidate list is compacted to.
    sap_max_contacts: int = struct.field(pytree_node=False, default=0)
    # Per-collider candidate cap applied after the sweep window test: the
    # window W buys exactness along the sort axis, the cap bounds how many
    # AABB-overlapping partners one collider keeps (with overflow counting).
    sap_row_cap: int = struct.field(pytree_node=False, default=16)
    # Candidate algorithm: "sweep" = sort-and-prune along the max-variance
    # axis with an sap_neighbors-wide window in sorted order (the reference
    # SAP, collision_broad.cpp:297-447,444, in batched form); "dense" =
    # all-pairs AABB mask + per-row top-K (O(C^2), exact, small scenes).
    sap_mode: str = struct.field(pytree_node=False, default="sweep")
    # Rows kept for the contact solve after narrowphase: the ContactTable is
    # compacted to the ACTIVE rows (manifolds that actually hit) so prep and
    # the 30-iteration solve scale with real contacts, not candidates.
    # 0 = no compaction.
    sap_active_budget: int = struct.field(pytree_node=False, default=0)
    # Static (type_a, type_b) combos present among colliders (canonical order).
    sap_type_pairs: Tuple[Tuple[int, int], ...] = struct.field(
        pytree_node=False, default=())
    # (C, C) upper-triangular pair admissibility (collision groups, static
    # pairs, kinematic-kinematic exclusion) — empty when sap_neighbors == 0.
    # Used as a full-matrix mask by the dense path only; the sweep path
    # re-derives admissibility from the per-body attributes below (a big-
    # table gather with sort-derived indices is avoided).
    sap_collidable: jnp.ndarray = None
    # Per-body attributes for the sweep path's admissibility test.
    sap_body_kinematic: jnp.ndarray = None   # (N,) bool
    sap_body_group: jnp.ndarray = None       # (N,) int32, -1 = no group
    sap_joint_excl: jnp.ndarray = None       # (E, 2) canonical body pairs

    # True: box/hull rows collide against exact heightfield triangles found
    # by min-max mip descent (physics/heightmap_collision.py — reference
    # src/physics/heightmap_collision.cpp:509); False: bilinear tangent plane.
    terrain_tri_exact: bool = struct.field(pytree_node=False, default=False)

    @property
    def world_body(self) -> int:
        return self.num_bodies


@struct.dataclass
class PhysicsSettings:
    """Mirrors the reference's physics_settings (src/physics/physics.h:382-400)."""

    frame_rate: int = struct.field(pytree_node=False, default=120)
    max_substeps: int = struct.field(pytree_node=False, default=4)
    solver_iterations: int = struct.field(pytree_node=False, default=30)
    # "colored": sequential Gauss-Seidel over precomputed conflict-free colors
    #   (the batched analogue of the reference's SIMD batch scheduling that
    #    avoids same-body conflicts within a batch, src/physics/constraints.cpp:3456).
    # "split_jacobi": parallel mass-splitting Jacobi for dense contact scenes.
    # "runtime_gs": true Gauss-Seidel on runtime broadphase pairs via
    #   on-device greedy coloring — several times slower per iteration than
    #   split_jacobi; the validation yardstick bounding Jacobi divergence.
    contact_mode: str = struct.field(pytree_node=False, default="colored")
    # split_jacobi does its gather/scatter as one-hot matmuls once
    # rows x body-slots reaches this size, and as gathers/scatter-adds below.
    jacobi_matmul_threshold: int = struct.field(
        pytree_node=False, default=256 * 1024)
    # Claim passes for runtime_gs coloring (last color is the unguaranteed
    # leftover slot; 32 covers grid-like piles with degree <= ~16).
    runtime_gs_colors: int = struct.field(pytree_node=False, default=32)
    global_force_field: Tuple[float, float, float] = struct.field(
        pytree_node=False, default=(0.0, 0.0, 0.0)
    )


def zero_state(num_bodies: int, dtype=jnp.float32) -> BodyState:
    n = num_bodies
    rot = jnp.zeros((n, 4), dtype).at[:, 3].set(1.0)
    z3 = jnp.zeros((n, 3), dtype)
    return BodyState(pos=z3, rot=rot, vel=z3, omega=z3, force=z3, torque=z3)
