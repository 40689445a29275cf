"""The jit-compiled physics step.

Pipeline per substep (mirrors reference: src/physics/physics.cpp:1180-1360):
  world collider poses -> narrowphase manifolds -> gravity/damping force
  integration -> constraint prep -> N solver iterations (joints then contacts)
  -> velocity integration into positions/rotations.

Everything here is written for ONE scene; `jax.vmap` over a leading batch axis
steps thousands of scenes in parallel.  The fixed-timestep substepping of the
reference (120 Hz, <=4 substeps/frame, src/physics/physics.h:385-387) is a static
Python loop so XLA sees a fixed program.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import maths as m
from . import collide, joints as joints_mod, solver
from .types import BodyState, PhysicsSettings, SceneArchetype


def _append_world(x, fill=0.0):
    pad = jnp.full((1,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x, pad], axis=0)


def integrate_forces(arch: SceneArchetype, pos, rot, vel, omega, force, torque, dt,
                     global_force_field):
    """Gravity + external forces + damping (reference: src/physics/rigid_body.cpp:95-124)."""
    inv_mass = arch.inv_mass[:-1]
    gravity = jnp.zeros_like(vel).at[:, 1].set(m.GRAVITY * arch.gravity_factor[:-1])
    rotm = m.quat_to_mat3(rot)
    inv_inertia_w = jnp.einsum(
        "nij,njk,nlk->nil", rotm, arch.inv_inertia[:-1], rotm
    )
    force = force + jnp.asarray(global_force_field, vel.dtype)
    # Kinematic bodies (inv_mass == 0) are immune to forces incl. gravity —
    # in the reference they simply have no rigid_body_component.
    moving = (inv_mass > 0.0)[:, None]
    lin_acc = (gravity + force * inv_mass[:, None]) * moving
    ang_acc = jnp.einsum("nij,nj->ni", inv_inertia_w, torque)
    vel = vel + lin_acc * dt
    omega = omega + ang_acc * dt
    vel = vel / (1.0 + dt * arch.linear_damping[:-1, None])
    omega = omega / (1.0 + dt * arch.angular_damping[:-1, None])
    return vel, omega, inv_inertia_w


def integrate_velocities(pos, rot, vel, omega, dt):
    """Semi-implicit Euler (reference: src/physics/rigid_body.cpp:126-142)."""
    pos = pos + vel * dt
    rot = m.quat_integrate(rot, omega, dt)
    return pos, rot


def physics_substep(
    arch: SceneArchetype,
    state: BodyState,
    dt: float,
    settings: PhysicsSettings,
    motor_overrides=None,
):
    n = arch.num_bodies

    # Contact generation uses pre-integration poses (reference: physics.cpp:1246
    # narrowphase runs before force integration).
    contacts = collide.generate_contacts(arch, state)

    force = state.force
    if arch.ff_center.shape[0] > 0:
        from .events import apply_force_fields
        force = force + apply_force_fields(arch, state)

    vel, omega, inv_inertia_w = integrate_forces(
        arch, state.pos, state.rot, state.vel, state.omega,
        force, state.torque, dt, settings.global_force_field,
    )

    # Extend to N+1 slots: the static world body (reference dummyRigidBodyIndex).
    pos1 = _append_world(state.pos)
    vel1 = _append_world(vel)
    omega1 = _append_world(omega)
    ii_w1 = jnp.concatenate(
        [inv_inertia_w, jnp.zeros((1, 3, 3), inv_inertia_w.dtype)], axis=0
    )
    inv_mass1 = arch.inv_mass

    mode = settings.contact_mode
    if arch.sap_neighbors > 0 and mode not in ("split_jacobi", "runtime_gs"):
        raise ValueError(
            "runtime broadphase (finalize(broadphase='sap')) produces dynamic "
            "pair sets that cannot be statically colored; use "
            "PhysicsSettings(contact_mode='split_jacobi') (or 'runtime_gs' "
            "for validation runs)"
        )
    if arch.sap_neighbors > 0 and arch.sap_active_budget > 0:
        # Compact to the manifolds that actually hit: prep + the iteration
        # loop scale with real contacts, not broadphase candidates.
        from . import broadphase as broadphase_mod
        contacts = broadphase_mod.compact_active(
            contacts, arch.sap_active_budget)
    num_pairs = contacts.body_a.shape[0]
    contact_sa = contact_sb = contact_colors = None
    if num_pairs > 0:
        if mode == "split_jacobi":
            # Split each body into `deg` pieces: effective masses see the
            # deg-times lighter piece (inv mass * deg) so each row's impulse
            # under-corrects by 1/deg; impulses apply at true masses.
            deg = solver.contact_degrees(contacts, n + 1)
            prep = solver.prep_contacts_full(
                contacts, pos1, inv_mass1, ii_w1, vel1, omega1, dt,
                inv_mass_eff=inv_mass1 * deg,
                inv_inertia_eff=ii_w1 * deg[:, None, None],
            )
            if num_pairs * (n + 1) >= settings.jacobi_matmul_threshold:
                # Large runtime pair sets: gather/scatter as one-hot
                # matmuls.
                contact_sa = solver.body_onehot(contacts.body_a, n + 1)
                contact_sb = solver.body_onehot(contacts.body_b, n + 1)
        elif mode == "runtime_gs":
            # True Gauss-Seidel on runtime pairs: on-device greedy coloring,
            # true (unsplit) masses — the validation yardstick for Jacobi.
            prep = solver.prep_contacts_full(
                contacts, pos1, inv_mass1, ii_w1, vel1, omega1, dt
            )
            contact_colors, _ = solver.runtime_color(
                contacts.body_a, contacts.body_b, contacts.active,
                inv_mass1[contacts.body_a] > 0,
                inv_mass1[contacts.body_b] > 0,
                n + 1, settings.runtime_gs_colors,
            )
        else:
            prep = solver.prep_contacts_full(
                contacts, pos1, inv_mass1, ii_w1, vel1, omega1, dt
            )
    else:
        prep = None

    rot1 = jnp.concatenate(
        [state.rot, jnp.zeros((1, 4), state.rot.dtype).at[:, 3].set(1.0)], axis=0
    )
    ctx = joints_mod.JointContext(
        pos1=pos1, rot1=rot1, inv_mass1=inv_mass1, ii_w1=ii_w1,
        local_cog1=arch.local_cog, dt=dt,
    )
    joint_preps = joints_mod.prep_all(arch, ctx, motor_overrides)

    imp_n = jnp.zeros((num_pairs, 4), vel.dtype)
    imp_t = jnp.zeros((num_pairs, 4), vel.dtype)

    def one_iteration(_, carry):
        vel1, omega1, imp_n, imp_t, joint_impulses = carry
        vel1, omega1, joint_impulses = joints_mod.solve_all_one_iteration(
            arch, joint_preps, joint_impulses, vel1, omega1
        )
        if prep is not None:
            if mode == "split_jacobi":
                if contact_sa is not None:
                    vel1, omega1, imp_n, imp_t = \
                        solver.solve_contacts_split_jacobi_matmul(
                            prep, vel1, omega1, imp_n, imp_t,
                            contact_sa, contact_sb)
                else:
                    vel1, omega1, imp_n, imp_t = \
                        solver.solve_contacts_split_jacobi(
                            prep, vel1, omega1, imp_n, imp_t)
            elif mode == "runtime_gs":
                vel1, omega1, imp_n, imp_t = solver.solve_contacts_runtime_gs(
                    prep, contact_colors, settings.runtime_gs_colors,
                    vel1, omega1, imp_n, imp_t
                )
            else:
                vel1, omega1, imp_n, imp_t = solver.solve_contacts_colored(
                    prep, arch.contact_color_indices, vel1, omega1, imp_n, imp_t
                )
        return vel1, omega1, imp_n, imp_t, joint_impulses

    joint_impulses = joints_mod.init_impulses(arch, vel.dtype)
    vel1, omega1, imp_n, imp_t, joint_impulses = jax.lax.fori_loop(
        0, settings.solver_iterations, one_iteration,
        (vel1, omega1, imp_n, imp_t, joint_impulses),
    )

    vel = vel1[:n]
    omega = omega1[:n]
    pos, rot = integrate_velocities(state.pos, state.rot, vel, omega, dt)

    new_state = state.replace(
        pos=pos, rot=rot, vel=vel, omega=omega,
        force=jnp.zeros_like(state.force), torque=jnp.zeros_like(state.torque),
    )
    return new_state, contacts


def physics_step(
    arch: SceneArchetype,
    state: BodyState,
    settings: PhysicsSettings,
    dt: float,
    num_substeps: Optional[int] = None,
    motor_overrides=None,
    collect_events: bool = False,
    prev_active=None,
):
    """Step a scene by `dt` using fixed-rate substeps.

    Substep count is static (computed from dt in Python), mirroring the
    reference's frame-rate accumulator with its <=4 substep cap
    (reference: src/physics/physics.cpp:1364-1400).

    With `collect_events=True`, also returns CollisionEvents folded over the
    substeps — begin/end detected PER SUBSTEP against `prev_active` (the
    `active` field of the previous frame's events), with approach speed
    measured from the pre-solve velocities of the substep the contact began
    in.  This matches the reference's per-internal-step collision callbacks
    with contact velocity (src/physics/physics.cpp:1037); detecting begins
    only on the frame's LAST substep reports near-zero impact speeds (the
    solver has already absorbed the hit).
    """
    if num_substeps is None:
        num_substeps = max(1, round(dt * settings.frame_rate))
        num_substeps = min(num_substeps, settings.max_substeps)
    h = 1.0 / settings.frame_rate
    contacts = None
    events = None
    for _ in range(num_substeps):
        if collect_events:
            # Pad a zero row: contact rows against planes/terrain use a
            # pseudo world-body index one past the body table.
            zero = jnp.zeros((1, 3), state.vel.dtype)
            vel0 = jnp.concatenate([state.vel, zero])
            omega0 = jnp.concatenate([state.omega, zero])
            pos0 = jnp.concatenate([state.pos, zero])
        state, contacts = physics_substep(
            arch, state, h, settings, motor_overrides)
        if collect_events:
            from .events import CollisionEvents, collision_events

            ev = collision_events(contacts, vel0, omega0, prev_active,
                                  pos=pos0)
            prev_active = ev.active
            events = ev if events is None else CollisionEvents(
                begin=events.begin | ev.begin,
                end=events.end | ev.end,
                active=ev.active,
                approach_speed=jnp.maximum(events.approach_speed,
                                           ev.approach_speed),
            )
    if collect_events:
        return state, contacts, events
    return state, contacts


def physics_step_interpolated(
    arch: SceneArchetype,
    state: BodyState,
    settings: PhysicsSettings,
    dt: float,
    accumulator: float = 0.0,
    motor_overrides=None,
):
    """Fixed-rate substeps with leftover-time accumulation + interpolated
    render transforms (reference: src/physics/physics.cpp:1364-1400 —
    transform0/transform1 lerp by the accumulator fraction).

    `dt` and `accumulator` are static Python floats (one compile per distinct
    frame dt — frame rates are fixed in practice).  Returns
    (new_state, contacts, new_accumulator, (render_pos, render_rot)):
    the render pose lies between the last two substep poses so motion looks
    smooth at any frame rate that is not a multiple of the physics rate."""
    h = 1.0 / settings.frame_rate
    total = accumulator + dt
    num_substeps = int(total / h)
    if num_substeps > settings.max_substeps:
        # Frame drop guard (reference: physics.cpp:1385-1391).
        num_substeps = settings.max_substeps
        total = num_substeps * h + (total % h)
    new_accumulator = total - num_substeps * h

    pos0, rot0 = state.pos, state.rot
    contacts = None
    for _ in range(num_substeps):
        pos0, rot0 = state.pos, state.rot
        state, contacts = physics_substep(arch, state, h, settings,
                                          motor_overrides)

    alpha = jnp.asarray(new_accumulator / h, state.pos.dtype)
    render_pos = pos0 + (state.pos - pos0) * alpha
    # nlerp with hemisphere correction.
    dot = jnp.sum(rot0 * state.rot, -1, keepdims=True)
    rot1 = jnp.where(dot < 0, -state.rot, state.rot)
    render_rot = m.normalize(rot0 + (rot1 - rot0) * alpha)
    return state, contacts, new_accumulator, (render_pos, render_rot)


def make_batched_step(arch: SceneArchetype, settings: PhysicsSettings, dt: float):
    """jit-compiled batched step: BodyState with leading batch axis."""

    def step(arch, batched_state):
        return jax.vmap(
            lambda s: physics_step(arch, s, settings, dt)[0]
        )(batched_state)

    return jax.jit(functools.partial(step, arch))
