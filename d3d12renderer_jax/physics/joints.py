"""Joint constraints: distance, ball, fixed, hinge, cone-twist, slider — all with
limits and motors (velocity + position), batched.

Math and semantics mirror the reference's per-type sequential-impulse solvers
(reference: src/physics/constraints.cpp:200-2070; betas at constraints.cpp:9-17,
position-motor velocity override at constraints.cpp:1196, swing motor axis
selection at constraints.cpp:1875-1905).  Instead of the reference's 8-wide SIMD
batches scheduled to avoid same-body conflicts (constraints.cpp:
scheduleConstraintsSIMD), joints are graph-colored at scene-compile time and each
color solves as one vectorized gather/compute/scatter; colors run sequentially so
the Gauss-Seidel ordering is preserved.

Per-type parameter tables are pytree leaves, so runtime-varying motor targets
(RL actions) flow in as regular jit inputs via `motor_overrides` — the batched
equivalent of learned_locomotion::applyAction writing motor targets into
constraint components (reference: src/learning/learned_locomotion.cpp:70-91).

Solve order inside one iteration follows the reference
(constraints.cpp:3764-3770): distance, ball, fixed, hinge, cone_twist, slider —
then contacts (handled by solver.py).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import maths as m
from .types import JointTable, SceneArchetype

# Reference constants (src/physics/constraints.cpp:9-17).
DISTANCE_BETA = 0.1
BALL_BETA = 0.1
SLIDER_BETA = 0.1
HINGE_ROTATION_BETA = 0.3
HINGE_LIMIT_BETA = 0.1
TWIST_LIMIT_BETA = 0.1
SLIDER_LIMIT_BETA = 0.1
DT_THRESHOLD = 1e-5

MOTOR_VELOCITY = 0.0
MOTOR_POSITION = 1.0

# Fraction of the position-motor swing error corrected per step
# (reference: constraints.cpp:1901 `deltaAngle * invDt * 0.2f`).
SWING_MOTOR_GAIN = 0.2

# Solve order within one solver iteration (reference: constraints.cpp:3764-3769).
JOINT_SOLVE_ORDER = ("distance", "ball", "fixed", "hinge", "cone_twist", "slider")


class JointContext(NamedTuple):
    """Per-substep body data shared by all joint preps (N+1 slots incl. world)."""

    pos1: jnp.ndarray       # (N+1, 3) COG positions
    rot1: jnp.ndarray       # (N+1, 4) orientations
    inv_mass1: jnp.ndarray  # (N+1,)
    ii_w1: jnp.ndarray      # (N+1, 3, 3) world-space inverse inertia
    local_cog1: jnp.ndarray # (N+1, 3)
    dt: float


def _skew(v):
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    rows = jnp.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], axis=-1
    )
    return rows.reshape(v.shape[:-1] + (3, 3))


def _safe_inv3(K, active):
    """Closed-form adjugate 3x3 inverse: pure elementwise work, where
    jnp.linalg.inv lowers to a batched LU factorization."""
    eye = jnp.eye(3, dtype=K.dtype)
    K = jnp.where(active[..., None, None], K, eye) + 1e-9 * eye
    a, b, c = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    d, e, f = K[..., 1, 0], K[..., 1, 1], K[..., 1, 2]
    g, h, i = K[..., 2, 0], K[..., 2, 1], K[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = jnp.where(jnp.abs(det) > 1e-20, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    adj = jnp.stack([
        A, -(b * i - c * h), b * f - c * e,
        B, a * i - c * g, -(a * f - c * d),
        C, -(a * h - b * g), a * e - b * d,
    ], axis=-1).reshape(K.shape)
    inv = adj * inv_det[..., None, None]
    return jnp.where(active[..., None, None], inv, 0.0)


def _inv22(k00, k01, k10, k11, active):
    det = k00 * k11 - k01 * k10
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    inv_det = inv_det * active
    return k11 * inv_det, -k01 * inv_det, -k10 * inv_det, k00 * inv_det


def _mv(mat, v):
    return jnp.einsum("...ij,...j->...i", mat, v)


def _common(table: JointTable, ctx: JointContext, p: Dict[str, jnp.ndarray]):
    """Anchors, masses, per-row inertia — shared by every joint type
    (reference: each initialize*VelocityConstraints preamble)."""
    ia, ib = table.body_a, table.body_b
    qa, qb = ctx.rot1[ia], ctx.rot1[ib]
    ra = m.quat_rotate(qa, p["anchor_a"] - ctx.local_cog1[ia])
    rb = m.quat_rotate(qb, p["anchor_b"] - ctx.local_cog1[ib])
    ga = ctx.pos1[ia] + ra
    gb = ctx.pos1[ib] + rb
    im_a, im_b = ctx.inv_mass1[ia], ctx.inv_mass1[ib]
    ii_a, ii_b = ctx.ii_w1[ia], ctx.ii_w1[ib]
    active = table.valid & ((im_a > 0) | (im_b > 0))
    return ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active


def _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active):
    """inv of K = skewA iiA skewA^T + skewB iiB skewB^T + (imA+imB) I
    (reference: constraints.cpp:489 and equivalents)."""
    sa, sb = _skew(ra), _skew(rb)
    K = (
        jnp.einsum("...ij,...jk,...lk->...il", sa, ii_a, sa)
        + jnp.einsum("...ij,...jk,...lk->...il", sb, ii_b, sb)
        + (im_a + im_b)[..., None, None] * jnp.eye(3, dtype=ra.dtype)
    )
    return _safe_inv3(K, active)


def _bias_scale(dt, beta):
    return jnp.where(dt > DT_THRESHOLD, beta / dt, 0.0)


def _apply_linear3(prep, P, va, wa, vb, wb):
    va = va - prep["im_a"][:, None] * P
    wa = wa - _mv(prep["ii_a"], jnp.cross(prep["ra"], P))
    vb = vb + prep["im_b"][:, None] * P
    wb = wb + _mv(prep["ii_b"], jnp.cross(prep["rb"], P))
    return va, wa, vb, wb


# --------------------------------------------------------------------------
# Distance (reference: constraints.cpp:200-270)
# --------------------------------------------------------------------------

def _prep_distance(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(table, ctx, p)
    u = gb - ga
    l = m.length(u)
    u = jnp.where((l > 1e-3)[..., None], u / jnp.maximum(l, 1e-3)[..., None], 0.0)
    bias = (l - p["length"]) * _bias_scale(ctx.dt, DISTANCE_BETA)
    ca, cb = jnp.cross(ra, u), jnp.cross(rb, u)
    to_wa, to_wb = _mv(ii_a, ca), _mv(ii_b, cb)
    k = im_a + im_b + jnp.sum(ca * to_wa, -1) + jnp.sum(cb * to_wb, -1)
    eff = jnp.where(k != 0, 1.0 / jnp.where(k == 0, 1.0, k), 0.0) * active
    return dict(ia=ia, ib=ib, ra=ra, rb=rb, u=u, bias=bias, eff=eff,
                to_wa=to_wa, to_wb=to_wb, im_a=im_a, im_b=im_b)


def _solve_distance(prep, va, wa, vb, wb, imp):
    av_a = va + jnp.cross(wa, prep["ra"])
    av_b = vb + jnp.cross(wb, prep["rb"])
    cdot = jnp.sum(prep["u"] * (av_b - av_a), -1) + prep["bias"]
    lam = -prep["eff"] * cdot
    P = lam[:, None] * prep["u"]
    va = va - prep["im_a"][:, None] * P
    wa = wa - prep["to_wa"] * lam[:, None]
    vb = vb + prep["im_b"][:, None] * P
    wb = wb + prep["to_wb"] * lam[:, None]
    return va, wa, vb, wb, imp


# --------------------------------------------------------------------------
# Ball (reference: constraints.cpp:460-540)
# --------------------------------------------------------------------------

def _prep_ball(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(table, ctx, p)
    inv_K = _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active)
    bias = (gb - ga) * _bias_scale(ctx.dt, BALL_BETA)
    return dict(ia=ia, ib=ib, ra=ra, rb=rb, inv_K=inv_K, bias=bias,
                im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b)


def _solve_ball_part(prep, va, wa, vb, wb):
    av_a = va + jnp.cross(wa, prep["ra"])
    av_b = vb + jnp.cross(wb, prep["rb"])
    cdot = av_b - av_a + prep["bias"]
    P = -_mv(prep["inv_K"], cdot)
    return _apply_linear3(prep, P, va, wa, vb, wb)


def _solve_ball(prep, va, wa, vb, wb, imp):
    va, wa, vb, wb = _solve_ball_part(prep, va, wa, vb, wb)
    return va, wa, vb, wb, imp


# --------------------------------------------------------------------------
# Fixed / weld (reference: constraints.cpp:740-860)
# --------------------------------------------------------------------------

def _prep_fixed(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(table, ctx, p)
    inv_K = _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active)
    t_bias = (gb - ga) * _bias_scale(ctx.dt, BALL_BETA)
    inv_K_rot = _safe_inv3(ii_a + ii_b, active)
    rot_err = m.quat_mul(qb, m.quat_mul(p["init_inv_rot"], m.quat_conj(qa)))
    r_bias = rot_err[..., :3] * (2.0 * _bias_scale(ctx.dt, SLIDER_BETA))
    return dict(ia=ia, ib=ib, ra=ra, rb=rb, inv_K=inv_K, bias=t_bias,
                inv_K_rot=inv_K_rot, r_bias=r_bias,
                im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b)


def _solve_fixed(prep, va, wa, vb, wb, imp):
    # Rotation part.
    lam = -_mv(prep["inv_K_rot"], (wb - wa) + prep["r_bias"])
    wa = wa - _mv(prep["ii_a"], lam)
    wb = wb + _mv(prep["ii_b"], lam)
    # Position part.
    va, wa, vb, wb = _solve_ball_part(prep, va, wa, vb, wb)
    return va, wa, vb, wb, imp


# --------------------------------------------------------------------------
# Hinge (reference: constraints.cpp:1081-1310)
# --------------------------------------------------------------------------

def _axial_limit_motor(axis_w, ii_a, ii_b, active):
    inv_k = jnp.sum(axis_w * _mv(ii_a, axis_w), -1) + jnp.sum(axis_w * _mv(ii_b, axis_w), -1)
    eff = jnp.where(inv_k != 0, 1.0 / jnp.where(inv_k == 0, 1.0, inv_k), 0.0) * active
    return eff, _mv(ii_a, axis_w), _mv(ii_b, axis_w)


def _prep_hinge(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(table, ctx, p)
    inv_K = _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active)
    t_bias = (gb - ga) * _bias_scale(ctx.dt, BALL_BETA)

    axis_a_w = m.quat_rotate(qa, p["axis_a"])
    axis_b_w = m.quat_rotate(qb, p["axis_b"])
    tb, bb = m.orthonormal_basis(axis_b_w)
    bxa = jnp.cross(tb, axis_a_w)
    cxa = jnp.cross(bb, axis_a_w)
    ii_sum_b = _mv(ii_a, bxa) + _mv(ii_b, bxa)
    ii_sum_c = _mv(ii_a, cxa) + _mv(ii_b, cxa)
    k00 = jnp.sum(bxa * ii_sum_b, -1)
    k01 = jnp.sum(bxa * ii_sum_c, -1)
    k10 = jnp.sum(cxa * ii_sum_b, -1)
    k11 = jnp.sum(cxa * ii_sum_c, -1)
    i00, i01, i10, i11 = _inv22(k00, k01, k10, k11, active)
    r_bias = jnp.stack(
        [jnp.sum(axis_a_w * tb, -1), jnp.sum(axis_a_w * bb, -1)], -1
    ) * _bias_scale(ctx.dt, HINGE_ROTATION_BETA)

    # Current angle (reference: constraints.cpp:1168-1170).
    cmp_a = m.quat_inv_rotate(qa, m.quat_rotate(qb, p["tangent_b"]))
    angle = jnp.arctan2(
        jnp.sum(cmp_a * p["bitangent_a"], -1), jnp.sum(cmp_a * p["tangent_a"], -1)
    )

    min_l, max_l = p["min_limit"], p["max_limit"]
    min_active = min_l <= 0.0
    max_active = max_l >= 0.0
    min_violated = min_active & (angle <= min_l)
    max_violated = max_active & (angle >= max_l)
    solve_limit = (min_violated | max_violated) & active
    limit_sign = jnp.where(min_violated, 1.0, -1.0)

    eff_ax, to_wa_ax, to_wb_ax = _axial_limit_motor(axis_a_w, ii_a, ii_b, active)
    eff_limit = eff_ax * solve_limit
    d = jnp.where(min_violated, angle - min_l, max_l - angle)
    limit_bias = d * _bias_scale(ctx.dt, HINGE_LIMIT_BETA)

    motor_active = (p["max_torque"] > 0.0) & active
    max_imp = jnp.maximum(p["max_torque"], 0.0) * ctx.dt
    # Position motor: reach target within one frame, clamped by max impulse
    # (reference: constraints.cpp:1192-1197).
    tgt = jnp.clip(
        p["motor_target"],
        jnp.where(min_active, min_l, -jnp.pi),
        jnp.where(max_active, max_l, jnp.pi),
    )
    motor_vel = jnp.where(
        p["motor_type"] == MOTOR_POSITION,
        jnp.where(ctx.dt > DT_THRESHOLD, (tgt - angle) / ctx.dt, 0.0),
        p["motor_target"],
    )
    eff_motor = eff_ax * motor_active

    return dict(ia=ia, ib=ib, ra=ra, rb=rb, inv_K=inv_K, bias=t_bias,
                bxa=bxa, cxa=cxa, i2=(i00, i01, i10, i11), r_bias=r_bias,
                axis=axis_a_w, eff_limit=eff_limit, limit_sign=limit_sign,
                limit_bias=limit_bias, eff_motor=eff_motor, motor_vel=motor_vel,
                max_imp=max_imp, to_wa_ax=to_wa_ax, to_wb_ax=to_wb_ax,
                im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b, angle=angle)


def _solve_axial_motor(prep, wa, wb, imp, slot):
    relw = jnp.sum(prep["axis"] * wb, -1) - jnp.sum(prep["axis"] * wa, -1)
    cdot = relw - prep["motor_vel"]
    lam = -prep["eff_motor"] * cdot
    new = jnp.clip(imp[:, slot] + lam, -prep["max_imp"], prep["max_imp"])
    lam = new - imp[:, slot]
    imp = imp.at[:, slot].set(new)
    wa = wa - prep["to_wa_ax"] * lam[:, None]
    wb = wb + prep["to_wb_ax"] * lam[:, None]
    return wa, wb, imp


def _solve_axial_limit(prep, wa, wb, imp, slot):
    s = prep["limit_sign"]
    relw = s * (jnp.sum(prep["axis"] * wb, -1) - jnp.sum(prep["axis"] * wa, -1))
    cdot = relw + prep["limit_bias"]
    lam = -prep["eff_limit"] * cdot
    new = jnp.maximum(imp[:, slot] + lam, 0.0)
    lam = (new - imp[:, slot]) * s
    imp = imp.at[:, slot].set(new)
    wa = wa - prep["to_wa_ax"] * lam[:, None]
    wb = wb + prep["to_wb_ax"] * lam[:, None]
    return wa, wb, imp


def _solve_hinge(prep, va, wa, vb, wb, imp):
    # Order (reference: constraints.cpp:1240): motor -> limit -> rotation -> position.
    wa, wb, imp = _solve_axial_motor(prep, wa, wb, imp, 0)
    wa, wb, imp = _solve_axial_limit(prep, wa, wb, imp, 1)

    dw = wb - wa
    c0 = jnp.sum(prep["bxa"] * dw, -1) + prep["r_bias"][:, 0]
    c1 = jnp.sum(prep["cxa"] * dw, -1) + prep["r_bias"][:, 1]
    i00, i01, i10, i11 = prep["i2"]
    l0 = -(i00 * c0 + i01 * c1)
    l1 = -(i10 * c0 + i11 * c1)
    P = prep["bxa"] * l0[:, None] + prep["cxa"] * l1[:, None]
    wa = wa - _mv(prep["ii_a"], P)
    wb = wb + _mv(prep["ii_b"], P)

    va, wa, vb, wb = _solve_ball_part(prep, va, wa, vb, wb)
    return va, wa, vb, wb, imp


# --------------------------------------------------------------------------
# Cone-twist (reference: constraints.cpp:1782-2070)
# --------------------------------------------------------------------------

def _prep_cone_twist(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(table, ctx, p)
    inv_K = _ball_K_inv(ra, rb, im_a, im_b, ii_a, ii_b, active)
    t_bias = (gb - ga) * _bias_scale(ctx.dt, BALL_BETA)
    dt = ctx.dt

    # Swing/twist decomposition in A's local frame (reference: constraints.cpp:1826-1836).
    btoa = m.quat_mul(m.quat_conj(qa), qb)
    axis_cmp = m.quat_rotate(btoa, p["axis_b"])
    swing_q = m.quat_from_to(p["axis_a"], axis_cmp)
    twist_tan = m.quat_rotate(swing_q, p["tangent_a"])
    twist_bitan = m.quat_rotate(swing_q, p["bitangent_a"])
    tan_cmp = m.quat_rotate(btoa, p["tangent_b"])
    twist_angle = jnp.arctan2(
        jnp.sum(tan_cmp * twist_bitan, -1), jnp.sum(tan_cmp * twist_tan, -1)
    )
    swing_axis_l, swing_angle = m.quat_to_axis_angle(swing_q)
    neg = swing_angle < 0.0
    swing_angle = jnp.abs(swing_angle)
    swing_axis_l = jnp.where(neg[..., None], -swing_axis_l, swing_axis_l)

    # Swing limit (reference: constraints.cpp:1849-1870).
    sl = p["swing_limit"]
    solve_swing = (sl >= 0.0) & (swing_angle >= sl) & active
    swing_axis_w = m.quat_rotate(qa, swing_axis_l)
    eff_swing, sw_to_wa, sw_to_wb = _axial_limit_motor(swing_axis_w, ii_a, ii_b, active)
    eff_swing = eff_swing * solve_swing
    swing_bias = (sl - swing_angle) * _bias_scale(dt, HINGE_LIMIT_BETA)

    # Swing motor (reference: constraints.cpp:1872-1905).
    swing_motor_active = (p["max_swing_torque"] > 0.0) & active
    max_swing_imp = jnp.maximum(p["max_swing_torque"], 0.0) * dt
    ax_c, ax_s = jnp.cos(p["swing_axis_angle"]), jnp.sin(p["swing_axis_angle"])
    local_motor_axis = ax_c[..., None] * p["tangent_a"] + ax_s[..., None] * p["bitangent_a"]
    # position branch
    sw_tgt = jnp.where(sl >= 0.0, jnp.clip(p["swing_target"], -sl, sl), p["swing_target"])
    local_target_dir = m.quat_rotate(
        m.quat_from_axis_angle(local_motor_axis, sw_tgt), p["axis_a"]
    )
    pos_axis_l = m.noz(jnp.cross(axis_cmp, local_target_dir))
    cos_ang = jnp.clip(jnp.sum(local_target_dir * axis_cmp, -1), 0.0, 1.0)
    pos_vel = jnp.where(dt > DT_THRESHOLD, jnp.arccos(cos_ang) / dt * SWING_MOTOR_GAIN, 0.0)
    is_pos = p["swing_motor_type"] == MOTOR_POSITION
    motor_axis_l = jnp.where(is_pos[..., None], pos_axis_l, local_motor_axis)
    swing_motor_vel = jnp.where(is_pos, pos_vel, p["swing_target"])
    swing_motor_axis_w = m.quat_rotate(qa, motor_axis_l)
    eff_swing_motor, swm_to_wa, swm_to_wb = _axial_limit_motor(
        swing_motor_axis_w, ii_a, ii_b, active
    )
    eff_swing_motor = eff_swing_motor * swing_motor_active

    # Twist limit + motor (reference: constraints.cpp:1907-1960) — same pattern
    # as the hinge axial limit/motor about A's limit axis.
    tl = p["twist_limit"]
    twist_axis_w = m.quat_rotate(qa, p["axis_a"])
    min_violated = (tl >= 0.0) & (twist_angle <= -tl)
    max_violated = (tl >= 0.0) & (twist_angle >= tl)
    solve_twist = (min_violated | max_violated) & active
    eff_tw, tw_to_wa, tw_to_wb = _axial_limit_motor(twist_axis_w, ii_a, ii_b, active)
    eff_twist_limit = eff_tw * solve_twist
    twist_sign = jnp.where(min_violated, 1.0, -1.0)
    d = jnp.where(min_violated, tl + twist_angle, tl - twist_angle)
    twist_bias = d * _bias_scale(dt, TWIST_LIMIT_BETA)

    twist_motor_active = (p["max_twist_torque"] > 0.0) & active
    max_twist_imp = jnp.maximum(p["max_twist_torque"], 0.0) * dt
    lim = jnp.where(tl >= 0.0, tl, jnp.pi)
    tw_tgt = jnp.clip(p["twist_target"], -lim, lim)
    twist_motor_vel = jnp.where(
        p["twist_motor_type"] == MOTOR_POSITION,
        jnp.where(dt > DT_THRESHOLD, (tw_tgt - twist_angle) / dt, 0.0),
        p["twist_target"],
    )
    eff_twist_motor = eff_tw * twist_motor_active

    return dict(
        ia=ia, ib=ib, ra=ra, rb=rb, inv_K=inv_K, bias=t_bias,
        im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b,
        swing_axis=swing_axis_w, eff_swing=eff_swing, swing_bias=swing_bias,
        sw_to_wa=sw_to_wa, sw_to_wb=sw_to_wb,
        swing_motor_axis=swing_motor_axis_w, eff_swing_motor=eff_swing_motor,
        swing_motor_vel=swing_motor_vel, max_swing_imp=max_swing_imp,
        swm_to_wa=swm_to_wa, swm_to_wb=swm_to_wb,
        twist_axis=twist_axis_w, eff_twist_limit=eff_twist_limit,
        twist_sign=twist_sign, twist_bias=twist_bias,
        eff_twist_motor=eff_twist_motor, twist_motor_vel=twist_motor_vel,
        max_twist_imp=max_twist_imp, tw_to_wa=tw_to_wa, tw_to_wb=tw_to_wb,
        swing_angle=swing_angle, twist_angle=twist_angle,
    )


def _solve_cone_twist(prep, va, wa, vb, wb, imp):
    # Order (reference: constraints.cpp:1986): twist motor -> swing motor ->
    # twist limit -> swing limit -> position.
    # imp slots: 0 twist motor, 1 swing motor, 2 twist limit, 3 swing limit.

    # Twist motor.
    ax = prep["twist_axis"]
    relw = jnp.sum(ax * wb, -1) - jnp.sum(ax * wa, -1)
    lam = -prep["eff_twist_motor"] * (relw - prep["twist_motor_vel"])
    new = jnp.clip(imp[:, 0] + lam, -prep["max_twist_imp"], prep["max_twist_imp"])
    lam = new - imp[:, 0]
    imp = imp.at[:, 0].set(new)
    wa = wa - prep["tw_to_wa"] * lam[:, None]
    wb = wb + prep["tw_to_wb"] * lam[:, None]

    # Swing motor.
    axm = prep["swing_motor_axis"]
    relw = jnp.sum(axm * wb, -1) - jnp.sum(axm * wa, -1)
    lam = -prep["eff_swing_motor"] * (relw - prep["swing_motor_vel"])
    new = jnp.clip(imp[:, 1] + lam, -prep["max_swing_imp"], prep["max_swing_imp"])
    lam = new - imp[:, 1]
    imp = imp.at[:, 1].set(new)
    wa = wa - prep["swm_to_wa"] * lam[:, None]
    wb = wb + prep["swm_to_wb"] * lam[:, None]

    # Twist limit.
    s = prep["twist_sign"]
    relw = s * (jnp.sum(ax * wb, -1) - jnp.sum(ax * wa, -1))
    lam = -prep["eff_twist_limit"] * (relw + prep["twist_bias"])
    new = jnp.maximum(imp[:, 2] + lam, 0.0)
    lam = (new - imp[:, 2]) * s
    imp = imp.at[:, 2].set(new)
    wa = wa - prep["tw_to_wa"] * lam[:, None]
    wb = wb + prep["tw_to_wb"] * lam[:, None]

    # Swing limit — note the inverted application sign
    # (reference: constraints.cpp:2035-2048 swing Cdot = aDotWA - aDotWB).
    axs = prep["swing_axis"]
    cdot = jnp.sum(axs * wa, -1) - jnp.sum(axs * wb, -1) + prep["swing_bias"]
    lam = -prep["eff_swing"] * cdot
    new = jnp.maximum(imp[:, 3] + lam, 0.0)
    lam = new - imp[:, 3]
    imp = imp.at[:, 3].set(new)
    wa = wa + prep["sw_to_wa"] * lam[:, None]
    wb = wb - prep["sw_to_wb"] * lam[:, None]

    va, wa, vb, wb = _solve_ball_part(prep, va, wa, vb, wb)
    return va, wa, vb, wb, imp


# --------------------------------------------------------------------------
# Slider (reference: constraints.cpp:1395-1560 init, :1560-1700 solve)
# --------------------------------------------------------------------------

def _prep_slider(table, ctx, p):
    ia, ib, qa, qb, ra, rb, ga, gb, im_a, im_b, ii_a, ii_b, active = _common(table, ctx, p)
    dt = ctx.dt
    axis_w = m.quat_rotate(qa, p["axis_a"])
    t, b = m.orthonormal_basis(axis_w)
    u = gb - ga
    r_au = ra + u

    rbxt, rbxb = jnp.cross(rb, t), jnp.cross(rb, b)
    rauxt, rauxb = jnp.cross(r_au, t), jnp.cross(r_au, b)
    ia_rauxt, ia_rauxb = _mv(ii_a, rauxt), _mv(ii_a, rauxb)
    ib_rbxt, ib_rbxb = _mv(ii_b, rbxt), _mv(ii_b, rbxb)
    im_sum = im_a + im_b
    k00 = jnp.sum(rauxt * ia_rauxt, -1) + jnp.sum(rbxt * ib_rbxt, -1) + im_sum
    k01 = jnp.sum(rauxt * ia_rauxb, -1) + jnp.sum(rbxt * ib_rbxb, -1)
    k10 = jnp.sum(rauxb * ia_rauxt, -1) + jnp.sum(rbxb * ib_rbxt, -1)
    k11 = jnp.sum(rauxb * ia_rauxb, -1) + jnp.sum(rbxb * ib_rbxb, -1) + im_sum
    i2 = _inv22(k00, k01, k10, k11, active)

    inv_K_rot = _safe_inv3(ii_a + ii_b, active)
    bscale = _bias_scale(dt, SLIDER_BETA)
    t_bias = jnp.stack([jnp.sum(u * t, -1), jnp.sum(u * b, -1)], -1) * bscale
    rot_err = m.quat_mul(qb, m.quat_mul(p["init_inv_rot"], m.quat_conj(qa)))
    r_bias = rot_err[..., :3] * (2.0 * bscale)

    dist = jnp.sum(u * axis_w, -1)
    neg_l, pos_l = p["neg_limit"], p["pos_limit"]
    min_violated = (neg_l <= 0.0) & (dist < neg_l)
    max_violated = (pos_l >= 0.0) & (dist > pos_l)
    solve_limit = (min_violated | max_violated) & active
    limit_sign = jnp.where(min_violated, 1.0, -1.0)
    rauxs = jnp.cross(r_au, axis_w)
    rbxs = jnp.cross(rb, axis_w)
    inv_ax = (
        im_sum + jnp.sum(rauxs * _mv(ii_a, rauxs), -1) + jnp.sum(rbxs * _mv(ii_b, rbxs), -1)
    )
    eff_limit = jnp.where(inv_ax != 0, 1.0 / jnp.where(inv_ax == 0, 1.0, inv_ax), 0.0)
    eff_limit = eff_limit * solve_limit
    err = jnp.where(min_violated, dist - neg_l, pos_l - dist)
    limit_bias = err * _bias_scale(dt, SLIDER_LIMIT_BETA)
    lim_to_wa, lim_to_wb = _mv(ii_a, rauxs), _mv(ii_b, rbxs)

    motor_active = (p["max_force"] > 0.0) & active
    max_imp = jnp.maximum(p["max_force"], 0.0) * dt
    tgt = jnp.clip(
        p["motor_target"],
        jnp.where(neg_l <= 0.0, neg_l, -jnp.inf),
        jnp.where(pos_l >= 0.0, pos_l, jnp.inf),
    )
    motor_vel = jnp.where(
        p["motor_type"] == MOTOR_POSITION,
        jnp.where(dt > DT_THRESHOLD, (tgt - dist) / dt, 0.0),
        p["motor_target"],
    )
    k_lin = im_sum
    eff_motor = jnp.where(k_lin != 0, 1.0 / jnp.where(k_lin == 0, 1.0, k_lin), 0.0)
    eff_motor = eff_motor * motor_active

    return dict(
        ia=ia, ib=ib, ra=ra, rb=rb, im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b,
        axis=axis_w, t=t, b=b, rbxt=rbxt, rbxb=rbxb, rauxt=rauxt, rauxb=rauxb,
        i2=i2, inv_K_rot=inv_K_rot, t_bias=t_bias, r_bias=r_bias,
        eff_limit=eff_limit, limit_sign=limit_sign, limit_bias=limit_bias,
        rauxs=rauxs, rbxs=rbxs, lim_to_wa=lim_to_wa, lim_to_wb=lim_to_wb,
        eff_motor=eff_motor, motor_vel=motor_vel, max_imp=max_imp, dist=dist,
    )


def _solve_slider(prep, va, wa, vb, wb, imp):
    ax = prep["axis"]

    # Motor (linear, no angular arms; reference: constraints.cpp slider solve).
    cdot = jnp.sum(vb * ax, -1) - jnp.sum(va * ax, -1) - prep["motor_vel"]
    lam = -prep["eff_motor"] * cdot
    new = jnp.clip(imp[:, 0] + lam, -prep["max_imp"], prep["max_imp"])
    lam = new - imp[:, 0]
    imp = imp.at[:, 0].set(new)
    P = lam[:, None] * ax
    va = va - prep["im_a"][:, None] * P
    vb = vb + prep["im_b"][:, None] * P

    # Limit.
    s = prep["limit_sign"]
    cdot = (
        jnp.sum(vb * ax, -1) + jnp.sum(wb * prep["rbxs"], -1)
        - jnp.sum(va * ax, -1) - jnp.sum(wa * prep["rauxs"], -1)
    )
    lam = -prep["eff_limit"] * (s * cdot + prep["limit_bias"])
    new = jnp.maximum(imp[:, 1] + lam, 0.0)
    lam = (new - imp[:, 1]) * s
    imp = imp.at[:, 1].set(new)
    P = lam[:, None] * ax
    va = va - prep["im_a"][:, None] * P
    wa = wa - prep["lim_to_wa"] * lam[:, None]
    vb = vb + prep["im_b"][:, None] * P
    wb = wb + prep["lim_to_wb"] * lam[:, None]

    # Rotation part (all 3 angular dof locked).
    lam3 = -_mv(prep["inv_K_rot"], (wb - wa) + prep["r_bias"])
    wa = wa - _mv(prep["ii_a"], lam3)
    wb = wb + _mv(prep["ii_b"], lam3)

    # Position part (2 dof perpendicular to axis).
    t, b = prep["t"], prep["b"]
    c0 = (
        jnp.sum(t * vb, -1) + jnp.sum(prep["rbxt"] * wb, -1)
        - jnp.sum(t * va, -1) - jnp.sum(prep["rauxt"] * wa, -1)
        + prep["t_bias"][:, 0]
    )
    c1 = (
        jnp.sum(b * vb, -1) + jnp.sum(prep["rbxb"] * wb, -1)
        - jnp.sum(b * va, -1) - jnp.sum(prep["rauxb"] * wa, -1)
        + prep["t_bias"][:, 1]
    )
    i00, i01, i10, i11 = prep["i2"]
    l0 = -(i00 * c0 + i01 * c1)
    l1 = -(i10 * c0 + i11 * c1)
    P = t * l0[:, None] + b * l1[:, None]
    va = va - prep["im_a"][:, None] * P
    wa = wa - _mv(prep["ii_a"], prep["rauxt"] * l0[:, None] + prep["rauxb"] * l1[:, None])
    vb = vb + prep["im_b"][:, None] * P
    wb = wb + _mv(prep["ii_b"], prep["rbxt"] * l0[:, None] + prep["rbxb"] * l1[:, None])

    return va, wa, vb, wb, imp


# --------------------------------------------------------------------------
# Registry + orchestration
# --------------------------------------------------------------------------

_PREP_FNS = {
    "distance": _prep_distance,
    "ball": _prep_ball,
    "fixed": _prep_fixed,
    "hinge": _prep_hinge,
    "cone_twist": _prep_cone_twist,
    "slider": _prep_slider,
}

_SOLVE_FNS = {
    "distance": _solve_distance,
    "ball": _solve_ball,
    "fixed": _solve_fixed,
    "hinge": _solve_hinge,
    "cone_twist": _solve_cone_twist,
    "slider": _solve_slider,
}

# Accumulated (clamped) impulse slots per type: motors and limits only —
# equality parts are solved unaccumulated like the reference.
IMPULSE_DIMS = {
    "distance": 0,
    "ball": 0,
    "fixed": 0,
    "hinge": 2,       # motor, limit
    "cone_twist": 4,  # twist motor, swing motor, twist limit, swing limit
    "slider": 2,      # motor, limit
}


def prep_all(
    arch: SceneArchetype,
    ctx: JointContext,
    motor_overrides: Optional[Tuple[Optional[Dict[str, jnp.ndarray]], ...]] = None,
):
    """Precompute per-joint constraint data for all joint tables.

    `motor_overrides[k]`, if given, overrides parameter arrays of table k
    (e.g. {"motor_target": actions}) — the RL action path."""
    preps = []
    for k, table in enumerate(arch.joints):
        params = dict(table.params)
        if motor_overrides is not None and motor_overrides[k]:
            params.update(motor_overrides[k])
        preps.append(_PREP_FNS[table.kind](table, ctx, params))
    return tuple(preps)


def init_impulses(arch: SceneArchetype, dtype):
    return tuple(
        jnp.zeros((t.body_a.shape[0], IMPULSE_DIMS[t.kind]), dtype)
        for t in arch.joints
    )


def _solve_table_colored(color_indices, prep, imp, vel, omega, row_solver):
    for idx in color_indices:
        p = jax.tree_util.tree_map(lambda x: x[idx], prep)
        ia, ib = p["ia"], p["ib"]
        va, wa = vel[ia], omega[ia]
        vb, wb = vel[ib], omega[ib]
        va, wa, vb, wb, new_imp = row_solver(p, va, wa, vb, wb, imp[idx])
        vel = vel.at[ia].set(va)
        omega = omega.at[ia].set(wa)
        vel = vel.at[ib].set(vb)
        omega = omega.at[ib].set(wb)
        imp = imp.at[idx].set(new_imp)
    return vel, omega, imp


def solve_all_one_iteration(arch: SceneArchetype, preps, impulses, vel, omega):
    """One Gauss-Seidel sweep over all joint tables, reference type order."""
    tables = {t.kind: (k, t) for k, t in enumerate(arch.joints)}
    new_imps = list(impulses)
    for kind in JOINT_SOLVE_ORDER:
        if kind not in tables:
            continue
        k, table = tables[kind]
        vel, omega, new_imps[k] = _solve_table_colored(
            arch.joint_color_indices[k], preps[k], impulses[k], vel, omega,
            _SOLVE_FNS[kind],
        )
        impulses = tuple(
            new_imps[i] if i == k else impulses[i] for i in range(len(new_imps))
        )
    return vel, omega, tuple(new_imps)
