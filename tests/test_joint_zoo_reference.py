"""Trajectory parity for the FULL joint zoo vs an independent scalar NumPy
reference (VERDICT r1 item 5).

Covers all 6 joint types — distance, ball (chain), fixed, hinge (+limit
+motor), cone-twist (+limits+motors), slider (+limit+motor) — plus a 3-body
mixed chain.  Each scalar simulator below is a straight-line float64 NumPy
port of the documented algorithm (reference: src/physics/constraints.cpp:
200-2070), written without importing any of the JAX code paths.  BASELINE
demands <= 1e-3 divergence over the test horizon.
"""

import math

import jax
import numpy as np
import pytest

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings

DT = 1.0 / 120.0
GRAVITY = -9.81
ITERS = 30
BETA = 0.1                 # distance/ball/slider beta
HINGE_ROT_BETA = 0.3
LIMIT_BETA = 0.1
SWING_MOTOR_GAIN = 0.2


# ---------------------------------------------------------------------------
# Scalar math helpers (float64, independent of core.maths)
# ---------------------------------------------------------------------------

def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _qconj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _qrot(q, v):
    u, w = q[:3], q[3]
    return 2 * (u @ v) * u + (w * w - u @ u) * v + 2 * w * np.cross(u, v)


def _onb(n):
    """Pixar/Duff orthonormal basis — must match core.maths.orthonormal_basis."""
    sign = 1.0 if n[2] >= 0.0 else -1.0
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t1 = np.array([1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    t2 = np.array([b, sign + n[1] * n[1] * a, -n[1]])
    return t1, t2


def _q_from_to(a, b):
    w = 1.0 + a @ b
    v = np.cross(a, b)
    if w < 1e-6:
        v, _ = _onb(a)
        w = 0.0
    q = np.array([*v, w])
    return q / np.linalg.norm(q)


def _q_axis_angle(q):
    v = q[:3]
    l = np.linalg.norm(v)
    angle = 2.0 * math.atan2(l, q[3])
    axis = v / l if l > 1e-9 else np.array([1.0, 0.0, 0.0])
    return axis, angle


def _q_from_axis_angle(axis, angle):
    return np.array([*(axis * math.sin(0.5 * angle)), math.cos(0.5 * angle)])


def _qintegrate(q, omega, dt):
    dq = _qmul(np.array([*(0.5 * omega), 0.0]), q)
    q = q + dq * dt
    return q / np.linalg.norm(q)


def _sphere_mass(r, density=1000.0):
    mass = density * 4.0 / 3.0 * math.pi * r ** 3
    return mass, 2.0 / 5.0 * mass * r * r


class _Body:
    """Dynamic body with isotropic (sphere) inertia; world = None."""

    def __init__(self, pos, r=0.1, damping=0.0):
        self.pos = np.asarray(pos, np.float64).copy()
        self.rot = np.array([0.0, 0.0, 0.0, 1.0])
        self.vel = np.zeros(3)
        self.omega = np.zeros(3)
        mass, i = _sphere_mass(r)
        self.inv_m = 1.0 / mass
        self.inv_i_local = 1.0 / i
        self.damping = damping

    @property
    def inv_I(self):
        # world inverse inertia — isotropic for spheres
        return np.eye(3) * self.inv_i_local


class _World:
    pos = np.zeros(3)
    rot = np.array([0.0, 0.0, 0.0, 1.0])
    inv_m = 0.0

    def __init__(self):
        self.vel = np.zeros(3)
        self.omega = np.zeros(3)

    @property
    def inv_I(self):
        return np.zeros((3, 3))


def _integrate(bodies, dt):
    for b in bodies:
        if isinstance(b, _World):
            continue
        b.vel = b.vel + np.array([0.0, GRAVITY, 0.0]) * dt
        b.vel = b.vel / (1.0 + dt * b.damping)
        b.omega = b.omega / (1.0 + dt * b.damping)


def _advance(bodies, dt):
    for b in bodies:
        if isinstance(b, _World):
            continue
        b.pos = b.pos + b.vel * dt
        b.rot = _qintegrate(b.rot, b.omega, dt)


def _anchors(ba, bb, anchor_a, anchor_b):
    ra = _qrot(ba.rot, anchor_a)
    rb = _qrot(bb.rot, anchor_b)
    return ra, rb, ba.pos + ra, bb.pos + rb


def _ball_K_inv(ba, bb, ra, rb):
    sa, sb = _skew(ra), _skew(rb)
    K = (sa @ ba.inv_I @ sa.T + sb @ bb.inv_I @ sb.T
         + (ba.inv_m + bb.inv_m) * np.eye(3))
    return np.linalg.inv(K + 1e-9 * np.eye(3))


def _apply_linear(ba, bb, ra, rb, P):
    ba.vel = ba.vel - ba.inv_m * P
    ba.omega = ba.omega - ba.inv_I @ np.cross(ra, P)
    bb.vel = bb.vel + bb.inv_m * P
    bb.omega = bb.omega + bb.inv_I @ np.cross(rb, P)


def _axial_eff(axis, ba, bb):
    k = axis @ (ba.inv_I @ axis) + axis @ (bb.inv_I @ axis)
    eff = 1.0 / k if k != 0 else 0.0
    return eff, ba.inv_I @ axis, bb.inv_I @ axis


# ---------------------------------------------------------------------------
# Scalar joint solvers: prep() once per substep, solve() per iteration
# ---------------------------------------------------------------------------

class _Distance:
    def __init__(self, ba, bb, anchor_a, anchor_b, length):
        self.ba, self.bb = ba, bb
        self.aa, self.ab, self.length = anchor_a, anchor_b, length

    def prep(self, dt):
        ba, bb = self.ba, self.bb
        self.ra, self.rb, ga, gb = _anchors(ba, bb, self.aa, self.ab)
        u = gb - ga
        l = np.linalg.norm(u)
        self.u = u / l if l > 1e-3 else np.zeros(3)
        self.bias = (l - self.length) * BETA / dt
        ca, cb = np.cross(self.ra, self.u), np.cross(self.rb, self.u)
        self.to_wa, self.to_wb = ba.inv_I @ ca, bb.inv_I @ cb
        k = ba.inv_m + bb.inv_m + ca @ self.to_wa + cb @ self.to_wb
        self.eff = 1.0 / k if k != 0 else 0.0

    def solve(self):
        ba, bb = self.ba, self.bb
        av_a = ba.vel + np.cross(ba.omega, self.ra)
        av_b = bb.vel + np.cross(bb.omega, self.rb)
        lam = -self.eff * (self.u @ (av_b - av_a) + self.bias)
        P = lam * self.u
        ba.vel = ba.vel - ba.inv_m * P
        ba.omega = ba.omega - self.to_wa * lam
        bb.vel = bb.vel + bb.inv_m * P
        bb.omega = bb.omega + self.to_wb * lam


class _Ball:
    def __init__(self, ba, bb, anchor_a, anchor_b):
        self.ba, self.bb = ba, bb
        self.aa, self.ab = anchor_a, anchor_b

    def prep(self, dt):
        self.ra, self.rb, ga, gb = _anchors(self.ba, self.bb, self.aa, self.ab)
        self.inv_K = _ball_K_inv(self.ba, self.bb, self.ra, self.rb)
        self.bias = (gb - ga) * BETA / dt

    def solve(self):
        ba, bb = self.ba, self.bb
        av_a = ba.vel + np.cross(ba.omega, self.ra)
        av_b = bb.vel + np.cross(bb.omega, self.rb)
        P = -self.inv_K @ (av_b - av_a + self.bias)
        _apply_linear(ba, bb, self.ra, self.rb, P)


class _Fixed(_Ball):
    def __init__(self, ba, bb, anchor_a, anchor_b, init_inv_rot):
        super().__init__(ba, bb, anchor_a, anchor_b)
        self.init_inv_rot = init_inv_rot

    def prep(self, dt):
        super().prep(dt)
        self.inv_K_rot = np.linalg.inv(
            self.ba.inv_I + self.bb.inv_I + 1e-9 * np.eye(3))
        rot_err = _qmul(self.bb.rot,
                        _qmul(self.init_inv_rot, _qconj(self.ba.rot)))
        self.r_bias = rot_err[:3] * (2.0 * BETA / dt)

    def solve(self):
        ba, bb = self.ba, self.bb
        lam = -self.inv_K_rot @ ((bb.omega - ba.omega) + self.r_bias)
        ba.omega = ba.omega - ba.inv_I @ lam
        bb.omega = bb.omega + bb.inv_I @ lam
        super().solve()


class _Hinge:
    def __init__(self, ba, bb, anchor_a, anchor_b, axis_a, axis_b,
                 tangent_a, bitangent_a, tangent_b,
                 min_limit=1.0, max_limit=-1.0,
                 motor_type=0.0, motor_target=0.0, max_torque=-1.0):
        self.ba, self.bb = ba, bb
        self.aa, self.ab = anchor_a, anchor_b
        self.axis_a, self.axis_b = axis_a, axis_b
        self.tangent_a, self.bitangent_a = tangent_a, bitangent_a
        self.tangent_b = tangent_b
        self.min_limit, self.max_limit = min_limit, max_limit
        self.motor_type, self.motor_target = motor_type, motor_target
        self.max_torque = max_torque

    def prep(self, dt):
        ba, bb = self.ba, self.bb
        self.ra, self.rb, ga, gb = _anchors(ba, bb, self.aa, self.ab)
        self.inv_K = _ball_K_inv(ba, bb, self.ra, self.rb)
        self.bias = (gb - ga) * BETA / dt

        axis_a_w = _qrot(ba.rot, self.axis_a)
        axis_b_w = _qrot(bb.rot, self.axis_b)
        tb, bbv = _onb(axis_b_w)
        self.bxa = np.cross(tb, axis_a_w)
        self.cxa = np.cross(bbv, axis_a_w)
        ii_b = ba.inv_I @ self.bxa + bb.inv_I @ self.bxa
        ii_c = ba.inv_I @ self.cxa + bb.inv_I @ self.cxa
        K2 = np.array([[self.bxa @ ii_b, self.bxa @ ii_c],
                       [self.cxa @ ii_b, self.cxa @ ii_c]])
        self.i2 = np.linalg.inv(K2) if abs(np.linalg.det(K2)) > 1e-12 else np.zeros((2, 2))
        self.r_bias = np.array([axis_a_w @ tb, axis_a_w @ bbv]) * (HINGE_ROT_BETA / dt)

        cmp_a = _qrot(_qconj(ba.rot), _qrot(bb.rot, self.tangent_b))
        angle = math.atan2(cmp_a @ self.bitangent_a, cmp_a @ self.tangent_a)

        min_active = self.min_limit <= 0.0
        max_active = self.max_limit >= 0.0
        min_violated = min_active and angle <= self.min_limit
        max_violated = max_active and angle >= self.max_limit
        self.solve_limit = min_violated or max_violated
        self.limit_sign = 1.0 if min_violated else -1.0
        eff_ax, self.to_wa_ax, self.to_wb_ax = _axial_eff(axis_a_w, ba, bb)
        self.axis = axis_a_w
        self.eff_limit = eff_ax if self.solve_limit else 0.0
        d = (angle - self.min_limit) if min_violated else (self.max_limit - angle)
        self.limit_bias = d * LIMIT_BETA / dt

        motor_active = self.max_torque > 0.0
        self.max_imp = max(self.max_torque, 0.0) * dt
        tgt = np.clip(self.motor_target,
                      self.min_limit if min_active else -math.pi,
                      self.max_limit if max_active else math.pi)
        self.motor_vel = ((tgt - angle) / dt if self.motor_type == 1.0
                          else self.motor_target)
        self.eff_motor = eff_ax if motor_active else 0.0
        self.imp = np.zeros(2)

    def solve(self):
        ba, bb = self.ba, self.bb
        # Motor.
        relw = self.axis @ bb.omega - self.axis @ ba.omega
        lam = -self.eff_motor * (relw - self.motor_vel)
        new = np.clip(self.imp[0] + lam, -self.max_imp, self.max_imp)
        lam = new - self.imp[0]
        self.imp[0] = new
        ba.omega = ba.omega - self.to_wa_ax * lam
        bb.omega = bb.omega + self.to_wb_ax * lam
        # Limit.
        s = self.limit_sign
        relw = s * (self.axis @ bb.omega - self.axis @ ba.omega)
        lam = -self.eff_limit * (relw + self.limit_bias)
        new = max(self.imp[1] + lam, 0.0)
        lam = (new - self.imp[1]) * s
        self.imp[1] = new
        ba.omega = ba.omega - self.to_wa_ax * lam
        bb.omega = bb.omega + self.to_wb_ax * lam
        # Rotation (2 dof).
        dw = bb.omega - ba.omega
        c = np.array([self.bxa @ dw, self.cxa @ dw]) + self.r_bias
        l2 = -self.i2 @ c
        P = self.bxa * l2[0] + self.cxa * l2[1]
        ba.omega = ba.omega - ba.inv_I @ P
        bb.omega = bb.omega + bb.inv_I @ P
        # Position.
        av_a = ba.vel + np.cross(ba.omega, self.ra)
        av_b = bb.vel + np.cross(bb.omega, self.rb)
        P = -self.inv_K @ (av_b - av_a + self.bias)
        _apply_linear(ba, bb, self.ra, self.rb, P)


class _ConeTwist:
    def __init__(self, ba, bb, anchor_a, anchor_b, axis_a, axis_b,
                 tangent_a, bitangent_a, tangent_b,
                 swing_limit=-1.0, twist_limit=-1.0,
                 swing_motor_type=0.0, swing_target=0.0, swing_axis_angle=0.0,
                 max_swing_torque=-1.0,
                 twist_motor_type=0.0, twist_target=0.0, max_twist_torque=-1.0):
        self.ba, self.bb = ba, bb
        self.aa, self.ab = anchor_a, anchor_b
        self.axis_a, self.axis_b = axis_a, axis_b
        self.tangent_a, self.bitangent_a = tangent_a, bitangent_a
        self.tangent_b = tangent_b
        self.swing_limit, self.twist_limit = swing_limit, twist_limit
        self.swing_motor_type, self.swing_target = swing_motor_type, swing_target
        self.swing_axis_angle = swing_axis_angle
        self.max_swing_torque = max_swing_torque
        self.twist_motor_type, self.twist_target = twist_motor_type, twist_target
        self.max_twist_torque = max_twist_torque

    def prep(self, dt):
        ba, bb = self.ba, self.bb
        self.ra, self.rb, ga, gb = _anchors(ba, bb, self.aa, self.ab)
        self.inv_K = _ball_K_inv(ba, bb, self.ra, self.rb)
        self.bias = (gb - ga) * BETA / dt

        btoa = _qmul(_qconj(ba.rot), bb.rot)
        axis_cmp = _qrot(btoa, self.axis_b)
        swing_q = _q_from_to(self.axis_a, axis_cmp)
        twist_tan = _qrot(swing_q, self.tangent_a)
        twist_bitan = _qrot(swing_q, self.bitangent_a)
        tan_cmp = _qrot(btoa, self.tangent_b)
        twist_angle = math.atan2(tan_cmp @ twist_bitan, tan_cmp @ twist_tan)
        swing_axis_l, swing_angle = _q_axis_angle(swing_q)
        if swing_angle < 0.0:
            swing_angle = -swing_angle
            swing_axis_l = -swing_axis_l

        sl = self.swing_limit
        solve_swing = sl >= 0.0 and swing_angle >= sl
        swing_axis_w = _qrot(ba.rot, swing_axis_l)
        eff_sw, self.sw_to_wa, self.sw_to_wb = _axial_eff(swing_axis_w, ba, bb)
        self.swing_axis = swing_axis_w
        self.eff_swing = eff_sw if solve_swing else 0.0
        self.swing_bias = (sl - swing_angle) * LIMIT_BETA / dt

        swing_motor_active = self.max_swing_torque > 0.0
        self.max_swing_imp = max(self.max_swing_torque, 0.0) * dt
        c, s = math.cos(self.swing_axis_angle), math.sin(self.swing_axis_angle)
        local_motor_axis = c * self.tangent_a + s * self.bitangent_a
        sw_tgt = (np.clip(self.swing_target, -sl, sl) if sl >= 0.0
                  else self.swing_target)
        local_target_dir = _qrot(
            _q_from_axis_angle(local_motor_axis, sw_tgt), self.axis_a)
        cr = np.cross(axis_cmp, local_target_dir)
        crl = np.linalg.norm(cr)
        pos_axis_l = cr / crl if crl * crl >= 1e-8 else np.zeros(3)
        cos_ang = np.clip(local_target_dir @ axis_cmp, 0.0, 1.0)
        pos_vel = math.acos(cos_ang) / dt * SWING_MOTOR_GAIN
        is_pos = self.swing_motor_type == 1.0
        motor_axis_l = pos_axis_l if is_pos else local_motor_axis
        self.swing_motor_vel = pos_vel if is_pos else self.swing_target
        axm = _qrot(ba.rot, motor_axis_l)
        eff_swm, self.swm_to_wa, self.swm_to_wb = _axial_eff(axm, ba, bb)
        self.swing_motor_axis = axm
        self.eff_swing_motor = eff_swm if swing_motor_active else 0.0

        tl = self.twist_limit
        twist_axis_w = _qrot(ba.rot, self.axis_a)
        min_violated = tl >= 0.0 and twist_angle <= -tl
        max_violated = tl >= 0.0 and twist_angle >= tl
        eff_tw, self.tw_to_wa, self.tw_to_wb = _axial_eff(twist_axis_w, ba, bb)
        self.twist_axis = twist_axis_w
        self.eff_twist_limit = eff_tw if (min_violated or max_violated) else 0.0
        self.twist_sign = 1.0 if min_violated else -1.0
        d = (tl + twist_angle) if min_violated else (tl - twist_angle)
        self.twist_bias = d * LIMIT_BETA / dt

        twist_motor_active = self.max_twist_torque > 0.0
        self.max_twist_imp = max(self.max_twist_torque, 0.0) * dt
        lim = tl if tl >= 0.0 else math.pi
        tw_tgt = np.clip(self.twist_target, -lim, lim)
        self.twist_motor_vel = ((tw_tgt - twist_angle) / dt
                                if self.twist_motor_type == 1.0
                                else self.twist_target)
        self.eff_twist_motor = eff_tw if twist_motor_active else 0.0
        self.imp = np.zeros(4)

    def solve(self):
        ba, bb = self.ba, self.bb
        # Twist motor.
        ax = self.twist_axis
        relw = ax @ bb.omega - ax @ ba.omega
        lam = -self.eff_twist_motor * (relw - self.twist_motor_vel)
        new = np.clip(self.imp[0] + lam, -self.max_twist_imp, self.max_twist_imp)
        lam = new - self.imp[0]
        self.imp[0] = new
        ba.omega = ba.omega - self.tw_to_wa * lam
        bb.omega = bb.omega + self.tw_to_wb * lam
        # Swing motor.
        axm = self.swing_motor_axis
        relw = axm @ bb.omega - axm @ ba.omega
        lam = -self.eff_swing_motor * (relw - self.swing_motor_vel)
        new = np.clip(self.imp[1] + lam, -self.max_swing_imp, self.max_swing_imp)
        lam = new - self.imp[1]
        self.imp[1] = new
        ba.omega = ba.omega - self.swm_to_wa * lam
        bb.omega = bb.omega + self.swm_to_wb * lam
        # Twist limit.
        s = self.twist_sign
        relw = s * (ax @ bb.omega - ax @ ba.omega)
        lam = -self.eff_twist_limit * (relw + self.twist_bias)
        new = max(self.imp[2] + lam, 0.0)
        lam = (new - self.imp[2]) * s
        self.imp[2] = new
        ba.omega = ba.omega - self.tw_to_wa * lam
        bb.omega = bb.omega + self.tw_to_wb * lam
        # Swing limit (inverted sign convention).
        axs = self.swing_axis
        cdot = axs @ ba.omega - axs @ bb.omega + self.swing_bias
        lam = -self.eff_swing * cdot
        new = max(self.imp[3] + lam, 0.0)
        lam = new - self.imp[3]
        self.imp[3] = new
        ba.omega = ba.omega + self.sw_to_wa * lam
        bb.omega = bb.omega - self.sw_to_wb * lam
        # Position.
        av_a = ba.vel + np.cross(ba.omega, self.ra)
        av_b = bb.vel + np.cross(bb.omega, self.rb)
        P = -self.inv_K @ (av_b - av_a + self.bias)
        _apply_linear(ba, bb, self.ra, self.rb, P)


class _Slider:
    def __init__(self, ba, bb, anchor_a, anchor_b, axis_a, init_inv_rot,
                 neg_limit=1.0, pos_limit=-1.0,
                 motor_type=0.0, motor_target=0.0, max_force=-1.0):
        self.ba, self.bb = ba, bb
        self.aa, self.ab = anchor_a, anchor_b
        self.axis_a, self.init_inv_rot = axis_a, init_inv_rot
        self.neg_limit, self.pos_limit = neg_limit, pos_limit
        self.motor_type, self.motor_target = motor_type, motor_target
        self.max_force = max_force

    def prep(self, dt):
        ba, bb = self.ba, self.bb
        ra, rb, ga, gb = _anchors(ba, bb, self.aa, self.ab)
        axis_w = _qrot(ba.rot, self.axis_a)
        t, b = _onb(axis_w)
        u = gb - ga
        r_au = ra + u

        self.rbxt, self.rbxb = np.cross(rb, t), np.cross(rb, b)
        self.rauxt, self.rauxb = np.cross(r_au, t), np.cross(r_au, b)
        im_sum = ba.inv_m + bb.inv_m
        k00 = (self.rauxt @ (ba.inv_I @ self.rauxt)
               + self.rbxt @ (bb.inv_I @ self.rbxt) + im_sum)
        k01 = (self.rauxt @ (ba.inv_I @ self.rauxb)
               + self.rbxt @ (bb.inv_I @ self.rbxb))
        k10 = (self.rauxb @ (ba.inv_I @ self.rauxt)
               + self.rbxb @ (bb.inv_I @ self.rbxt))
        k11 = (self.rauxb @ (ba.inv_I @ self.rauxb)
               + self.rbxb @ (bb.inv_I @ self.rbxb) + im_sum)
        K2 = np.array([[k00, k01], [k10, k11]])
        self.i2 = np.linalg.inv(K2) if abs(np.linalg.det(K2)) > 1e-12 else np.zeros((2, 2))

        self.inv_K_rot = np.linalg.inv(ba.inv_I + bb.inv_I + 1e-9 * np.eye(3))
        self.t_bias = np.array([u @ t, u @ b]) * (BETA / dt)
        rot_err = _qmul(bb.rot, _qmul(self.init_inv_rot, _qconj(ba.rot)))
        self.r_bias = rot_err[:3] * (2.0 * BETA / dt)
        self.axis, self.t, self.b = axis_w, t, b

        dist = u @ axis_w
        min_violated = self.neg_limit <= 0.0 and dist < self.neg_limit
        max_violated = self.pos_limit >= 0.0 and dist > self.pos_limit
        self.limit_sign = 1.0 if min_violated else -1.0
        self.rauxs = np.cross(r_au, axis_w)
        self.rbxs = np.cross(rb, axis_w)
        inv_ax = (im_sum + self.rauxs @ (ba.inv_I @ self.rauxs)
                  + self.rbxs @ (bb.inv_I @ self.rbxs))
        eff = 1.0 / inv_ax if inv_ax != 0 else 0.0
        self.eff_limit = eff if (min_violated or max_violated) else 0.0
        err = (dist - self.neg_limit) if min_violated else (self.pos_limit - dist)
        self.limit_bias = err * LIMIT_BETA / dt
        self.lim_to_wa = ba.inv_I @ self.rauxs
        self.lim_to_wb = bb.inv_I @ self.rbxs

        motor_active = self.max_force > 0.0
        self.max_imp = max(self.max_force, 0.0) * dt
        tgt = np.clip(self.motor_target,
                      self.neg_limit if self.neg_limit <= 0.0 else -np.inf,
                      self.pos_limit if self.pos_limit >= 0.0 else np.inf)
        self.motor_vel = ((tgt - dist) / dt if self.motor_type == 1.0
                          else self.motor_target)
        self.eff_motor = (1.0 / im_sum if im_sum != 0 else 0.0) if motor_active else 0.0
        self.imp = np.zeros(2)

    def solve(self):
        ba, bb = self.ba, self.bb
        ax = self.axis
        # Motor (linear).
        cdot = bb.vel @ ax - ba.vel @ ax - self.motor_vel
        lam = -self.eff_motor * cdot
        new = np.clip(self.imp[0] + lam, -self.max_imp, self.max_imp)
        lam = new - self.imp[0]
        self.imp[0] = new
        ba.vel = ba.vel - ba.inv_m * lam * ax
        bb.vel = bb.vel + bb.inv_m * lam * ax
        # Limit.
        s = self.limit_sign
        cdot = (bb.vel @ ax + bb.omega @ self.rbxs
                - ba.vel @ ax - ba.omega @ self.rauxs)
        lam = -self.eff_limit * (s * cdot + self.limit_bias)
        new = max(self.imp[1] + lam, 0.0)
        lam = (new - self.imp[1]) * s
        self.imp[1] = new
        ba.vel = ba.vel - ba.inv_m * lam * ax
        ba.omega = ba.omega - self.lim_to_wa * lam
        bb.vel = bb.vel + bb.inv_m * lam * ax
        bb.omega = bb.omega + self.lim_to_wb * lam
        # Rotation (3 dof).
        lam3 = -self.inv_K_rot @ ((bb.omega - ba.omega) + self.r_bias)
        ba.omega = ba.omega - ba.inv_I @ lam3
        bb.omega = bb.omega + bb.inv_I @ lam3
        # Position (2 dof).
        t, b = self.t, self.b
        c0 = (t @ bb.vel + self.rbxt @ bb.omega
              - t @ ba.vel - self.rauxt @ ba.omega + self.t_bias[0])
        c1 = (b @ bb.vel + self.rbxb @ bb.omega
              - b @ ba.vel - self.rauxb @ ba.omega + self.t_bias[1])
        l2 = -self.i2 @ np.array([c0, c1])
        P = t * l2[0] + b * l2[1]
        ba.vel = ba.vel - ba.inv_m * P
        ba.omega = ba.omega - ba.inv_I @ (self.rauxt * l2[0] + self.rauxb * l2[1])
        bb.vel = bb.vel + bb.inv_m * P
        bb.omega = bb.omega + bb.inv_I @ (self.rbxt * l2[0] + self.rbxb * l2[1])


def _simulate(bodies, joints, steps, dt=DT):
    """Scalar reference loop mirroring physics_substep's ordering."""
    traj = []
    for _ in range(steps):
        for j in joints:  # prep at pre-integration pose
            j.prep(dt)
        _integrate(bodies, dt)
        for _ in range(ITERS):
            for j in joints:  # table order = reference type solve order
                j.solve()
        _advance(bodies, dt)
        traj.append(np.concatenate(
            [b.pos for b in bodies if not isinstance(b, _World)]))
    return np.stack(traj)


def _run_jax(build, steps, dt=DT, vel0=None, omega0=None):
    arch, state = build.finalize()
    if vel0 is not None:
        state = state.replace(vel=state.vel.at[0].set(np.asarray(vel0, np.float32)))
    if omega0 is not None:
        state = state.replace(
            omega=state.omega.at[0].set(np.asarray(omega0, np.float32)))
    settings = PhysicsSettings()
    step = jax.jit(
        lambda s: physics_step(arch, s, settings, dt, num_substeps=1)[0])
    traj = []
    for _ in range(steps):
        state = step(state)
        traj.append(np.asarray(state.pos).ravel())
    return np.stack(traj)


def _assert_close(traj_jax, traj_ref, tol=1e-3):
    err = np.abs(traj_jax - traj_ref).max()
    assert err < tol, f"max trajectory divergence {err}"


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_distance_joint_matches_reference():
    b = SceneBuilder()
    body = b.add_body(position=(1.0, 0.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    b.add_distance_joint(-1, body, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0))
    traj_jax = _run_jax(b, 240)

    w, d = _World(), _Body((1.0, 0.0, 0.0))
    joints = [_Distance(w, d, np.zeros(3), np.zeros(3), 1.0)]
    _assert_close(traj_jax, _simulate([w, d], joints, 240))


def test_fixed_joint_matches_reference():
    b = SceneBuilder()
    body = b.add_body(position=(0.5, 0.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    b.add_fixed_joint(-1, body, (0.0, 0.0, 0.0))
    traj_jax = _run_jax(b, 240, vel0=(0.0, 2.0, 0.0), omega0=(0.0, 0.0, 3.0))

    w, d = _World(), _Body((0.5, 0.0, 0.0))
    d.vel = np.array([0.0, 2.0, 0.0])
    d.omega = np.array([0.0, 0.0, 3.0])
    joints = [_Fixed(w, d, np.zeros(3), np.array([-0.5, 0.0, 0.0]),
                     np.array([0.0, 0.0, 0.0, 1.0]))]
    _assert_close(traj_jax, _simulate([w, d], joints, 240))


def test_hinge_limit_motor_matches_reference():
    b = SceneBuilder()
    body = b.add_body(position=(1.0, 0.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    b.add_hinge_joint(-1, body, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                      min_limit=-0.6, max_limit=0.5,
                      motor_type=1.0, motor_target=0.25, max_torque=2.0)
    traj_jax = _run_jax(b, 240)

    w, d = _World(), _Body((1.0, 0.0, 0.0))
    axis = np.array([0.0, 0.0, 1.0])
    tan, bitan = _onb(axis)
    joints = [_Hinge(w, d, np.zeros(3), np.array([-1.0, 0.0, 0.0]),
                     axis, axis, tan, bitan, tan,
                     min_limit=-0.6, max_limit=0.5,
                     motor_type=1.0, motor_target=0.25, max_torque=2.0)]
    _assert_close(traj_jax, _simulate([w, d], joints, 240))


def test_hinge_velocity_motor_matches_reference():
    b = SceneBuilder()
    body = b.add_body(position=(1.0, 0.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    b.add_hinge_joint(-1, body, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                      min_limit=-0.4, max_limit=0.9,
                      motor_type=0.0, motor_target=2.0, max_torque=1.0)
    traj_jax = _run_jax(b, 240)

    w, d = _World(), _Body((1.0, 0.0, 0.0))
    axis = np.array([0.0, 0.0, 1.0])
    tan, bitan = _onb(axis)
    joints = [_Hinge(w, d, np.zeros(3), np.array([-1.0, 0.0, 0.0]),
                     axis, axis, tan, bitan, tan,
                     min_limit=-0.4, max_limit=0.9,
                     motor_type=0.0, motor_target=2.0, max_torque=1.0)]
    _assert_close(traj_jax, _simulate([w, d], joints, 240))


def test_cone_twist_limits_motors_matches_reference():
    b = SceneBuilder()
    body = b.add_body(position=(0.0, -1.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    b.add_cone_twist_joint(-1, body, (0.0, 0.0, 0.0), (0.0, -1.0, 0.0),
                           swing_limit=0.4, twist_limit=0.3,
                           swing_motor_type=0.0, swing_target=0.5,
                           max_swing_torque=0.2,
                           twist_motor_type=0.0, twist_target=1.0,
                           max_twist_torque=0.2)
    traj_jax = _run_jax(b, 240, omega0=(1.0, 2.0, 0.0))

    w, d = _World(), _Body((0.0, -1.0, 0.0))
    d.omega = np.array([1.0, 2.0, 0.0])
    axis = np.array([0.0, -1.0, 0.0])
    tan, bitan = _onb(axis)
    joints = [_ConeTwist(w, d, np.zeros(3), np.array([0.0, 1.0, 0.0]),
                         axis, axis, tan, bitan, tan,
                         swing_limit=0.4, twist_limit=0.3,
                         swing_motor_type=0.0, swing_target=0.5,
                         max_swing_torque=0.2,
                         twist_motor_type=0.0, twist_target=1.0,
                         max_twist_torque=0.2)]
    _assert_close(traj_jax, _simulate([w, d], joints, 240))


def test_slider_limit_motor_matches_reference():
    b = SceneBuilder()
    body = b.add_body(position=(0.0, 0.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    b.add_slider_joint(-1, body, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                       neg_limit=-0.3, pos_limit=0.5,
                       motor_type=0.0, motor_target=0.8, max_force=50.0)
    traj_jax = _run_jax(b, 240)

    w, d = _World(), _Body((0.0, 0.0, 0.0))
    axis = np.array([1.0, 0.0, 0.0])
    joints = [_Slider(w, d, np.zeros(3), np.zeros(3), axis,
                      np.array([0.0, 0.0, 0.0, 1.0]),
                      neg_limit=-0.3, pos_limit=0.5,
                      motor_type=0.0, motor_target=0.8, max_force=50.0)]
    _assert_close(traj_jax, _simulate([w, d], joints, 240))


@pytest.mark.slow
def test_three_body_chain_matches_reference():
    """world -ball- b1 -hinge- b2 -cone_twist- b3 under gravity.

    Solve order across tables follows the reference type order (ball,
    hinge, cone_twist); damping keeps the chain out of the chaotic regime
    so f32-vs-f64 drift stays within tolerance."""
    b = SceneBuilder()
    b1 = b.add_body(position=(1.0, 0.0, 0.0), linear_damping=0.5,
                    angular_damping=0.5)
    b.add_sphere_collider(b1, radius=0.1)
    b2 = b.add_body(position=(2.0, 0.0, 0.0), linear_damping=0.5,
                    angular_damping=0.5)
    b.add_sphere_collider(b2, radius=0.1)
    b3 = b.add_body(position=(3.0, 0.0, 0.0), linear_damping=0.5,
                    angular_damping=0.5)
    b.add_sphere_collider(b3, radius=0.1)
    b.add_ball_joint(-1, b1, (0.0, 0.0, 0.0))
    b.add_hinge_joint(b1, b2, (1.5, 0.0, 0.0), (0.0, 0.0, 1.0))
    b.add_cone_twist_joint(b2, b3, (2.5, 0.0, 0.0), (1.0, 0.0, 0.0),
                           swing_limit=0.7, twist_limit=0.4)
    traj_jax = _run_jax(b, 180)

    d1 = _Body((1.0, 0.0, 0.0), damping=0.5)
    d2 = _Body((2.0, 0.0, 0.0), damping=0.5)
    d3 = _Body((3.0, 0.0, 0.0), damping=0.5)
    w = _World()
    axis_h = np.array([0.0, 0.0, 1.0])
    tan_h, bitan_h = _onb(axis_h)
    axis_c = np.array([1.0, 0.0, 0.0])
    tan_c, bitan_c = _onb(axis_c)
    joints = [
        _Ball(w, d1, np.zeros(3), np.array([-1.0, 0.0, 0.0])),
        _Hinge(d1, d2, np.array([0.5, 0.0, 0.0]), np.array([-0.5, 0.0, 0.0]),
               axis_h, axis_h, tan_h, bitan_h, tan_h),
        _ConeTwist(d2, d3, np.array([0.5, 0.0, 0.0]),
                   np.array([-0.5, 0.0, 0.0]),
                   axis_c, axis_c, tan_c, bitan_c, tan_c,
                   swing_limit=0.7, twist_limit=0.4),
    ]
    _assert_close(traj_jax, _simulate([w, d1, d2, d3], joints, 180))
