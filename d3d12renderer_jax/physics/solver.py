"""Sequential-impulse contact solver, batched.

Math mirrors the reference's collision velocity constraints exactly
(reference: src/physics/constraints.cpp:3307-3448): per contact point, one friction
impulse along a fixed tangent (aligned with the pre-solve relative velocity) is
solved first, then the normal impulse with accumulated clamping and a bias
  bias = -restitution * vRel_n + 0.1 * (penetration - slop) / dt   (slop = 1mm)
applied only when penetration > slop and the contact is approaching.

Parallelization replaces the reference's 8-wide AVX2 batches that avoid same-body
conflicts (reference: src/physics/constraints.cpp:3456 scheduleConstraintsSIMD):

* "colored" mode: candidate pairs are graph-colored at scene-compile time; rows of
  one color share no dynamic body, so a color solves as one vectorized
  gather/compute/scatter.  Colors run sequentially -> true Gauss-Seidel ordering,
  deterministic and exactly mirrored by the NumPy reference implementation.
* "split_jacobi" mode (dense scenes): all pairs solve in parallel against
  degree-scaled ("mass split") bodies, deltas merged with segment-sum.  Stable for
  thousands of simultaneous contacts where static coloring is impossible.

All functions are written for a single scene; `jax.vmap` over the leading axis
provides the scene batch (the batched analogue of SubprocVecEnv + AVX lanes).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import maths as m
from .narrow import ContactTable

# Reference constants (src/physics/constraints.cpp:3360-3364).
CONTACT_SLOP = 0.001
BAUMGARTE_SCALE = 0.1
DT_THRESHOLD = 1e-5


@struct.dataclass
class ContactPrep:
    """Precomputed per-(pair,point) constraint data, fixed during iterations."""

    r_a: jnp.ndarray        # (P,4,3) anchor rel. to body A COG
    r_b: jnp.ndarray        # (P,4,3)
    normal: jnp.ndarray     # (P,3)
    tangent: jnp.ndarray    # (P,4,3)
    bias: jnp.ndarray       # (P,4)
    eff_mass_n: jnp.ndarray # (P,4)
    eff_mass_t: jnp.ndarray # (P,4)
    # impulse -> delta angular velocity maps (invInertia * (r x dir))
    n_to_wa: jnp.ndarray    # (P,4,3)
    n_to_wb: jnp.ndarray    # (P,4,3)
    t_to_wa: jnp.ndarray    # (P,4,3)
    t_to_wb: jnp.ndarray    # (P,4,3)
    inv_mass_a: jnp.ndarray # (P,)   (possibly degree-scaled)
    inv_mass_b: jnp.ndarray # (P,)
    friction: jnp.ndarray   # (P,)
    pmask: jnp.ndarray      # (P,4)
    body_a: jnp.ndarray     # (P,)
    body_b: jnp.ndarray     # (P,)


def contact_degrees(ct: ContactTable, num_slots: int) -> jnp.ndarray:
    """Per-body count of active contact pairs (for mass splitting)."""
    ones = ct.active.astype(jnp.float32)
    deg = jnp.zeros((num_slots,), jnp.float32)
    deg = deg.at[ct.body_a].add(ones)
    deg = deg.at[ct.body_b].add(ones)
    return jnp.maximum(deg, 1.0)


def prep_contacts_full(
    ct: ContactTable,
    body_pos: jnp.ndarray,        # (N+1,3)
    inv_mass: jnp.ndarray,        # (N+1,)
    inv_inertia_w: jnp.ndarray,   # (N+1,3,3)
    vel: jnp.ndarray,
    omega: jnp.ndarray,
    dt,
    inv_mass_eff: jnp.ndarray = None,
    inv_inertia_eff: jnp.ndarray = None,
) -> ContactPrep:
    """`inv_mass`/`inv_inertia_w` are used to APPLY impulses; the optional
    `*_eff` variants are used to compute effective masses.  For mass-splitting
    Jacobi the eff masses use the split (deg-times lighter) bodies so each
    row's impulse under-corrects by 1/deg and the Jacobi sum is contractive
    (Tonge-style mass splitting); applying at true masses keeps momentum
    exact.  Gauss-Seidel (colored) mode passes identical arrays."""
    ia, ib = ct.body_a, ct.body_b
    if inv_mass_eff is None:
        inv_mass_eff = inv_mass
    if inv_inertia_eff is None:
        inv_inertia_eff = inv_inertia_w
    im_a, im_b = inv_mass[ia], inv_mass[ib]
    ii_a, ii_b = inv_inertia_w[ia], inv_inertia_w[ib]
    im_ea, im_eb = inv_mass_eff[ia], inv_mass_eff[ib]
    ii_ea, ii_eb = inv_inertia_eff[ia], inv_inertia_eff[ib]

    r_a = ct.point - body_pos[ia][:, None, :]            # (P,4,3)
    r_b = ct.point - body_pos[ib][:, None, :]

    va = vel[ia][:, None, :] + jnp.cross(omega[ia][:, None, :], r_a)
    vb = vel[ib][:, None, :] + jnp.cross(omega[ib][:, None, :], r_b)
    relv = vb - va                                       # (P,4,3)
    n = ct.normal[:, None, :]                            # (P,1,3)
    vrel_n = jnp.sum(relv * n, axis=-1)                  # (P,4)
    tangent = m.noz(relv - n * vrel_n[..., None])        # (P,4,3)

    def mv34(mat, v):
        # (P,3,3) x (P,4,3) -> (P,4,3) as an elementwise broadcast-sum
        # instead of a batched matmul of 3x3 operands.
        return jnp.sum(mat[:, None, :, :] * v[:, :, None, :], axis=-1)

    def eff(direction):
        cr_a = jnp.cross(r_a, direction)
        cr_b = jnp.cross(r_b, direction)
        # Impulse-application maps use true inertia.
        ii_cr_a = mv34(ii_a, cr_a)
        ii_cr_b = mv34(ii_b, cr_b)
        # Effective mass uses the (possibly split) eff inertia/mass.
        ii_ecr_a = mv34(ii_ea, cr_a)
        ii_ecr_b = mv34(ii_eb, cr_b)
        k = (
            im_ea[:, None] + jnp.sum(cr_a * ii_ecr_a, axis=-1)
            + im_eb[:, None] + jnp.sum(cr_b * ii_ecr_b, axis=-1)
        )
        eff_mass = jnp.where(k != 0.0, 1.0 / jnp.where(k == 0.0, 1.0, k), 0.0)
        return eff_mass, ii_cr_a, ii_cr_b

    nb = jnp.broadcast_to(n, r_a.shape)
    eff_n, n_to_wa, n_to_wb = eff(nb)
    eff_t, t_to_wa, t_to_wb = eff(tangent)

    # Restitution + Baumgarte bias (reference: constraints.cpp:3355-3365).
    bias = jnp.where(
        (dt > DT_THRESHOLD)
        & (ct.depth > CONTACT_SLOP)
        & (vrel_n < 0.0),
        -ct.restitution[:, None] * vrel_n
        + BAUMGARTE_SCALE * (ct.depth - CONTACT_SLOP) / dt,
        0.0,
    )

    return ContactPrep(
        r_a=r_a, r_b=r_b, normal=ct.normal, tangent=tangent, bias=bias,
        eff_mass_n=eff_n, eff_mass_t=eff_t,
        n_to_wa=n_to_wa, n_to_wb=n_to_wb, t_to_wa=t_to_wa, t_to_wb=t_to_wb,
        inv_mass_a=im_a, inv_mass_b=im_b,
        friction=ct.friction, pmask=ct.pmask & ct.active[:, None],
        body_a=ia, body_b=ib,
    )


def _gather_prep(prep: ContactPrep, idx) -> ContactPrep:
    return jax.tree_util.tree_map(lambda x: x[idx], prep)


def _solve_rows(prep: ContactPrep, va, wa, vb, wb, imp_n, imp_t):
    """Solve the 4 manifold points of each row sequentially on local velocity
    registers.  Returns updated local velocities and accumulated impulses.
    Mirrors reference: src/physics/constraints.cpp:3381-3448."""
    for k in range(prep.pmask.shape[-1]):
        mask = prep.pmask[:, k]
        r_a, r_b = prep.r_a[:, k], prep.r_b[:, k]
        t = prep.tangent[:, k]
        n = prep.normal

        # Tangent (friction) first.
        relv = (vb + jnp.cross(wb, r_b)) - (va + jnp.cross(wa, r_a))
        vt = jnp.sum(relv * t, axis=-1)
        lam = -prep.eff_mass_t[:, k] * vt
        max_f = prep.friction * imp_n[:, k]
        new_imp = jnp.clip(imp_t[:, k] + lam, -max_f, max_f)
        lam = jnp.where(mask, new_imp - imp_t[:, k], 0.0)
        imp_t = imp_t.at[:, k].set(jnp.where(mask, new_imp, imp_t[:, k]))
        p = lam[:, None] * t
        va = va - prep.inv_mass_a[:, None] * p
        wa = wa - prep.t_to_wa[:, k] * lam[:, None]
        vb = vb + prep.inv_mass_b[:, None] * p
        wb = wb + prep.t_to_wb[:, k] * lam[:, None]

        # Normal.
        relv = (vb + jnp.cross(wb, r_b)) - (va + jnp.cross(wa, r_a))
        vn = jnp.sum(relv * n, axis=-1)
        lam = -prep.eff_mass_n[:, k] * (vn - prep.bias[:, k])
        new_imp = jnp.maximum(imp_n[:, k] + lam, 0.0)
        lam = jnp.where(mask, new_imp - imp_n[:, k], 0.0)
        imp_n = imp_n.at[:, k].set(jnp.where(mask, new_imp, imp_n[:, k]))
        p = lam[:, None] * n
        va = va - prep.inv_mass_a[:, None] * p
        wa = wa - prep.n_to_wa[:, k] * lam[:, None]
        vb = vb + prep.inv_mass_b[:, None] * p
        wb = wb + prep.n_to_wb[:, k] * lam[:, None]

    return va, wa, vb, wb, imp_n, imp_t


def solve_contacts_colored(
    prep: ContactPrep,
    color_indices: Tuple[jnp.ndarray, ...],
    vel: jnp.ndarray,
    omega: jnp.ndarray,
    imp_n: jnp.ndarray,
    imp_t: jnp.ndarray,
):
    """One Gauss-Seidel iteration over all contact rows, color by color.

    `color_indices[c]` holds the row indices of color c; rows within one color
    share no dynamic body so their gather/solve/scatter is exact."""
    for idx in color_indices:
        p = _gather_prep(prep, idx)
        ia, ib = p.body_a, p.body_b
        va, wa = vel[ia], omega[ia]
        vb, wb = vel[ib], omega[ib]
        va, wa, vb, wb, new_n, new_t = _solve_rows(
            p, va, wa, vb, wb, imp_n[idx], imp_t[idx]
        )
        vel = vel.at[ia].set(va)
        omega = omega.at[ia].set(wa)
        vel = vel.at[ib].set(vb)
        omega = omega.at[ib].set(wb)
        imp_n = imp_n.at[idx].set(new_n)
        imp_t = imp_t.at[idx].set(new_t)
    return vel, omega, imp_n, imp_t


def solve_contacts_split_jacobi(
    prep: ContactPrep,
    vel: jnp.ndarray,
    omega: jnp.ndarray,
    imp_n: jnp.ndarray,
    imp_t: jnp.ndarray,
):
    """One mass-splitting Jacobi iteration: all rows in parallel, deltas summed.

    `prep` must have been built with degree-scaled inverse mass/inertia."""
    ia, ib = prep.body_a, prep.body_b
    va0, wa0 = vel[ia], omega[ia]
    vb0, wb0 = vel[ib], omega[ib]
    va, wa, vb, wb, imp_n, imp_t = _solve_rows(
        prep, va0, wa0, vb0, wb0, imp_n, imp_t
    )
    vel = vel.at[ia].add(va - va0)
    omega = omega.at[ia].add(wa - wa0)
    vel = vel.at[ib].add(vb - vb0)
    omega = omega.at[ib].add(wb - wb0)
    return vel, omega, imp_n, imp_t


def runtime_color(ia, ib, active, dyn_a, dyn_b, num_slots: int,
                  num_colors: int):
    """Greedy parallel coloring of a RUNTIME contact graph (fixed shapes).

    The static path colors at compile time (builder.py); runtime broadphase
    pairs change every step, so colors are claimed on-device: `num_colors - 1`
    claim passes, each scattering row ids onto bodies with min-reduction —
    rows that win on both their dynamic bodies take that color and retire.
    Rows never claimed land in the last color slot, which is NOT guaranteed
    conflict-free (with enough colors it is empty in practice).

    Returns (color (P,), leftover_count) — leftover_count is the number of
    active rows in that final unguaranteed color."""
    p = ia.shape[0]
    rowid = jnp.arange(p, dtype=jnp.int32)
    color = jnp.full((p,), num_colors - 1, jnp.int32)
    unclaimed = active
    for c in range(num_colors - 1):
        slots = jnp.full((num_slots,), p, jnp.int32)
        slots = slots.at[ia].min(jnp.where(unclaimed & dyn_a, rowid, p))
        slots = slots.at[ib].min(jnp.where(unclaimed & dyn_b, rowid, p))
        won = (unclaimed
               & (~dyn_a | (slots[ia] == rowid))
               & (~dyn_b | (slots[ib] == rowid)))
        color = jnp.where(won, c, color)
        unclaimed = unclaimed & ~won
    return color, jnp.sum(unclaimed)


def solve_contacts_runtime_gs(prep: ContactPrep, color, num_colors: int,
                              vel, omega, imp_n, imp_t):
    """One Gauss-Seidel iteration over runtime-colored contacts.

    Color subsets solve sequentially; within a color no two rows share a
    dynamic body, so masked delta scatter-add is exact sequential-impulse.
    Validation/reference mode for the Jacobi fallback — each iteration runs
    num_colors masked sweeps, so it is several times slower than Jacobi."""
    ia, ib = prep.body_a, prep.body_b
    for c in range(num_colors):
        in_color = color == c
        p_c = prep.replace(pmask=prep.pmask & in_color[:, None])
        va0, wa0 = vel[ia], omega[ia]
        vb0, wb0 = vel[ib], omega[ib]
        va, wa, vb, wb, imp_n, imp_t = _solve_rows(
            p_c, va0, wa0, vb0, wb0, imp_n, imp_t
        )
        vel = vel.at[ia].add(va - va0)
        omega = omega.at[ia].add(wa - wa0)
        vel = vel.at[ib].add(vb - vb0)
        omega = omega.at[ib].add(wb - wb0)
    return vel, omega, imp_n, imp_t


def body_onehot(body_ids, num_slots: int):
    """(P, N) one-hot row->body matrix for matmul gather/scatter.

    bf16: values are exactly 0/1 (representable), so products and the
    at-most-one-term sums stay exact while HBM traffic on the matrices —
    which dominates the iteration loop — halves."""
    return (body_ids[:, None]
            == jnp.arange(num_slots, dtype=body_ids.dtype)[None, :]
            ).astype(jnp.bfloat16)


def solve_contacts_split_jacobi_matmul(
    prep: ContactPrep,
    vel: jnp.ndarray,
    omega: jnp.ndarray,
    imp_n: jnp.ndarray,
    imp_t: jnp.ndarray,
    sa: jnp.ndarray,
    sb: jnp.ndarray,
):
    """Mass-splitting Jacobi iteration with gather/scatter as matmuls.

    With one-hot row->body matrices `sa`/`sb` (body_onehot, built once per
    substep), gather = S @ [vel|omega] and scatter-add = S^T @ deltas:
    dense (P, N) matmuls in place of 4 scatter-adds per iteration.  Each
    one-hot row/column sums at most one value, so the result is exact up to
    the matmul's precision."""
    vo = jnp.concatenate([vel, omega], axis=-1)          # (N, 6)
    ga = jnp.dot(sa, vo, preferred_element_type=jnp.float32)
    gb = jnp.dot(sb, vo, preferred_element_type=jnp.float32)
    va0, wa0 = ga[:, :3], ga[:, 3:]
    vb0, wb0 = gb[:, :3], gb[:, 3:]
    va, wa, vb, wb, imp_n, imp_t = _solve_rows(
        prep, va0, wa0, vb0, wb0, imp_n, imp_t
    )
    da = jnp.concatenate([va - va0, wa - wa0], axis=-1)  # (P, 6)
    db = jnp.concatenate([vb - vb0, wb - wb0], axis=-1)
    vo = (vo + jnp.dot(sa.T, da, preferred_element_type=jnp.float32)
          + jnp.dot(sb.T, db, preferred_element_type=jnp.float32))
    return vo[:, :3], vo[:, 3:], imp_n, imp_t
