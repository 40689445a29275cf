"""Runtime device-side broadphase: batched sweep-and-prune (default) or
dense AABB overlap, + typed compaction.

Replaces the reference's sort-and-prune sweep (reference:
src/physics/collision_broad.cpp:297-447, variance-axis pick at :444) for
scenes too large for the compile-time all-pairs bucket enumeration
(physics/builder.py).  Two algorithms:

* "sweep" (default, candidate_pairs_swept): sort colliders by AABB min along
  the max-variance axis, then test each against the next W in sorted order —
  the reference SAP in fixed-shape batched form.  All window accesses are
  SHIFTED SLICES of permuted arrays (per-candidate gathers with sort-derived
  indices are avoided), so the cost is O(C log C + C*W) of elementwise
  work.  W ("sap_neighbors") must cover the widest same-axis
  slab; the overflow counter reports when it does not.
* "dense" (candidate_pairs): (C, C) boolean AABB mask + per-row top-K —
  O(C^2) but exact for any neighbor distribution; best for C <= ~2k.

Candidates are compacted per shape-type combo (two-stage top_k) so each
narrowphase kernel (collide.pair_narrow_dispatch) runs only on rows of its
own combo, then the contact table is compacted to ACTIVE manifolds
(compact_active) before solver prep.  Runtime pair sets cannot be statically
colored, so contacts solve in mass-splitting Jacobi mode (with one-hot
matmul scatter — solver.solve_contacts_split_jacobi_matmul) or in
"runtime_gs" mode via on-device greedy coloring (solver.runtime_color).
Overflow at every fixed-shape stage is detected and reported, matching
SURVEY §7's "bucketed padding + overflow stat" hard-part recipe.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import maths as m
from .types import (
    SHAPE_BOX,
    SHAPE_CAPSULE,
    SHAPE_CYLINDER,
    SHAPE_HULL,
    SHAPE_SPHERE,
    BodyState,
    SceneArchetype,
)
from .narrow import ContactTable


def world_aabbs(arch: SceneArchetype, wpos, wrot):
    """Per-collider world AABB (..., C, 3) min/max.

    Exact for spheres and boxes (the hot cases); conservative bound-radius
    AABBs for capsule/cylinder/hull (reference computes exact per-type AABBs,
    src/physics/bounding_volumes.cpp — the bound-radius fallback only admits
    extra candidates, never misses one)."""
    t = arch.col_type
    size = arch.col_size

    rotm = m.quat_to_mat3(wrot)                       # (..., C, 3, 3)
    box_ext = jnp.einsum("...ij,...j->...i", jnp.abs(rotm), size)
    sphere_ext = jnp.broadcast_to(size[..., :1], wpos.shape)
    bound_ext = jnp.broadcast_to(
        arch.col_bound_radius[..., :, None], wpos.shape)

    is_sphere = (t == SHAPE_SPHERE)[..., :, None]
    is_box = (t == SHAPE_BOX)[..., :, None]
    ext = jnp.where(is_sphere, sphere_ext, jnp.where(is_box, box_ext, bound_ext))
    return wpos - ext, wpos + ext


def candidate_pairs_swept(arch: SceneArchetype, amin, amax):
    """(C, W) sweep-and-prune candidates: sort colliders by AABB min along
    the max-variance axis, test each against the next W in sorted order.

    This is the reference SAP in batched fixed-shape form
    (src/physics/collision_broad.cpp:297-447; variance-axis pick at :444):
    the sort is one C-element argsort, each collider prunes with the sweep
    condition (next.min <= this.max on the sort axis) before the full AABB
    test.  O(C log C + C*W) vs the dense path's O(C^2).

    Returns (i_idx, j_idx, valid, overflow) with i_idx/j_idx/valid (C, W);
    overflow counts rows whose sweep window ended while the sweep condition
    still held (a candidate beyond W sorted neighbors was dropped).
    Unbatched (C, 3) inputs only — batch via vmap."""
    c = amin.shape[0]
    w = min(arch.sap_neighbors, max(c - 1, 1))
    centers = 0.5 * (amin + amax)
    axis = jnp.argmax(jnp.var(centers, axis=0))
    amin_ax = jnp.take(amin, axis, axis=-1)
    amax_ax = jnp.take(amax, axis, axis=-1)
    order = jnp.argsort(amin_ax).astype(jnp.int32)

    # Permute everything into sorted order ONCE (C-row gathers), then every
    # window access is a SHIFTED SLICE of the sorted arrays instead of a
    # per-candidate gather with sort-derived indices; W static shifts are
    # plain elementwise work.
    amin_s = amin[order]
    amax_s = amax[order]
    amin_ax_s = amin_ax[order]
    bodies = arch.col_body[order]
    kin_s = arch.sap_body_kinematic[bodies]
    grp_s = arch.sap_body_group[bodies]

    def shifted(x, o):
        """x[i + o] with edge clamp, as a slice + pad (no gather)."""
        pad = jnp.broadcast_to(x[-1:], (o,) + x.shape[1:])
        return jnp.concatenate([x[o:], pad], axis=0)

    offs = list(range(1, w + 1))
    amin_j = jnp.stack([shifted(amin_s, o) for o in offs], axis=1)  # (C,W,3)
    amax_j = jnp.stack([shifted(amax_s, o) for o in offs], axis=1)
    amin_ax_j = jnp.stack([shifted(amin_ax_s, o) for o in offs], axis=1)
    bodies_j = jnp.stack([shifted(bodies, o) for o in offs], axis=1)
    kin_j = jnp.stack([shifted(kin_s, o) for o in offs], axis=1)
    grp_j = jnp.stack([shifted(grp_s, o) for o in offs], axis=1)
    oj = jnp.stack([shifted(order, o) for o in offs], axis=1)       # (C,W)

    i_pos = jnp.arange(c, dtype=jnp.int32)
    in_range = (i_pos[:, None] + jnp.arange(1, w + 1,
                                            dtype=jnp.int32)[None, :]) < c
    sweep_ok = amin_ax_j <= amax_ax[order][:, None]
    overlap = jnp.all((jnp.maximum(amin_s[:, None, :], amin_j)
                       <= jnp.minimum(amax_s[:, None, :], amax_j)), axis=-1)
    # Admissibility from per-body attributes (builder._collides decomposed).
    bi = bodies[:, None]
    collidable = (bi != bodies_j) & ~(kin_s[:, None] & kin_j)
    collidable &= ~((grp_s[:, None] >= 0) & (grp_s[:, None] == grp_j))
    excl = arch.sap_joint_excl
    if excl.shape[0] > 0:
        lo_b = jnp.minimum(bi, bodies_j)[..., None]
        hi_b = jnp.maximum(bi, bodies_j)[..., None]
        collidable &= ~jnp.any((lo_b == excl[None, None, :, 0])
                               & (hi_b == excl[None, None, :, 1]), axis=-1)
    valid = in_range & sweep_ok & overlap & collidable

    spill = ((i_pos + w + 1 < c)
             & (shifted(amin_ax_s, min(w + 1, c - 1) if c > 1 else 0)
                <= amax_ax[order]))
    overflow = jnp.sum(spill)
    i_idx = jnp.broadcast_to(order[:, None], (c, w))

    # Per-row compaction: keep at most sap_row_cap valid neighbors per
    # collider (vectorized tiny top_ks) so the downstream global sorts work
    # on C*cap rows instead of C*W.  The wide window W buys sweep
    # EXACTNESS; the row cap bounds per-collider contact count (like the
    # dense path's K) with its own overflow accounting.
    cap = getattr(arch, "sap_row_cap", 0) or 0
    if 0 < cap < w:
        rscore = jnp.where(valid,
                           w - jnp.arange(w, dtype=jnp.int32)[None, :], 0)
        vals, selw = jax.lax.top_k(rscore, cap)          # (C, cap)
        overflow = overflow + jnp.sum(
            jnp.sum(valid, axis=-1) > cap)
        i_idx = jnp.take_along_axis(i_idx, selw, axis=-1)
        oj = jnp.take_along_axis(oj, selw, axis=-1)
        valid = vals > 0
    return i_idx, oj, valid, overflow


def candidate_pairs(arch: SceneArchetype, amin, amax):
    """(C, K) candidate collider-pair table from dense AABB overlap.

    Returns (j_idx, valid, overflow): row i's candidates are colliders
    j_idx[i, :] with valid mask; overflow is the per-scene count of rows whose
    true overlap count exceeded K (dropped pairs)."""
    K = arch.sap_neighbors
    C = amin.shape[-2]
    # (C, C) interval overlap on all three axes.
    lo = jnp.maximum(amin[..., :, None, :], amin[..., None, :, :])
    hi = jnp.minimum(amax[..., :, None, :], amax[..., None, :, :])
    overlap = jnp.all(lo <= hi, axis=-1)
    mask = overlap & arch.sap_collidable            # upper-triangular & groups
    counts = jnp.sum(mask, axis=-1)                  # (C,)
    # Prefer small j deterministically: score C-j for overlapping pairs.
    j_rank = jnp.arange(C, dtype=jnp.int32)
    score = jnp.where(mask, C - j_rank, 0).astype(jnp.int32)
    vals, j_idx = jax.lax.top_k(score, K)            # (C, K)
    valid = vals > 0
    overflow = jnp.sum(counts > K)
    return j_idx, valid, overflow


def sap_manifolds(arch: SceneArchetype, wpos, wrot) -> ContactTable:
    """ContactTable over the runtime candidate pairs (flattened (C*K,) rows)."""
    from . import collide  # local import to avoid a module cycle

    amin, amax = world_aabbs(arch, wpos, wrot)
    if arch.sap_mode == "sweep":
        i_idx, j_idx, valid, _ = candidate_pairs_swept(arch, amin, amax)
    else:
        j_idx, valid, _ = candidate_pairs(arch, amin, amax)
        i_idx = jnp.broadcast_to(
            jnp.arange(j_idx.shape[-2], dtype=jnp.int32)[..., :, None],
            j_idx.shape)

    C, K = j_idx.shape[-2], j_idx.shape[-1]
    ia = i_idx.reshape(i_idx.shape[:-2] + (C * K,))
    ib = j_idx.reshape(j_idx.shape[:-2] + (C * K,))
    valid = valid.reshape(valid.shape[:-2] + (C * K,))

    # Canonical shape-type order (sphere < capsule < ... as in type codes) so
    # each narrow kernel sees its (type_a <= type_b) convention.
    ta = arch.col_type[ia]
    tb = arch.col_type[ib]
    swap = ta > tb
    ia, ib = jnp.where(swap, ib, ia), jnp.where(swap, ia, ib)
    ta, tb = jnp.where(swap, tb, ta), jnp.where(swap, ta, tb)

    # Compact the sparse (C*K) candidate list PER TYPE COMBO, each into its
    # own fixed-budget table, so every narrow kernel only runs on rows of
    # its own combo (the runtime analogue of the builder's type-segmented
    # buckets).  Running every kernel masked over all candidates cost
    # n_combos x budget kernel-rows for <= budget real pairs.
    #
    # Two stages: one top_k over the full C*K window table (dominated by
    # its size at large sweep windows), then cheap per-combo top_ks over
    # the compacted mid table.
    P0 = C * K
    n_combos = max(len(arch.sap_type_pairs), 1)
    budget_all = min(arch.sap_max_contacts, P0)
    combo_budget = max(budget_all // n_combos, 1)
    if P0 > 2 * budget_all:
        rank0 = P0 - jnp.arange(P0, dtype=jnp.int32)
        _, sel0 = jax.lax.top_k(jnp.where(valid, rank0, 0), budget_all)
        ia = jnp.take_along_axis(ia, sel0, axis=-1)
        ib = jnp.take_along_axis(ib, sel0, axis=-1)
        valid = jnp.take_along_axis(valid, sel0, axis=-1)
        ta = jnp.take_along_axis(ta, sel0, axis=-1)
        tb = jnp.take_along_axis(tb, sel0, axis=-1)
        P0 = budget_all
    rank = P0 - jnp.arange(P0, dtype=jnp.int32)

    from . import narrow
    parts = []
    for (tta, ttb) in arch.sap_type_pairs:
        combo = valid & (ta == tta) & (tb == ttb)
        vals, sel = jax.lax.top_k(jnp.where(combo, rank, 0), combo_budget)
        ia_c = jnp.take_along_axis(ia, sel, axis=-1)
        ib_c = jnp.take_along_axis(ib, sel, axis=-1)
        valid_c = vals > 0
        pa = jnp.take_along_axis(wpos, ia_c[..., :, None], axis=-2)
        ra = jnp.take_along_axis(wrot, ia_c[..., :, None], axis=-2)
        pb = jnp.take_along_axis(wpos, ib_c[..., :, None], axis=-2)
        rb = jnp.take_along_axis(wrot, ib_c[..., :, None], axis=-2)
        n_c, p_c, d_c, m_c = collide.pair_narrow_dispatch(
            arch, ia_c, ib_c, tta, ttb, pa, ra, pb, rb)
        m_c = m_c & valid_c[..., :, None]
        friction, restitution = narrow.combine_materials(
            arch.col_friction[ia_c], arch.col_friction[ib_c],
            arch.col_restitution[ia_c], arch.col_restitution[ib_c],
        )
        parts.append(ContactTable(
            body_a=arch.col_body[ia_c],
            body_b=arch.col_body[ib_c],
            normal=n_c,
            point=p_c,
            depth=d_c,
            pmask=m_c,
            friction=jnp.broadcast_to(friction, d_c.shape[:-1]),
            restitution=jnp.broadcast_to(restitution, d_c.shape[:-1]),
            active=jnp.any(m_c, axis=-1),
        ))
    if len(parts) == 1:
        return parts[0]
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *parts)


def compact_active(contacts: ContactTable, budget: int) -> ContactTable:
    """Keep `budget` rows of a ContactTable, active rows first (stable).

    Prep tables and the N-iteration contact solve are linear in row count;
    after narrowphase most candidate rows missed, so the solver only needs
    the manifolds that actually hit (the runtime analogue of the reference
    packing only real contacts into solver batches, constraints.cpp:3711).
    Rows beyond `budget` active ones are dropped — size the budget from the
    scene (builder default: 4 contacts per collider)."""
    p0 = contacts.active.shape[-1]
    if budget >= p0:
        return contacts
    score = jnp.where(contacts.active,
                      p0 - jnp.arange(p0, dtype=jnp.int32), 0)
    _, sel = jax.lax.top_k(score, budget)
    return jax.tree_util.tree_map(lambda x: jnp.take(x, sel, axis=0),
                                  contacts)


def overflow_count(arch: SceneArchetype, state: BodyState):
    """Diagnostic: number of colliders whose overlap set exceeded K this step."""
    from . import collide
    wpos, wrot = collide.collider_world_poses(arch, state)
    amin, amax = world_aabbs(arch, wpos, wrot)
    if arch.sap_mode == "sweep":
        _, _, _, overflow = candidate_pairs_swept(arch, amin, amax)
    else:
        _, _, overflow = candidate_pairs(arch, amin, amax)
    return overflow
