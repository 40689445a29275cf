"""Runtime dense-AABB broadphase (physics/broadphase.py).

Device-kernel-vs-host-reference pattern (reference self-test model:
src/rendering/bitonic_sort.cpp:215-281): candidate pairs are checked against a
brute-force NumPy enumeration, and SAP-mode dynamics against the compile-time
bucket path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.physics import broadphase, collide
from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings


def _random_pile(num_bodies, seed=0, broadphase_mode="sap", neighbors=16):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.5, restitution=0.0)
    side = int(np.ceil(num_bodies ** (1 / 3)))
    count = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if count >= num_bodies:
                    break
                pos = ((ix - side / 2) * 1.2 + rng.uniform(-0.05, 0.05),
                       0.8 + iy * 1.2,
                       (iz - side / 2) * 1.2 + rng.uniform(-0.05, 0.05))
                body = b.add_body(position=pos, mass=1.0)
                if count % 2 == 0:
                    b.add_box_collider(body, (0.4, 0.4, 0.4), friction=0.5)
                else:
                    b.add_sphere_collider(body, 0.4, friction=0.5)
                count += 1
    if broadphase_mode == "sap":
        return b.finalize(broadphase="sap", sap_neighbors=neighbors,
                          sap_row_cap=max(neighbors, 16))
    return b.finalize()


def test_candidate_pairs_match_bruteforce():
    arch, state = _random_pile(27, seed=3)
    # Scatter bodies into a noisy cloud so overlaps are nontrivial.
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.uniform(-2.0, 2.0, state.pos.shape).astype(np.float32))
    state = state.replace(pos=pos)

    wpos, wrot = collide.collider_world_poses(arch, state)
    amin, amax = broadphase.world_aabbs(arch, wpos, wrot)
    j_idx, valid, overflow = broadphase.candidate_pairs(arch, amin, amax)

    got = set()
    C = amin.shape[0]
    for i in range(C):
        for k in range(j_idx.shape[1]):
            if bool(valid[i, k]):
                got.add((i, int(j_idx[i, k])))

    amin_np, amax_np = np.asarray(amin), np.asarray(amax)
    coll = np.asarray(arch.sap_collidable)
    expect = set()
    for i in range(C):
        for j in range(i + 1, C):
            if not coll[i, j]:
                continue
            if np.all(amin_np[i] <= amax_np[j]) and np.all(amin_np[j] <= amax_np[i]):
                expect.add((i, j))

    assert int(overflow) == 0
    assert got == expect


def test_overflow_detected_when_neighbors_exceed_k():
    arch, state = _random_pile(27, seed=3, neighbors=2)
    # All bodies at the same spot: every pair overlaps -> rows overflow K=2.
    state = state.replace(pos=jnp.zeros_like(state.pos))
    assert int(broadphase.overflow_count(arch, state)) > 0


@pytest.mark.slow
def test_sap_pile_settles_like_static_buckets():
    settings = PhysicsSettings(frame_rate=60, solver_iterations=20,
                               contact_mode="split_jacobi")
    heights = {}
    for mode in ("sap", "static"):
        arch, state = _random_pile(27, seed=5, broadphase_mode=mode)
        step = jax.jit(lambda s, arch=arch: physics_step(
            arch, s, settings, 1.0 / 60.0)[0])
        for _ in range(150):
            state = step(state)
        ys = np.asarray(state.pos[:, 1])
        assert ys.min() > -0.1, f"{mode}: sank through floor"
        assert np.abs(np.asarray(state.pos)).max() < 50.0, f"{mode}: explosion"
        heights[mode] = np.sort(ys)

    # Same pile, same solver: settled height distributions agree loosely
    # (row order differs, so trajectories diverge at float level).
    assert np.abs(heights["sap"].mean() - heights["static"].mean()) < 0.15


def test_sap_requires_split_jacobi():
    arch, state = _random_pile(8)
    with pytest.raises(ValueError):
        physics_step(arch, state, PhysicsSettings(contact_mode="colored"),
                     1.0 / 60.0)


def test_swept_candidates_match_bruteforce():
    """Sweep-and-prune candidates = brute-force AABB pairs when the window
    covers every same-axis overlap (reference: collision_broad.cpp:297-447)."""
    arch, state = _random_pile(27, seed=3, neighbors=26)
    rng = np.random.default_rng(2)
    pos = jnp.asarray(rng.uniform(-2.0, 2.0, state.pos.shape).astype(np.float32))
    state = state.replace(pos=pos)

    wpos, wrot = collide.collider_world_poses(arch, state)
    amin, amax = broadphase.world_aabbs(arch, wpos, wrot)
    i_idx, j_idx, valid, overflow = broadphase.candidate_pairs_swept(
        arch, amin, amax)

    got = set()
    for i in range(i_idx.shape[0]):
        for k in range(i_idx.shape[1]):
            if bool(valid[i, k]):
                a, b = int(i_idx[i, k]), int(j_idx[i, k])
                got.add((min(a, b), max(a, b)))

    amin_np, amax_np = np.asarray(amin), np.asarray(amax)
    coll = np.asarray(arch.sap_collidable)
    expect = set()
    c = amin_np.shape[0]
    for i in range(c):
        for j in range(i + 1, c):
            if not coll[i, j]:
                continue
            if np.all(amin_np[i] <= amax_np[j]) and np.all(amin_np[j] <= amax_np[i]):
                expect.add((i, j))

    assert int(overflow) == 0
    assert got == expect


def test_swept_overflow_on_narrow_window():
    arch, state = _random_pile(27, seed=3, neighbors=2)
    state = state.replace(pos=jnp.zeros_like(state.pos))
    assert int(broadphase.overflow_count(arch, state)) > 0


def test_compact_active_keeps_all_active_rows():
    arch, state = _random_pile(27, seed=5)
    # Drop for a few frames so some manifolds are active.
    settings = PhysicsSettings(frame_rate=60, solver_iterations=8,
                               contact_mode="split_jacobi")
    step = jax.jit(lambda s: physics_step(arch, s, settings, 1 / 60.0)[0])
    for _ in range(40):
        state = step(state)
    ct = collide.generate_contacts(arch, state)
    n_active = int(np.asarray(ct.active).sum())
    assert n_active > 0
    compacted = broadphase.compact_active(ct, n_active + 4)
    assert int(np.asarray(compacted.active).sum()) == n_active
    # Active rows carry identical data after compaction.
    act_rows = {(int(a), int(b), float(d))
                for a, b, d, m in zip(np.asarray(ct.body_a),
                                      np.asarray(ct.body_b),
                                      np.asarray(ct.depth[:, 0]),
                                      np.asarray(ct.active)) if m}
    got_rows = {(int(a), int(b), float(d))
                for a, b, d, m in zip(np.asarray(compacted.body_a),
                                      np.asarray(compacted.body_b),
                                      np.asarray(compacted.depth[:, 0]),
                                      np.asarray(compacted.active)) if m}
    assert act_rows == got_rows


def test_jacobi_matmul_matches_scatter_path():
    """The one-hot matmul gather/scatter Jacobi must match the .at[] scatter
    path to float rounding over a real settling trajectory."""
    arch, state0 = _random_pile(27, seed=7)
    results = {}
    for threshold in (1, 10**9):   # always-matmul vs never-matmul
        settings = PhysicsSettings(frame_rate=60, solver_iterations=10,
                                   contact_mode="split_jacobi",
                                   jacobi_matmul_threshold=threshold)
        step = jax.jit(lambda s, se=settings: physics_step(
            arch, s, se, 1 / 60.0)[0])
        state = state0
        for _ in range(60):
            state = step(state)
        results[threshold] = np.asarray(state.pos)
    np.testing.assert_allclose(results[1], results[10**9], atol=5e-4)


@pytest.mark.slow
def test_runtime_gs_bounds_jacobi_divergence():
    """runtime_gs (true Gauss-Seidel via on-device coloring) vs split_jacobi —
    the VERDICT-required Jacobi divergence yardstick, documented in
    BASELINE.md.

    (a) A deterministic 5-box tower: rest heights must agree tightly (the
    stack has one fixed point).  (b) The chaotic pile: per-body positions
    legitimately diverge (toppling is ordering-sensitive), so the settled
    height DISTRIBUTION is compared instead."""
    # (a) tower
    def build_tower():
        b = SceneBuilder()
        b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.6)
        for i in range(5):
            body = b.add_body(position=(0.0, 0.55 + 1.02 * i, 0.0), mass=1.0)
            b.add_box_collider(body, (0.5, 0.5, 0.5), friction=0.6)
        return b.finalize(broadphase="sap", sap_neighbors=8)

    tower_rest = {}
    for mode in ("runtime_gs", "split_jacobi"):
        arch, state = build_tower()
        settings = PhysicsSettings(frame_rate=60, solver_iterations=20,
                                   contact_mode=mode)
        step = jax.jit(lambda s, a=arch, se=settings: physics_step(
            a, s, se, 1 / 60.0)[0])
        for _ in range(180):
            state = step(state)
        tower_rest[mode] = np.sort(np.asarray(state.pos[:, 1]))
        expect = 0.5 + 1.0 * np.arange(5)
        # GS resolves penetration fully; mass-split Jacobi under-corrects
        # ~2 cm per interface at 20 iterations (measured: max 0.095 over a
        # 5-box tower) — the divergence documented in BASELINE.md.
        atol = 0.02 if mode == "runtime_gs" else 0.12
        np.testing.assert_allclose(tower_rest[mode], expect, atol=atol,
                                   err_msg=f"{mode} tower rest heights")
    diff = np.abs(tower_rest["runtime_gs"] - tower_rest["split_jacobi"])
    assert diff.max() < 0.12, f"tower rest divergence {diff.max():.4f}"

    # (b) pile distribution
    arch, state0 = _random_pile(27, seed=9)
    heights = {}
    for mode in ("runtime_gs", "split_jacobi"):
        settings = PhysicsSettings(frame_rate=60, solver_iterations=20,
                                   contact_mode=mode)
        step = jax.jit(lambda s, se=settings: physics_step(
            arch, s, se, 1 / 60.0)[0])
        state = state0
        for _ in range(240):
            state = step(state)
        ys = np.asarray(state.pos[:, 1])
        assert ys.min() > -0.1, f"{mode}: sank through floor"
        assert np.abs(np.asarray(state.pos)).max() < 50.0, f"{mode}: explosion"
        heights[mode] = np.sort(ys)
    assert np.abs(heights["runtime_gs"].mean()
                  - heights["split_jacobi"].mean()) < 0.1


def test_runtime_color_is_conflict_free():
    from d3d12renderer_jax.physics import solver

    rng = np.random.default_rng(0)
    p, nb = 200, 40
    ia = jnp.asarray(rng.integers(0, nb, p), jnp.int32)
    ib_raw = rng.integers(0, nb - 1, p)
    # Contact rows never pair a body with itself.
    ib = jnp.asarray(np.where(ib_raw >= np.asarray(ia), ib_raw + 1, ib_raw),
                     jnp.int32)
    active = jnp.asarray(rng.random(p) < 0.7)
    dyn = jnp.ones((p,), bool)
    color, leftover = solver.runtime_color(ia, ib, active, dyn, dyn,
                                           nb + 1, 32)
    color, leftover = np.asarray(color), int(leftover)
    assert leftover == 0
    for c in range(31):
        rows = np.where((color == c) & np.asarray(active))[0]
        bodies = np.concatenate([np.asarray(ia)[rows], np.asarray(ib)[rows]])
        assert len(bodies) == len(set(bodies.tolist())), f"conflict in color {c}"
