"""BVH build (host) + stackless traversal (device).

Replaces the reference's DXR acceleration structures (reference:
src/rendering/raytracing.h:41 BLAS build, src/rendering/raytracing_tlas.h:10
per-frame TLAS): rays traverse a software BVH.

Design: the tree is flattened in depth-first order with *skip links*
("miss" pointers), so traversal is a single `lax.while_loop` over a per-ray
node cursor — no stack, no recursion, fully vectorized over millions of rays.
Leaves hold up to LEAF_SIZE triangles tested branch-free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from .mesh import MeshData

LEAF_SIZE = 4


@struct.dataclass
class BVH:
    # Nodes, depth-first order. Inner node's children are node+1 (near) and
    # found via traversal order; `miss` skips the node's whole subtree.
    node_min: jnp.ndarray    # (N, 3)
    node_max: jnp.ndarray    # (N, 3)
    node_first: jnp.ndarray  # (N,) first triangle (leaves) or -1
    node_count: jnp.ndarray  # (N,) triangle count (0 for inner)
    node_miss: jnp.ndarray   # (N,) skip pointer (N = done)

    # Triangle soup, leaf-ordered and padded to a multiple of LEAF_SIZE.
    tri_v0: jnp.ndarray      # (T, 3)
    tri_e1: jnp.ndarray      # (T, 3) v1 - v0
    tri_e2: jnp.ndarray      # (T, 3) v2 - v0
    tri_n0: jnp.ndarray      # (T, 3) vertex normals
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_uv0: jnp.ndarray     # (T, 2)
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    tri_material: jnp.ndarray  # (T,) int32
    tri_valid: jnp.ndarray   # (T,) bool (padding rows False)

    # Dense intersection tables (see build_dense below), set on the
    # per-frame instance shells (render/instances.py), whose 1-node tree is
    # not a real hierarchy: closest_hit then scans all triangles.
    dense: "DenseTris" = None


BVH_CACHE_VERSION = 6  # v6: no dense tables in the cache
BVH_CACHE_MIN_TRIS = 50_000   # don't litter the cache with tiny test scenes
_BVH_FIELDS = ("node_min", "node_max", "node_first", "node_count",
               "node_miss", "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1",
               "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_material",
               "tri_valid")


def _bvh_cache_dir() -> str:
    import os

    d = os.environ.get("D3D12_BVH_CACHE_DIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".bvh_cache"))
    os.makedirs(d, exist_ok=True)
    return d


def _bvh_cache_key(meshes) -> str:
    import hashlib

    h = hashlib.blake2b(digest_size=20)
    h.update(f"v{BVH_CACHE_VERSION}|leaf{LEAF_SIZE}".encode())
    for mesh, mat_id in meshes:
        for a in (mesh.positions, mesh.normals, mesh.uvs, mesh.indices):
            arr = np.ascontiguousarray(a)
            h.update(f"{arr.dtype}{arr.shape}".encode())
            h.update(arr.tobytes())
        h.update(str(int(mat_id)).encode())
    return h.hexdigest()


def _bvh_cache_load(path: str) -> Optional[BVH]:
    try:
        with np.load(path) as z:
            return BVH(**{k: jnp.asarray(z[k]) for k in _BVH_FIELDS})
    except Exception:
        return None


def _bvh_cache_save(path: str, out: BVH, keep: int = 16):
    import os

    d = {k: np.asarray(getattr(out, k)) for k in _BVH_FIELDS}
    tmp = f"{path}.tmp{os.getpid()}"  # pid suffix: concurrent builders of
    with open(tmp, "wb") as f:        # the same scene must not interleave
        np.savez(f, **d)
    os.replace(tmp, path)
    # LRU prune by mtime.
    files = sorted(
        (os.path.join(_bvh_cache_dir(), f)
         for f in os.listdir(_bvh_cache_dir()) if f.endswith(".npz")),
        key=os.path.getmtime)
    for f in files[:-keep]:
        try:
            os.remove(f)
        except OSError:
            pass


def build_bvh(meshes: List[Tuple[MeshData, int]],
              cache: Optional[bool] = None) -> BVH:
    """Build from [(mesh, material_id), ...] on the host (median split).

    Big scenes (>= BVH_CACHE_MIN_TRIS) are disk-cached by CONTENT HASH in
    <checkout>/.bvh_cache (or $D3D12_BVH_CACHE_DIR) — the BLAS-cache
    analogue of the reference's derived-data `.cache.bin`
    (asset/model_asset.cpp:23-63).  `cache=False` (or D3D12_BVH_CACHE=0)
    disables."""
    import os

    total_tris = sum(len(mesh.indices) for mesh, _ in meshes)
    if cache is None:
        cache = (os.environ.get("D3D12_BVH_CACHE", "1") != "0"
                 and total_tris >= BVH_CACHE_MIN_TRIS)
    cpath = None
    if cache:
        try:  # unwritable cache dir must degrade to an uncached build
            cpath = os.path.join(_bvh_cache_dir(),
                                 _bvh_cache_key(meshes) + ".npz")
            if os.path.exists(cpath):
                hit = _bvh_cache_load(cpath)
                if hit is not None:
                    return hit
        except Exception:
            cpath = None
    v0s, e1s, e2s, n0s, n1s, n2s, uv0s, uv1s, uv2s, mats = \
        [], [], [], [], [], [], [], [], [], []
    for mesh, mat in meshes:
        p = mesh.positions.astype(np.float64)
        n = mesh.normals
        uv = mesh.uvs
        i = mesh.indices
        v0, v1, v2 = p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]
        v0s.append(v0)
        e1s.append(v1 - v0)
        e2s.append(v2 - v0)
        n0s.append(n[i[:, 0]])
        n1s.append(n[i[:, 1]])
        n2s.append(n[i[:, 2]])
        uv0s.append(uv[i[:, 0]])
        uv1s.append(uv[i[:, 1]])
        uv2s.append(uv[i[:, 2]])
        mats.append(np.full(len(i), mat, np.int32))

    v0 = np.concatenate(v0s)
    e1 = np.concatenate(e1s)
    e2 = np.concatenate(e2s)
    n0 = np.concatenate(n0s)
    n1 = np.concatenate(n1s)
    n2 = np.concatenate(n2s)
    uv0 = np.concatenate(uv0s)
    uv1 = np.concatenate(uv1s)
    uv2 = np.concatenate(uv2s)
    mat = np.concatenate(mats)

    centroids = v0 + (e1 + e2) / 3.0
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)

    built = None
    if os.environ.get("D3D12_NATIVE_BVH", "1") != "0":
        # Native C++ median split (native/mesh_ops.cpp bvh_build): identical
        # split rule and node layout, ~50x the NumPy builder on big scenes.
        from ..assets.native import bvh_build_arrays

        built = bvh_build_arrays(lo, hi, centroids, LEAF_SIZE)
    if built is None:
        built = _build_nodes_numpy(lo, hi, centroids)
    node_min, node_max, node_first, node_count, miss, perm = built
    t = len(perm)
    pad = (-t) % LEAF_SIZE if t else LEAF_SIZE
    valid = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])

    def take(a, fill=0.0):
        out = a[perm]
        padding = np.full((pad,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([out, padding])
    out = BVH(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        node_first=jnp.asarray(node_first),
        node_count=jnp.asarray(node_count),
        node_miss=jnp.asarray(miss),
        tri_v0=jnp.asarray(take(v0).astype(np.float32)),
        tri_e1=jnp.asarray(take(e1).astype(np.float32)),
        tri_e2=jnp.asarray(take(e2).astype(np.float32)),
        tri_n0=jnp.asarray(take(n0).astype(np.float32)),
        tri_n1=jnp.asarray(take(n1).astype(np.float32)),
        tri_n2=jnp.asarray(take(n2).astype(np.float32)),
        tri_uv0=jnp.asarray(take(uv0).astype(np.float32)),
        tri_uv1=jnp.asarray(take(uv1).astype(np.float32)),
        tri_uv2=jnp.asarray(take(uv2).astype(np.float32)),
        tri_material=jnp.asarray(take(mat, fill=0)),
        tri_valid=jnp.asarray(valid),
    )
    if cpath is not None:
        try:
            _bvh_cache_save(cpath, out)
        except Exception:
            pass
    return out


def _build_nodes_numpy(lo, hi, centroids):
    """NumPy fallback of the median-split build (same layout as the native
    `bvh_build` in native/mesh_ops.cpp): DFS pre-order nodes, skip links,
    leaf-order triangle permutation."""
    nodes = []  # (min, max, first, count) — children at n+1
    order: List[np.ndarray] = []
    placed = [0]  # running leaf-triangle total (NOT re-summed per leaf:
                  # that was accidentally quadratic — 276 s at 123k tris)

    def emit(tri_idx) -> int:
        my = len(nodes)
        bb_lo = lo[tri_idx].min(axis=0)
        bb_hi = hi[tri_idx].max(axis=0)
        if len(tri_idx) <= LEAF_SIZE:
            first = placed[0]
            placed[0] += len(tri_idx)
            order.append(tri_idx)
            nodes.append([bb_lo, bb_hi, first, len(tri_idx)])
            return my
        nodes.append([bb_lo, bb_hi, -1, 0])
        c = centroids[tri_idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # Tie-break by global triangle index so the split SET is unique —
        # keeps the tree identical to the native builder's nth_element.
        med = np.lexsort((tri_idx, c[:, axis]))
        half = len(tri_idx) // 2
        emit(tri_idx[med[:half]])
        emit(tri_idx[med[half:]])
        return my

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        emit(np.arange(len(lo)))
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(nodes)
    # Miss links: in DFS order, node i's miss = next sibling of the nearest
    # ancestor (derived from subtree sizes).
    miss = np.full(n_nodes, n_nodes, np.int32)
    memo = {}

    def subtree_size_memo(i):
        if i in memo:
            return memo[i]
        if nodes[i][3] > 0:
            memo[i] = 1
            return 1
        left = i + 1
        ls = subtree_size_memo(left)
        right = left + ls
        rs = subtree_size_memo(right)
        memo[i] = 1 + ls + rs
        return memo[i]

    stack = [(0, n_nodes)]
    while stack:
        i, m = stack.pop()
        miss[i] = m
        if nodes[i][3] == 0:  # inner
            left = i + 1
            ls = subtree_size_memo(left)
            right = left + ls
            stack.append((left, right))
            stack.append((right, m))

    perm = np.concatenate(order) if order else np.zeros(0, np.int64)
    node_min = np.stack([n[0] for n in nodes]).astype(np.float32)
    node_max = np.stack([n[1] for n in nodes]).astype(np.float32)
    node_first = np.array([n[2] for n in nodes], np.int32)
    node_count = np.array([n[3] for n in nodes], np.int32)
    return node_min, node_max, node_first, node_count, miss, perm


def _ray_aabb(o, inv_d, lo, hi, t_max):
    """Slab test. o/inv_d (R,3); lo/hi (R,3). Returns hit mask (R,)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tmin = jnp.minimum(t0, t1).max(axis=-1)
    tmax = jnp.maximum(t0, t1).min(axis=-1)
    return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin <= t_max)


def _ray_tris(o, d, v0, e1, e2, valid, t_max):
    """Moller-Trumbore over a (R, K) leaf block.

    o/d (R,3); v0/e1/e2 (R,K,3). Returns (t, u, v, hit) each (R,K)."""
    ox = o[:, None, :]
    dx = d[:, None, :]
    pvec = jnp.cross(dx, e2)
    det = jnp.sum(e1 * pvec, -1)
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = ox - v0
    u = jnp.sum(tvec * pvec, -1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dx * qvec, -1) * inv_det
    t = jnp.sum(e2 * qvec, -1) * inv_det
    hit = (
        valid & (jnp.abs(det) > 1e-9)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > 1e-4) & (t < t_max[:, None])
    )
    return t, u, v, hit


# --------------------------------------------------------------------------
# Dense intersection path
# --------------------------------------------------------------------------
#
# Every ray against every triangle, as PLANE tests: precompute per-triangle
# plane + 2 barycentric edge planes; then every (ray, tri) test is 8 dot
# products, all expressible as (R,3)@(3,T) matmuls, scanned over triangle
# chunks.  No gathers and no divergence, at O(rays x triangles) work: the
# path for the per-frame instance shells, which have no tree.  Built BVHs
# take the skip-link traversal, which is faster on the card at every
# measured size (PERF.md).  The plane dots run at full f32 precision (on
# the GPU an f32 matmul may otherwise run in TF32 and move hits).

DENSE_CHUNK = 512
_F32 = jax.lax.Precision.HIGHEST


@struct.dataclass
class DenseTris:
    """Plane-form triangle soup for all-pairs intersection as matmuls."""

    n: jnp.ndarray          # (T, 3) geometric normal (unnormalized)
    n_off: jnp.ndarray      # (T,) plane offset: n.v0
    e1p: jnp.ndarray        # (T, 3) barycentric-u plane normal
    e1_off: jnp.ndarray     # (T,)
    e2p: jnp.ndarray        # (T, 3) barycentric-v plane normal
    e2_off: jnp.ndarray     # (T,)
    valid: jnp.ndarray      # (T,)


def build_dense(bvh: BVH) -> DenseTris:
    v0, e1, e2 = bvh.tri_v0, bvh.tri_e1, bvh.tri_e2
    n = jnp.cross(e1, e2)
    nn = jnp.sum(n * n, -1, keepdims=True)
    # Barycentric planes: u = dot(e1p, p) + e1_off, v = dot(e2p, p) + e2_off
    # with (u, v) the Moller barycentrics.  e1p = cross(e2, n)/nn etc.
    e1p = jnp.cross(e2, n) / jnp.maximum(nn, 1e-20)
    e2p = jnp.cross(n, e1) / jnp.maximum(nn, 1e-20)

    return DenseTris(
        n=n,
        n_off=jnp.sum(n * v0, -1),
        e1p=e1p,
        e1_off=-jnp.sum(e1p * v0, -1),
        e2p=e2p,
        e2_off=-jnp.sum(e2p * v0, -1),
        valid=bvh.tri_valid,
    )


RAY_BLOCK = 65536


def closest_hit_dense(dense: DenseTris, origin, direction, t_max=1e30,
                      chunk=DENSE_CHUNK):
    """All-pairs closest hit via plane matmuls, scanned over triangle chunks.

    origin/direction (R, 3).  Returns the same dict as closest_hit.
    Large ray sets are processed in RAY_BLOCK slabs so the (rays x chunk)
    intermediates stay well under HBM capacity."""
    r_total = origin.shape[0]
    if r_total > RAY_BLOCK:
        pad_r = (-r_total) % RAY_BLOCK
        o = jnp.pad(origin, ((0, pad_r), (0, 0)))
        d = jnp.pad(direction, ((0, pad_r), (0, 0)),
                    constant_values=1.0)
        t_max_a = jnp.broadcast_to(
            jnp.asarray(t_max, jnp.float32), (r_total,))
        t_max_a = jnp.pad(t_max_a, (0, pad_r), constant_values=1e30)
        o = o.reshape(-1, RAY_BLOCK, 3)
        d = d.reshape(-1, RAY_BLOCK, 3)
        t_max_a = t_max_a.reshape(-1, RAY_BLOCK)
        res = jax.lax.map(
            lambda args: closest_hit_dense(dense, args[0], args[1],
                                           t_max=args[2], chunk=chunk),
            (o, d, t_max_a),
        )
        return {k: v.reshape((-1,) + v.shape[2:])[:r_total]
                for k, v in res.items()}

    t_count = dense.n.shape[0]
    pad = (-t_count) % chunk
    def padt(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
    n = padt(dense.n).reshape(-1, chunk, 3)
    n_off = padt(dense.n_off).reshape(-1, chunk)
    e1p = padt(dense.e1p).reshape(-1, chunk, 3)
    e1_off = padt(dense.e1_off).reshape(-1, chunk)
    e2p = padt(dense.e2p).reshape(-1, chunk, 3)
    e2_off = padt(dense.e2_off).reshape(-1, chunk)
    valid = jnp.pad(dense.valid, (0, pad)).reshape(-1, chunk)
    base = jnp.arange(n.shape[0]) * chunk

    r = origin.shape[0]
    o = origin
    d = direction

    def chunk_step(carry, inputs):
        t_best, tri_best, uv_best = carry
        cn, cn_off, ce1, ce1_off, ce2, ce2_off, cvalid, cbase = inputs
        # (R, C) plane dots as matmuls.
        no = jnp.dot(o, cn.T, precision=_F32)
        nd = jnp.dot(d, cn.T, precision=_F32)
        t = (cn_off[None, :] - no) / jnp.where(jnp.abs(nd) < 1e-12,
                                               jnp.inf, nd)
        uo = jnp.dot(o, ce1.T, precision=_F32)
        ud = jnp.dot(d, ce1.T, precision=_F32)
        vo = jnp.dot(o, ce2.T, precision=_F32)
        vd = jnp.dot(d, ce2.T, precision=_F32)
        u = uo + t * ud + ce1_off[None, :]
        v = vo + t * vd + ce2_off[None, :]
        ok = (
            cvalid[None, :] & (t > 1e-4) & (t < t_best[:, None])
            & (u >= 0) & (v >= 0) & (u + v <= 1)
        )
        t_mask = jnp.where(ok, t, jnp.inf)
        k = jnp.argmin(t_mask, -1)
        tk = jnp.take_along_axis(t_mask, k[:, None], -1)[:, 0]
        better = tk < t_best
        t_best = jnp.where(better, tk, t_best)
        tri_best = jnp.where(better, cbase + k, tri_best)
        uk = jnp.take_along_axis(u, k[:, None], -1)[:, 0]
        vk = jnp.take_along_axis(v, k[:, None], -1)[:, 0]
        uv_best = jnp.where(better[:, None], jnp.stack([uk, vk], -1), uv_best)
        return (t_best, tri_best, uv_best), None

    init = (jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)),
            jnp.full((r,), -1, jnp.int32),
            jnp.zeros((r, 2), jnp.float32))
    (t_best, tri_best, uv_best), _ = jax.lax.scan(
        chunk_step, init,
        (n, n_off, e1p, e1_off, e2p, e2_off, valid, base.astype(jnp.int32)),
    )
    return {"t": t_best, "tri": tri_best, "uv": uv_best, "hit": tri_best >= 0}


def closest_hit(bvh: BVH, origin, direction, t_max=1e30, max_steps=512):
    """Vectorized closest hit.

    origin/direction (R, 3).  Returns dict of (R,) arrays:
    t, tri (int32, -1 = miss), uv (R, 2), hit.  Instance shells (with dense
    tables) take the all-pairs scan, built BVHs the skip-link traversal."""
    if bvh.dense is not None:
        return closest_hit_dense(bvh.dense, origin, direction, t_max=t_max)
    return closest_hit_traverse(bvh, origin, direction, t_max=t_max,
                                max_steps=max_steps)


def closest_hit_traverse(bvh: BVH, origin, direction, t_max=1e30,
                         max_steps=512):
    """Skip-link BVH traversal: every ray walks the DFS node order, descends
    into hit inner nodes and follows `node_miss` past missed ones."""
    r = origin.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(direction) < 1e-12,
                            jnp.where(direction >= 0, 1e-12, -1e-12), direction)
    n_nodes = bvh.node_min.shape[0]

    def cond(state):
        node, t_best, tri_best, uv_best, steps = state
        return jnp.any(node < n_nodes) & (steps < max_steps)

    def body(state):
        node, t_best, tri_best, uv_best, steps = state
        active = node < n_nodes
        ni = jnp.minimum(node, n_nodes - 1)
        lo = bvh.node_min[ni]
        hi = bvh.node_max[ni]
        first = bvh.node_first[ni]
        count = bvh.node_count[ni]
        miss = bvh.node_miss[ni]

        box_hit = _ray_aabb(origin, inv_d, lo, hi, t_best) & active
        is_leaf = count > 0

        # Leaf: test LEAF_SIZE triangles.
        base = jnp.where(is_leaf & box_hit, first, 0)
        tri_idx = base[:, None] + jnp.arange(LEAF_SIZE)[None, :]
        tri_idx = jnp.minimum(tri_idx, bvh.tri_v0.shape[0] - 1)
        valid = (
            (jnp.arange(LEAF_SIZE)[None, :] < count[:, None])
            & bvh.tri_valid[tri_idx]
            & (is_leaf & box_hit)[:, None]
        )
        t, u, v, hit = _ray_tris(
            origin, direction,
            bvh.tri_v0[tri_idx], bvh.tri_e1[tri_idx], bvh.tri_e2[tri_idx],
            valid, t_best,
        )
        t_masked = jnp.where(hit, t, jnp.inf)
        k = jnp.argmin(t_masked, axis=-1)
        t_leaf = jnp.take_along_axis(t_masked, k[:, None], -1)[:, 0]
        better = t_leaf < t_best
        t_best = jnp.where(better, t_leaf, t_best)
        tri_best = jnp.where(
            better, jnp.take_along_axis(tri_idx, k[:, None], -1)[:, 0], tri_best
        )
        u_best = jnp.take_along_axis(u, k[:, None], -1)[:, 0]
        v_best = jnp.take_along_axis(v, k[:, None], -1)[:, 0]
        uv_best = jnp.where(better[:, None],
                            jnp.stack([u_best, v_best], -1), uv_best)

        # Next node: descend into hit inner nodes, else skip.
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, miss)
        node = jnp.where(active, nxt, node)
        return node, t_best, tri_best, uv_best, steps + 1

    node0 = jnp.zeros((r,), jnp.int32)
    t0 = jnp.full((r,), t_max, jnp.float32)
    tri0 = jnp.full((r,), -1, jnp.int32)
    uv0 = jnp.zeros((r, 2), jnp.float32)
    node, t_best, tri_best, uv_best, _ = jax.lax.while_loop(
        cond, body, (node0, t0, tri0, uv0, jnp.zeros((), jnp.int32))
    )
    return {"t": t_best, "tri": tri_best, "uv": uv_best,
            "hit": tri_best >= 0}


def any_hit(bvh: BVH, origin, direction, t_max, max_steps=512):
    """Shadow-ray query: True where something blocks before t_max."""
    res = closest_hit(bvh, origin, direction, t_max=t_max, max_steps=max_steps)
    return res["hit"] & (res["t"] < t_max)


def hit_attributes(bvh: BVH, res):
    """Interpolate normal/uv/material at hit points.

    All per-triangle attributes ride ONE packed (T, 19) row gather instead
    of nine separate attribute gathers."""
    tri = jnp.maximum(res["tri"], 0)
    u = res["uv"][:, 0]
    v = res["uv"][:, 1]
    w = 1.0 - u - v
    gn_t = jnp.cross(bvh.tri_e1, bvh.tri_e2)
    gn_t = gn_t / jnp.maximum(
        jnp.linalg.norm(gn_t, axis=-1, keepdims=True), 1e-9)
    table = jnp.concatenate([
        bvh.tri_n0, bvh.tri_n1, bvh.tri_n2,          # 0:9
        bvh.tri_uv0, bvh.tri_uv1, bvh.tri_uv2,       # 9:15
        gn_t,                                        # 15:18
        bvh.tri_material[:, None].astype(jnp.float32),  # 18 (exact <2^24)
    ], -1)
    # Fused with its producers, XLA lowers the gather far slower — force
    # materialized inputs (same barrier as the raster uv tail).
    table, ti = jax.lax.optimization_barrier((table, tri))
    # Barrier the gather OUTPUT too: with multiple consumers (n, uv, gn,
    # material slices) XLA otherwise REMATERIALIZES the 2M-row gather per
    # consumer fusion.
    rows = jax.lax.optimization_barrier(table[ti])   # (R, 19)
    n = (w[:, None] * rows[:, 0:3] + u[:, None] * rows[:, 3:6]
         + v[:, None] * rows[:, 6:9])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    uv = (w[:, None] * rows[:, 9:11] + u[:, None] * rows[:, 11:13]
          + v[:, None] * rows[:, 13:15])
    gn = rows[:, 15:18]
    return n, gn, uv, rows[:, 18].astype(jnp.int32)


def build_shading_table(bvh: BVH, materials) -> jnp.ndarray:
    """(T, 28) packed per-triangle shading attributes: geometric rows +
    material constants expanded per triangle.  FRAME-INVARIANT — compute
    once per scene (Scene.with_shading_table) and reuse every frame."""
    gn_t = jnp.cross(bvh.tri_e1, bvh.tri_e2)
    gn_t = gn_t / jnp.maximum(
        jnp.linalg.norm(gn_t, axis=-1, keepdims=True), 1e-9)
    mt = bvh.tri_material
    tex = (materials.albedo_texture[mt][:, None].astype(jnp.float32)
           if materials.texture_atlas is not None
           else jnp.full((mt.shape[0], 1), -1.0))
    return jnp.concatenate([
        bvh.tri_n0, bvh.tri_n1, bvh.tri_n2,              # 0:9
        bvh.tri_uv0, bvh.tri_uv1, bvh.tri_uv2,           # 9:15
        gn_t,                                            # 15:18
        mt[:, None].astype(jnp.float32),                 # 18
        materials.albedo[mt],                            # 19:22
        materials.roughness[mt][:, None],                # 22
        materials.metallic[mt][:, None],                 # 23
        materials.emissive[mt],                          # 24:27
        tex,                                             # 27
    ], -1)


def hit_attributes_shaded(bvh: BVH, materials, res, table=None):
    """hit_attributes + the hit's material values, ONE packed row gather.

    Material constants (albedo tint, roughness, metallic, emissive,
    texture index) are expanded per TRIANGLE into the same packed table as
    the geometric attributes, so the whole G-buffer shading input costs a
    single (T, 28) fetch instead of one big row gather plus five
    per-material gathers.
    Texture modulation still samples the atlas per pixel when present.

    Pass a precomputed `table` (build_shading_table / Scene.attr_table)
    for per-frame rendering — it is frame-invariant.

    Returns (n, gn, uv, mat_id, albedo, roughness, metallic, emissive)."""
    tri = jnp.maximum(res["tri"], 0)
    u = res["uv"][:, 0]
    v = res["uv"][:, 1]
    w = 1.0 - u - v
    if table is None:
        table = build_shading_table(bvh, materials)
    table, ti = jax.lax.optimization_barrier((table, tri))
    # See hit_attributes: output barrier prevents per-consumer gather remat.
    rows = jax.lax.optimization_barrier(table[ti])       # (R, 28)
    n = (w[:, None] * rows[:, 0:3] + u[:, None] * rows[:, 3:6]
         + v[:, None] * rows[:, 6:9])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    uv = (w[:, None] * rows[:, 9:11] + u[:, None] * rows[:, 11:13]
          + v[:, None] * rows[:, 13:15])
    gn = rows[:, 15:18]
    albedo = rows[:, 19:22]
    if materials.texture_atlas is not None:
        tix = rows[:, 27].astype(jnp.int32)
        has = tix >= 0
        t = jnp.maximum(tix, 0)
        r_ = materials.texture_atlas.shape[1]
        uu = jnp.mod(uv[..., 0], 1.0)
        vv = jnp.mod(uv[..., 1], 1.0)
        px = jnp.clip((uu * (r_ - 1)).astype(jnp.int32), 0, r_ - 1)
        py = jnp.clip((vv * (r_ - 1)).astype(jnp.int32), 0, r_ - 1)
        texv = materials.texture_atlas[t, py, px]
        albedo = jnp.where(has[:, None], albedo * texv, albedo)
    return (n, gn, uv, rows[:, 18].astype(jnp.int32), albedo,
            rows[:, 22], rows[:, 23], rows[:, 24:27])
