"""Tile-binned software rasterizer: primary visibility at content scale.

Primary visibility is a single projective transform, so binning TRIANGLES to
SCREEN tiles replaces a 3D ray/AABB traversal with an exact 2D rectangle
overlap, and the per-pair test drops from a full ray-triangle intersection
to three edge evaluations and an interpolated-depth compare (no divide).

This stands in for the reference's hardware rasterizer geometry pass
(reference: src/rendering/main_renderer.cpp depth prepass + opaque pass at
1920x1080, src/main.cpp:121): a tile-binned rasterizer in 2D homogeneous
coordinates [Olano & Greer 1997] — NO near-plane clipping, triangles
crossing w=0 are handled exactly by the sign rules below.

Formulation (per frame, all plain XLA):
  * Each vertex maps to homogeneous PIXEL coordinates V = (X, Y, W) with
    X/W = pixel x, Y/W = pixel y, W = view depth (matching
    render/camera.py generate_rays pixel conventions exactly).
  * Edge planes E0 = cross(V1,V2)/D, E1 = cross(V2,V0)/D, E2 = cross(V0,V1)/D
    with D = det[V0;V1;V2].  For screen point p = (px, py, 1):
    the camera ray through p hits the triangle plane with perspective-correct
    barycentrics li = Ei.p / q and interpolated attribute-over-depth
    q(p) = sum_i a_i Ei.p (a_i = 1 gives q = 1/view-depth).
    Covered AND in front  <=>  min(E0.p, E1.p, E2.p) >= 0 AND q(p) > 0 —
    exact for any triangle, including near-plane-crossing ones (mixed W
    signs flip through the 1/D normalization) and back-facing ones (D < 0
    likewise; visibility is two-sided, matching the ray path).
  * Depth resolve: the winner per pixel MAXIMIZES q (nearest surface).
  * A visit is one (tile, block of 128 triangles) pair.  Per 64x32-pixel
    tile, the visit list holds the blocks whose screen rects overlap it,
    front-to-back by conservative max-q.  The visit step (_visit_all)
    evaluates every (visit, pixel, triangle) in chunks of visits, reduces
    to the best triangle per (visit, pixel), then takes the max per
    (tile, pixel) across visits.

Outputs match render/bvh.closest_hit's contract ({t, tri, uv, hit}) so the
G-buffer (render/gbuffer.py) is produced by the same downstream math.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

# Screen tile (pixels).
TILE_X = 64
TILE_Y = 32
PX = TILE_X * TILE_Y                  # pixels per tile
# Triangles per visit block.
GROUP = 128
# Visit-list cap per tile (top-K nearest blocks).  Overflow beyond the cap
# drops the FARTHEST blocks only (they are sorted front-to-back) and is
# counted.
VISIT_CAP = 128
# Visits evaluated together by the visit step: (VISIT_CHUNK, PX, GROUP)
# intermediates.
VISIT_CHUNK = 16
_SENTINEL = 0x7FFFFFFF
_W_EPS = 1e-6


class FrameTables(NamedTuple):
    """Per-(frame, view) rasterization tables (all device arrays)."""
    planes: jnp.ndarray     # (8, 4*Tp) f32: lanes [(g*4+p)*128+j], rows x/y/w
    rect: jnp.ndarray       # (4, G) group screen rects, rows x0/y0/x1/y1
    qhi: jnp.ndarray        # (G,) conservative max q per group
    n_tris: int             # unpadded triangle count


def perspective_rows(camera, width: int, height: int):
    """(3, 4) homogeneous-pixel transform M and (1, 4) depth-attribute row.

    [X; Y; W] = M @ [p; 1] reproduces render/camera.py generate_rays:
    X/W = (ndc_x*0.5 + 0.5)*width, Y/W = (1 - ndc_y)*0.5*height, W = -z_view.
    The depth attribute a = 1 makes q = interpolated 1/W."""
    from ..core import maths as m
    q = camera.rotation
    ex = m.quat_rotate(q[None], jnp.array([[1.0, 0.0, 0.0]]))[0]
    ey = m.quat_rotate(q[None], jnp.array([[0.0, 1.0, 0.0]]))[0]
    ez = m.quat_rotate(q[None], jnp.array([[0.0, 0.0, 1.0]]))[0]
    c = camera.position
    th = math.tan(camera.v_fov * 0.5)
    # view rows: vx = ex.(p - c), vy = ey.(p - c), w = -ez.(p - c)
    row_vx = jnp.concatenate([ex, -jnp.dot(ex, c)[None]])
    row_vy = jnp.concatenate([ey, -jnp.dot(ey, c)[None]])
    row_w = jnp.concatenate([-ez, jnp.dot(ez, c)[None]])
    row_x = 0.5 * width * (row_vx / (th * camera.aspect) + row_w)
    row_y = 0.5 * height * (row_w - row_vy / th)
    mat = jnp.stack([row_x, row_y, row_w])
    attr = jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32)
    return mat.astype(jnp.float32), attr


def _project_planes(tri_v0, tri_e1, tri_e2, tri_valid, mat, attr,
                    width: int, height: int):
    """Shared per-tri projection: plane components + screen rect + max-q.

    ~40 flops/tri, in component-ROW layout (every array is (T,)).
    Degenerate or edge-on triangles produce NaN/inf planes which fail every
    coverage compare.

    Returns (e0, e1, e2, qp, x0, y0, x1, y1, q_tri): e*/qp are 3-lists of
    (T,) plane components; rect/max-q are (T,) with invalid tris pushed to
    empty rects (+inf/-inf) and q_tri = -inf."""
    f32 = jnp.float32
    v0 = tri_v0.astype(f32).T                                  # (3, T) rows
    v1 = v0 + tri_e1.astype(f32).T
    v2 = v0 + tri_e2.astype(f32).T

    def proj(v):  # (3, T) world rows -> (X, Y, W) pixel rows
        return [mat[r, 0] * v[0] + mat[r, 1] * v[1] + mat[r, 2] * v[2]
                + mat[r, 3] for r in range(3)]

    def attr_of(v):
        return (attr[0, 0] * v[0] + attr[0, 1] * v[1] + attr[0, 2] * v[2]
                + attr[0, 3])

    h0, h1, h2 = proj(v0), proj(v1), proj(v2)                  # [X, Y, W]
    a0, a1, a2 = attr_of(v0), attr_of(v1), attr_of(v2)

    def cross(u, w):
        return [u[1] * w[2] - u[2] * w[1],
                u[2] * w[0] - u[0] * w[2],
                u[0] * w[1] - u[1] * w[0]]

    c12, c20, c01 = cross(h1, h2), cross(h2, h0), cross(h0, h1)
    det = h0[0] * c12[0] + h0[1] * c12[1] + h0[2] * c12[2]
    inv_d = 1.0 / det
    nan = jnp.float32(jnp.nan)
    vrow = tri_valid

    def plane(c):
        return [jnp.where(vrow, x * inv_d, nan) for x in c]

    e0, e1, e2 = plane(c12), plane(c20), plane(c01)
    qp = [a0 * e0[i] + a1 * e1[i] + a2 * e2[i] for i in range(3)]

    # Conservative per-tri screen rect + max-q; any vertex at/behind the
    # camera plane makes the footprint unbounded -> full screen, q cap inf.
    ws = [h[2] for h in (h0, h1, h2)]
    safe = [jnp.maximum(w, _W_EPS) for w in ws]
    sx = [h[0] / s for h, s in zip((h0, h1, h2), safe)]
    sy = [h[1] / s for h, s in zip((h0, h1, h2), safe)]
    qs = [a / s for a, s in zip((a0, a1, a2), safe)]
    unb = (ws[0] <= _W_EPS) | (ws[1] <= _W_EPS) | (ws[2] <= _W_EPS)

    def min3(v):
        return jnp.minimum(jnp.minimum(v[0], v[1]), v[2])

    def max3(v):
        return jnp.maximum(jnp.maximum(v[0], v[1]), v[2])

    x0 = jnp.where(unb, 0.0, min3(sx))
    x1 = jnp.where(unb, float(width), max3(sx))
    y0 = jnp.where(unb, 0.0, min3(sy))
    y1 = jnp.where(unb, float(height), max3(sy))
    q_tri = jnp.where(unb, jnp.inf, max3(qs))
    x0 = jnp.where(vrow, x0, jnp.inf)
    y0 = jnp.where(vrow, y0, jnp.inf)
    x1 = jnp.where(vrow, x1, -jnp.inf)
    y1 = jnp.where(vrow, y1, -jnp.inf)
    q_tri = jnp.where(vrow, q_tri, -jnp.inf)
    return e0, e1, e2, qp, x0, y0, x1, y1, q_tri


def build_frame_tables(tri_v0, tri_e1, tri_e2, tri_valid, mat, attr,
                       width: int, height: int) -> FrameTables:
    """Project all triangles and build the per-frame plane + binning tables
    at GROUP (128-tri) granularity (see build_pair_tables for the exact
    per-tri binning used at content scale)."""
    t = tri_v0.shape[0]
    pad = (-t) % GROUP
    e0, e1, e2, qp, x0, y0, x1, y1, q_tri = _project_planes(
        tri_v0, tri_e1, tri_e2, tri_valid, mat, attr, width, height)

    # Pack to (8, 4*Tp): lane (g*4 + p)*128 + j, component rows 0..2.
    tp = t + pad

    def pack_comp(i):
        rows = jnp.stack([e0[i], e1[i], e2[i], qp[i]])         # (4, T)
        rows = jnp.pad(rows, ((0, 0), (0, pad)), constant_values=jnp.nan)
        return rows.reshape(4, tp // GROUP, GROUP).transpose(1, 0, 2).ravel()

    tbl = jnp.stack([pack_comp(i) for i in range(3)])
    tbl = jnp.pad(tbl, ((0, 5), (0, 0)))                       # (8, 4*Tp)

    def gmin(x, cv):
        return jnp.pad(x, (0, pad), constant_values=cv).reshape(
            -1, GROUP).min(-1)

    def gmax(x, cv):
        return jnp.pad(x, (0, pad), constant_values=cv).reshape(
            -1, GROUP).max(-1)

    rect = jnp.stack([gmin(x0, jnp.inf), gmin(y0, jnp.inf),
                      gmax(x1, -jnp.inf), gmax(y1, -jnp.inf)])
    qhi = gmax(q_tri, -jnp.inf)
    return FrameTables(planes=tbl, rect=rect, qhi=qhi, n_tris=t)


def _visit_bits(n_tiles: int, n_groups: int) -> Tuple[int, int, int]:
    tile_bits = max(n_tiles - 1, 1).bit_length()
    group_bits = max(n_groups - 1, 1).bit_length()
    q_bits = 31 - tile_bits - group_bits
    assert q_bits >= 6, (n_tiles, n_groups)
    return tile_bits, q_bits, group_bits


def geometric_needed(tables: FrameTables, width: int, height: int):
    """(n_tiles, G) bool: group's screen rect overlaps the tile."""
    ntx, nty = width // TILE_X, height // TILE_Y
    tx = jnp.arange(ntx, dtype=jnp.float32) * TILE_X
    ty = jnp.arange(nty, dtype=jnp.float32) * TILE_Y
    tx0 = jnp.tile(tx, nty)[:, None]                    # (n_tiles, 1)
    ty0 = jnp.repeat(ty, ntx)[:, None]
    r = tables.rect                                     # (4, G) rows
    return ((r[0][None, :] < tx0 + TILE_X) & (r[2][None, :] > tx0)
            & (r[1][None, :] < ty0 + TILE_Y) & (r[3][None, :] > ty0)
            & (tables.qhi[None, :] > 0.0))              # (n_tiles, G)


# Safety margin on occlusion-feedback culling: a group is skipped only when
# its conservative max q is BELOW the tile's min resolved q by this factor
# (guards the qhi == qmin equality case in f32).
_FB_MARGIN = 1.0 - 1e-5


def visit_plan(tables: FrameTables, width: int, height: int,
               needed=None):
    """Per-tile front-to-back visit lists.

    Returns (packed, counts, scale, overflow): packed (n_tiles*VISIT_CAP,)
    int32 sorted words tile|qq|group (ascending = per tile,
    nearest-possible group first; tail is sentinel), counts (n_tiles,)
    visits per tile (>= 1 — empty tiles get one skip-only visit), scale (1,)
    f32 dequantizing qq to an upper bound on the group's q, overflow ()
    int32 visits dropped by the per-tile cap (farthest-first)."""
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    n_groups = tables.qhi.shape[0]
    _, q_bits, group_bits = _visit_bits(n_tiles, n_groups)
    qmax_q = (1 << q_bits) - 1

    if needed is None:
        needed = geometric_needed(tables, width, height)

    finite = jnp.isfinite(tables.qhi) & (tables.qhi > 0)
    scale = jnp.maximum(jnp.max(jnp.where(finite, tables.qhi, 0.0)), 1e-30) \
        / (qmax_q - 1)
    # qq ascending == conservative q bound descending; qq == 0 marks
    # unbounded q (near-crossing groups).
    q_up = jnp.ceil(tables.qhi / scale)
    qq = jnp.where(jnp.isfinite(tables.qhi),
                   jnp.clip(qmax_q - q_up, 1, qmax_q - 1), 0)
    key = jnp.where(needed, -qq[None, :].astype(jnp.float32), -jnp.inf)
    cap = min(VISIT_CAP, n_groups)
    vals, gidx = jax.lax.top_k(key, cap)                # (n_tiles, cap)
    valid = vals > -jnp.inf
    counts = valid.sum(-1)
    overflow = needed.sum() - counts.sum()

    tiles = jax.lax.broadcasted_iota(jnp.int32, vals.shape, 0)
    words = ((tiles << (q_bits + group_bits))
             | ((-vals).astype(jnp.int32) << group_bits)
             | gidx)
    # Tiles with no visits: one skip-only word (qq = qmax_q -> bound 0,
    # never evaluated).
    forced = ((tiles << (q_bits + group_bits)) | (qmax_q << group_bits))
    none = counts == 0
    words = jnp.where(valid, words,
                      jnp.where(none[:, None]
                                & (jax.lax.broadcasted_iota(
                                    jnp.int32, vals.shape, 1) == 0),
                                forced, jnp.int32(_SENTINEL)))
    counts = jnp.maximum(counts, 1)
    packed = jnp.sort(words.ravel())
    return packed, counts, scale.reshape(1).astype(jnp.float32), overflow


# Pair capacity for exact per-tri binning (multiple of GROUP).  The 260k-tri
# atrium at 1080p measures ~170k exact (tri, tile) pairs; 512k gives 3x
# headroom.  When a frame exceeds the cap the excess pairs are DROPPED
# (arbitrary tris, counted in `pairs_overflow`) — callers needing
# exactness-or-bust should check the counter and re-render via the group
# path (closest_hit_raster(binning="group")).
PAIR_CAP = 512 * 1024
assert PAIR_CAP % GROUP == 0


def visit_plan_pairs(tri_v0, tri_e1, tri_e2, tri_valid, mat, attr,
                     width: int, height: int, pair_cap: int = None):
    """EXACT per-triangle tile binning (vs the conservative GROUP-rect
    binning of visit_plan): each triangle is expanded to the tiles its own
    screen rect overlaps, pairs are sorted front-to-back per tile, and the
    per-visit plane tables are GATHERED in sorted order so every visit
    block holds 128 pairs of one tile.  The atrium at 1080p has ~170k
    exact pairs vs 24k group visits x 128 tris = 3.1M pair-equivalents.

    The slot->tri map is a scatter-max at segment starts + cummax; visit
    alignment happens POST-sort with per-visit index math; the table
    carries the triangle ID as row 12 so the visit step emits real tri ids.

    Returns (packed_words, counts, scale2, table, pairs_overflow,
    visits_overflow, bits):
      packed_words (NV,) int32 visit words
        tile | qq2 | block sorted per tile front-to-back;
      counts (n_tiles,) visits per tile (>= 1, <= VISIT_CAP);
      scale2 (1,) f32 dequantizer for qq2;
      table (16*NV, GROUP) f32 per-visit plane rows (row 12 = tri id)."""
    assert width % TILE_X == 0 and height % TILE_Y == 0, (width, height)
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    cap = pair_cap or PAIR_CAP
    t = tri_v0.shape[0]
    i32 = jnp.int32

    e0, e1, e2, qp, x0, y0, x1, y1, q_tri = _project_planes(
        tri_v0, tri_e1, tri_e2, tri_valid, mat, attr, width, height)

    # Per-tri plane rows (T+1, 16); row 12 carries the triangle id (f32 is
    # exact to 2^24); trailing row serves pad pairs (NaN planes fail every
    # coverage compare).
    rows16 = jnp.stack(
        [e0[0], e0[1], e0[2], e1[0], e1[1], e1[2],
         e2[0], e2[1], e2[2], qp[0], qp[1], qp[2],
         jnp.arange(t, dtype=jnp.float32),
         jnp.zeros(t, jnp.float32), jnp.zeros(t, jnp.float32),
         jnp.zeros(t, jnp.float32)], axis=-1)                   # (T, 16)
    rows16 = jnp.pad(rows16, ((0, 1), (0, 0)),
                     constant_values=jnp.nan)                   # (T+1, 16)

    # Exact tile ranges; NaN rects (degenerate tris) fail `vis` and the
    # nan_to_num keeps the int casts defined.
    fx0 = jnp.nan_to_num(jnp.clip(jnp.floor(x0 / TILE_X), 0, ntx - 1))
    fy0 = jnp.nan_to_num(jnp.clip(jnp.floor(y0 / TILE_Y), 0, nty - 1))
    fx1 = jnp.nan_to_num(jnp.clip(jnp.ceil(x1 / TILE_X) - 1, 0, ntx - 1))
    fy1 = jnp.nan_to_num(jnp.clip(jnp.ceil(y1 / TILE_Y) - 1, 0, nty - 1))
    vis = ((q_tri > 0.0) & (x1 > 0.0) & (x0 < width)
           & (y1 > 0.0) & (y0 < height))
    tx0i, ty0i = fx0.astype(i32), fy0.astype(i32)
    cx = jnp.maximum(fx1.astype(i32) - tx0i + 1, 1)
    cy = jnp.maximum(fy1.astype(i32) - ty0i + 1, 1)
    counts_tri = jnp.where(vis, cx * cy, 0)

    # Pair sort key: tile | qq (30 bits; bit 30 spare so no real key can
    # reach the 0x7FFFFFFF invalid sentinel).
    tile_bits = max(n_tiles - 1, 1).bit_length()
    qp_bits = 30 - tile_bits
    qmax_p = (1 << qp_bits) - 1
    finite = jnp.isfinite(q_tri) & (q_tri > 0)
    scale = jnp.maximum(jnp.max(jnp.where(finite, q_tri, 0.0)), 1e-30) \
        / (qmax_p - 1)
    q_up = jnp.ceil(q_tri / scale)
    qq = jnp.where(jnp.isfinite(q_tri),
                   jnp.clip(qmax_p - q_up, 1, qmax_p - 1), 0).astype(i32)

    # Expansion slot -> tri: scatter each visible tri's id at its segment
    # start, cummax fills the segment.  All per-tri payloads ride ONE
    # (T, 4)-row gather.
    cum = jnp.cumsum(counts_tri)
    starts = cum - counts_tri
    total = cum[-1]
    pairs_overflow = jnp.maximum(total - cap, 0)
    write = (counts_tri > 0) & (starts < cap)
    mark = jnp.zeros(cap, i32).at[jnp.where(write, starts, 0)].max(
        jnp.where(write, jnp.arange(t, dtype=i32) + 1, 0))
    slots = jnp.arange(cap, dtype=i32)
    tri_of = jax.lax.associative_scan(jnp.maximum, mark) - 1
    live = slots < total
    tri_c = jnp.clip(tri_of, 0, t - 1)
    assert ntx <= 1024 and nty <= 1024
    prect = tx0i | (ty0i << 10) | (cx << 20)
    payload = jnp.stack([prect, starts, qq, jnp.zeros_like(qq)], -1)
    pay_g = payload[tri_c]                                      # (cap, 4)
    rect_g, local = pay_g[:, 0], slots - pay_g[:, 1]
    cx_g = jnp.maximum(rect_g >> 20, 1)
    tile = ((rect_g >> 10) & 1023) * ntx + (rect_g & 1023) \
        + (local // cx_g) * ntx + local % cx_g
    key = jnp.where(live, (tile << qp_bits) | pay_g[:, 2],
                    jnp.int32(_SENTINEL))
    val = jnp.where(live, tri_c, -1)
    skey, sval = jax.lax.sort((key, val), num_keys=1, is_stable=True)

    # Post-sort visit alignment, all at visit granularity (NV ~ 5k): tile
    # segment boundaries via n_tiles-sized searchsorted, ceil-div visit
    # counts, per-visit source windows into the sorted pair list.  Lanes
    # past a segment's end become pad pairs (tri -1 -> NaN row).
    stile = skey >> qp_bits                          # ascending; invalid big
    bounds = jnp.searchsorted(stile, jnp.arange(n_tiles + 1)).astype(i32)
    cnt_t = bounds[1:] - bounds[:-1]
    nv_t = jnp.maximum((cnt_t + GROUP - 1) // GROUP, 1)
    vcum = jnp.cumsum(nv_t)
    nv = cap // GROUP + n_tiles                      # static visit capacity
    v_bits = max(nv - 1, 1).bit_length()
    q2_bits = 31 - tile_bits - v_bits
    assert q2_bits >= 4, (n_tiles, nv)
    qmax2 = (1 << q2_bits) - 1
    vidx = jnp.arange(nv, dtype=i32)
    vtile = jnp.searchsorted(vcum, vidx, side="right").astype(i32)
    live_v = vidx < vcum[-1]
    vtile_c = jnp.clip(vtile, 0, n_tiles - 1)
    lv = vidx - (vcum - nv_t)[vtile_c]               # visit rank in tile
    seg0 = bounds[:-1][vtile_c]
    seg1 = bounds[1:][vtile_c]
    src0 = seg0 + lv * GROUP
    src = src0[:, None] + jnp.arange(GROUP, dtype=i32)[None, :]
    pvalid = src < seg1[:, None]
    tri_aligned = jnp.where(pvalid, sval[jnp.minimum(src, cap - 1)], -1)

    # Visit words: bound = the first (nearest) member pair's quantized q,
    # conservatively requantized to q2_bits (floor keeps bound2 >= bound);
    # qq==0 stays 0 (unbounded, never skipped); empty tiles' forced visit
    # gets qmax2 (bound 0 -> skipped, but still inits the tile).
    has_pair = lv * GROUP < cnt_t[vtile_c]
    kfirst = skey[jnp.minimum(src0, cap - 1)]
    vqq = jnp.where(has_pair, kfirst & ((1 << qp_bits) - 1), qmax_p)
    qq2 = jnp.where(vqq == 0, 0,
                    jnp.where(vqq >= qmax_p, qmax2,
                              jnp.clip((vqq * (qmax2 - 1)) // (qmax_p - 1),
                                       1, qmax2 - 1)))
    scale2 = scale * (qmax_p - 1) / (qmax2 - 1)
    words = jnp.where(live_v,
                      (vtile << (q2_bits + v_bits)) | (qq2 << v_bits) | vidx,
                      jnp.int32(_SENTINEL))

    # Clamp per-tile visits at VISIT_CAP; over-cap visits (the FARTHEST
    # blocks — per-tile order is front-to-back) are dropped and the tiny
    # word list re-sorted compact.
    keep = live_v & (lv < VISIT_CAP)
    visits_overflow = (live_v & ~keep).sum()
    packed = jnp.sort(jnp.where(keep, words, jnp.int32(_SENTINEL)))
    counts = jnp.minimum(nv_t, VISIT_CAP)

    # Gather the per-visit plane tables in aligned order:
    # (NV*G, 16) rows -> (NV, 16, GROUP) -> (16*NV, GROUP) blocks.
    tri_idx = jnp.where(tri_aligned >= 0, tri_aligned, t).reshape(-1)
    table = rows16[tri_idx].reshape(nv, GROUP, 16).transpose(0, 2, 1) \
        .reshape(nv * 16, GROUP)
    return (packed, counts, scale2.reshape(1).astype(jnp.float32), table,
            pairs_overflow, visits_overflow,
            dict(q_bits=q2_bits, group_bits=v_bits))


def rasterize_pairs(tri_v0, tri_e1, tri_e2, tri_valid, mat, attr,
                    width: int, height: int, jitter=(0.5, 0.5),
                    pair_cap: int = None, with_uv: bool = False):
    """Exact per-tri binned rasterization -> ROW-MAJOR (q, tri, overflow).

    Same output contract as rasterize() (group binning) but ~10x fewer
    pair tests at content scale; `overflow` counts dropped pairs plus
    dropped visits (0 in correct frames — callers needing exactness-or-bust
    check it and fall back to binning="group").

    `with_uv` appends ROW-MAJOR (u, v) perspective-correct winner
    barycentrics (requires the perspective attr row, q == 1/w)."""
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    (packed, counts, scale2, table, povf, vovf,
     bits) = visit_plan_pairs(tri_v0, tri_e1, tri_e2, tri_valid, mat, attr,
                              width, height, pair_cap)
    out = _visit_all(packed, table, n_tiles=n_tiles, ntx=ntx,
                     q_bits=bits["q_bits"], group_bits=bits["group_bits"],
                     jitter=jitter, tri_rows=True, with_uv=with_uv)
    q, win = out[0], out[1]
    qmin = q.reshape(n_tiles, PX).min(-1)
    res = (_unscramble(q, width, height),
           _unscramble(win, width, height), povf + vovf, qmin)
    if with_uv:
        res = res + (_unscramble(out[2], width, height),
                     _unscramble(out[3], width, height))
    return res


def _visit_all(packed, table, *, n_tiles, ntx, q_bits, group_bits, jitter,
               tri_rows, with_uv: bool = False):
    """The visit step: rasterize every visit word of `packed` and resolve
    the nearest triangle per pixel.  Returns TILE-MAJOR (q, win[, u, v]),
    each (n_tiles * PX,): q = the winner's depth attribute (0 = no
    coverage), win = its triangle id (-1), u/v its perspective-correct
    barycentrics (with_uv, pair path only).

    `table` is (8, 4*GROUP*n_blocks) (group path: rows x/y/w, lanes
    [(block*4 + comp)*GROUP + j] for comps e0, e1, e2, q) or
    (16*n_blocks, GROUP) (pair path: per-visit rows
    [e0xyw e1xyw e2xyw qxyw id pad*3]); each word's low `group_bits`
    select its block.  Skip-only words (qq == max, empty tiles) and
    sentinels are not evaluated.

    Visits run VISIT_CHUNK at a time: edge functions and depth over
    (visit, pixel, triangle), the per-(visit, pixel) winner (max q, ties to
    the lower column), then the max over each tile's visits (ties to the
    earlier, i.e. nearer-bounded, visit)."""
    shift = q_bits + group_bits
    qmax_q = (1 << q_bits) - 1
    nw = packed.shape[0]
    pad = (-nw) % VISIT_CHUNK
    words = jnp.pad(packed, (0, pad), constant_values=_SENTINEL)
    nwp = nw + pad
    live = ((words != _SENTINEL)
            & (((words >> group_bits) & qmax_q) != qmax_q))
    tile = jnp.where(live, words >> shift, n_tiles)          # n_tiles: drop
    blk = words & ((1 << group_bits) - 1)
    if tri_rows:
        planes = table.reshape(-1, 16, GROUP)                # (NB, 16, G)
    else:
        planes = table[0:3].reshape(3, -1, 4, GROUP).transpose(1, 2, 0, 3)
    jit2 = jnp.asarray(jitter, jnp.float32).reshape(2)
    rows = jnp.arange(PX, dtype=jnp.int32)
    cols = jnp.arange(GROUP, dtype=jnp.int32)

    def chunk(c):
        sl = jax.lax.dynamic_slice_in_dim
        t_c = sl(tile, c * VISIT_CHUNK, VISIT_CHUNK)
        b_c = sl(blk, c * VISIT_CHUNK, VISIT_CHUNK)
        pl_c = planes[b_c]                                   # (C, 16|4, ...)
        if tri_rows:
            comp = pl_c[:, 0:12].reshape(-1, 4, 3, GROUP)    # (C, 4, 3, G)
            ids = pl_c[:, 12].astype(jnp.int32)              # (C, G)
        else:
            comp = pl_c                                      # (C, 4, 3, G)
            ids = b_c[:, None] * GROUP + cols[None, :]
        fx = ((t_c % ntx) * TILE_X)[:, None] + rows % TILE_X
        fy = ((t_c // ntx) * TILE_Y)[:, None] + rows // TILE_X
        fx = (fx.astype(jnp.float32) + jit2[0])[:, :, None]  # (C, PX, 1)
        fy = (fy.astype(jnp.float32) + jit2[1])[:, :, None]

        def edge(k):
            return (fx * comp[:, None, k, 0] + fy * comp[:, None, k, 1]
                    + comp[:, None, k, 2])                   # (C, PX, G)

        e0, e1, e2, q = edge(0), edge(1), edge(2), edge(3)
        covered = jnp.minimum(jnp.minimum(e0, e1), e2) >= 0.0
        qm = jnp.where(covered & (q > 0.0) & (q < jnp.inf), q, -1.0)
        q_best = jnp.max(qm, -1)                             # (C, PX)
        col = jnp.argmax(qm, -1)                             # first max
        win = jnp.take_along_axis(ids, col, -1)
        out = (q_best, win)
        if with_uv:
            def at_col(k):
                p = jnp.take_along_axis(
                    comp[:, k], jnp.broadcast_to(col[:, None], (
                        col.shape[0], 3, PX)), -1)           # (C, 3, PX)
                return (fx[..., 0] * p[:, 0] + fy[..., 0] * p[:, 1]
                        + p[:, 2])
            qs = jnp.maximum(q_best, 1e-30)
            out += (at_col(1) / qs, at_col(2) / qs)
        return out

    outs = jax.lax.map(chunk, jnp.arange(nwp // VISIT_CHUNK))
    outs = [x.reshape(nwp, PX) for x in outs]
    q_v = outs[0]
    idx = tile[:, None] * PX + rows[None, :]                 # (NW, PX)
    n_px = n_tiles * PX
    q_pix = jnp.zeros((n_px,), jnp.float32).at[idx].max(q_v, mode="drop")
    # The winning visit per pixel: the earliest whose q equals the max.
    vids = jnp.broadcast_to(jnp.arange(nwp, dtype=jnp.int32)[:, None],
                            idx.shape)
    is_max = (q_v > 0.0) & (q_v == q_pix.at[idx].get(mode="fill",
                                                      fill_value=-1.0))
    v_pix = jnp.full((n_px,), nwp, jnp.int32).at[idx].min(
        jnp.where(is_max, vids, nwp), mode="drop")
    hit = v_pix < nwp
    vsafe = jnp.minimum(v_pix, nwp - 1)
    pix = jnp.tile(rows, n_tiles)

    def pick(x, miss):
        return jnp.where(hit, x[vsafe, pix], miss)

    res = (q_pix, pick(outs[1], -1))
    if with_uv:
        res += (pick(outs[2], 0.0), pick(outs[3], 0.0))
    return res


def _rasterize_tiles(tables: FrameTables, width: int, height: int,
                     jitter=(0.5, 0.5), needed=None):
    """One rasterization pass -> TILE-MAJOR per-pixel (q, win, overflow).

    `needed` optionally restricts the (tile, group) visit mask (occlusion
    feedback); None means the full geometric mask."""
    assert width % TILE_X == 0 and height % TILE_Y == 0, (width, height)
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    n_groups = tables.qhi.shape[0]
    _, q_bits, group_bits = _visit_bits(n_tiles, n_groups)
    packed, counts, scale, overflow = visit_plan(tables, width, height,
                                                 needed=needed)
    q, win = _visit_all(packed, tables.planes, n_tiles=n_tiles, ntx=ntx,
                        q_bits=q_bits, group_bits=group_bits, jitter=jitter,
                        tri_rows=False)
    return q, win, overflow


def _unscramble(x, width, height):
    """Tile-major (ty, tx, y_in, x_in) -> row-major, as pure reshapes."""
    ntx, nty = width // TILE_X, height // TILE_Y
    return (x.reshape(nty, ntx, TILE_Y, TILE_X)
            .transpose(0, 2, 1, 3).reshape(height * width))


def rasterize(tables: FrameTables, width: int, height: int,
              jitter=(0.5, 0.5), tile_qmin=None):
    """Rasterize the frame tables -> per-pixel (q, winning tri id).

    Returns (q, tri, overflow, tile_qmin_out): q/tri (height*width,) in
    ROW-MAJOR pixel order (q = the winner's interpolated depth attribute, 0
    where no triangle covers the pixel; tri = -1 there); tile_qmin_out
    (n_tiles,) is the per-tile min resolved q, the occlusion-feedback input
    for the NEXT frame.  width/height must be TILE multiples (callers pad).

    `tile_qmin` (previous frame's tile_qmin_out, or None) enables
    occlusion-culled visiting with an EXACT repair pass: phase 1 skips
    groups whose conservative max q lies below the previous tile minimum;
    phase 2 re-rasterizes any tile where a skipped group could still beat
    the phase-1 result (the test uses phase-1 depths, so the combined
    result is exact for ANY camera/scene motion — with a static view,
    phase 2 is empty and the frame costs only the visible visits).  This
    is two-phase HiZ occlusion culling; the reference renders Sponza
    brute-force (hardware raster), so this is a strict capability add."""
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    needed_geo = geometric_needed(tables, width, height)
    if tile_qmin is None:
        q, win, overflow = _rasterize_tiles(tables, width, height, jitter,
                                            needed=needed_geo)
        qmin = q.reshape(n_tiles, PX).min(-1)
        return (_unscramble(q, width, height),
                _unscramble(win, width, height), overflow, qmin)

    qhi = tables.qhi[None, :]
    cull1 = qhi <= tile_qmin[:, None] * _FB_MARGIN
    q1, win1, ovf1 = _rasterize_tiles(tables, width, height, jitter,
                                      needed=needed_geo & ~cull1)
    qmin1 = q1.reshape(n_tiles, PX).min(-1)
    # Exactness repair: any culled group that could still beat the tile's
    # CURRENT min resolved depth forces a from-scratch re-raster of that
    # tile against every group passing the current bound.
    residual = needed_geo & cull1 & (qhi > qmin1[:, None] * _FB_MARGIN)
    dirty = jnp.any(residual, axis=1)
    needed2 = (needed_geo & (qhi > qmin1[:, None] * _FB_MARGIN)
               & dirty[:, None])
    q2, win2, ovf2 = _rasterize_tiles(tables, width, height, jitter,
                                      needed=needed2)
    sel = jnp.repeat(dirty, PX)
    q = jnp.where(sel, q2, q1)
    win = jnp.where(sel, win2, win1)
    qmin = q.reshape(n_tiles, PX).min(-1)
    return (_unscramble(q, width, height),
            _unscramble(win, width, height), ovf1 + ovf2, qmin)


def closest_hit_raster(bvh, camera, width: int, height: int,
                       jitter=(0.5, 0.5),
                       tables: Optional[FrameTables] = None,
                       tile_qmin=None, binning: str = "tri",
                       pair_cap: int = None):
    """Primary-visibility drop-in for render/bvh.closest_hit on pinhole
    cameras: returns {t, tri, uv, hit} (row-major pixels) computed by the
    tile-binned rasterizer.  t and barycentrics are recomputed from the
    winner's plane row / closed form so the G-buffer math downstream is
    identical to the ray path's.

    `binning`: "tri" (default) bins EXACT per-tri screen rects (~10x fewer
    pair tests at content scale; drops pairs past `pair_cap`, see
    visit_plan_pairs); "group" bins conservative 128-tri group rects (no
    cap losses, supports occlusion feedback).

    `tile_qmin`: previous frame's res["tile_qmin"] enables exact two-phase
    occlusion-culled visiting (group binning only, see rasterize)."""
    wp = width + ((-width) % TILE_X)
    hp = height + ((-height) % TILE_Y)
    pair_uv = None
    if binning == "tri" and tables is None and tile_qmin is None:
        mat, attr = perspective_rows(camera, width, height)
        q, tri, overflow, qmin_out, ku, kv = rasterize_pairs(
            bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.tri_valid, mat, attr,
            wp, hp, jitter=jitter, pair_cap=pair_cap, with_uv=True)
        pair_uv = (ku, kv)
    else:
        if tables is None:
            # The projection maps to UNPADDED pixel coordinates (identical
            # to generate_rays); padded tiles just evaluate the linear edge
            # functions beyond x = width, which is exact extrapolation.
            mat, attr = perspective_rows(camera, width, height)
            tables = build_frame_tables(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
                                        bvh.tri_valid, mat, attr, wp, hp)
        q, tri, overflow, qmin_out = rasterize(tables, wp, hp, jitter=jitter,
                                               tile_qmin=tile_qmin)
    if wp != width or hp != height:
        def crop(x):
            return x.reshape(hp, wp)[:height, :width].reshape(-1)
        q, tri = crop(q), crop(tri)
        if pair_uv is not None:
            pair_uv = (crop(pair_uv[0]), crop(pair_uv[1]))
    hit = tri >= 0

    # t from q in closed form: q = 1/w (view depth); the pixel's unit ray
    # direction has view-space -z component w/t  =>  t = |dir_cam| * w.
    th = math.tan(camera.v_fov * 0.5)
    jit2 = jnp.asarray(jitter, jnp.float32)     # traceable (TAA per-frame)
    x = jnp.arange(width, dtype=jnp.float32) + jit2[0]
    y = jnp.arange(height, dtype=jnp.float32) + jit2[1]
    ndc_x = (x / width * 2.0 - 1.0) * th * camera.aspect
    ndc_y = (1.0 - y / height * 2.0) * th
    norm = jnp.sqrt(1.0 + ndc_x[None, :] ** 2 + ndc_y[:, None] ** 2).reshape(-1)
    t = jnp.where(hit, norm / jnp.maximum(q, 1e-30), jnp.inf)

    if pair_uv is not None:
        # Pair path: the visit step emitted the winner's
        # perspective-correct barycentrics (see rasterize_pairs with_uv).
        uv = jnp.where(hit[:, None],
                       jnp.stack([pair_uv[0], pair_uv[1]], -1), 0.0)
        return {"t": t, "tri": tri, "uv": uv, "hit": hit,
                "overflow": overflow, "tile_qmin": qmin_out}

    # Group path: barycentrics from the winner's Moller plane rows
    # (render/bvh.py hit_attributes contract), via one packed (T, 8) row
    # gather.
    from ..render.bvh import build_dense
    from ..render.camera import generate_rays
    o, d = generate_rays(camera, width, height)
    p = o + jnp.where(hit, t, 0.0)[:, None] * d
    dense = build_dense(bvh)
    table8 = jnp.concatenate([
        dense.e1p, dense.e1_off[:, None],
        dense.e2p, dense.e2_off[:, None],
    ], -1)
    # Barrier: fused with its producers, XLA lowers this gather slower —
    # force materialized inputs.
    table8, ti = jax.lax.optimization_barrier(
        (table8, jnp.maximum(tri, 0)))
    rows = table8[ti]                                        # (R, 8)
    u = jnp.sum(p * rows[:, 0:3], -1) + rows[:, 3]
    v = jnp.sum(p * rows[:, 4:7], -1) + rows[:, 7]
    uv = jnp.where(hit[:, None], jnp.stack([u, v], -1), 0.0)
    return {"t": t, "tri": tri, "uv": uv, "hit": hit,
            "overflow": overflow, "tile_qmin": qmin_out}
