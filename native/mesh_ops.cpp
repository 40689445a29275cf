// Native host-side mesh processing: the hot paths of asset import.
//
// Reference equivalents: src/asset/mesh_postprocessing.cpp (vertex welding,
// normal generation) and src/asset/obj.cpp (OBJ parsing) — all native C++ in
// the reference.  This framework keeps these host-side stages native too:
// importing a multi-million-vertex mesh through Python loops would dominate
// scene load time.  Exposed through a plain C ABI consumed via ctypes
// (assets/native.py), with a pure-Python fallback when no compiler exists.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Vertex welding: merge vertices closer than `tolerance` (grid hashing).
// Returns the number of unique vertices; fills remap[i] = new index of old i.
// ---------------------------------------------------------------------------

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct CellHash {
    size_t operator()(const CellKey& k) const {
        // Large-prime mix (same spirit as the reference's spatial hashing).
        return (size_t)(k.x * 73856093LL ^ k.y * 19349669LL ^ k.z * 83492791LL);
    }
};

int64_t weld_vertices(const float* positions, int64_t num_vertices,
                      float tolerance, int32_t* remap_out) {
    const double inv = 1.0 / (double)tolerance;
    std::unordered_map<CellKey, int32_t, CellHash> grid;
    grid.reserve((size_t)num_vertices);
    int64_t unique = 0;
    for (int64_t i = 0; i < num_vertices; ++i) {
        CellKey key{
            (int64_t)llround(positions[i * 3 + 0] * inv),
            (int64_t)llround(positions[i * 3 + 1] * inv),
            (int64_t)llround(positions[i * 3 + 2] * inv),
        };
        auto it = grid.find(key);
        if (it == grid.end()) {
            grid.emplace(key, (int32_t)unique);
            remap_out[i] = (int32_t)unique;
            ++unique;
        } else {
            remap_out[i] = it->second;
        }
    }
    return unique;
}

// ---------------------------------------------------------------------------
// Area-weighted vertex normals.
// ---------------------------------------------------------------------------

void generate_normals(const float* positions, int64_t num_vertices,
                      const int32_t* indices, int64_t num_triangles,
                      float* normals_out) {
    memset(normals_out, 0, sizeof(float) * (size_t)num_vertices * 3);
    for (int64_t t = 0; t < num_triangles; ++t) {
        const int32_t a = indices[t * 3], b = indices[t * 3 + 1],
                      c = indices[t * 3 + 2];
        const float* pa = positions + (int64_t)a * 3;
        const float* pb = positions + (int64_t)b * 3;
        const float* pc = positions + (int64_t)c * 3;
        const float e1x = pb[0] - pa[0], e1y = pb[1] - pa[1], e1z = pb[2] - pa[2];
        const float e2x = pc[0] - pa[0], e2y = pc[1] - pa[1], e2z = pc[2] - pa[2];
        const float nx = e1y * e2z - e1z * e2y;
        const float ny = e1z * e2x - e1x * e2z;
        const float nz = e1x * e2y - e1y * e2x;
        for (int32_t v : {a, b, c}) {
            normals_out[(int64_t)v * 3 + 0] += nx;
            normals_out[(int64_t)v * 3 + 1] += ny;
            normals_out[(int64_t)v * 3 + 2] += nz;
        }
    }
    for (int64_t i = 0; i < num_vertices; ++i) {
        float* n = normals_out + i * 3;
        const float len = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        if (len > 1e-12f) {
            n[0] /= len;
            n[1] /= len;
            n[2] /= len;
        }
    }
}

// ---------------------------------------------------------------------------
// Fast OBJ geometry scan: positions + triangulated faces (v//n and v/t/n
// forms; materials handled by the Python layer).  Two-pass: count, then fill.
// Returns 0 on success.
// ---------------------------------------------------------------------------

int64_t obj_count(const char* text, int64_t length,
                  int64_t* out_vertices, int64_t* out_triangles) {
    int64_t nv = 0, nt = 0;
    const char* p = text;
    const char* end = text + length;
    while (p < end) {
        if (p[0] == 'v' && p + 1 < end && p[1] == ' ') {
            ++nv;
        } else if (p[0] == 'f' && p + 1 < end && p[1] == ' ') {
            int corners = 0;
            const char* q = p + 1;
            while (q < end && *q != '\n') {
                while (q < end && *q == ' ') ++q;
                if (q < end && *q != '\n' && *q != ' ') {
                    ++corners;
                    while (q < end && *q != ' ' && *q != '\n') ++q;
                }
            }
            if (corners >= 3) nt += corners - 2;
        }
        while (p < end && *p != '\n') ++p;
        ++p;
    }
    *out_vertices = nv;
    *out_triangles = nt;
    return 0;
}

int64_t obj_parse(const char* text, int64_t length,
                  float* positions_out, int32_t* indices_out) {
    int64_t nv = 0, nt = 0;
    const char* p = text;
    const char* end = text + length;
    std::vector<int64_t> corner_buf;
    while (p < end) {
        if (p[0] == 'v' && p + 1 < end && p[1] == ' ') {
            char* q = nullptr;
            positions_out[nv * 3 + 0] = strtof(p + 2, &q);
            positions_out[nv * 3 + 1] = strtof(q, &q);
            positions_out[nv * 3 + 2] = strtof(q, &q);
            ++nv;
        } else if (p[0] == 'f' && p + 1 < end && p[1] == ' ') {
            corner_buf.clear();
            const char* q = p + 1;
            while (q < end && *q != '\n') {
                while (q < end && *q == ' ') ++q;
                if (q >= end || *q == '\n') break;
                char* r = nullptr;
                long idx = strtol(q, &r, 10);
                if (r == q) break;
                int64_t vi = idx > 0 ? idx - 1 : nv + idx;
                corner_buf.push_back(vi);
                q = r;
                while (q < end && *q != ' ' && *q != '\n') ++q;  // skip /t/n
            }
            for (size_t k = 1; k + 1 < corner_buf.size(); ++k) {
                indices_out[nt * 3 + 0] = (int32_t)corner_buf[0];
                indices_out[nt * 3 + 1] = (int32_t)corner_buf[k];
                indices_out[nt * 3 + 2] = (int32_t)corner_buf[k + 1];
                ++nt;
            }
        }
        while (p < end && *p != '\n') ++p;
        ++p;
    }
    return nt;
}

}  // extern "C"

#include <algorithm>
#include <utility>

// ---------------------------------------------------------------------------
// BVH median-split build (host).  The device consumes the result as flat arrays
// (render/bvh.py); only the tree CONSTRUCTION is host-side and hot — the
// NumPy recursive argsort builder costs ~3.3 s at 123k triangles, this is
// the native replacement (reference analogue: D3D12 BLAS builds are native
// driver code, raytracing.cpp `blas_builder`).
//
// Semantics match the Python builder exactly: DFS pre-order nodes, split
// axis = first axis of max centroid extent, split point = count/2 by
// centroid order, leaves hold <= leaf_size triangles, miss links = next
// sibling of the nearest ancestor (root miss = node count).
//
// lo/hi/cent: (T, 3) float64.  node_* arrays have capacity node_cap;
// perm_out (T,) int64 receives the leaf-order triangle permutation.
// Returns the node count, or -1 if node_cap would overflow.
// ---------------------------------------------------------------------------

namespace {

struct BvhBuilder {
    const double *lo, *hi, *cent;
    int32_t leaf_size;
    int64_t node_cap;
    float *node_min, *node_max;
    int32_t *node_first, *node_count;
    int64_t *idx;
    std::vector<int64_t> subtree;  // per-node subtree size (for miss links)
    int64_t n_nodes = 0;
    bool overflow = false;

    // Builds [b, e) of idx; returns this subtree's node count.
    int64_t build(int64_t b, int64_t e) {
        if (n_nodes >= node_cap) {
            overflow = true;
            return 0;
        }
        const int64_t my = n_nodes++;
        subtree.push_back(0);
        double bb_lo[3] = {1e300, 1e300, 1e300};
        double bb_hi[3] = {-1e300, -1e300, -1e300};
        double c_lo[3] = {1e300, 1e300, 1e300};
        double c_hi[3] = {-1e300, -1e300, -1e300};
        for (int64_t i = b; i < e; ++i) {
            const int64_t t = idx[i];
            for (int k = 0; k < 3; ++k) {
                const double l = lo[t * 3 + k], h = hi[t * 3 + k];
                if (l < bb_lo[k]) bb_lo[k] = l;
                if (h > bb_hi[k]) bb_hi[k] = h;
                const double c = cent[t * 3 + k];
                if (c < c_lo[k]) c_lo[k] = c;
                if (c > c_hi[k]) c_hi[k] = c;
            }
        }
        for (int k = 0; k < 3; ++k) {
            node_min[my * 3 + k] = (float)bb_lo[k];
            node_max[my * 3 + k] = (float)bb_hi[k];
        }
        const int64_t count = e - b;
        if (count <= leaf_size) {
            node_first[my] = (int32_t)b;  // leaves fill idx left-to-right
            node_count[my] = (int32_t)count;
            subtree[my] = 1;
            return 1;
        }
        node_first[my] = -1;
        node_count[my] = 0;
        int axis = 0;
        double best = c_hi[0] - c_lo[0];
        for (int k = 1; k < 3; ++k) {  // strict >: first max, like np.argmax
            const double ext = c_hi[k] - c_lo[k];
            if (ext > best) { best = ext; axis = k; }
        }
        const double* cv = cent;
        // Tie-break by triangle index: a unique key makes the median SET
        // deterministic and identical to the NumPy builder's lexsort.
        std::nth_element(idx + b, idx + b + count / 2, idx + e,
                         [cv, axis](int64_t a, int64_t c) {
                             const double va = cv[a * 3 + axis];
                             const double vb = cv[c * 3 + axis];
                             return va < vb || (va == vb && a < c);
                         });
        const int64_t ls = build(b, b + count / 2);
        const int64_t rs = build(b + count / 2, e);
        subtree[my] = 1 + ls + rs;
        return subtree[my];
    }
};

}  // namespace

extern "C" int64_t bvh_build(const double* lo, const double* hi,
                             const double* cent, int64_t num_tris,
                             int32_t leaf_size, int64_t node_cap,
                             float* node_min, float* node_max,
                             int32_t* node_first, int32_t* node_count,
                             int32_t* node_miss, int64_t* perm_out) {
    if (num_tris <= 0 || leaf_size <= 0) return -1;
    for (int64_t i = 0; i < num_tris; ++i) perm_out[i] = i;
    BvhBuilder bld{lo, hi, cent, leaf_size, node_cap,
                   node_min, node_max, node_first, node_count, perm_out};
    bld.subtree.reserve((size_t)(2 * num_tris / leaf_size + 16));
    bld.build(0, num_tris);
    if (bld.overflow) return -1;
    const int64_t n = bld.n_nodes;
    // Miss links: DFS stack of (node, miss), children resolved by subtree
    // sizes — identical to the Python assignment loop.
    std::vector<std::pair<int64_t, int64_t>> stack;
    stack.emplace_back(0, n);
    while (!stack.empty()) {
        const auto [i, m] = stack.back();
        stack.pop_back();
        node_miss[i] = (int32_t)m;
        if (node_count[i] == 0) {
            const int64_t left = i + 1;
            const int64_t right = left + bld.subtree[left];
            stack.emplace_back(left, right);
            stack.emplace_back(right, m);
        }
    }
    return n;
}
