// Native binned-SAH BVH builder (the port's copy of the JAX package's
// vpt_tpu/accel/cpp/bvh_builder.cpp; the code is unchanged).
//
// Identical output layout to the NumPy builder, build_bvh(use_native=False)
// in vpt_tpu_torch/accel/bvh.py (DFS pre-order nodes, skip links, reordered
// triangle permutation): the equivalent of the reference's driver-side BLAS
// build (BLASBuilder::Build + Compact, PathTracer.cpp:433-502), which is
// also native.  Many times faster than the NumPy builder on large meshes.
//
// C ABI for ctypes; no dependencies beyond the C++17 standard library.
// Built with g++ into vpt_tpu_torch/build/ at first use (accel/kernels.py
// host_library).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int N_BINS = 16;

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Builder {
    const Vec3 *v0, *v1, *v2;
    std::vector<Vec3> centroid, tri_min, tri_max;
    int leaf_size;

    std::vector<Vec3> node_min, node_max;
    std::vector<int32_t> node_first, node_count, node_right;
    std::vector<int32_t> order;
    int32_t cursor = 0;

    float area(const Vec3& mn, const Vec3& mx) const {
        float dx = std::max(mx.x - mn.x, 0.f);
        float dy = std::max(mx.y - mn.y, 0.f);
        float dz = std::max(mx.z - mn.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }

    // Iterative DFS with an explicit stack so deep trees can't overflow the
    // C stack.  Emits nodes in DFS pre-order.
    struct Task {
        int32_t* idx;
        int32_t count;
        int32_t node_id;   // -1 => create node now
        int32_t parent;    // parent node id needing right-child fixup, or -1
    };

    int build(int32_t* idx, int32_t n) {
        std::vector<Task> stack;
        stack.push_back({idx, n, -1, -1});
        std::vector<int32_t> scratch(n);

        while (!stack.empty()) {
            Task t = stack.back();
            stack.pop_back();

            // Create node
            Vec3 mn = {std::numeric_limits<float>::max(), std::numeric_limits<float>::max(),
                       std::numeric_limits<float>::max()};
            Vec3 mx = {-mn.x, -mn.y, -mn.z};
            for (int32_t i = 0; i < t.count; ++i) {
                mn = vmin(mn, tri_min[t.idx[i]]);
                mx = vmax(mx, tri_max[t.idx[i]]);
            }
            int32_t nid = (int32_t)node_min.size();
            node_min.push_back(mn);
            node_max.push_back(mx);
            node_first.push_back(0);
            node_count.push_back(0);
            node_right.push_back(-1);
            if (t.parent >= 0) node_right[t.parent] = nid;

            int axis;
            float pos;
            if (!find_split(t.idx, t.count, mn, mx, axis, pos)) {
                node_first[nid] = cursor;
                node_count[nid] = t.count;
                for (int32_t i = 0; i < t.count; ++i) order[cursor + i] = t.idx[i];
                cursor += t.count;
                continue;
            }

            // Partition in place
            int32_t left = 0;
            for (int32_t i = 0; i < t.count; ++i) {
                float c = axis == 0 ? centroid[t.idx[i]].x
                        : axis == 1 ? centroid[t.idx[i]].y
                                    : centroid[t.idx[i]].z;
                if (c < pos) std::swap(t.idx[left++], t.idx[i]);
            }
            if (left == 0 || left == t.count) {
                // Degenerate: median split by sorting on the axis
                std::nth_element(
                    t.idx, t.idx + t.count / 2, t.idx + t.count,
                    [&](int32_t a, int32_t b) {
                        auto ca = centroid[a], cb = centroid[b];
                        float fa = axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z;
                        float fb = axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z;
                        return fa < fb;
                    });
                left = t.count / 2;
            }

            // Right pushed first so left is processed (and emitted) next —
            // the left child must be nid+1.  Right's parent fixup targets nid.
            stack.push_back({t.idx + left, t.count - left, -1, nid});
            stack.push_back({t.idx, left, -1, -1});
        }
        return (int)node_min.size();
    }

    bool find_split(const int32_t* idx, int32_t count, const Vec3& nmn, const Vec3& nmx,
                    int& out_axis, float& out_pos) {
        if (count <= leaf_size) return false;

        Vec3 cmin = centroid[idx[0]], cmax = centroid[idx[0]];
        for (int32_t i = 1; i < count; ++i) {
            cmin = vmin(cmin, centroid[idx[i]]);
            cmax = vmax(cmax, centroid[idx[i]]);
        }

        float best_cost = std::numeric_limits<float>::max();
        out_axis = -1;
        for (int axis = 0; axis < 3; ++axis) {
            float lo = axis == 0 ? cmin.x : axis == 1 ? cmin.y : cmin.z;
            float hi = axis == 0 ? cmax.x : axis == 1 ? cmax.y : cmax.z;
            float ext = hi - lo;
            if (ext <= 1e-12f) continue;

            int32_t bin_count[N_BINS] = {0};
            Vec3 bin_min[N_BINS], bin_max[N_BINS];
            for (int b = 0; b < N_BINS; ++b) {
                bin_min[b] = {std::numeric_limits<float>::max(),
                              std::numeric_limits<float>::max(),
                              std::numeric_limits<float>::max()};
                bin_max[b] = {-bin_min[b].x, -bin_min[b].y, -bin_min[b].z};
            }
            for (int32_t i = 0; i < count; ++i) {
                const Vec3& c = centroid[idx[i]];
                float cv = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
                int b = std::min((int)((cv - lo) / ext * N_BINS), N_BINS - 1);
                bin_count[b]++;
                bin_min[b] = vmin(bin_min[b], tri_min[idx[i]]);
                bin_max[b] = vmax(bin_max[b], tri_max[idx[i]]);
            }

            // Prefix/suffix sweeps
            float la[N_BINS], ra[N_BINS];
            int32_t lc[N_BINS], rc[N_BINS];
            Vec3 mn = bin_min[0], mx = bin_max[0];
            int32_t cnt = 0;
            for (int b = 0; b < N_BINS; ++b) {
                mn = vmin(mn, bin_min[b]);
                mx = vmax(mx, bin_max[b]);
                cnt += bin_count[b];
                la[b] = bin_count[b] || b ? area(mn, mx) : 0.f;
                lc[b] = cnt;
            }
            mn = bin_min[N_BINS - 1];
            mx = bin_max[N_BINS - 1];
            cnt = 0;
            for (int b = N_BINS - 1; b >= 0; --b) {
                mn = vmin(mn, bin_min[b]);
                mx = vmax(mx, bin_max[b]);
                cnt += bin_count[b];
                ra[b] = area(mn, mx);
                rc[b] = cnt;
            }
            for (int b = 0; b < N_BINS - 1; ++b) {
                if (lc[b] == 0 || rc[b + 1] == 0) continue;
                float cost = la[b] * lc[b] + ra[b + 1] * rc[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    out_axis = axis;
                    out_pos = lo + ext * (b + 1) / N_BINS;
                }
            }
        }

        if (out_axis < 0) {
            // Coincident centroids: force median split on the widest axis
            out_axis = 0;
            out_pos = (cmin.x + cmax.x) * 0.5f;
            return true;
        }
        if (best_cost >= area(nmn, nmx) * count && count <= 2 * leaf_size) return false;
        return true;
    }
};

}  // namespace

extern "C" {

// Returns the node count, or -1 on error.  Output arrays must hold at least
// 2*n_tris entries (nodes) / n_tris entries (order).
int vpt_build_bvh(const float* v0, const float* v1, const float* v2, int n_tris,
                  int leaf_size, float* out_aabb_min, float* out_aabb_max,
                  int32_t* out_first, int32_t* out_count, int32_t* out_skip,
                  int32_t* out_order) {
    if (n_tris <= 0) return -1;
    Builder b;
    b.v0 = reinterpret_cast<const Vec3*>(v0);
    b.v1 = reinterpret_cast<const Vec3*>(v1);
    b.v2 = reinterpret_cast<const Vec3*>(v2);
    b.leaf_size = leaf_size;
    b.centroid.resize(n_tris);
    b.tri_min.resize(n_tris);
    b.tri_max.resize(n_tris);
    for (int i = 0; i < n_tris; ++i) {
        const Vec3 &a = b.v0[i], &c = b.v1[i], &d = b.v2[i];
        b.centroid[i] = {(a.x + c.x + d.x) / 3.f, (a.y + c.y + d.y) / 3.f,
                         (a.z + c.z + d.z) / 3.f};
        b.tri_min[i] = vmin(vmin(a, c), d);
        b.tri_max[i] = vmax(vmax(a, c), d);
    }
    b.order.resize(n_tris);

    std::vector<int32_t> idx(n_tris);
    for (int i = 0; i < n_tris; ++i) idx[i] = i;
    int n_nodes = b.build(idx.data(), n_tris);

    // Skip links: skip(left(n)) = right(n); skip(right(n)) = skip(n).
    const int32_t SENTINEL = INT32_MAX;
    std::vector<int32_t> skip(n_nodes, SENTINEL);
    std::vector<int32_t> stack = {0};
    while (!stack.empty()) {
        int32_t nid = stack.back();
        stack.pop_back();
        int32_t rid = b.node_right[nid];
        if (rid >= 0) {
            skip[nid + 1] = rid;
            skip[rid] = skip[nid];
            stack.push_back(nid + 1);
            stack.push_back(rid);
        }
    }

    std::memcpy(out_aabb_min, b.node_min.data(), n_nodes * sizeof(Vec3));
    std::memcpy(out_aabb_max, b.node_max.data(), n_nodes * sizeof(Vec3));
    std::memcpy(out_first, b.node_first.data(), n_nodes * sizeof(int32_t));
    std::memcpy(out_count, b.node_count.data(), n_nodes * sizeof(int32_t));
    std::memcpy(out_skip, skip.data(), n_nodes * sizeof(int32_t));
    std::memcpy(out_order, b.order.data(), n_tris * sizeof(int32_t));
    return n_nodes;
}

}  // extern "C"
