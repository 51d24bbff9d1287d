// Device helpers shared by the warp-per-ray traversal kernels, trace.cu
// (stream, occlude) and visit.cu (the packet visit): the cluster layout, the
// NaN-propagating slab test, the instance transform and Moller-Trumbore.
// Every formula rounds like its plain torch version in
// vpt_tpu_torch/accel/traverse.py when built with --fmad=false.
//
// The cluster layout (VPT_CLUSTER_SIZE, VPT_GROUP_SIZE).  A cluster block
// holds K triangles (a multiple of 8) in 8 sub-blocks of K / 8; a group
// holds 1 to 32 member clusters, which lanes 0..G-1 test in one step.  The
// kernels are compiled for K in {32, 64, 128, 256, 512, 1024} (the default,
// 128, keeps its constants) and once more with K read at run time (K = 0 in
// the templates), which takes every other multiple of 8.  `TriLayout` says
// how one warp runs a cluster's triangle tests: a pass takes `per_pass`
// open sub-blocks at once, `lanes` lanes each (lane q * lanes + k takes
// triangle k of the pass's q-th sub-block), and a sub-block of more than 32
// triangles takes `chunks` passes of 32.  K = 128: two sub-blocks of 16 per
// pass, as before the layout knobs; K = 64: four of 8; K = 256: one of 32;
// K = 1024: one sub-block in four passes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vpt {

constexpr int kNSub = 8;     // sub-blocks per cluster
constexpr int kMaxGroup = 32;  // member clusters per group: at most one per lane
constexpr unsigned kFull = 0xffffffffu;

struct TriLayout {
  int k;         // K, triangles per cluster block: the stride of a block's component rows
  int sub;       // K / 8, triangles per sub-block
  int lanes;     // lanes per sub-block in a pass: min(sub, 32)
  int per_pass;  // sub-blocks per pass: min(32 / sub, 8), 1 above 32 triangles
  int chunks;    // passes over one sub-block: ceil(sub / 32)
};

// The layout of K triangles per cluster: compile-time constants for K > 0,
// from `k_rt` for K = 0.
template <int K>
__device__ __forceinline__ TriLayout tri_layout(int k_rt) {
  const int k = K > 0 ? K : k_rt;
  const int sub = k / kNSub;
  const int lanes = sub < 32 ? sub : 32;
  const int fit = 32 / lanes;
  return TriLayout{k, sub, lanes, sub > 32 ? 1 : (fit < kNSub ? fit : kNSub), (sub + 31) / 32};
}

// A pass over the open sub-blocks (`open`, warp-uniform: bit s set where
// sub-block s is still entered within the best t): its sub-blocks are the
// first per_pass set bits, in ascending index, each walked by every lane
// alike.  The lanes holding them (lanes 0..7 hold one sub-block each) take
// them out of `in_s`; returns the sub-block of this lane's slot, -1 if the
// pass has none for it.  At K = 128 this is the first two open sub-blocks,
// lanes 0-15 taking the first and 16-31 the second.
__device__ __forceinline__ int pass_block(unsigned open, const TriLayout& L, int lane, int slot, bool& in_s) {
  int s = -1;
  unsigned rest = open;
#pragma unroll
  for (int q = 0; q < kNSub; ++q) {
    if (q >= L.per_pass) break;
    const int sq = rest ? __ffs(rest) - 1 : -1;
    if (lane == sq) in_s = false;
    if (slot == q) s = sq;
    rest &= rest - 1u;
  }
  return s;
}

__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float guarded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin, const float* __restrict__ direction,
                                        size_t i) {
  Ray r;
  r.ox = origin[3 * i], r.oy = origin[3 * i + 1], r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i], r.dy = direction[3 * i + 1], r.dz = direction[3 * i + 2];
  r.ix = guarded_inv(r.dx), r.iy = guarded_inv(r.dy), r.iz = guarded_inv(r.dz);
  return r;
}

// Does the ray enter box [lx, ly, lz] - [hx, hy, hz] within (t_min, tf]?  The
// entry distance goes to `tn`.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx, float hy, float hz,
                                     const Ray& r, float t_min, float tf, float& tn) {
  tn = t_min;
  float s0 = (lx - r.ox) * r.ix, s1 = (hx - r.ox) * r.ix;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  s0 = (ly - r.oy) * r.iy;
  s1 = (hy - r.oy) * r.iy;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  s0 = (lz - r.oz) * r.iz;
  s1 = (hz - r.oz) * r.iz;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  return tn <= tf;
}

// A [lo.xyz, hi.xyz] box of six floats that starts at an even float, read as
// three 8-byte loads.
__device__ __forceinline__ bool slab6(const float* p, const Ray& r, float t_min, float tf, float& tn) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 2);
  const float2 c = *reinterpret_cast<const float2*>(p + 4);
  return slab(a.x, a.y, b.x, b.y, c.x, c.y, r, t_min, tf, tn);
}

// The world ray in an instance's local space, by its world -> local rows T
// (12 floats on a 16-byte boundary).  The direction stays unnormalised, so t
// stays world-parametric; local inverse 1 / where(|d| > 1e-20, d, 1e-20).
__device__ __forceinline__ Ray to_instance(const Ray& w, const float* T) {
  const float4* T4 = reinterpret_cast<const float4*>(T);
  const float4 r0 = T4[0], r1 = T4[1], r2 = T4[2];
  Ray l;
  l.ox = r0.x * w.ox + r0.y * w.oy + r0.z * w.oz + r0.w;
  l.oy = r1.x * w.ox + r1.y * w.oy + r1.z * w.oz + r1.w;
  l.oz = r2.x * w.ox + r2.y * w.oy + r2.z * w.oz + r2.w;
  l.dx = r0.x * w.dx + r0.y * w.dy + r0.z * w.dz;
  l.dy = r1.x * w.dx + r1.y * w.dy + r1.z * w.dz;
  l.dz = r2.x * w.dx + r2.y * w.dy + r2.z * w.dz;
  l.ix = guarded_inv(l.dx);
  l.iy = guarded_inv(l.dy);
  l.iz = guarded_inv(l.dz);
  return l;
}

// Moller-Trumbore of the local ray against one triangle of a (16, K) block,
// its component rows `k` floats apart.
__device__ __forceinline__ float moller_trumbore(const float* tri, const Ray& l, float t_min, float& u, float& v,
                                                 bool& ok, int k) {
  const float p0x = tri[0 * k], p0y = tri[1 * k], p0z = tri[2 * k];
  const float e1x = tri[3 * k], e1y = tri[4 * k], e1z = tri[5 * k];
  const float e2x = tri[6 * k], e2y = tri[7 * k], e2z = tri[8 * k];
  const float pvx = l.dy * e2z - l.dz * e2y;
  const float pvy = l.dz * e2x - l.dx * e2z;
  const float pvz = l.dx * e2y - l.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tvx = l.ox - p0x, tvy = l.oy - p0y, tvz = l.oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (l.dx * qvx + l.dy * qvy + l.dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  ok = ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min;
  return t;
}

// A member cluster's row of the cluster tables.
struct Member {
  int count, block, start, inst;
};

// Launch `kernel` compiled for K = k_tris, or its run-time-K build (K = 0)
// for a K outside {32, 64, 128, 256, 512, 1024}.
#define VPT_DISPATCH_K(k_tris, LAUNCH) \
  switch (k_tris) {                     \
    case 32: LAUNCH(32); break;         \
    case 64: LAUNCH(64); break;         \
    case 128: LAUNCH(128); break;       \
    case 256: LAUNCH(256); break;       \
    case 512: LAUNCH(512); break;       \
    case 1024: LAUNCH(1024); break;     \
    default: LAUNCH(0); break;          \
  }

// Whether the kernels take a layout: K a positive multiple of 8, 1 to 32
// clusters per group.
inline bool layout_ok(int k_tris, int group_size) {
  return k_tris > 0 && k_tris % kNSub == 0 && group_size >= 1 && group_size <= kMaxGroup;
}

}  // namespace vpt
