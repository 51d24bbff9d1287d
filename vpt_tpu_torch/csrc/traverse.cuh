// Device helpers shared by the warp-per-ray traversal kernels, trace.cu
// (stream, occlude) and visit.cu (the packet visit): the cluster shape, the
// NaN-propagating slab test, the instance transform and Moller-Trumbore.
// Every formula rounds like its plain torch version in
// vpt_tpu_torch/accel/traverse.py when built with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vpt {

constexpr int kTris = 128;           // K, triangles per cluster block
constexpr int kNSub = 8;             // sub-blocks per cluster
constexpr int kSub = kTris / kNSub;  // 16 triangles per sub-block
constexpr int kGroup = 8;            // member clusters per group
constexpr unsigned kFull = 0xffffffffu;

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

// Moller-Trumbore of the local ray against one triangle of a (16, K) block.
__device__ __forceinline__ float moller_trumbore(const float* tri, const Ray& l, float t_min, float& u, float& v,
                                                 bool& ok) {
  const float p0x = tri[0 * kTris], p0y = tri[1 * kTris], p0z = tri[2 * kTris];
  const float e1x = tri[3 * kTris], e1y = tri[4 * kTris], e1z = tri[5 * kTris];
  const float e2x = tri[6 * kTris], e2y = tri[7 * kTris], e2z = tri[8 * kTris];
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

}  // namespace vpt
