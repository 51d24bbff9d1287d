// Closest-hit and any-hit occlusion traversal of the cluster tables.
//
// Replaces two Pallas kernels:
//   vpt_stream   <- vpt_tpu/accel/stream.py   stream_pallas  (_stream_kernel)
//   vpt_occlude  <- vpt_tpu/accel/occlude.py  occlude_pallas (_occlude_kernel)
//
// One thread per ray of the key-sorted wavefront.  A ray in band b and
// supertile j walks its band's entry-sorted candidate groups (order[b, :ngrp]):
//   - it stops when the band's entry distance exceeds its own best t (closest
//     hit) or its tmax (occlusion): entries are sorted and the band's entry
//     into a group never exceeds the ray's own, so the stop is exact;
//   - it skips groups whose supertile bit is clear or whose supertile entry
//     already lies beyond its best t;
//   - for each member cluster with cnt > 0 it runs the world-space slab test,
//     moves the ray into the instance's local space (direction left
//     unnormalised so t stays world-parametric), and runs Moller-Trumbore
//     over the cluster's triangles in index order with a strict '<'.
// On equal t the first triangle in visit order wins, as in the Pallas kernel.
// An any-hit ray (flags bit 1) stops at its first hit; an occlusion ray stops
// at its first triangle whose virtual id differs from its exclude id.
//
// What bounds it on the H100: the traversal is latency- and divergence-bound,
// not FLOP- or bandwidth-bound.  Each (ray, entered cluster) pair costs one
// 24-byte box read and up to K = 128 triangle tests of about 40 float
// operations, with loop trip counts that differ from ray to ray.  The simple
// design relies on the key sort: neighbouring threads of a warp share their
// first candidate groups, so their triangle reads hit the same addresses
// (broadcast through L1) and their loops diverge little.  The cluster tables
// (C x 24 B boxes, about 100 KB on the colonnade scene) stay in global
// memory, where L1/L2 cache them, instead of crowding out occupancy in
// shared memory.  Triangles are read from the component-major (B, 16, K)
// blocks of ClusterData.tris.
//
// Built with --fmad=false so the slab and Moller-Trumbore arithmetic rounds
// exactly like the plain torch versions, which makes culling decisions agree.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSupertile = 1024;

__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float guarded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

struct Tables {
  const int32_t* ngrp;        // (B,)
  const int32_t* order;       // (B, Gp) entry-sorted group ids
  const float* entry_sorted;  // (B, Gp)
  const int64_t* bits;        // (B, Gp) supertile masks, bit j = supertile j
  const float* sent;          // (B, T, Gp) per-supertile entry, +inf = none
  const float* aabbs;         // (C, 6) world boxes [lo.xyz, hi.xyz]
  const int32_t* count;       // (C,)
  const int32_t* start;       // (C,) virtual triangle id base
  const int32_t* block_id;    // (C,) row of tris
  const int32_t* inst;        // (C,) instance
  const float* inv_rows;      // (n_inst, 12) world -> local affines
  const float* tris;          // (Bk, 16, K) rows 0..8 = p0, e1, e2 components
};

template <bool OCCLUDE, bool INSTANCED>
__global__ void trace_kernel(
    Tables tb, const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ tmax_in, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ extri_in, int n, int tiles, int gp,
    int group_size, int k_tris, float t_min,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int32_t* __restrict__ blocked_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int band = tiles * kSupertile;
  const int b = i / band;
  const int j = (i - b * band) / kSupertile;

  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1], dz = direction[3 * i + 2];
  const float ix = guarded_inv(dx), iy = guarded_inv(dy), iz = guarded_inv(dz);
  const float tmax = tmax_in[i];
  const int32_t fl = flags[i];
  const bool active = (fl & 1) != 0;
  const bool anyhit = !OCCLUDE && (fl & 2) != 0;
  const int32_t extri = OCCLUDE ? extri_in[i] : -1;

  float best = tmax;  // closest hit so far; occlusion keeps tmax
  int32_t best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool done = !active;

  const int ng = tb.ngrp[b];
  const int32_t* order = tb.order + (size_t)b * gp;
  const float* entry = tb.entry_sorted + (size_t)b * gp;
  const int64_t* bits = tb.bits + (size_t)b * gp;
  const float* sent = tb.sent + ((size_t)b * tiles + j) * gp;

  for (int gi = 0; gi < ng && !done; ++gi) {
    if (entry[gi] > best) break;
    const int g = order[gi];
    if (((bits[g] >> j) & 1) == 0) continue;
    if (sent[g] > best) continue;
    for (int m = 0; m < group_size && !done; ++m) {
      const int c = g * group_size + m;
      const int cnt = tb.count[c];
      if (cnt <= 0) continue;
      const float* box = tb.aabbs + 6 * (size_t)c;
      float tn = t_min, tf = best;
      float s0 = (box[0] - ox) * ix, s1 = (box[3] - ox) * ix;
      tn = pmax(tn, pmin(s0, s1));
      tf = pmin(tf, pmax(s0, s1));
      s0 = (box[1] - oy) * iy;
      s1 = (box[4] - oy) * iy;
      tn = pmax(tn, pmin(s0, s1));
      tf = pmin(tf, pmax(s0, s1));
      s0 = (box[2] - oz) * iz;
      s1 = (box[5] - oz) * iz;
      tn = pmax(tn, pmin(s0, s1));
      tf = pmin(tf, pmax(s0, s1));
      if (!(tn <= tf)) continue;

      float lox = ox, loy = oy, loz = oz, ldx = dx, ldy = dy, ldz = dz;
      if (INSTANCED) {
        const float* T = tb.inv_rows + 12 * (size_t)tb.inst[c];
        lox = T[0] * ox + T[1] * oy + T[2] * oz + T[3];
        loy = T[4] * ox + T[5] * oy + T[6] * oz + T[7];
        loz = T[8] * ox + T[9] * oy + T[10] * oz + T[11];
        ldx = T[0] * dx + T[1] * dy + T[2] * dz;
        ldy = T[4] * dx + T[5] * dy + T[6] * dz;
        ldz = T[8] * dx + T[9] * dy + T[10] * dz;
      }
      const float* blk = tb.tris + (size_t)tb.block_id[c] * 16 * k_tris;
      const int32_t base = tb.start[c];
      for (int k = 0; k < cnt; ++k) {
        const float p0x = blk[0 * k_tris + k], p0y = blk[1 * k_tris + k], p0z = blk[2 * k_tris + k];
        const float e1x = blk[3 * k_tris + k], e1y = blk[4 * k_tris + k], e1z = blk[5 * k_tris + k];
        const float e2x = blk[6 * k_tris + k], e2y = blk[7 * k_tris + k], e2z = blk[8 * k_tris + k];
        const float pvx = ldy * e2z - ldz * e2y;
        const float pvy = ldz * e2x - ldx * e2z;
        const float pvz = ldx * e2y - ldy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool ok_det = fabsf(det) > 1e-12f;
        const float inv_det = ok_det ? 1.0f / det : 0.0f;
        const float tvx = lox - p0x, tvy = loy - p0y, tvz = loz - p0z;
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (ldx * qvx + ldy * qvy + ldz * qvz) * inv_det;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        const bool valid = ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                           t > t_min && t < best;
        if (!valid) continue;
        if (OCCLUDE) {
          if (base + k != extri) {
            done = true;
            break;
          }
        } else {
          best = t;
          best_tri = base + k;
          best_u = u;
          best_v = v;
          if (anyhit) {
            done = true;
            break;
          }
        }
      }
    }
  }
  if (OCCLUDE) {
    blocked_out[i] = (active && done) ? 1 : 0;
  } else {
    t_out[i] = best;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

template <bool OCCLUDE>
int launch(const Tables& tb, const float* origin, const float* direction,
           const float* tmax, const int32_t* flags, const int32_t* extri, int n,
           int tiles, int gp, int group_size, int k_tris, float t_min,
           int instanced, float* t_out, int32_t* tri_out, float* u_out,
           float* v_out, int32_t* blocked_out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (instanced) {
    trace_kernel<OCCLUDE, true><<<blocks, threads, 0, stream>>>(
        tb, origin, direction, tmax, flags, extri, n, tiles, gp, group_size,
        k_tris, t_min, t_out, tri_out, u_out, v_out, blocked_out);
  } else {
    trace_kernel<OCCLUDE, false><<<blocks, threads, 0, stream>>>(
        tb, origin, direction, tmax, flags, extri, n, tiles, gp, group_size,
        k_tris, t_min, t_out, tri_out, u_out, v_out, blocked_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vpt_stream(
    const int32_t* ngrp, const int32_t* order, const float* entry_sorted,
    const int64_t* bits, const float* sent, const float* origin,
    const float* direction, const float* tmax, const int32_t* flags,
    const float* aabbs, const int32_t* count, const int32_t* start,
    const int32_t* block_id, const int32_t* inst, const float* inv_rows,
    const float* tris, int n, int tiles, int gp, int group_size, int k_tris,
    float t_min, int instanced, float* t_out, int32_t* tri_out, float* u_out,
    float* v_out, void* stream) {
  Tables tb{ngrp, order, entry_sorted, bits, sent, aabbs, count, start,
            block_id, inst, inv_rows, tris};
  return launch<false>(tb, origin, direction, tmax, flags, nullptr, n, tiles, gp,
                       group_size, k_tris, t_min, instanced, t_out, tri_out,
                       u_out, v_out, nullptr, (cudaStream_t)stream);
}

extern "C" int vpt_occlude(
    const int32_t* ngrp, const int32_t* order, const float* entry_sorted,
    const int64_t* bits, const float* sent, const float* origin,
    const float* direction, const float* tmax, const int32_t* act,
    const int32_t* extri, const float* aabbs, const int32_t* count,
    const int32_t* start, const int32_t* block_id, const int32_t* inst,
    const float* inv_rows, const float* tris, int n, int tiles, int gp,
    int group_size, int k_tris, float t_min, int instanced,
    int32_t* blocked_out, void* stream) {
  Tables tb{ngrp, order, entry_sorted, bits, sent, aabbs, count, start,
            block_id, inst, inv_rows, tris};
  return launch<true>(tb, origin, direction, tmax, act, extri, n, tiles, gp,
                      group_size, k_tris, t_min, instanced, nullptr, nullptr,
                      nullptr, nullptr, blocked_out, (cudaStream_t)stream);
}
