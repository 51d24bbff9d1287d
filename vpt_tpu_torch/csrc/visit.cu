// Packet-major closest-hit (or any-hit) visit of culled candidate groups.
//
// Replaces the Pallas kernel
//   vpt_visit  <- vpt_tpu/accel/visit_kernel.py  visit_pallas (_visit_kernel)
//
// One 512-thread block per packet, one thread per ray.
// The packet marches its entry-sorted candidate groups (order[p, :nvis]):
//   - group w+1 is visited while entry[w+1] < cap, the block maximum of the
//     live rays' best t (live = active, and without a hit yet under any-hit);
//   - each of the group's member clusters passes a packet-level gate first:
//     does any ray enter the world box, with tf = best t for live rays and
//     t_min for the others (__syncthreads_or)?
//   - an entered member's 9 x K triangle components and its 8 sub-block
//     boxes are staged in shared memory once; each thread moves its ray into
//     the instance's local space (direction left unnormalised, so t stays
//     world-parametric);
//   - for each sub-block, a per-ray slab test of its mesh-local box against
//     the current best t and a block-level any gate, then Moller-Trumbore
//     over its K/8 triangles for the rays that entered.  Within a sub-block
//     the smallest index wins a t tie (ascending scan with a strict '<');
//     across sub-blocks and clusters only a strictly closer hit replaces the
//     current one.
// These are the Pallas kernel's semantics, not its schedule: the Pallas
// kernel overlaps one member's DMA with the previous member's triangle math,
// so its gates read a best t that lags by one cluster.  Here every gate reads
// the current best t, which only skips work that could not change a hit.
//
// What bounds it on the H100: per packet and entered member, the block
// spends one 4.6 KB shared-memory stage and up to 8 x 16 triangle tests of
// about 40 float operations per ray, with block-wide barriers between the
// gates.  The key sort upstream makes packet mates share candidates, so the
// gates skip most members and the staged triangles serve all 512 rays
// (broadcast reads).  Cluster tables (world boxes, counts, transforms) stay
// in global memory, where L1/L2 cache them.
//
// Built with --fmad=false so the slab and Moller-Trumbore arithmetic rounds
// exactly like the plain torch version, which makes every gate agree.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNSub = 8;       // sub-blocks per cluster
constexpr int kPacket = 512;  // rays per packet = threads per block

__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float guarded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

// Does the ray (o, inv) enter box [lo, hi] within (t_min, tf]?
__device__ __forceinline__ bool slab(const float* lo, const float* hi, float ox, float oy, float oz,
                                     float ix, float iy, float iz, float t_min, float tf) {
  float tn = t_min;
  float s0 = (lo[0] - ox) * ix, s1 = (hi[0] - ox) * ix;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  s0 = (lo[1] - oy) * iy;
  s1 = (hi[1] - oy) * iy;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  s0 = (lo[2] - oz) * iz;
  s1 = (hi[2] - oz) * iz;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  return tn <= tf;
}

struct VisitArgs {
  const int32_t* nvis;        // (P,) candidate groups per packet
  const int32_t* order;       // (P, Gp) entry-sorted group ids
  const float* entry;         // (P, Gp) sorted entry distances, +inf padded
  const float* origin;        // (P, 512, 3)
  const float* direction;     // (P, 512, 3)
  const int32_t* act;         // (P, 512)
  const float* tmax;          // (P, 512)
  const float* aabbs;         // (C, 6) world boxes [lo.xyz, hi.xyz]
  const int32_t* count;       // (C,)
  const int32_t* start;       // (C,) virtual triangle id base
  const int32_t* block_id;    // (C,) row of tris / sub_aabbs
  const int32_t* inst;        // (C,) instance
  const float* inv_rows;      // (n_inst, 12) world -> local affines
  const float* tris;          // (B, 16, K) rows 0..8 = p0, e1, e2 components
  const float* sub_aabbs;     // (B, 8, 6) mesh-local sub-block boxes
  int gp, group_size, k_tris;
  float t_min;
  float* t_out;
  int32_t* tri_out;
  float* u_out;
  float* v_out;
};

// Block maximum of x; every thread gets it.  `scratch` holds one float per warp.
__device__ float block_max(float x, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = scratch[0];
  for (int i = 1; i < kPacket / 32; ++i) m = fmaxf(m, scratch[i]);
  __syncthreads();  // scratch is free again
  return m;
}

template <bool ANY_HIT, bool INSTANCED>
__global__ void __launch_bounds__(kPacket) visit_kernel(VisitArgs a) {
  extern __shared__ float smem[];
  const int K = a.k_tris;
  const int sub = K / kNSub;
  float* s_tri = smem;                  // [9][K]
  float* s_box = smem + 9 * K;          // [8][6]
  float* s_red = s_box + kNSub * 6;     // [warps]

  const int p = blockIdx.x;
  const size_t i = (size_t)p * kPacket + threadIdx.x;
  const float ox = a.origin[3 * i], oy = a.origin[3 * i + 1], oz = a.origin[3 * i + 2];
  const float dx = a.direction[3 * i], dy = a.direction[3 * i + 1], dz = a.direction[3 * i + 2];
  const float ix = guarded_inv(dx), iy = guarded_inv(dy), iz = guarded_inv(dz);
  const bool act = a.act[i] != 0;
  const float t_min = a.t_min;

  float best = a.tmax[i];
  int32_t best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;

  const int nv = a.nvis[p];
  const int32_t* order = a.order + (size_t)p * a.gp;
  const float* entry = a.entry + (size_t)p * a.gp;

  bool cont = nv > 0;
  for (int w = 0; cont;) {
    const int g = order[w];
    for (int m = 0; m < a.group_size; ++m) {
      const int c = g * a.group_size + m;
      const bool live = act && (!ANY_HIT || best_tri < 0);
      const float* box = a.aabbs + 6 * (size_t)c;
      const bool enter = slab(box, box + 3, ox, oy, oz, ix, iy, iz, t_min, live ? best : t_min);
      if (!__syncthreads_or(enter)) continue;
      const int cnt = a.count[c];
      if (cnt <= 0) continue;  // an empty slot: no triangle could hit

      const int blk = a.block_id[c];
      const float* src = a.tris + (size_t)blk * 16 * K;
      for (int e = threadIdx.x; e < 9 * K; e += kPacket) s_tri[e] = src[e];
      const float* sb = a.sub_aabbs + (size_t)blk * kNSub * 6;
      for (int e = threadIdx.x; e < kNSub * 6; e += kPacket) s_box[e] = sb[e];
      __syncthreads();

      float lox = ox, loy = oy, loz = oz, ldx = dx, ldy = dy, ldz = dz;
      float lix = ix, liy = iy, liz = iz;
      if (INSTANCED) {
        const float* T = a.inv_rows + 12 * (size_t)a.inst[c];
        lox = T[0] * ox + T[1] * oy + T[2] * oz + T[3];
        loy = T[4] * ox + T[5] * oy + T[6] * oz + T[7];
        loz = T[8] * ox + T[9] * oy + T[10] * oz + T[11];
        ldx = T[0] * dx + T[1] * dy + T[2] * dz;
        ldy = T[4] * dx + T[5] * dy + T[6] * dz;
        ldz = T[8] * dx + T[9] * dy + T[10] * dz;
        lix = guarded_inv(ldx);
        liy = guarded_inv(ldy);
        liz = guarded_inv(ldz);
      }
      const int32_t base = a.start[c];
      for (int s = 0; s < kNSub; ++s) {
        const bool live_s = act && (!ANY_HIT || best_tri < 0);
        const bool enter_s =
            live_s && slab(s_box + 6 * s, s_box + 6 * s + 3, lox, loy, loz, lix, liy, liz, t_min, best);
        if (!__syncthreads_or(enter_s) || !enter_s) continue;
        const float bt = best;
        float tb = INFINITY, ub = 0.0f, vb = 0.0f;
        int jb = 0;
        for (int j = 0; j < sub; ++j) {
          const int k = s * sub + j;
          const float p0x = s_tri[0 * K + k], p0y = s_tri[1 * K + k], p0z = s_tri[2 * K + k];
          const float e1x = s_tri[3 * K + k], e1y = s_tri[4 * K + k], e1z = s_tri[5 * K + k];
          const float e2x = s_tri[6 * K + k], e2y = s_tri[7 * K + k], e2z = s_tri[8 * K + k];
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
          const bool valid = ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
                             t < bt && k < cnt;
          if (valid && t < tb) {
            tb = t;
            jb = j;
            ub = u;
            vb = v;
          }
        }
        if (tb < bt) {
          best = tb;
          best_tri = base + s * sub + jb;
          best_u = ub;
          best_v = vb;
        }
      }
      __syncthreads();  // every thread is done with the staged cluster
    }
    const bool live = act && (!ANY_HIT || best_tri < 0);
    const float cap = block_max(live ? best : 0.0f, s_red);
    ++w;
    cont = w < nv && entry[w] < cap;
  }
  a.t_out[i] = best;
  a.tri_out[i] = best_tri;
  a.u_out[i] = best_u;
  a.v_out[i] = best_v;
}

template <bool ANY_HIT, bool INSTANCED>
int launch(const VisitArgs& a, int n_pk, cudaStream_t stream) {
  const size_t smem = (size_t)(9 * a.k_tris + kNSub * 6 + kPacket / 32) * sizeof(float);
  visit_kernel<ANY_HIT, INSTANCED><<<n_pk, kPacket, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vpt_visit(
    const int32_t* nvis, const int32_t* order, const float* entry, const float* origin,
    const float* direction, const int32_t* act, const float* tmax, const float* aabbs,
    const int32_t* count, const int32_t* start, const int32_t* block_id, const int32_t* inst,
    const float* inv_rows, const float* tris, const float* sub_aabbs, int n_pk, int gp,
    int group_size, int k_tris, float t_min, int any_hit, int instanced, float* t_out,
    int32_t* tri_out, float* u_out, float* v_out, void* stream) {
  if (n_pk <= 0) return 0;
  const VisitArgs a{nvis, order, entry, origin, direction, act, tmax, aabbs, count, start,
                    block_id, inst, inv_rows, tris, sub_aabbs, gp, group_size, k_tris, t_min,
                    t_out, tri_out, u_out, v_out};
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) return instanced ? launch<true, true>(a, n_pk, s) : launch<true, false>(a, n_pk, s);
  return instanced ? launch<false, true>(a, n_pk, s) : launch<false, false>(a, n_pk, s);
}
