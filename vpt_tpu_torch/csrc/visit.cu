// Packet closest-hit (or any-hit) visit of culled candidate groups.
//
// Replaces the Pallas kernel
//   vpt_visit  <- vpt_tpu/accel/visit_kernel.py  visit_pallas (_visit_kernel)
//
// What it computes.  Ray i of packet p (512 rays) walks its packet's
// entry-sorted candidate groups order[p, :nvis[p]] front to back, with its
// own best t (tmax at first); an inactive ray walks nothing.
//   - The walk ends at the first candidate whose packet entry is not below
//     the ray's best t.  The packet's entry of a group is the least entry of
//     its active rays, so it never exceeds the ray's own: no member the walk
//     skips could be entered within best t.
//   - A member cluster with triangles is entered, in index order, where the
//     ray meets its world box within the current best t.
//   - The ray moves to the instance's local space, and each of the cluster's
//     8 mesh-local sub-block boxes (16 triangles each; an empty one is
//     skipped by count) that it enters within the current best t runs its 16
//     Moller-Trumbore tests, in index order.  The smallest index wins a t tie
//     inside a sub-block; otherwise only a strictly closer hit replaces the
//     current one.  An any-hit ray stops at the first sub-block that holds a
//     hit and takes that sub-block's closest hit.
// Every gate is the ray's own.  The Pallas kernel gates a member on "any
// live ray of the packet enters it"; a ray that does not enter a member's
// world box itself cannot hit its triangles but by rounding, so the plain
// version, accel/visit.py, now carries the per-ray gate too, and the two
// agree exactly.
//
// What bounds it on the H100.  The work the rays need is that of csrc/
// trace.cu's stream kernel on the same rays (~0.4 GFLOP, ~20 MB for 262,144
// bounce rays: ~6 us); its time goes to latency and divergence.  The parent
// design, one 512-thread block per packet, paid a block-wide barrier per
// member and per sub-block and a shared-memory stage per entered cluster,
// and the packet's other rays waited at each of them.  So, as trace.cu does,
// this kernel gives each ray a warp of its own (4 per 128-thread block) and
// spends the lanes on the parallel parts of one ray's walk:
//   - 32 candidates per step, lane k taking candidate g0 + k: its packet
//     entry, its id and its group box, which the lane takes as the union of
//     the group's 8 member boxes (12 16-byte loads; the C interface carries
//     no group boxes).  A box holds each member's, and the slab roundings are
//     monotone, so a ray that misses the union misses every member: the group
//     test only saves work.  One ballot keeps the groups entered within best
//     t;
//   - lanes 0..7 test the group's 8 member boxes, loading each member's
//     count, block, triangle base and instance for the warp to share;
//   - lanes 0..7 test the entered cluster's 8 sub-block boxes;
//   - lanes 0..15 and 16..31 run the Moller-Trumbore tests of the next two
//     entered sub-blocks s < s', each lane loading its own triangle.  Two
//     warp min-reductions keep the sequential semantics: first s's closest
//     hit, then s' only if the ray still enters its box within the new best
//     t, and only a strictly closer hit.
// K = 128, 8 sub-blocks and 8 members per group are compile-time constants;
// the wrapper raises on other shapes.
//
// Built with --fmad=false so the slab and Moller-Trumbore arithmetic rounds
// exactly like the plain torch version, which makes every gate agree.

#include "traverse.cuh"

namespace {

using namespace vpt;

constexpr int kPacket = 512;  // rays per packet (visit.py PACKET)
constexpr int kWarps = 4;     // rays per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kNoKey = 0xffffffffu;  // above the key of every t but NaN

// An unsigned key that orders like the float t; -0.0 and +0.0 get the same
// key, since they compare equal, so equal t resolve to the lower lane.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned b = __float_as_uint(t + 0.0f);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

struct Tables {
  const float* aabbs;      // (C, 6) world boxes [lo.xyz, hi.xyz]
  const int32_t* count;    // (C,)
  const int32_t* start;    // (C,) virtual triangle id base
  const int32_t* block_id; // (C,) row of tris / sub_aabbs
  const int32_t* inst;     // (C,) instance
  const float* inv_rows;   // (n_inst, 12) world -> local affines
  const float* tris;       // (B, 16, K) rows 0..8 = p0, e1, e2 components
  const float* sub_aabbs;  // (B, 8, 6) mesh-local sub-block boxes
};

// The search state of the warp's ray; every lane holds the same copy.
struct Search {
  float best;  // closest hit so far, tmax at first
  int32_t best_tri;
  float best_u, best_v;
  bool live;  // still searching
};

// Take the closest hit among the lanes with `cand` (the lowest lane on equal
// t); every candidate's t is below the current best.
template <bool ANY_HIT>
__device__ __forceinline__ void take(bool cand, float t, float u, float v, int32_t id, Search& S) {
  const unsigned key = cand ? order_key(t) : kNoKey;
  const unsigned low = __reduce_min_sync(kFull, key);
  if (low == kNoKey) return;
  const int win = __ffs(__ballot_sync(kFull, key == low)) - 1;
  S.best = __shfl_sync(kFull, t, win);
  S.best_tri = __shfl_sync(kFull, id, win);
  S.best_u = __shfl_sync(kFull, u, win);
  S.best_v = __shfl_sync(kFull, v, win);
  if (ANY_HIT) S.live = false;
}

// A member cluster with triangles, entered by the warp's ray.
template <bool ANY_HIT, bool INSTANCED>
__device__ __forceinline__ void visit_cluster(const Tables& tb, const Member& mc, const Ray& w, float t_min,
                                              Search& S, int lane) {
  const int cnt = mc.count;
  const Ray l = INSTANCED ? to_instance(w, tb.inv_rows + 12 * (size_t)mc.inst) : w;
  // Lanes 0..7: the sub-block slabs, tf = the current best t.
  float tn_s = INFINITY;
  bool in_s = false;
  if (lane < kNSub && lane * kSub < cnt) {
    in_s = slab6(tb.sub_aabbs + ((size_t)mc.block * kNSub + lane) * 6, l, t_min, S.best, tn_s);
  }
  const float* block = tb.tris + (size_t)mc.block * 16 * kTris;
  const int half = lane >> 4, k = lane & 15;
  while (S.live) {
    // The next two sub-blocks still entered within the best t: lanes 0-15
    // test the first one's triangles, 16-31 the second's.
    const unsigned open = __ballot_sync(kFull, in_s && tn_s <= S.best);
    if (open == 0) break;
    const int sa = __ffs(open) - 1;
    const unsigned rest = open & (open - 1u);
    const int sb = rest ? __ffs(rest) - 1 : -1;
    if (lane == sa || lane == sb) in_s = false;
    const int s = half ? sb : sa;
    float t = INFINITY, u = 0.0f, v = 0.0f;
    bool valid = false;
    if (s >= 0 && s * kSub + k < cnt) {
      t = moller_trumbore(block + s * kSub + k, l, t_min, u, v, valid);
      valid = valid && t < S.best;
    }
    const int32_t id = mc.start + s * kSub + k;
    take<ANY_HIT>(valid && half == 0, t, u, v, id, S);
    // The second sub-block as if visited after the first: only if the ray
    // still enters its box within the new best t, and only a closer hit.
    if (sb >= 0 && S.live && __shfl_sync(kFull, tn_s, sb) <= S.best) {
      take<ANY_HIT>(valid && half == 1 && t < S.best, t, u, v, id, S);
    }
  }
}

// Lane k's candidate group box: the union of the group's 8 member boxes, the
// 48 floats of their (8, 6) rows read as 12 16-byte loads.  Pad members
// (lo 3e9, hi -3e9) change neither bound.
__device__ __forceinline__ void group_box(const float* rows, float* lo, float* hi) {
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  float f[48];
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    const float4 x = r4[q];
    f[4 * q] = x.x, f[4 * q + 1] = x.y, f[4 * q + 2] = x.z, f[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = f[a];
    hi[a] = f[3 + a];
#pragma unroll
    for (int m = 1; m < kGroup; ++m) {
      lo[a] = fminf(lo[a], f[6 * m + a]);
      hi[a] = fmaxf(hi[a], f[6 * m + 3 + a]);
    }
  }
}

template <bool ANY_HIT, bool INSTANCED>
__global__ void __launch_bounds__(kThreads) visit_kernel(
    Tables tb, const int32_t* __restrict__ nvis, const int32_t* __restrict__ order,
    const float* __restrict__ entry, const float* __restrict__ origin, const float* __restrict__ direction,
    const int32_t* __restrict__ act, const float* __restrict__ tmax, int n, int gp, float t_min,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);  // the warp's ray
  if (i >= n) return;
  const int p = i / kPacket;
  const Ray w = load_ray(origin, direction, i);
  Search S{tmax[i], -1, 0.0f, 0.0f, act[i] != 0};

  const int nv = nvis[p];
  const int32_t* ord = order + (size_t)p * gp;
  const float* ent = entry + (size_t)p * gp;
  bool walking = S.live;
  for (int g0 = 0; g0 < nv && walking; g0 += 32) {
    const int gi = g0 + lane;
    const bool listed = gi < nv;
    // Loads first, gates after: two dependent round trips per step.
    const float e = listed ? ent[gi] : INFINITY;
    const int g = listed ? ord[gi] : 0;
    float lo[3], hi[3];
    group_box(tb.aabbs + 6 * kGroup * (size_t)g, lo, hi);
    // Entries are sorted, so the walked candidates are a prefix of the step.
    const bool go = listed && e < S.best;
    if (__any_sync(kFull, !go)) walking = false;
    float tn_g = INFINITY;
    const bool in_g = go && slab(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2], w, t_min, S.best, tn_g);
    unsigned todo = __ballot_sync(kFull, in_g);
    while (todo != 0 && S.live) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (!(__shfl_sync(kFull, e, src) < S.best)) {  // the walk ends here
        walking = false;
        break;
      }
      if (!(__shfl_sync(kFull, tn_g, src) <= S.best)) continue;
      // Lanes 0..7: the member clusters' world slabs, with each member's
      // table row loaded alongside for the lanes to share.
      const int c = __shfl_sync(kFull, g, src) * kGroup + (lane & (kGroup - 1));
      Member mb{0, 0, 0, 0};
      float tn_m = INFINITY;
      bool in_m = false;
      if (lane < kGroup) {
        mb = Member{tb.count[c], tb.block_id[c], tb.start[c], INSTANCED ? tb.inst[c] : 0};
        in_m = slab6(tb.aabbs + 6 * (size_t)c, w, t_min, S.best, tn_m) && mb.count > 0;
      }
      unsigned members = __ballot_sync(kFull, in_m);
      while (members != 0 && S.live) {
        const int m = __ffs(members) - 1;
        members &= members - 1u;
        if (!(__shfl_sync(kFull, tn_m, m) <= S.best)) continue;
        const Member cm{__shfl_sync(kFull, mb.count, m), __shfl_sync(kFull, mb.block, m),
                        __shfl_sync(kFull, mb.start, m), __shfl_sync(kFull, mb.inst, m)};
        visit_cluster<ANY_HIT, INSTANCED>(tb, cm, w, t_min, S, lane);
      }
    }
    if (!S.live) walking = false;
  }
  if (lane != 0) return;
  t_out[i] = S.best;
  tri_out[i] = S.best_tri;
  u_out[i] = S.best_u;
  v_out[i] = S.best_v;
}

}  // namespace

extern "C" int vpt_visit(
    const int32_t* nvis, const int32_t* order, const float* entry, const float* origin,
    const float* direction, const int32_t* act, const float* tmax, const float* aabbs,
    const int32_t* count, const int32_t* start, const int32_t* block_id, const int32_t* inst,
    const float* inv_rows, const float* tris, const float* sub_aabbs, int n_pk, int gp,
    int group_size, int k_tris, float t_min, int any_hit, int instanced, float* t_out,
    int32_t* tri_out, float* u_out, float* v_out, void* stream) {
  if (group_size != kGroup || k_tris != kTris) return (int)cudaErrorInvalidValue;
  if (n_pk <= 0) return 0;
  const Tables tb{aabbs, count, start, block_id, inst, inv_rows, tris, sub_aabbs};
  const int n = n_pk * kPacket;
  const int blocks = n / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    if (instanced) {
      visit_kernel<true, true><<<blocks, kThreads, 0, s>>>(tb, nvis, order, entry, origin, direction, act, tmax, n,
                                                           gp, t_min, t_out, tri_out, u_out, v_out);
    } else {
      visit_kernel<true, false><<<blocks, kThreads, 0, s>>>(tb, nvis, order, entry, origin, direction, act, tmax, n,
                                                            gp, t_min, t_out, tri_out, u_out, v_out);
    }
  } else if (instanced) {
    visit_kernel<false, true><<<blocks, kThreads, 0, s>>>(tb, nvis, order, entry, origin, direction, act, tmax, n,
                                                          gp, t_min, t_out, tri_out, u_out, v_out);
  } else {
    visit_kernel<false, false><<<blocks, kThreads, 0, s>>>(tb, nvis, order, entry, origin, direction, act, tmax, n,
                                                           gp, t_min, t_out, tri_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
