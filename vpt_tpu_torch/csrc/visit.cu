// Packet closest-hit (or any-hit) visit of culled candidate groups.
//
// Replaces the Pallas kernel
//   vpt_visit  <- vpt_tpu/accel/visit_kernel.py  visit_pallas (_visit_kernel)
//
// What it computes.  Ray i of packet p (P rays: 512 by default,
// VPT_PACKET_SIZE, a run-time argument) walks its packet's
// entry-sorted candidate groups order[p, :nvis[p]] front to back, with its
// own best t (tmax at first); an inactive ray walks nothing.
//   - The walk ends at the first candidate whose packet entry is not below
//     the ray's best t.  The packet's entry of a group is the least entry of
//     its active rays, so it never exceeds the ray's own: no member the walk
//     skips could be entered within best t.
//   - A member cluster with triangles is entered, in index order, where the
//     ray meets its world box within the current best t.
//   - The ray moves to the instance's local space, and each of the cluster's
//     8 mesh-local sub-block boxes (K / 8 triangles each; an empty one is
//     skipped by count) that it enters within the current best t runs its
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
//     the group's G member boxes (for G = 8, 12 16-byte loads; the C
//     interface carries no group boxes).  A box holds each member's, and the slab roundings are
//     monotone, so a ray that misses the union misses every member: the group
//     test only saves work.  One ballot keeps the groups entered within best
//     t;
//   - lanes 0..G-1 test the group's G member boxes (G <= 32), loading each
//     member's count, block, triangle base and instance for the warp to
//     share;
//   - lanes 0..7 test the entered cluster's 8 sub-block boxes;
//   - the lanes run the Moller-Trumbore tests of the next entered
//     sub-blocks s < s' < ... (traverse.cuh TriLayout: at K = 128 lanes
//     0..15 and 16..31 take two sub-blocks of 16), each lane loading its own
//     triangle.  One warp min-reduction per sub-block keeps the sequential
//     semantics: first s's closest hit, then s' only if the ray still enters
//     its box within the new best t, and only a strictly closer hit; a
//     sub-block above 32 triangles takes passes of 32, a later one only a
//     closer hit.
// The layout as in trace.cu: K a template constant for 32-1024 in powers of
// two and a run-time value otherwise, the group size and P run-time values;
// the wrapper raises on a layout outside these.
//
// Built with --fmad=false so the slab and Moller-Trumbore arithmetic rounds
// exactly like the plain torch version, which makes every gate agree.

#include "traverse.cuh"

namespace {

using namespace vpt;

constexpr int kWarps = 4;  // rays per block, one warp each
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
// t); every candidate's t is below the current best.  Returns whether it
// took one.
__device__ __forceinline__ bool take(bool cand, float t, float u, float v, int32_t id, Search& S) {
  const unsigned key = cand ? order_key(t) : kNoKey;
  const unsigned low = __reduce_min_sync(kFull, key);
  if (low == kNoKey) return false;
  const int win = __ffs(__ballot_sync(kFull, key == low)) - 1;
  S.best = __shfl_sync(kFull, t, win);
  S.best_tri = __shfl_sync(kFull, id, win);
  S.best_u = __shfl_sync(kFull, u, win);
  S.best_v = __shfl_sync(kFull, v, win);
  return true;
}

// A member cluster with triangles, entered by the warp's ray.
template <bool ANY_HIT, bool INSTANCED>
__device__ __forceinline__ void visit_cluster(const Tables& tb, const Member& mc, const Ray& w, float t_min,
                                              Search& S, int lane, const TriLayout& L) {
  const int cnt = mc.count;
  const Ray l = INSTANCED ? to_instance(w, tb.inv_rows + 12 * (size_t)mc.inst) : w;
  // Lanes 0..7: the sub-block slabs, tf = the current best t.
  float tn_s = INFINITY;
  bool in_s = false;
  if (lane < kNSub && lane * L.sub < cnt) {
    in_s = slab6(tb.sub_aabbs + ((size_t)mc.block * kNSub + lane) * 6, l, t_min, S.best, tn_s);
  }
  const float* block = tb.tris + (size_t)mc.block * 16 * L.k;
  const int slot = lane / L.lanes, k0 = lane - slot * L.lanes;
  while (S.live) {
    // The next per_pass sub-blocks still entered within the best t: lane
    // slot * lanes + k0 tests triangle k0 of the slot-th (with K = 128,
    // lanes 0-15 the first sub-block, 16-31 the second).
    const unsigned open = __ballot_sync(kFull, in_s && tn_s <= S.best);
    if (open == 0) break;
    const int s = pass_block(open, L, lane, slot, in_s);
    bool took = false;
    for (int c = 0; c < L.chunks; ++c) {
      const int k = L.chunks == 1 ? k0 : c * 32 + k0;
      float t = INFINITY, u = 0.0f, v = 0.0f;
      bool valid = false;
      if (s >= 0 && (L.chunks == 1 || k < L.sub) && s * L.sub + k < cnt) {
        t = moller_trumbore(block + s * L.sub + k, l, t_min, u, v, valid, L.k);
        valid = valid && t < S.best;
      }
      const int32_t id = mc.start + s * L.sub + k;
      // The pass's sub-blocks as if visited one after another: a later one
      // only if the ray still enters its box within the new best t, and
      // only a closer hit; a sub-block's later chunk only a closer hit.  An
      // any-hit ray takes the closest hit of its first sub-block that holds
      // one and stops.
      unsigned rest = open;
      for (int q = 0; q < L.per_pass; ++q) {
        const int sq = rest ? __ffs(rest) - 1 : -1;  // the pass's q-th sub-block, as pass_block walks them
        rest &= rest - 1u;
        if (sq < 0) break;
        if (q > 0 && !(__shfl_sync(kFull, tn_s, sq) <= S.best)) continue;
        if (take(valid && slot == q && t < S.best, t, u, v, id, S)) {
          took = true;
          if (ANY_HIT) break;
        }
      }
    }
    if (ANY_HIT && took) S.live = false;
  }
}

// Lane k's candidate group box: the union of the group's member boxes.  A
// group of 8 reads the 48 floats of its (8, 6) rows as 12 16-byte loads; any
// other group size reads each member's row as three 8-byte loads.  Pad
// members (lo 3e9, hi -3e9) change neither bound.
__device__ __forceinline__ void group_box(const float* aabbs, int g, int group, float* lo, float* hi) {
  if (group == 8) {
    const float4* r4 = reinterpret_cast<const float4*>(aabbs + 48 * (size_t)g);
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
      for (int m = 1; m < 8; ++m) {
        lo[a] = fminf(lo[a], f[6 * m + a]);
        hi[a] = fmaxf(hi[a], f[6 * m + 3 + a]);
      }
    }
    return;
  }
  const float* rows = aabbs + 6 * (size_t)group * g;
  lo[0] = lo[1] = lo[2] = INFINITY;
  hi[0] = hi[1] = hi[2] = -INFINITY;
  for (int m = 0; m < group; ++m) {
    const float2 a = *reinterpret_cast<const float2*>(rows + 6 * m);
    const float2 b = *reinterpret_cast<const float2*>(rows + 6 * m + 2);
    const float2 c = *reinterpret_cast<const float2*>(rows + 6 * m + 4);
    lo[0] = fminf(lo[0], a.x), lo[1] = fminf(lo[1], a.y), lo[2] = fminf(lo[2], b.x);
    hi[0] = fmaxf(hi[0], b.y), hi[1] = fmaxf(hi[1], c.x), hi[2] = fmaxf(hi[2], c.y);
  }
}

template <bool ANY_HIT, bool INSTANCED, int K>
__global__ void __launch_bounds__(kThreads) visit_kernel(
    Tables tb, const int32_t* __restrict__ nvis, const int32_t* __restrict__ order,
    const float* __restrict__ entry, const float* __restrict__ origin, const float* __restrict__ direction,
    const int32_t* __restrict__ act, const float* __restrict__ tmax, int n, int packet, int gp, int group,
    int k_tris, float t_min, float* __restrict__ t_out, int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
  const TriLayout L = tri_layout<K>(k_tris);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);  // the warp's ray
  if (i >= n) return;
  const int p = i / packet;
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
    group_box(tb.aabbs, g, group, lo, hi);
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
      // Lanes 0..G-1: the member clusters' world slabs, with each member's
      // table row loaded alongside for the lanes to share.
      const int c = __shfl_sync(kFull, g, src) * group + lane;
      Member mb{0, 0, 0, 0};
      float tn_m = INFINITY;
      bool in_m = false;
      if (lane < group) {
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
        visit_cluster<ANY_HIT, INSTANCED>(tb, cm, w, t_min, S, lane, L);
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
    const float* inv_rows, const float* tris, const float* sub_aabbs, int n_pk, int packet, int gp,
    int group_size, int k_tris, float t_min, int any_hit, int instanced, float* t_out,
    int32_t* tri_out, float* u_out, float* v_out, void* stream) {
  if (!layout_ok(k_tris, group_size) || packet <= 0 || packet % kWarps != 0) return (int)cudaErrorInvalidValue;
  if (n_pk <= 0) return 0;
  const Tables tb{aabbs, count, start, block_id, inst, inv_rows, tris, sub_aabbs};
  const int n = n_pk * packet;
  const int blocks = n / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
#define VPT_VISIT_ONE(A, I, K)                                                                             \
  visit_kernel<A, I, K><<<blocks, kThreads, 0, s>>>(tb, nvis, order, entry, origin, direction, act, tmax, n, \
                                                    packet, gp, group_size, k_tris, t_min, t_out, tri_out,  \
                                                    u_out, v_out)
#define VPT_VISIT_LAUNCH(K)                      \
  if (any_hit) {                                 \
    if (instanced) {                             \
      VPT_VISIT_ONE(true, true, K);              \
    } else {                                     \
      VPT_VISIT_ONE(true, false, K);             \
    }                                            \
  } else if (instanced) {                        \
    VPT_VISIT_ONE(false, true, K);               \
  } else {                                       \
    VPT_VISIT_ONE(false, false, K);              \
  }
  VPT_DISPATCH_K(k_tris, VPT_VISIT_LAUNCH)
#undef VPT_VISIT_LAUNCH
#undef VPT_VISIT_ONE
  return (int)cudaGetLastError();
}
