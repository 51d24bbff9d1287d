// Closest-hit and any-hit occlusion traversal of the cluster tables.
//
// Replaces two Pallas kernels:
//   vpt_stream   <- vpt_tpu/accel/stream.py   stream_pallas  (_stream_kernel)
//   vpt_occlude  <- vpt_tpu/accel/occlude.py  occlude_pallas (_occlude_kernel)
//
// What it computes.  Every ray of the key-sorted wavefront in band b and
// supertile j walks its band's entry-sorted candidate groups (order[b, :ngrp]),
// as the Pallas kernels do:
//   - a group counts where the supertile's bit is set, its supertile entry
//     lies within the ray's best t (closest hit; tmax for occlusion) and the
//     ray enters the group box; the walk ends where the band's entry exceeds
//     best t (entries are sorted and never exceed the ray's own);
//   - a member cluster with triangles is entered when the ray meets its world
//     box within best t;
//   - the ray moves to the instance's local space (direction unnormalised, so
//     t stays world-parametric; local inverse 1 / where(|d| > 1e-20, d, 1e-20));
//   - the sub-block cull of stream.py:283-331 and occlude.py:137-207: each of
//     the cluster's 8 mesh-local sub-block boxes (K / 8 triangles each; an
//     empty one, its box inverted, is never entered) is slab-tested, and its
//     Moller-Trumbore tests run only while its entry distance is within the
//     current best t.
// A group box is the exact union of its members' boxes, so its slab never
// rejects a member the member's own slab would enter (the roundings are
// monotone): the group test only saves work.  Tie rules: the lower index
// wins equal t inside a sub-block and, since a pass tests several sub-blocks
// at once, across the pass in index order; otherwise (a later pass, a later
// chunk of a sub-block above 32 triangles) only a strictly closer hit
// replaces the current one.  An any-hit ray (flags bit 1) stops at its first
// hit; an occlusion ray stops at its first triangle whose virtual id differs
// from its exclude id.
//
// What bounds it on the H100.  The work the rays need is small: at the main
// path's shapes a bounce ray enters ~1.3 clusters and ~2 sub-blocks and runs
// ~31 triangle tests of ~53 float operations before its final hit, so a
// 262,144-ray call needs ~0.4 GFLOP and ~20 MB: ~6 us at the FP32 peak, a
// few us of HBM.  Its time goes to latency and divergence: chains of
// dependent loads of small tables, and loops whose trip counts differ from
// ray to ray.  A warp of 32 rays, one per lane, runs the union of its lanes'
// loops, and diffuse bounce rays share few clusters: that design, with the
// warp's entered sub-blocks staged in shared memory by cp.async, double
// buffered, took 2.0-2.1 ms on an H100 (PERF.md).  So this kernel gives each
// ray a warp of its own (4 per 128-thread block) and spends the lanes on the
// parallel parts of one ray's traversal:
//   - the candidate walk takes 32 groups per step (lane k: candidate g0 + k;
//     its entry, id, supertile bit, supertile entry and group box), and one
//     ballot keeps the groups the ray enters;
//   - the lanes slab-test the group's G member boxes, 32 a step (lane k
//     member c0 + k; traverse.cuh walk_members), loading each member's
//     count, block, triangle base and instance alongside for the warp to
//     share by shuffles;
//   - lanes 0..7 slab-test the entered cluster's 8 sub-block boxes;
//   - the lanes run the Moller-Trumbore tests of the next open sub-blocks
//     (traverse.cuh TriLayout: at K = 128 lanes 0..15 and 16..31 take two
//     sub-blocks of 16), each lane loading its own triangle's 9 components
//     (coalesced: a sub-block's component row is 4K / 8 contiguous bytes),
//     and a warp min-reduction picks the hit.  No lane ever needs another
//     lane's triangle, so nothing is staged in shared memory.
// Loads are issued before the gates that use them, so a walk step costs two
// dependent round trips and a cluster three.  The layout (VPT_CLUSTER_SIZE,
// VPT_GROUP_SIZE): K is a template constant for 32, 64, 128 (the default),
// 256, 512 and 1024 and a run-time value for any other multiple of 8
// (traverse.cuh VPT_DISPATCH_K); the group size, any G >= 1, is a run-time
// value, and groups above 32 members run the run-time-K build with the
// chunked member walk (WIDE); the wrappers raise on a layout outside these.  At K = 128, 64-72 registers
// (-Xptxas -v); capping them for occupancy spilled and ran slower.
//
// Built with --fmad=false so the slab and Moller-Trumbore arithmetic rounds
// exactly like the plain torch versions, which makes culling decisions agree.

#include "traverse.cuh"

namespace {

using namespace vpt;

constexpr int kSupertile = 1024;
constexpr int kWarps = 4;  // rays per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kInfBits = 0x7f800000u;

struct Tables {
  const int32_t* ngrp;        // (B,)
  const int32_t* order;       // (B, Gp) entry-sorted group ids
  const float* entry_sorted;  // (B, Gp)
  const int64_t* bits;        // (B, Gp) supertile masks, bit j = supertile j
  const float* sent;          // (B, T, Gp) per-supertile entry, +inf = none
  const float* aabbs;         // (C, 6) world boxes [lo.xyz, hi.xyz]
  const int32_t* count;       // (C,)
  const int32_t* start;       // (C,) virtual triangle id base
  const int32_t* block_id;    // (C,) row of tris / sub_aabbs
  const int32_t* inst;        // (C,) instance
  const float* inv_rows;      // (n_inst, 12) world -> local affines
  const float* tris;          // (Bk, 16, K) rows 0..8 = p0, e1, e2 components
  const float* sub_aabbs;     // (Bk, 8, 6) mesh-local sub-block boxes
  const float* group_min;     // (G, 3) world group boxes: the members' union
  const float* group_max;     // (G, 3)
};

// The search state of the warp's ray; every lane holds the same copy.
struct Search {
  float best;  // closest hit so far; occlusion keeps tmax
  int32_t best_tri;
  float best_u, best_v;
  bool live;  // still searching
  bool anyhit;
  bool blocked;
  int32_t extri;
};

// A member cluster with triangles, entered by the warp's ray.
template <bool OCCLUDE, bool INSTANCED>
__device__ __forceinline__ void visit_cluster(const Tables& tb, const Member& mc, const Ray& w, float t_min,
                                              Search& S, int lane, const TriLayout& L) {
  const int cnt = mc.count;
  const Ray l = INSTANCED ? to_instance(w, tb.inv_rows + 12 * (size_t)mc.inst) : w;
  const int blk = mc.block;
  const int32_t base = mc.start;
  // Lanes 0..7: the sub-block slabs, tf = the current best t.
  float tn_s = INFINITY;
  bool in_s = false;
  if (lane < kNSub && lane * L.sub < cnt) {
    in_s = slab6(tb.sub_aabbs + ((size_t)blk * kNSub + lane) * 6, l, t_min, S.best, tn_s);
  }
  const float* block = tb.tris + (size_t)blk * 16 * L.k;
  const int slot = lane / L.lanes, k0 = lane - slot * L.lanes;
  while (S.live) {
    // The next per_pass sub-blocks whose entry is still within the best t,
    // tested together: lane slot * lanes + k0 takes triangle k0 of the
    // slot-th (with K = 128, lanes 0-15 the first sub-block, 16-31 the
    // second).
    const unsigned open = __ballot_sync(kFull, in_s && tn_s <= S.best);
    if (open == 0) break;
    const int s = pass_block(open, L, lane, slot, in_s);
    for (int c = 0; c < L.chunks; ++c) {
      if (c > 0 && !S.live) break;
      const int k = L.chunks == 1 ? k0 : c * 32 + k0;
      float t = INFINITY, u = 0.0f, v = 0.0f;
      bool valid = false;
      if (s >= 0 && (L.chunks == 1 || k < L.sub) && s * L.sub + k < cnt) {
        t = moller_trumbore(block + s * L.sub + k, l, t_min, u, v, valid, L.k);
        valid = valid && t < S.best;
      }
      const int32_t id = base + s * L.sub + k;
      if (OCCLUDE) {
        if (__any_sync(kFull, valid && id != S.extri)) {
          S.blocked = true;
          S.live = false;
        }
      } else {
        // Closest hit, the lower lane on equal t (index order: the pass's
        // sub-blocks in ascending order, a later chunk only if closer).
        // Valid t are > t_min > 0, so their bit patterns order like the
        // floats.
        const unsigned tbits = valid ? __float_as_uint(t) : kInfBits;
        const unsigned low = __reduce_min_sync(kFull, tbits);
        if (low != kInfBits) {
          const int win = __ffs(__ballot_sync(kFull, valid && tbits == low)) - 1;
          S.best = __uint_as_float(low);
          S.best_tri = __shfl_sync(kFull, id, win);
          S.best_u = __shfl_sync(kFull, u, win);
          S.best_v = __shfl_sync(kFull, v, win);
          if (S.anyhit) S.live = false;
        }
      }
    }
  }
}

template <bool OCCLUDE, bool INSTANCED, int K, bool WIDE>
__global__ void __launch_bounds__(kThreads) trace_kernel(
    Tables tb, const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ tmax_in, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ extri_in, int n, int tiles, int gp, int group, int k_tris, float t_min,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int32_t* __restrict__ blocked_out) {
  const TriLayout L = tri_layout<K>(k_tris);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);  // the warp's ray
  if (i >= n) return;
  const int band = tiles * kSupertile;
  const int b = i / band;
  const int j = (i - b * band) / kSupertile;

  const Ray w = load_ray(origin, direction, i);
  Search S;
  S.best = tmax_in[i];
  S.best_tri = -1;
  S.best_u = S.best_v = 0.0f;
  const int32_t fl = flags[i];
  S.live = (fl & 1) != 0;
  S.anyhit = !OCCLUDE && (fl & 2) != 0;
  S.blocked = false;
  S.extri = OCCLUDE ? extri_in[i] : -1;

  const int ng = tb.ngrp[b];
  const int32_t* order = tb.order + (size_t)b * gp;
  const float* entry = tb.entry_sorted + (size_t)b * gp;
  const int64_t* bits = tb.bits + (size_t)b * gp;
  const float* sent = tb.sent + ((size_t)b * tiles + j) * gp;

  // The candidate walk, 32 candidates per step: lane k takes candidate g0 + k
  // and keeps it if the supertile's bit is set and the ray itself enters the
  // group box before its best t.  The band's entries are sorted and never
  // exceed the ray's own, so the walk ends at the first one beyond best t.
  for (int g0 = 0; g0 < ng && S.live; g0 += 32) {
    const int gi = g0 + lane;
    const bool listed = gi < ng;
    // Loads first, gates after: two dependent round trips per step.
    const float e = listed ? entry[gi] : INFINITY;
    const int g = listed ? order[gi] : 0;
    const int64_t gbits = bits[g];
    const float sg = sent[g];
    const float* lo = tb.group_min + 3 * (size_t)g;
    const float* hi = tb.group_max + 3 * (size_t)g;
    const float lx = lo[0], ly = lo[1], lz = lo[2], hx = hi[0], hy = hi[1], hz = hi[2];
    const bool last = __any_sync(kFull, !listed || !(e <= S.best));
    float tn_g = INFINITY;
    const bool in_g = listed && e <= S.best && ((gbits >> j) & 1) != 0 && sg <= S.best &&
                      slab(lx, ly, lz, hx, hy, hz, w, t_min, S.best, tn_g);
    unsigned todo = __ballot_sync(kFull, in_g);
    while (todo != 0 && S.live) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int gg = __shfl_sync(kFull, g, src);
      if (!(__shfl_sync(kFull, tn_g, src) <= S.best)) continue;
      // The member clusters' world slabs, 32 members a step (traverse.cuh).
      walk_members<INSTANCED, WIDE>(tb, gg, group, w, t_min, S, lane, [&](const Member& cm) {
        visit_cluster<OCCLUDE, INSTANCED>(tb, cm, w, t_min, S, lane, L);
      });
    }
    if (last) break;
  }
  if (lane != 0) return;
  if (OCCLUDE) {
    blocked_out[i] = S.blocked ? 1 : 0;
  } else {
    t_out[i] = S.best;
    tri_out[i] = S.best_tri;
    u_out[i] = S.best_u;
    v_out[i] = S.best_v;
  }
}

template <bool OCCLUDE>
int launch(const Tables& tb, const float* origin, const float* direction,
           const float* tmax, const int32_t* flags, const int32_t* extri, int n,
           int tiles, int gp, int group_size, int k_tris, float t_min, int instanced,
           float* t_out, int32_t* tri_out, float* u_out, float* v_out,
           int32_t* blocked_out, cudaStream_t stream) {
  if (!layout_ok(k_tris, group_size)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = (n + kWarps - 1) / kWarps;
#define VPT_TRACE_LAUNCH_W(K, WIDE)                                                                     \
  if (instanced) {                                                                                      \
    trace_kernel<OCCLUDE, true, K, WIDE><<<blocks, kThreads, 0, stream>>>(                              \
        tb, origin, direction, tmax, flags, extri, n, tiles, gp, group_size, k_tris, t_min, t_out, tri_out, \
        u_out, v_out, blocked_out);                                                                     \
  } else {                                                                                              \
    trace_kernel<OCCLUDE, false, K, WIDE><<<blocks, kThreads, 0, stream>>>(                             \
        tb, origin, direction, tmax, flags, extri, n, tiles, gp, group_size, k_tris, t_min, t_out, tri_out, \
        u_out, v_out, blocked_out);                                                                     \
  }
#define VPT_TRACE_LAUNCH(K) VPT_TRACE_LAUNCH_W(K, false)
  if (group_size > kWideGroup) {
    VPT_TRACE_LAUNCH_W(0, true)
  } else {
    VPT_DISPATCH_K(k_tris, VPT_TRACE_LAUNCH)
  }
#undef VPT_TRACE_LAUNCH
#undef VPT_TRACE_LAUNCH_W
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vpt_stream(
    const int32_t* ngrp, const int32_t* order, const float* entry_sorted,
    const int64_t* bits, const float* sent, const float* origin,
    const float* direction, const float* tmax, const int32_t* flags,
    const float* aabbs, const int32_t* count, const int32_t* start,
    const int32_t* block_id, const int32_t* inst, const float* inv_rows,
    const float* tris, const float* sub_aabbs, const float* group_min,
    const float* group_max, int n, int tiles, int gp, int group_size, int k_tris, float t_min,
    int instanced, float* t_out, int32_t* tri_out, float* u_out, float* v_out,
    void* stream) {
  const Tables tb{ngrp, order, entry_sorted, bits, sent, aabbs, count, start, block_id,
                  inst, inv_rows, tris, sub_aabbs, group_min, group_max};
  return launch<false>(tb, origin, direction, tmax, flags, nullptr, n, tiles, gp,
                       group_size, k_tris, t_min, instanced, t_out, tri_out, u_out, v_out,
                       nullptr, (cudaStream_t)stream);
}

extern "C" int vpt_occlude(
    const int32_t* ngrp, const int32_t* order, const float* entry_sorted,
    const int64_t* bits, const float* sent, const float* origin,
    const float* direction, const float* tmax, const int32_t* act,
    const int32_t* extri, const float* aabbs, const int32_t* count,
    const int32_t* start, const int32_t* block_id, const int32_t* inst,
    const float* inv_rows, const float* tris, const float* sub_aabbs,
    const float* group_min, const float* group_max, int n, int tiles, int gp,
    int group_size, int k_tris, float t_min, int instanced, int32_t* blocked_out, void* stream) {
  const Tables tb{ngrp, order, entry_sorted, bits, sent, aabbs, count, start, block_id,
                  inst, inv_rows, tris, sub_aabbs, group_min, group_max};
  return launch<true>(tb, origin, direction, tmax, act, extri, n, tiles, gp,
                      group_size, k_tris, t_min, instanced, nullptr, nullptr, nullptr,
                      nullptr, blocked_out, (cudaStream_t)stream);
}
