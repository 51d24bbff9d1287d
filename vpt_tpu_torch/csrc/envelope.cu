// Ray-vs-group envelope kernels for the stream and occlude trace paths.
//
// Replaces the two Pallas kernels of vpt_tpu/accel/envelope.py:
//   vpt_ray_keys          <- envelope.ray_keys (_keys_kernel)
//   vpt_supertile_tables  <- envelope.supertile_tables (_tables_kernel)
//
// Both evaluate one slab formula per (ray, box): tn starts at t_min, tf at
// the ray's tmax, per axis s0 = (lo - o) * inv and s1 = (hi - o) * inv,
// tn = max(tn, min(s0, s1)), tf = min(tf, max(s0, s1)) with NaN-propagating
// min / max (torch.minimum / maximum), and the ray enters iff tn <= tf, at
// entry = tn.  Built with --fmad=false, so every product and sum rounds
// exactly like the plain torch versions in vpt_tpu_torch/accel/envelope.py,
// and both results equal theirs bit for bit.
//
// What bounds them on the H100: FP32 instruction rate.  Each slab is 6 subtractions,
// 6 products and 12 min / max over data that sits in shared memory and
// registers; the bytes are only the rays (28 B each) and the output.  The
// design cuts both factors of the N x Gp slab count of a dense pass:
//
// * One instruction per min / max.  PTX min.NaN / max.NaN (sm_80 and up)
//   propagate NaN like torch in one instruction, where fminf / fmaxf plus a
//   NaN test and a select took three.  NaN matters: an inactive ray may
//   carry a NaN origin, and the plain versions give it +inf (NaN <= tf is
//   false), where fminf / fmaxf alone would give it the finite t_min.  A
//   group box is staged as lo.xyz and hi.xyz side by side, two 16-byte
//   shared loads that every lane of a warp reads at one address.
//
// * A two-level walk.  While a block stages the Gp group boxes it takes the
//   union box of each 8 consecutive groups (a chunk), over all Gp boxes as
//   given, padding included, each box's lo / hi taken in either order.  A
//   ray tests a chunk's 8 members only where it enters the union.  This is
//   exact: per axis, x -> (x - o) * inv rounds monotonically (increasing for
//   inv > 0, decreasing for inv < 0; inv is finite, from the caller's 1e-20
//   guard), and the member's interval [min(lo, hi), max(lo, hi)] lies inside
//   the union's, so the member's near slab value is >= the union's and its
//   far value <= the union's; min and max are exact.  Hence a member's tn >=
//   the union's tn and its tf <= the union's tf: a ray that misses the union
//   misses every member, and an entered member's entry is never below the
//   union's entry.  A NaN origin or tmax makes both NaN: neither is entered.
//
// vpt_ray_keys: one thread per ray walks the chunks in ascending group id
// and keeps the (entry, id)-lexicographic first and second entered groups
// by strict '<' (envelope.py:_minsel: entry ties go to the lower id).  It
// skips a chunk unless its union entry is below the entry it would have to
// beat (the second for levels 2, the first for levels 1 and the fe key):
// every member's entry is >= the union's and its id above every id held, so
// the strict '<' would not take it.  Rays arrive unsorted, so a warp runs the
// chunks that any of its lanes enters.  Mode 3 is the packet trace's "fe"
// key (VPT_SORT_KEY=fe, vpt_tpu/accel/cluster.py:504-511): the first entered
// group * 1024 + its entry quantised as (int)clip(entry / max(diag, 1e-20) *
// 256, 0, 1023), diag the root box's diagonal read from the device (so the
// caller never waits for it), and Gp * 1024 for a ray that enters nothing.
//
// vpt_supertile_tables: one block per tile of sorted rays, one ray per
// thread, compiled for four tile sizes: 1024 (the stream path's
// supertiles) and 128, 256, 512 or 1024 (the packet trace's packets,
// VPT_PACKET_SIZE, whose per-group nearest entry is the packet cull).  Any
// other tile (another VPT_PACKET_SIZE) runs the run-time-tile build: a
// block of whole warps, the tile rounded up to 32 threads and at most
// 1024, loops over its tile's rays, kMaxThreads at a time; a thread past
// the tile's end enters nothing.
// Per chunk each lane tests its ray against the union; where any lane of the
// warp entered, the lanes whose ray entered test the 8 members, each member's
// warp minimum is taken by __reduce_min_sync on an order-preserving unsigned
// key of the entry (positive floats b | 0x80000000, negative floats ~b, so
// any t_min works, a negative one included), and 8 lanes fold the 8 minima
// into the block's shared row by atomicMin.  The block maps the keys back
// and writes its Gp row at the end.  Entries are never NaN (a NaN slab is
// not entered, +inf); -0.0 orders below +0.0, which compare equal as floats.
// An inactive ray carries tmax -inf (packets) or t_min (supertiles) and
// enters nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;  // groups per union box
constexpr int kKeysThreads = 256;
constexpr int kMaxThreads = 1024;  // a block of the run-time-tile tables
constexpr unsigned kFull = 0xffffffffu;

// An unsigned key that orders like the float, for every float but NaN: the
// sign bit set on positive floats, every bit flipped on negative ones.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}
__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
constexpr unsigned kInfKey = 0x7f800000u | 0x80000000u;  // order_key(+inf)

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin, const float* __restrict__ inv,
                                        const float* __restrict__ tmax, int i) {
  return Ray{origin[3 * i], origin[3 * i + 1], origin[3 * i + 2], inv[3 * i], inv[3 * i + 1], inv[3 * i + 2],
             tmax[i]};
}

// Entry distance of a ray into the box (lo, hi), +inf when it does not enter.
__device__ __forceinline__ float slab_entry(const Ray& r, float4 lo, float4 hi, float t_min) {
  float s0 = (lo.x - r.ox) * r.ix, s1 = (hi.x - r.ox) * r.ix;
  float tn = nan_max(t_min, nan_min(s0, s1));
  float tf = nan_min(r.tmax, nan_max(s0, s1));
  s0 = (lo.y - r.oy) * r.iy;
  s1 = (hi.y - r.oy) * r.iy;
  tn = nan_max(tn, nan_min(s0, s1));
  tf = nan_min(tf, nan_max(s0, s1));
  s0 = (lo.z - r.oz) * r.iz;
  s1 = (hi.z - r.oz) * r.iz;
  tn = nan_max(tn, nan_min(s0, s1));
  tf = nan_min(tf, nan_max(s0, s1));
  return (tn <= tf) ? tn : INFINITY;
}

// Stage the (3, gp) group boxes as box[2g] = lo, box[2g + 1] = hi, then the
// gp / 8 union boxes the same way.  Ends with a barrier.
__device__ void stage_boxes(const float* __restrict__ gmin, const float* __restrict__ gmax, int gp,
                            float4* box, float4* uni) {
  for (int g = threadIdx.x; g < gp; g += blockDim.x) {
    box[2 * g] = make_float4(gmin[g], gmin[gp + g], gmin[2 * gp + g], 0.0f);
    box[2 * g + 1] = make_float4(gmax[g], gmax[gp + g], gmax[2 * gp + g], 0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < gp / kChunk; c += blockDim.x) {
    float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
    float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.0f);
    for (int g = c * kChunk; g < (c + 1) * kChunk; ++g) {
      const float4 a = box[2 * g], b = box[2 * g + 1];
      lo.x = nan_min(lo.x, nan_min(a.x, b.x));
      lo.y = nan_min(lo.y, nan_min(a.y, b.y));
      lo.z = nan_min(lo.z, nan_min(a.z, b.z));
      hi.x = nan_max(hi.x, nan_max(a.x, b.x));
      hi.y = nan_max(hi.y, nan_max(a.y, b.y));
      hi.z = nan_max(hi.z, nan_max(a.z, b.z));
    }
    uni[2 * c] = lo;
    uni[2 * c + 1] = hi;
  }
  __syncthreads();
}

constexpr int kDepthSteps = 1024;  // the fe key's entry-depth levels per group

template <int kLevels>  // 1, 2, or 3 = the fe key
__global__ void __launch_bounds__(kKeysThreads) ray_keys_kernel(
    const float* __restrict__ origin, const float* __restrict__ inv, const float* __restrict__ tmax,
    const float* __restrict__ gmin, const float* __restrict__ gmax, int n, int gp, float t_min,
    const float* __restrict__ diag, int32_t* __restrict__ key) {
  extern __shared__ float4 smem[];
  float4* box = smem;
  float4* uni = smem + 2 * gp;
  stage_boxes(gmin, gmax, gp, box, uni);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origin, inv, tmax, i);
  float v1 = INFINITY, v2 = INFINITY;
  int a1 = gp, a2 = gp;
  for (int c = 0; c < gp / kChunk; ++c) {
    const float ue = slab_entry(r, uni[2 * c], uni[2 * c + 1], t_min);
    if (!(ue < (kLevels == 2 ? v2 : v1))) continue;
#pragma unroll
    for (int m = 0; m < kChunk; ++m) {
      const int g = c * kChunk + m;
      const float e = slab_entry(r, box[2 * g], box[2 * g + 1], t_min);
      if (e < v1) {
        v2 = v1;
        a2 = a1;
        v1 = e;
        a1 = g;
      } else if (kLevels == 2 && e < v2) {
        v2 = e;
        a2 = g;
      }
    }
  }
  const int l0 = (v1 < INFINITY) ? a1 : gp;
  const int l1 = (v2 < INFINITY) ? a2 : gp;
  if (kLevels == 3) {
    const float q = fminf(fmaxf(v1 / fmaxf(*diag, 1e-20f) * 256.0f, 0.0f), (float)(kDepthSteps - 1));
    key[i] = l0 * kDepthSteps + ((v1 < INFINITY) ? (int)q : 0);
  } else {
    key[i] = (kLevels == 2) ? l0 * (gp + 1) + l1 : l0;
  }
}

template <int kTile>  // 0: a run-time tile, `tile` rays, that a block of blockDim.x threads loops over
__global__ void __launch_bounds__(kTile > 0 ? kTile : kMaxThreads) supertile_tables_kernel(
    const float* __restrict__ origin, const float* __restrict__ inv, const float* __restrict__ tmax,
    const float* __restrict__ gmin, const float* __restrict__ gmax, int gp, float t_min, int tile,
    float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* box = smem;
  float4* uni = smem + 2 * gp;
  unsigned* best = reinterpret_cast<unsigned*>(uni + 2 * (gp / kChunk));
  for (int g = threadIdx.x; g < gp; g += blockDim.x) best[g] = kInfKey;
  stage_boxes(gmin, gmax, gp, box, uni);  // its barriers also publish `best`
  const int rays = kTile > 0 ? kTile : tile;
  const int step = kTile > 0 ? kTile : (int)blockDim.x;  // every thread runs the same number of rounds
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < rays; r0 += step) {
    const int k = r0 + threadIdx.x;
    const bool real = kTile > 0 || k < rays;  // a thread past the tile's end enters nothing
    const Ray r = real ? load_ray(origin, inv, tmax, blockIdx.x * rays + k) : Ray{};
    for (int c = 0; c < gp / kChunk; ++c) {
      const bool in = real && slab_entry(r, uni[2 * c], uni[2 * c + 1], t_min) < INFINITY;
      if (!__any_sync(kFull, in)) continue;
      unsigned mine = kInfKey;  // lane m < 8 keeps member m's warp minimum
#pragma unroll
      for (int m = 0; m < kChunk; ++m) {
        const int g = c * kChunk + m;
        const float e = in ? slab_entry(r, box[2 * g], box[2 * g + 1], t_min) : INFINITY;
        const unsigned w = __reduce_min_sync(kFull, order_key(e));
        if (lane == m) mine = w;
      }
      if (lane < kChunk && mine != kInfKey) atomicMin(&best[c * kChunk + lane], mine);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < gp; g += blockDim.x) out[(size_t)blockIdx.x * gp + g] = from_order_key(best[g]);
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t box_bytes(int gp) { return (size_t)2 * (gp + gp / kChunk) * sizeof(float4); }

}  // namespace

template <int kLevels>
int launch_keys(const float* origin, const float* inv, const float* tmax, const float* gmin, const float* gmax, int n,
                int gp, float t_min, const float* diag, int32_t* key, cudaStream_t stream) {
  const size_t smem = box_bytes(gp);
  const int blocks = (n + kKeysThreads - 1) / kKeysThreads;
  if (blocks == 0) return (int)cudaSuccess;
  const cudaError_t err = allow_smem(ray_keys_kernel<kLevels>, smem);
  if (err != cudaSuccess) return (int)err;
  ray_keys_kernel<kLevels><<<blocks, kKeysThreads, smem, stream>>>(origin, inv, tmax, gmin, gmax, n, gp, t_min, diag,
                                                                     key);
  return (int)cudaGetLastError();
}

extern "C" int vpt_ray_keys(
    const float* origin, const float* inv, const float* tmax, const float* gmin,
    const float* gmax, int n, int gp, float t_min, int levels, const float* diag, int32_t* key,
    void* stream) {
  if (gp % kChunk != 0 || levels < 1 || levels > 3 || (levels == 3) != (diag != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (levels == 3) return launch_keys<3>(origin, inv, tmax, gmin, gmax, n, gp, t_min, diag, key, s);
  if (levels == 2) return launch_keys<2>(origin, inv, tmax, gmin, gmax, n, gp, t_min, diag, key, s);
  return launch_keys<1>(origin, inv, tmax, gmin, gmax, n, gp, t_min, diag, key, s);
}

template <int kTile>
int launch_tables(const float* origin, const float* inv, const float* tmax, const float* gmin,
                  const float* gmax, int n, int gp, float t_min, int tile, float* out, cudaStream_t stream) {
  const size_t smem = box_bytes(gp) + (size_t)gp * sizeof(unsigned);
  const int blocks = n / tile;
  if (blocks == 0) return (int)cudaSuccess;
  // The run-time tile: whole warps, up to kMaxThreads, each thread taking
  // rays k, k + threads, ... of its tile.
  const int threads = kTile > 0 ? kTile : (tile >= kMaxThreads ? kMaxThreads : (tile + 31) / 32 * 32);
  cudaError_t err = allow_smem(supertile_tables_kernel<kTile>, smem);
  if (err != cudaSuccess) return (int)err;
  supertile_tables_kernel<kTile><<<blocks, threads, smem, stream>>>(origin, inv, tmax, gmin, gmax, gp, t_min, tile,
                                                                    out);
  return (int)cudaGetLastError();
}

extern "C" int vpt_supertile_tables(
    const float* origin, const float* inv, const float* tmax, const float* gmin,
    const float* gmax, int n, int gp, float t_min, int tile, float* out, void* stream) {
  if (gp % kChunk != 0 || tile <= 0 || n % tile != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 128: return launch_tables<128>(origin, inv, tmax, gmin, gmax, n, gp, t_min, tile, out, s);
    case 256: return launch_tables<256>(origin, inv, tmax, gmin, gmax, n, gp, t_min, tile, out, s);
    case 512: return launch_tables<512>(origin, inv, tmax, gmin, gmax, n, gp, t_min, tile, out, s);
    case 1024: return launch_tables<1024>(origin, inv, tmax, gmin, gmax, n, gp, t_min, tile, out, s);
    default: return launch_tables<0>(origin, inv, tmax, gmin, gmax, n, gp, t_min, tile, out, s);
  }
}
