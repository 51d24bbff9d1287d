// The Hopper counterparts of the JAX package's Mosaic probes:
// scripts/mosaic_probe.py (probe1-probe6, probe8-probe11) and
// scripts/smem_probe.py (`probe` / `kernel`).  Each TPU probe asks a
// question the Pallas trace kernels were built around: how much fits in
// fast memory, and what a data-dependent scalar read, store, binning step,
// reduction or async copy into it costs.  Each kernel here computes what
// its probe's Pallas kernel computes, on the probe's inputs, with the
// answer for this card: shared memory is the fast memory (the TPU's SMEM
// and VMEM both), and a warp or a block stands for the TPU core's scalar
// or vector unit.  `python -m vpt_tpu_torch.tools.hopper_probe` runs them;
// the wrappers and plain versions are there.
//
// What bounds them: none moves more than a few KB or does more than ~10^6
// operations, so their bounds are nanoseconds and their times are launch
// latency plus the dependent chains they time (one thread's loop for
// probes 4 and 6, a block-wide reduction per drain for probe 11).  That is
// the answer they give: the cost per access or per drain, in one block, as
// the JAX probes ran one TPU core.
//
// Shared memory above 48 KB is dynamic shared memory, asked for per kernel
// with cudaFuncSetAttribute before the launch (probe8, smem_probe); the
// card takes up to 227 KB (232,448 bytes) a block and refuses more.  A
// refusal returns its CUDA error, which is the probe's answer, and the
// error is cleared so that no later launch reads it as its own.
//
// Built with --fmad=false like the trace kernels, so that the
// Moller-Trumbore probes (3, 10) round exactly like their plain versions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse.cuh"

namespace {

constexpr int kRows = 8;     // the (8, 128) tile of the TPU probes
constexpr int kLanes = 128;
constexpr int kTile = kRows * kLanes;
constexpr int kPermLen = 1024;  // the timing probes' permutation
constexpr float kMtTmin = 1e-4f;  // the probes' t > 1e-4 test

// The lanes the probes read at (perm) are taken mod 128 and probe2's group
// ids outside its bins are skipped, so no input reaches outside shared
// memory; the wrappers' inputs lie in range, where this changes nothing.

// The error of a launch just made, cleared.
int launched() { return (int)cudaGetLastError(); }

// Dynamic shared memory of `bytes` for `kernel`: above 48 KB it must be
// asked for.  A refusal is returned and cleared.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// probe1 (mosaic_probe.py:29): out[i] = x[i % 8, perm[i]], 128 reads at
// data-dependent lanes.  The tile goes to shared memory once, each thread
// makes one read there.
__global__ void __launch_bounds__(kLanes) probe1_kernel(const int32_t* __restrict__ perm, const float* __restrict__ x,
                                                        float* __restrict__ out) {
  __shared__ float tile[kTile];
  for (int k = threadIdx.x; k < kTile; k += blockDim.x) tile[k] = x[k];
  __syncthreads();
  const int i = threadIdx.x;
  out[i] = tile[(i % kRows) * kLanes + (perm[i] & (kLanes - 1))];
}

// probe2 (mosaic_probe.py:59): bin n ray ids by their group id into
// `groups` bins of `cap` slots in shared memory, counting each group.  A
// thread per ray takes its slot by atomicAdd, so the order inside a bin
// varies from run to run; slots past a bin's count (and past `cap`) stay
// -1.
__global__ void __launch_bounds__(1024) probe2_kernel(const int32_t* __restrict__ gid, int n, int groups, int cap,
                                                      int32_t* __restrict__ bins, int32_t* __restrict__ cnt) {
  extern __shared__ int32_t smem2[];
  int32_t* scnt = smem2;
  int32_t* sbins = smem2 + groups;
  for (int k = threadIdx.x; k < groups; k += blockDim.x) scnt[k] = 0;
  for (int k = threadIdx.x; k < groups * cap; k += blockDim.x) sbins[k] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = gid[i];
    if ((unsigned)g >= (unsigned)groups) continue;  // an id outside the bins is not binned
    const int c = atomicAdd(&scnt[g], 1);
    if (c < cap) sbins[g * cap + c] = i;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < groups; k += blockDim.x) cnt[k] = scnt[k];
  for (int k = threadIdx.x; k < groups * cap; k += blockDim.x) bins[k] = sbins[k];
}

// Moller-Trumbore of ray r (rays: (R, 8) rows [o.xyz, d.xyz, tmax, pad])
// against the triangle whose 9 components (p0, e1, e2) lie `stride` floats
// apart from `tri`: t, or +inf where the hit is not valid.  traverse.cuh's
// operation order, which the plain version repeats.
__device__ __forceinline__ float mt_probe(const float* tri, const vpt::Ray& ray, int stride) {
  float u, v;
  bool ok;
  const float t = vpt::moller_trumbore(tri, ray, kMtTmin, u, v, ok, stride);
  return ok ? t : INFINITY;
}

__device__ __forceinline__ vpt::Ray probe_ray(const float* rays, int r) {
  vpt::Ray l;
  l.ox = rays[8 * r], l.oy = rays[8 * r + 1], l.oz = rays[8 * r + 2];
  l.dx = rays[8 * r + 3], l.dy = rays[8 * r + 4], l.dz = rays[8 * r + 5];
  l.ix = l.iy = l.iz = 0.0f;  // unused by Moller-Trumbore
  return l;
}

// probe3 (mosaic_probe.py:102): ray-major Moller-Trumbore, rays in rows and
// triangles in lanes.  One block, a thread per (ray, triangle) pair; the
// triangles' (9, T) rows are staged in shared memory once for all rays.
__global__ void __launch_bounds__(1024) probe3_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                                                      int n_rays, int n_tris, float* __restrict__ out) {
  extern __shared__ float stris[];
  for (int k = threadIdx.x; k < 9 * n_tris; k += blockDim.x) stris[k] = tris[k];
  __syncthreads();
  const int p = threadIdx.x;
  if (p >= n_rays * n_tris) return;
  const int r = p / n_tris, j = p - r * n_tris;
  out[p] = mt_probe(stris + j, probe_ray(rays, r), n_tris);
}

// probe10 (mosaic_probe.py:389): scalar-broadcast Moller-Trumbore.  A block
// per ray, whose scalars every thread loads into registers (one address
// for the warp: a broadcast), a thread per triangle reading its components
// from device memory (coalesced rows).
__global__ void __launch_bounds__(1024) probe10_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                                                       int n_tris, float* __restrict__ out) {
  const int r = blockIdx.x, j = threadIdx.x;
  const vpt::Ray ray = probe_ray(rays, r);
  if (j < n_tris) out[(size_t)r * n_tris + j] = mt_probe(tris + j, ray, n_tris);
}

// probe4 (mosaic_probe.py:162): n_iter reads x[(i % 64) / 8, perm[i % 1024]]
// summed in order by one thread, as the TPU's scalar core ran them: a
// dependent chain of shared-memory reads and float adds.
__global__ void __launch_bounds__(kLanes) probe4_kernel(const int32_t* __restrict__ perm, const float* __restrict__ x,
                                                        int n_iter, float* __restrict__ out) {
  __shared__ float tile[kTile];
  __shared__ int32_t sperm[kPermLen];
  for (int k = threadIdx.x; k < kTile; k += blockDim.x) tile[k] = x[k];
  for (int k = threadIdx.x; k < kPermLen; k += blockDim.x) sperm[k] = perm[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  float acc = 0.0f;
  for (int i = 0; i < n_iter; ++i) acc += tile[((i % 64) / kRows) * kLanes + (sperm[i % kPermLen] & (kLanes - 1))];
  out[0] = acc;
}

// probe5 (mosaic_probe.py:198): out[i % 8, perm[i]] = i + 1 for i < n over
// a zeroed tile.  A thread per store into the tile in shared memory; where
// two stores meet one slot the later one (the larger i + 1) is kept by
// atomicMax, as the sequential loop keeps its last store.
__global__ void __launch_bounds__(kTile) probe5_kernel(const int32_t* __restrict__ perm, int n,
                                                       float* __restrict__ out) {
  __shared__ int32_t tile[kTile];
  tile[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    atomicMax(&tile[(i % kRows) * kLanes + (perm[i] & (kLanes - 1))], i + 1);
  }
  __syncthreads();
  out[threadIdx.x] = (float)tile[threadIdx.x];
}

// probe6 (mosaic_probe.py:230): n_iter stores out[(i % 64) / 8, perm[i %
// 1024]] = i over a zeroed tile, by one thread in order into shared memory.
__global__ void __launch_bounds__(kTile) probe6_kernel(const int32_t* __restrict__ perm, int n_iter,
                                                       float* __restrict__ out) {
  __shared__ float tile[kTile];
  __shared__ int32_t sperm[kPermLen];
  tile[threadIdx.x] = 0.0f;
  sperm[threadIdx.x] = perm[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_iter; ++i) tile[((i % 64) / kRows) * kLanes + (sperm[i % kPermLen] & (kLanes - 1))] = (float)i;
  }
  __syncthreads();
  out[threadIdx.x] = tile[threadIdx.x];
}

// probe8 (mosaic_probe.py:327): a scratch of n ints in dynamic shared
// memory, written and read at both ends: out = x + (x + 1).
__global__ void probe8_kernel(const int32_t* __restrict__ x, int n, int32_t* __restrict__ out) {
  extern __shared__ int32_t scratch[];
  if (threadIdx.x != 0) return;
  volatile int32_t* s = scratch;
  s[0] = x[0];
  s[n - 1] = x[0] + 1;
  out[0] = s[0] + s[n - 1];
}

// smem_probe (smem_probe.py:16): the whole (1, n) operand copied into
// dynamic shared memory by the block, then out = x[0] + x[n - 1] read
// there.
__global__ void __launch_bounds__(1024) smem_probe_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  extern __shared__ float operand[];
  for (int k = threadIdx.x; k < n; k += blockDim.x) operand[k] = x[k];
  __syncthreads();
  if (threadIdx.x == 0) out[0] = operand[0] + operand[n - 1];
}

// probe9 (mosaic_probe.py:354): the (8, 128) tile copied into shared memory
// by one bulk asynchronous copy (cp.async.bulk, the copy engine's
// counterpart of pltpu.make_async_copy), completed on an mbarrier that
// expects its 4,096 bytes (the semaphore's wait), then 128 reads
// sbuf[i % 8, (i * 37) % 128] summed in order by one thread.
__global__ void __launch_bounds__(32) probe9_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float sbuf[kTile];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const unsigned sb = (unsigned)__cvta_generic_to_shared(sbuf);
  const unsigned mb = (unsigned)__cvta_generic_to_shared(&bar);
  const unsigned bytes = kTile * sizeof(float);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(sb), "l"(x), "r"(bytes), "r"(mb) : "memory");
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(mb), "r"(0u)
        : "memory");
  }
  float acc = 0.0f;
  for (int i = 0; i < kLanes; ++i) acc += sbuf[(i % kRows) * kLanes + (i * 37) % kLanes];
  out[0] = acc;
}

// Butterfly sum of one value per lane: every lane ends with the warp's sum,
// added in the order the plain version repeats (lane l + lane l + 16
// first, then + 8, ... + 1).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(vpt::kFull, v, off);
  return v;
}

// probe11 (mosaic_probe.py:456): n drains, each the sum of the (8, 128)
// tile plus the drain's index, read as a scalar and stored where it is
// above -1: out[i % 128] = w.  A thread per element holds it in a
// register; a drain is a warp butterfly, 32 warp sums through shared
// memory and one more butterfly, two barriers, then one thread's
// conditional store.  The slots start at 0.
__global__ void __launch_bounds__(kTile) probe11_kernel(const float* __restrict__ x, int n,
                                                        float* __restrict__ out) {
  __shared__ float warp_sums[kTile / 32];
  __shared__ float slots[kLanes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float mine = x[threadIdx.x];
  if (threadIdx.x < kLanes) slots[threadIdx.x] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float s = warp_sum(mine);
    if (lane == 0) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
      const float w = warp_sum(warp_sums[lane]) + (float)i;
      if (lane == 0 && w > -1.0f) slots[i % kLanes] = w;
    }
    __syncthreads();
  }
  if (threadIdx.x < kLanes) out[threadIdx.x] = slots[threadIdx.x];
}

}  // namespace

extern "C" int vpt_probe1(const int32_t* perm, const float* x, float* out, void* stream) {
  probe1_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(perm, x, out);
  return launched();
}

extern "C" int vpt_probe2(const int32_t* gid, int n, int groups, int cap, int32_t* bins, int32_t* cnt, void* stream) {
  if (n < 0 || groups <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)groups * (cap + 1) * sizeof(int32_t);
  const int err = allow_smem(probe2_kernel, smem);
  if (err) return err;
  probe2_kernel<<<1, 1024, smem, (cudaStream_t)stream>>>(gid, n, groups, cap, bins, cnt);
  return launched();
}

extern "C" int vpt_probe3(const float* rays, const float* tris, int n_rays, int n_tris, float* out, void* stream) {
  if (n_rays <= 0 || n_tris <= 0 || n_rays * n_tris > 1024 || 9 * n_tris * sizeof(float) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  probe3_kernel<<<1, 1024, 9 * n_tris * sizeof(float), (cudaStream_t)stream>>>(rays, tris, n_rays, n_tris, out);
  return launched();
}

extern "C" int vpt_probe4(const int32_t* perm, const float* x, int n_iter, float* out, void* stream) {
  probe4_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(perm, x, n_iter, out);
  return launched();
}

extern "C" int vpt_probe5(const int32_t* perm, int n, float* out, void* stream) {
  probe5_kernel<<<1, kTile, 0, (cudaStream_t)stream>>>(perm, n, out);
  return launched();
}

extern "C" int vpt_probe6(const int32_t* perm, int n_iter, float* out, void* stream) {
  probe6_kernel<<<1, kTile, 0, (cudaStream_t)stream>>>(perm, n_iter, out);
  return launched();
}

extern "C" int vpt_probe8(const int32_t* x, int n, int32_t* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(int32_t);
  const int err = allow_smem(probe8_kernel, smem);
  if (err) return err;
  probe8_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(x, n, out);
  return launched();
}

extern "C" int vpt_probe9(const float* x, float* out, void* stream) {
  if ((uintptr_t)x % 16 != 0) return (int)cudaErrorInvalidValue;  // cp.async.bulk: 16-byte aligned
  probe9_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(x, out);
  return launched();
}

extern "C" int vpt_probe10(const float* rays, const float* tris, int n_rays, int n_tris, float* out, void* stream) {
  if (n_rays <= 0 || n_tris <= 0 || n_tris > 1024) return (int)cudaErrorInvalidValue;
  probe10_kernel<<<n_rays, (n_tris + 31) / 32 * 32, 0, (cudaStream_t)stream>>>(rays, tris, n_tris, out);
  return launched();
}

extern "C" int vpt_probe11(const float* x, int n, float* out, void* stream) {
  probe11_kernel<<<1, kTile, 0, (cudaStream_t)stream>>>(x, n, out);
  return launched();
}

extern "C" int vpt_smem_probe(const float* x, int n, float* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(float);
  const int err = allow_smem(smem_probe_kernel, smem);
  if (err) return err;
  smem_probe_kernel<<<1, 1024, smem, (cudaStream_t)stream>>>(x, n, out);
  return launched();
}

// The name of a CUDA error, for the probes' FAIL lines.
extern "C" int vpt_probe_error_name(int err, char* buf, int len) {
  const char* s = cudaGetErrorName((cudaError_t)err);
  int k = 0;
  for (; s[k] != '\0' && k < len - 1; ++k) buf[k] = s[k];
  buf[k] = '\0';
  return 0;
}
