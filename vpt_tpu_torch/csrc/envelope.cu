// Ray-vs-group envelope kernels for the stream and occlude trace paths.
//
// Replaces the two Pallas kernels of vpt_tpu/accel/envelope.py:
//   vpt_ray_keys          <- envelope.ray_keys (_keys_kernel)
//   vpt_supertile_tables  <- envelope.supertile_tables (_tables_kernel)
//
// Both evaluate the same slab formula per (ray, padded group box): tn starts
// at t_min, tf at the ray's tmax, per axis s0 = (lo - o) * inv and
// s1 = (hi - o) * inv, and the ray enters the group iff tn <= tf, entry = tn.
// Built with --fmad=false, so every product and sum rounds exactly like the
// plain torch versions in vpt_tpu_torch/accel/envelope.py.
//
// What bounds them on the H100: both are N x Gp slab tests (about 20 float
// operations each) over data that fits in shared memory or registers.  At
// the main path's N = 262,144 rays and Gp = 640 groups that is 3.4 GFLOP per
// call, a few milliseconds of FP32 issue; memory traffic is only the rays
// (28 B each) and the output.  The simple design keeps the group boxes
// (ray_keys) or the supertile's rays (supertile_tables) in shared memory so
// the inner loop reads shared memory and registers only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSupertile = 1024;  // rays per supertile (stream.py SUPER_ROWS * 128)

// torch.minimum / torch.maximum propagate NaN; fminf / fmaxf drop it.
__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Entry distance of one ray into one box, +inf when it does not enter.
__device__ __forceinline__ float slab_entry(
    float ox, float oy, float oz, float ix, float iy, float iz, float tmax,
    float lx, float ly, float lz, float hx, float hy, float hz, float t_min) {
  float tn = t_min, tf = tmax;
  float s0 = (lx - ox) * ix, s1 = (hx - ox) * ix;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  s0 = (ly - oy) * iy;
  s1 = (hy - oy) * iy;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  s0 = (lz - oz) * iz;
  s1 = (hz - oz) * iz;
  tn = pmax(tn, pmin(s0, s1));
  tf = pmin(tf, pmax(s0, s1));
  return (tn <= tf) ? tn : INFINITY;
}

// One thread per ray; the (3, Gp) lo/hi group boxes sit in shared memory.
// Walking groups in ascending id with strict '<' keeps the lexicographic
// (entry, id) minimum of envelope.py:_minsel: entry ties go to the lower id.
__global__ void ray_keys_kernel(
    const float* __restrict__ origin, const float* __restrict__ inv,
    const float* __restrict__ tmax, const float* __restrict__ gmin,
    const float* __restrict__ gmax, int n, int gp, float t_min, int levels,
    int32_t* __restrict__ key) {
  extern __shared__ float boxes[];  // [xlo ylo zlo xhi yhi zhi] x gp
  for (int k = threadIdx.x; k < 3 * gp; k += blockDim.x) {
    boxes[k] = gmin[k];
    boxes[3 * gp + k] = gmax[k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float ix = inv[3 * i], iy = inv[3 * i + 1], iz = inv[3 * i + 2];
  const float tm = tmax[i];
  float v1 = INFINITY, v2 = INFINITY;
  int a1 = gp, a2 = gp;
  for (int g = 0; g < gp; ++g) {
    const float e = slab_entry(
        ox, oy, oz, ix, iy, iz, tm, boxes[g], boxes[gp + g], boxes[2 * gp + g],
        boxes[3 * gp + g], boxes[4 * gp + g], boxes[5 * gp + g], t_min);
    if (e < v1) {
      v2 = v1;
      a2 = a1;
      v1 = e;
      a1 = g;
    } else if (e < v2) {
      v2 = e;
      a2 = g;
    }
  }
  const int l0 = (v1 < INFINITY) ? a1 : gp;
  const int l1 = (v2 < INFINITY) ? a2 : gp;
  key[i] = (levels == 2) ? l0 * (gp + 1) + l1 : l0;
}

// One block per 1024-ray supertile: its rays are staged in shared memory and
// each thread owns groups g = tid, tid + blockDim, ... taking the minimum
// entry over the staged rays.  No atomics: every output has one writer.
__global__ void supertile_tables_kernel(
    const float* __restrict__ origin, const float* __restrict__ inv,
    const float* __restrict__ tmax, const float* __restrict__ gmin,
    const float* __restrict__ gmax, int gp, float t_min,
    float* __restrict__ out) {
  __shared__ float so[3][kSupertile];
  __shared__ float si[3][kSupertile];
  __shared__ float st[kSupertile];
  const int base = blockIdx.x * kSupertile;
  for (int r = threadIdx.x; r < kSupertile; r += blockDim.x) {
    const int i = base + r;
    for (int ax = 0; ax < 3; ++ax) {
      so[ax][r] = origin[3 * i + ax];
      si[ax][r] = inv[3 * i + ax];
    }
    st[r] = tmax[i];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < gp; g += blockDim.x) {
    const float lx = gmin[g], ly = gmin[gp + g], lz = gmin[2 * gp + g];
    const float hx = gmax[g], hy = gmax[gp + g], hz = gmax[2 * gp + g];
    float best = INFINITY;
    for (int r = 0; r < kSupertile; ++r) {
      const float e = slab_entry(
          so[0][r], so[1][r], so[2][r], si[0][r], si[1][r], si[2][r], st[r],
          lx, ly, lz, hx, hy, hz, t_min);
      best = fminf(best, e);
    }
    out[(size_t)blockIdx.x * gp + g] = best;
  }
}

}  // namespace

extern "C" int vpt_ray_keys(
    const float* origin, const float* inv, const float* tmax, const float* gmin,
    const float* gmax, int n, int gp, float t_min, int levels, int32_t* key,
    void* stream) {
  const size_t smem = (size_t)6 * gp * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ray_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  ray_keys_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      origin, inv, tmax, gmin, gmax, n, gp, t_min, levels, key);
  return (int)cudaGetLastError();
}

extern "C" int vpt_supertile_tables(
    const float* origin, const float* inv, const float* tmax, const float* gmin,
    const float* gmax, int n, int gp, float t_min, float* out, void* stream) {
  const int blocks = n / kSupertile;
  supertile_tables_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      origin, inv, tmax, gmin, gmax, gp, t_min, out);
  return (int)cudaGetLastError();
}
