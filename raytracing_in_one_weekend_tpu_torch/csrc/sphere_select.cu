// Nearest-sphere selection for Hopper (sm_90a): every ray against every
// sphere, the nearest entry distance and its winner.
//
// Replaces, from ops/pallas_sphere.py of the JAX package:
// * `_kernel` (sphere_select): nearest t, winner index, winner exit t;
//   the detached selection under the differentiable wavefront's
//   intersect.nearest_hit, which re-evaluates the winner with gradients;
// * `_kernel_full` (sphere_select_full): nearest t, winner exit t and the
//   winner's 16-column record (material payload, centre, 1/r), for the
//   forward wavefront's fast arm.  A block whose rays are all inactive
//   writes the miss sentinels and skips the sweep.
// Plain versions: ops/sphere_select.py::sphere_select_reference and
// sphere_select_full_reference, which this kernel matches bit for bit:
// the same operations in the same order, IEEE sqrt and division, no
// --use_fast_math and -fmad=false, so nothing is contracted.
//
// What bounds it on this card: ALU.  Each (ray, sphere) pair costs ~20
// flops (two 3-dots, the discriminant, a square root and two roots where
// it is positive); at 512x512 rays and the cover's 485 spheres that is
// ~2.5 GFLOP, ~38 us at the FP32 peak, against ~9-26 MB of rays in and
// results out (3-8 us at 3.35 TB/s).
//
// What this simple design does about it: one thread owns one ray and
// keeps it in registers; each block stages the sphere geometry (centre and
// |c|^2 - r^2, 16 bytes a sphere) in shared memory, 1024 spheres at a time,
// and every thread of a warp reads the same sphere at the same step (a
// broadcast).  The winner's record is read once per ray through the
// read-only cache instead of the TPU kernel's one-hot matrix product.  The
// TPU kernel's (8, 128) padding and its far-away pad spheres are gone: the
// loop runs over the real spheres only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // spheres staged in shared memory at a time
constexpr int kRec = 16;

struct Best {
  float t;
  float exit;
  int idx;
};

// Sweep all s spheres for the ray (o, d), staging them chunk by chunk.
// Every thread of the block calls this (the staging synchronises);
// `live` says whether this thread's ray is swept.
__device__ Best sweep(const float4* __restrict__ sph_g, int s, float t_min,
                      bool live, float ox, float oy, float oz, float dx,
                      float dy, float dz, float4* sh) {
  const float a = (dx * dx + dy * dy) + dz * dz;
  const float o_dot_d = (ox * dx + oy * dy) + oz * dz;
  const float o_sq = (ox * ox + oy * oy) + oz * oz;
  const float inv_a = 1.0f / a;
  Best best{kBig, kBig, 0};
  for (int base = 0; base < s; base += kChunk) {
    const int count = min(kChunk, s - base);
    __syncthreads();
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      sh[k] = sph_g[base + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < count; ++k) {
      const float4 g = sh[k];
      const float d_dot_c = (dx * g.x + dy * g.y) + dz * g.z;
      const float o_dot_c = (ox * g.x + oy * g.y) + oz * g.z;
      const float b = o_dot_d - d_dot_c;
      const float c = (o_sq - 2.0f * o_dot_c) + g.w;
      const float disc = b * b - a * c;
      if (disc > 0.0f) {
        const float sq = sqrtf(disc);
        const float t_near = (-b - sq) * inv_a;
        const float t_far = (-b + sq) * inv_a;
        const bool far_ok = t_far > t_min;
        const float t = t_near > t_min ? t_near : (far_ok ? t_far : kBig);
        if (t < best.t) {  // strict: the first index wins a tie (argmin)
          best.t = t;
          best.exit = far_ok ? t_far : kBig;
          best.idx = base + k;
        }
      }
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads) sphere_select_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float4* __restrict__ sph_g, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ exit_out, int n, int s,
    float t_min) {
  __shared__ float4 sh[kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int j = live ? i : 0;
  const Best best = sweep(
      sph_g, s, t_min, live, origin[3 * j], origin[3 * j + 1],
      origin[3 * j + 2], direction[3 * j], direction[3 * j + 1],
      direction[3 * j + 2], sh);
  if (!live) return;
  t_out[i] = best.t;
  idx_out[i] = best.idx;
  exit_out[i] = best.t < kBig ? best.exit : kBig;
}

__global__ void __launch_bounds__(kThreads) sphere_select_full_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const uint8_t* __restrict__ active, const float4* __restrict__ sph_g,
    const float* __restrict__ rec_g, float* __restrict__ t_out,
    float* __restrict__ exit_out, float* __restrict__ rec_out, int n, int s,
    float t_min, int want_exit) {
  __shared__ float4 sh[kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  const bool act = in_range && active[i] != 0;
  if (!__syncthreads_or(act)) {
    // no active ray in this block: miss sentinels, zero records
    if (in_range) {
      t_out[i] = kBig;
      exit_out[i] = kBig;
      for (int k = 0; k < kRec; ++k) rec_out[(size_t)i * kRec + k] = 0.0f;
    }
    return;
  }
  const int j = in_range ? i : 0;
  const Best best = sweep(
      sph_g, s, t_min, in_range, origin[3 * j], origin[3 * j + 1],
      origin[3 * j + 2], direction[3 * j], direction[3 * j + 1],
      direction[3 * j + 2], sh);
  if (!in_range) return;
  t_out[i] = best.t;
  exit_out[i] = (want_exit && best.t < kBig) ? best.exit : kBig;
  // the winner's record (sphere 0's on a miss, as argmin's one-hot picks)
  const float4* w = reinterpret_cast<const float4*>(rec_g + (size_t)best.idx * kRec);
  float4* o = reinterpret_cast<float4*>(rec_out + (size_t)i * kRec);
#pragma unroll
  for (int k = 0; k < kRec / 4; ++k) o[k] = __ldg(w + k);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`
// and returns cudaGetLastError() right after the launch.
extern "C" int rtiw_sphere_select(const float* origin, const float* direction,
                                  const float* sph, float* t_out,
                                  int* idx_out, float* exit_out, int n, int s,
                                  float t_min, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    sphere_select_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        origin, direction, reinterpret_cast<const float4*>(sph), t_out,
        idx_out, exit_out, n, s, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtiw_sphere_select_full(
    const float* origin, const float* direction, const uint8_t* active,
    const float* sph, const float* rec, float* t_out, float* exit_out,
    float* rec_out, int n, int s, float t_min, int want_exit, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    sphere_select_full_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        origin, direction, active, reinterpret_cast<const float4*>(sph), rec,
        t_out, exit_out, rec_out, n, s, t_min, want_exit);
  }
  return static_cast<int>(cudaGetLastError());
}
