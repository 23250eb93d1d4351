// Per-ray fused path trace for Hopper (sm_90a): a wavefront of given rays,
// each traced through up to trace_depth bounces in one launch, sphere-only
// scenes, gradient or no sky.
//
// Replaces: ops/pallas_megatrace.py::_kernel of the JAX package (launched
// by `megatrace`), the wavefront integrator's `mega` arm, with the hash
// PRNG of its hw_prng=False mode: bounce `depth` of lane i draws from
// lowbias32(seed + i * 9781 + stream * 6271 + depth * 26699).
// Plain version: ops/megatrace.py::megatrace_reference, which this kernel
// matches bit for bit under the precision contract of
// megatrace_common.cuh (no --use_fast_math, -fmad=false, fmaf where
// written, correctly rounded sqrt/rsqrt/sin/cos).
//
// What bounds it on this card: ALU in the sphere sweep.  Every bounce of
// every ray tests all S spheres (~20 flops each; ~8.9 kflop a bounce on the
// book cover's 485 spheres); device memory sees 28 bytes of ray in and 48
// bytes of results out per ray.
//
// What this simple design does about it: one thread owns one ray and keeps
// its whole path in registers through every bounce; each block stages the
// sphere geometry (16 bytes a sphere) in shared memory, read as a
// broadcast; the winner's 64-byte record is read through the read-only
// cache.  Past SPH_CULL_MIN = 1024 spheres (kBig: 16 KB a block would cut
// the blocks an SM, and a scene of 16k spheres would not fit at all) the
// build of its own reads the geometry through the read-only cache
// instead: the table (65.6 KB for sphere_field's 4,099 spheres) stays in
// L1 and L2, and the lanes of a warp read the same row at the same step.
// It sweeps every sphere, as JAX's per-ray kernel does.  A ray that leaves to the sky stops at once (the TPU kernel waits
// for its whole tile).  The bounce is megatrace_bounce.cuh, the same code
// as the batch kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "megatrace_bounce.cuh"

namespace {

using namespace rtiw;

constexpr int kOutRows = 12;  // radiance 0-2 | valid 3 | normal 4-6 |
                              // albedo 7-9 | events 10 | rays 11
constexpr int kThreads = 128;
constexpr uint32_t kSaltDepth = 26699u;

template <bool kBig>
__global__ void __launch_bounds__(kThreads) megatrace_wave_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const uint8_t* __restrict__ active, const float* __restrict__ sky_g,
    const float4* __restrict__ sph_g, const float* __restrict__ rec,
    float* __restrict__ out, int n, int s, int seed, int trace_depth,
    float t_min, int has_dielectrics, int sky_on) {
  extern __shared__ float4 staged[];
  const float4* sph = sph_g;
  if constexpr (!kBig) {
    for (int k = threadIdx.x; k < s; k += blockDim.x) staged[k] = sph_g[k];
    __syncthreads();
    sph = staged;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float sky[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) sky[k] = __ldg(sky_g + k);
  // lane id through float32, as the JAX kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)(float)i;
  const uint32_t lane_key = (uint32_t)seed + lane * 9781u;

  Path p{};
  p.ox = origin[3 * i];
  p.oy = origin[3 * i + 1];
  p.oz = origin[3 * i + 2];
  p.dx = direction[3 * i];
  p.dy = direction[3 * i + 1];
  p.dz = direction[3 * i + 2];
  p.thx = p.thy = p.thz = 1.f;
  p.active = active[i] != 0;
  float rays = 0.f;
  for (int depth = 0; depth < trace_depth && p.active; ++depth) {
    bounce(p, sph, s, rec, t_min, has_dielectrics != 0, sky_on != 0, sky,
           lane_key + (uint32_t)depth * kSaltDepth, depth);
    rays += 1.0f;
  }
  const float res[kOutRows] = {
      p.valid ? p.rx : 0.f, p.valid ? p.ry : 0.f, p.valid ? p.rz : 0.f,
      p.valid ? 1.f : 0.f, p.anx, p.any, p.anz, p.aax, p.aay, p.aaz,
      p.events, rays};
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) out[(size_t)k * n + i] = res[k];
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() right after the launch.  big != 0 takes the
// build that reads the spheres through the read-only cache (the wrapper
// passes it past SPH_CULL_MIN spheres).
extern "C" int rtiw_megatrace_wave(
    const float* origin, const float* direction, const uint8_t* active,
    const float* sky, const float* sph, const float* rec, float* out, int n,
    int s, int seed, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int big, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const size_t shmem = big ? 0 : (size_t)s * sizeof(float4);
    auto kernel = big ? megatrace_wave_kernel<true>
                      : megatrace_wave_kernel<false>;
    kernel<<<blocks, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
        origin, direction, active, sky, reinterpret_cast<const float4*>(sph),
        rec, out, n, s, seed, trace_depth, t_min, has_dielectrics, sky_on);
  }
  return static_cast<int>(cudaGetLastError());
}
