// One bounce of the bounce-synchronous streamed-mesh sampler for Hopper
// (sm_90a): every live lane of a path-state array in device memory.
//
// Replaces: ops/pallas_meshtrace.py::_sync_kernel of the JAX package (one
// `_bounce_step` per 1024-lane tile, state rows in and out, streamed
// triangles DMA'd super-block by super-block in a per-tile near-to-far
// order).
// Plain version: ops/meshtrace.py::bounce_sync_reference, bit for bit (the
// precision contract of megatrace_common.cuh, -fmad=false).
//
// Layout: state is (24, n) float32, row-major, updated in place: rows 0-22
// the path (origin, direction, throughput, radiance, active, valid, AOV
// normal and albedo, got, events, rays), row 23 the lane id, which keys the
// hash PRNG and survives the compaction's permutations.  One thread owns
// one lane and reads its column: for each row a warp reads 32 neighbouring
// floats, so every access is coalesced.
//
// What bounds it on this card: ALU work and divergence in the triangle
// sweep (56 flops per ray-triangle test, plus a slab test per super and per
// block a ray's cull reaches), as in the batch kernel; the state moves 96
// bytes in and out per live lane per bounce.  The JAX kernel orders a
// tile's super-blocks near to far (`_tile_super_order`) so that its DMAs
// stop early; here each lane culls for itself with the batch kernel's
// two-level test (megatrace_bounce.cuh), visiting supers in index order,
// which finds the same nearest hit (the earlier row on a tie).  Dead lanes
// return at once and write nothing, the form the JAX kernel's whole-tile
// early-out takes per lane.  Spheres are staged in shared memory as in the
// batch kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "megatrace_bounce.cuh"

namespace {

using namespace rtiw;

constexpr int kThreads = 128;
constexpr int kLaneRow = 23;

__global__ void __launch_bounds__(kThreads) meshtrace_sync_kernel(
    float* __restrict__ state, int n, const float4* __restrict__ sph_g, int s,
    const float* __restrict__ rec, const float* __restrict__ sky_g,
    TriScene tri, uint32_t seed, uint32_t salt, int depth, float t_min,
    int has_dielectrics, int sky_on) {
  extern __shared__ float4 sph[];
  for (int k = threadIdx.x; k < s; k += blockDim.x) sph[k] = sph_g[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* col = state + i;  // row r of this lane at col[r * n]
  if (!(col[12 * (size_t)n] > 0.0f)) return;  // dead: every bit stays

  float v[22];
#pragma unroll
  for (int r = 0; r < 22; ++r) v[r] = col[r * (size_t)n];
  Path p;
  p.ox = v[0];
  p.oy = v[1];
  p.oz = v[2];
  p.dx = v[3];
  p.dy = v[4];
  p.dz = v[5];
  p.thx = v[6];
  p.thy = v[7];
  p.thz = v[8];
  p.rx = v[9];
  p.ry = v[10];
  p.rz = v[11];
  p.active = true;
  p.valid = v[13] > 0.5f;
  p.anx = v[14];
  p.any = v[15];
  p.anz = v[16];
  p.aax = v[17];
  p.aay = v[18];
  p.aaz = v[19];
  p.got = v[20] > 0.5f;
  p.events = v[21];
  float sky[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) sky[k] = __ldg(sky_g + k);
  // the lane id through float32 and int32, as the JAX kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)col[kLaneRow * (size_t)n];
  bounce<true, true>(p, sph, s, rec, t_min, has_dielectrics != 0,
                     sky_on != 0, sky, seed + lane * 9781u + salt, depth, tri);

  const float out[22] = {
      p.ox,  p.oy,  p.oz,  p.dx,  p.dy,  p.dz,  p.thx,         p.thy,
      p.thz, p.rx,  p.ry,  p.rz,  p.active ? 1.0f : 0.0f, p.valid ? 1.0f : 0.0f,
      p.anx, p.any, p.anz, p.aax, p.aay,  p.aaz, p.got ? 1.0f : 0.0f,
      p.events};
#pragma unroll
  for (int r = 0; r < 22; ++r) col[r * (size_t)n] = out[r];
  col[22 * (size_t)n] += 1.0f;  // one ray
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() right after the launch.  state: (24, n)
// floats; sph (s, 4), rec (s, 16), sky 6 floats (bottom rgb, top rgb);
// the streamed tables as megatrace_batch.cu takes them (tri_geo (tri_rows,
// 12), tri_aabb (tri_blocks, 8), tri_sup (tri_supers, 8), tri_rec
// (tri_rows, 32)); the hash base of a lane is seed + lane * 9781 + salt.
extern "C" int rtiw_meshtrace_sync(
    float* state, int n, const float* sph, int s, const float* rec,
    const float* sky, const float* tri_geo, const float* tri_aabb,
    const float* tri_sup, const float* tri_rec, int tri_rows, int tri_blocks,
    int tri_supers, uint32_t seed, uint32_t salt, int depth, float t_min,
    int has_dielectrics, int sky_on, void* stream) {
  if (n > 0) {
    TriScene tri;
    tri.geo = reinterpret_cast<const float4*>(tri_geo);
    tri.aabb = reinterpret_cast<const float4*>(tri_aabb);
    tri.sup = reinterpret_cast<const float4*>(tri_sup);
    tri.rec = tri_rec;
    tri.rows = tri_rows;
    tri.blocks = tri_blocks;
    tri.supers = tri_supers;
    const int blocks = (n + kThreads - 1) / kThreads;
    meshtrace_sync_kernel<<<blocks, kThreads, (size_t)s * sizeof(float4),
                            static_cast<cudaStream_t>(stream)>>>(
        state, n, reinterpret_cast<const float4*>(sph), s, rec, sky, tri, seed,
        salt, depth, t_min, has_dielectrics, sky_on);
  }
  return static_cast<int>(cudaGetLastError());
}
