// One bounce of the bounce-synchronous streamed-mesh sampler for Hopper
// (sm_90a): every live lane of a path-state array in device memory.
//
// Replaces: ops/pallas_meshtrace.py::_sync_kernel of the JAX package (one
// `_bounce_step` per 1024-lane tile, state rows in and out, streamed
// triangles DMA'd super-block by super-block in a per-tile near-to-far
// order).
// Plain version: ops/meshtrace.py::bounce_sync_reference, bit for bit (the
// precision contract of megatrace_common.cuh, -fmad=false); the traversal
// below is modelled step for step by ops/meshtrace.py::sync_traversal.
//
// Layout: state is (24, n) float32, row-major, updated in place: rows 0-22
// the path (origin, direction, throughput, radiance, active, valid, AOV
// normal and albedo, got, events, rays), row 23 the lane id, which keys the
// hash PRNG and survives the compaction's permutations.  One thread owns
// one lane and reads its column: for each row a warp reads 32 neighbouring
// floats, so every access is coalesced.
//
// What bounds it on this card: ALU work in the triangle sweep (56 flops per
// ray-triangle test, 26 per AABB), and how much of it a warp's lanes share.
// Design: one thread block is one group of kGroup neighbouring lanes
// (after the pair compaction, rays of one direction octant from one patch
// of surface), whose triangle sweep is group_sweep.cuh's group traversal
// (near-to-far supers with an early stop, block votes, TMA-staged blocks,
// (lane, row) pairs dealt to the group).  This file keeps the state-column
// I/O around it; spheres are staged in shared memory as in the batch
// kernel, and the shading is megatrace_bounce.cuh's.
// meshtrace_visit_order_kernel reads the visit order back (for checks
// against meshtrace.tile_super_order; it stages nothing and writes no
// state).
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_sweep.cuh"

namespace {

using namespace rtiw;

constexpr int kLaneRow = 23;

__global__ void __launch_bounds__(kGroup) meshtrace_sync_kernel(
    float* __restrict__ state, int n, const float4* __restrict__ sph_g, int s,
    const float* __restrict__ rec, const float* __restrict__ sky_g,
    TriScene tri, uint32_t seed, uint32_t salt, int depth, float t_min,
    int has_dielectrics, int sky_on) {
  extern __shared__ float4 sph[];
  __shared__ __align__(128) GroupShared g;

  const int i = blockIdx.x * kGroup + threadIdx.x;
  float* col = state + i;  // row r of this lane at col[r * n]
  const bool live = i < n && col[12 * (size_t)n] > 0.0f;
  // a group without a live lane writes nothing: dead lanes keep every bit
  if (!__syncthreads_or(live)) return;
  for (int k = threadIdx.x; k < s; k += kGroup) sph[k] = sph_g[k];
  group_init(g);
  __syncthreads();

  float v[22];
#pragma unroll
  for (int r = 0; r < 22; ++r) v[r] = live ? col[r * (size_t)n] : 0.0f;
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
  float best_t = 0.0f;
  int best = 0;
  if (live) sphere_sweep(p, sph, s, t_min, best_t, best);
  bool tri_wins;
  int tri_idx;
  float tri_u, tri_v;
  GroupCursor cursor;
  group_hit(g, cursor, p, live, live && v[12] >= 0.5f, tri, t_min, best_t,
            tri_wins, tri_idx, tri_u, tri_v);
  if (!live) return;

  float sky[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) sky[k] = __ldg(sky_g + k);
  // the lane id through float32 and int32, as the JAX kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)col[kLaneRow * (size_t)n];
  shade<true>(p, best_t, best, tri_wins, tri_idx, tri_u, tri_v, rec,
              has_dielectrics != 0, sky_on != 0, sky,
              seed + lane * 9781u + salt, depth, tri);

  const float out[22] = {
      p.ox,  p.oy,  p.oz,  p.dx,  p.dy,  p.dz,  p.thx,         p.thy,
      p.thz, p.rx,  p.ry,  p.rz,  p.active ? 1.0f : 0.0f, p.valid ? 1.0f : 0.0f,
      p.anx, p.any, p.anz, p.aax, p.aay,  p.aaz, p.got ? 1.0f : 0.0f,
      p.events};
#pragma unroll
  for (int r = 0; r < 22; ++r) col[r * (size_t)n] = out[r];
  col[22 * (size_t)n] += 1.0f;  // one ray
}

// The visit order meshtrace_sync_kernel's block computes for the same
// lanes (every block, live lanes or not), into order / dist (blocks,
// tri.supers).
__global__ void __launch_bounds__(kGroup) meshtrace_visit_order_kernel(
    const float* __restrict__ state, int n, TriScene tri,
    int* __restrict__ order, float* __restrict__ dist) {
  __shared__ float fold[kGroupWarps][12];
  __shared__ float key[kMaxSupers];
  __shared__ int ord[kMaxSupers];
  __shared__ float dis[kMaxSupers];
  const int i = blockIdx.x * kGroup + threadIdx.x;
  const float* col = state + i;
  const float alive = i < n ? col[12 * (size_t)n] : 0.0f;
  Path p;
  p.ox = i < n ? col[0] : 0.0f;
  p.oy = i < n ? col[(size_t)n] : 0.0f;
  p.oz = i < n ? col[2 * (size_t)n] : 0.0f;
  p.dx = i < n ? col[3 * (size_t)n] : 0.0f;
  p.dy = i < n ? col[4 * (size_t)n] : 0.0f;
  p.dz = i < n ? col[5 * (size_t)n] : 0.0f;
  visit_order(p, alive > 0.0f && alive >= 0.5f, tri, fold, key, ord, dis);
  for (int k = threadIdx.x; k < tri.supers; k += kGroup) {
    order[(size_t)blockIdx.x * tri.supers + k] = ord[k];
    dist[(size_t)blockIdx.x * tri.supers + k] = dis[k];
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`
// and returns cudaGetLastError() right after the launch.

// Lanes of a thread block.
extern "C" int rtiw_meshtrace_sync_group() { return kGroup; }

// One bounce.  state: (24, n) floats; sph (s, 4), rec (s, 16), sky 6
// floats (bottom rgb, top rgb); the streamed tables as megatrace_batch.cu
// takes them (tri_geo (tri_rows, 12), 16-byte aligned, tri_aabb
// (tri_blocks, 8), tri_sup (tri_supers <= 128, 8), tri_rec (tri_rows,
// 32)); the hash base of a lane is seed + lane * 9781 + salt.
extern "C" int rtiw_meshtrace_sync(
    float* state, int n, const float* sph, int s, const float* rec,
    const float* sky, const float* tri_geo, const float* tri_aabb,
    const float* tri_sup, const float* tri_rec, int tri_rows, int tri_blocks,
    int tri_supers, uint32_t seed, uint32_t salt, int depth, float t_min,
    int has_dielectrics, int sky_on, void* stream) {
  if (tri_supers > kMaxSupers) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    TriScene tri;
    tri.geo = reinterpret_cast<const float4*>(tri_geo);
    tri.aabb = reinterpret_cast<const float4*>(tri_aabb);
    tri.sup = reinterpret_cast<const float4*>(tri_sup);
    tri.rec = tri_rec;
    tri.rows = tri_rows;
    tri.blocks = tri_blocks;
    tri.supers = tri_supers;
    const int blocks = (n + kGroup - 1) / kGroup;
    // the sphere table beside ~34 KB of static shared memory
    const size_t dyn = (size_t)s * sizeof(float4);
    const cudaError_t err = cudaFuncSetAttribute(
        meshtrace_sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    meshtrace_sync_kernel<<<blocks, kGroup, dyn,
                            static_cast<cudaStream_t>(stream)>>>(
        state, n, reinterpret_cast<const float4*>(sph), s, rec, sky, tri,
        seed, salt, depth, t_min, has_dielectrics, sky_on);
  }
  return static_cast<int>(cudaGetLastError());
}

// The visit order of every block of a launch on `state` (24, n): order
// (int32) and dist (float32), each (ceil(n / kGroup), tri_supers).
extern "C" int rtiw_meshtrace_visit_order(const float* state, int n,
                                          const float* tri_sup,
                                          int tri_supers, int* order,
                                          float* dist, void* stream) {
  if (tri_supers > kMaxSupers) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    TriScene tri;
    tri.sup = reinterpret_cast<const float4*>(tri_sup);
    tri.supers = tri_supers;
    meshtrace_visit_order_kernel<<<(n + kGroup - 1) / kGroup, kGroup, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        state, n, tri, order, dist);
  }
  return static_cast<int>(cudaGetLastError());
}
