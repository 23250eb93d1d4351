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
// of surface).  It walks the supers in the group's near-to-far order
// (`visit_order`, meshtrace.tile_super_order's: per group, a lower bound on
// the distance at which any live ray can enter each super, unreachable
// supers last; computed by the block itself, which costs a few barriers,
// where the same order as torch glue took 2.4 ms of a 17.8 ms bounce on an
// H100) and stops at the first super that no live lane could reach before
// its best hit so far: the order puts the likely winners first, so the
// bounds shrink early and the far side of the mesh is never read.  At a
// super one block-wide vote says which of its 16 blocks some lane's slab
// test reaches; those blocks' geometry rows (192 x 48 B) are copied into a
// ring of kStages shared-memory stages by TMA bulk copies (cp.async.bulk
// with an mbarrier), the next blocks' copies in flight while the current
// one is tested.  Each lane keeps its own culls (the super and block slab
// tests against its own best hit).  The lanes that pass a block's test are
// listed, and their (lane, row) pairs are dealt to all the group's threads
// (rays in shared memory): with one thread a lane, a warp ran a block's
// 192 rows for any one lane that passed, which at bounce 1 of mesh_huge
// was 4.8 times the tests the lanes needed (chip_smoke phase 19's warp
// share).  A lane's best hit is one 64-bit key in shared memory, (t, row)
// in lexicographic order, lowered by atomicMin, so in any visit order and
// any dealing the winner is the plain version's: the nearest hit, the
// earlier row on a tie.  Spheres are staged in shared memory as in the
// batch kernel; the shading is megatrace_bounce.cuh's.
// meshtrace_visit_order_kernel reads the visit order back (for checks
// against meshtrace.tile_super_order; it stages nothing and writes no
// state).
#include <cuda_runtime.h>
#include <stdint.h>

#include "megatrace_bounce.cuh"

namespace {

using namespace rtiw;

// Lanes of a block: meshtrace.SYNC_GROUP, which the loader checks (PERF.md
// has the readings that chose 128 over 64 and 256).
constexpr int kGroup = 128;
constexpr int kWarps = kGroup / 32;
constexpr int kLaneRow = 23;
constexpr int kStages = 3;  // shared-memory stages of the block ring
constexpr int kBlockVec = 3 * kTriBlock;  // float4s of one block's geometry
constexpr uint32_t kStageBytes = kBlockVec * sizeof(float4);  // 9216
constexpr float kUnreached = 1e29f;  // below the visit order's +inf
constexpr int kMaxSupers = 128;  // supers of TRI_STREAM_MAX triangles: 86

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy block `blk`'s geometry rows into the stage `dst`; `bar` completes
// when the bytes have landed.  One thread issues it.
__device__ __forceinline__ void stage_block(float4* dst, const float4* geo,
                                            int blk, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(kStageBytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(geo + (size_t)blk * kBlockVec), "r"(kStageBytes),
      "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The OR of `m` over the block; every thread calls it.  The two slot rows
// alternate, so a row is written again only after the barrier of the
// next call, which every thread reaches after reading it.
__device__ __forceinline__ unsigned block_or(unsigned m,
                                             unsigned (*votes)[kWarps],
                                             int& row) {
  m = __reduce_or_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31) == 0) votes[row][threadIdx.x >> 5] = m;
  __syncthreads();
  unsigned all = 0;
  for (int w = 0; w < kWarps; ++w) all |= votes[row][w];
  row ^= 1;
  return all;
}

// (t, row) as one integer whose order is the lexicographic order of the
// pairs (t by its IEEE order, then row), and back.
__device__ __forceinline__ unsigned long long hit_key(float t, int row) {
  uint32_t u = __float_as_uint(t);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)row;
}

__device__ __forceinline__ float key_time(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// The min (kMin) or max of `x` over the warp.
template <bool kMin>
__device__ __forceinline__ float warp_fold(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xFFFFFFFFu, x, off);
    x = kMin ? fminf(x, y) : fmaxf(x, y);
  }
  return x;
}

// The group's visit order, meshtrace.tile_super_order's for this block's
// lanes, into ord / dis (shared): the bounds of the live lanes' origins
// and directions (flag act), per super 0.999 x the Euclidean gap between
// the origin box and its AABB, +inf where no live direction points towards
// a super wholly on one side of the origins, then a stable rank sort.
__device__ __forceinline__ void visit_order(const Path& p, bool act,
                                            const TriScene& tri,
                                            float (*fold)[12], float* key,
                                            int* ord, float* dis) {
  const float big = 1e30f;
  float b[12] = {act ? p.ox : big,   act ? p.oy : big,   act ? p.oz : big,
                 act ? p.ox : -big,  act ? p.oy : -big,  act ? p.oz : -big,
                 act ? p.dx : big,   act ? p.dy : big,   act ? p.dz : big,
                 act ? p.dx : -big,  act ? p.dy : -big,  act ? p.dz : -big};
#pragma unroll
  for (int k = 0; k < 12; ++k)
    b[k] = (k / 3) % 2 == 0 ? warp_fold<true>(b[k]) : warp_fold<false>(b[k]);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < 12; ++k) fold[threadIdx.x >> 5][k] = b[k];
  __syncthreads();
  for (int w = 0; w < kWarps; ++w)
#pragma unroll
    for (int k = 0; k < 12; ++k)
      b[k] = (k / 3) % 2 == 0 ? fminf(b[k], fold[w][k])
                              : fmaxf(b[k], fold[w][k]);
  for (int s = threadIdx.x; s < tri.supers; s += kGroup) {
    const float4 lo = __ldg(tri.sup + 2 * s);
    const float4 hi = __ldg(tri.sup + 2 * s + 1);
    const float slo[3] = {lo.x, lo.y, lo.z}, shi[3] = {hi.x, hi.y, hi.z};
    float g[3];
    bool unreach = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g[k] = fmaxf(fmaxf(slo[k] - b[3 + k], b[k] - shi[k]), 0.0f);
      unreach |= (slo[k] > b[3 + k] && b[9 + k] <= 0.0f) ||
                 (shi[k] < b[k] && b[6 + k] >= 0.0f);
    }
    key[s] = unreach ? __int_as_float(0x7f800000)
                     : sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) * 0.999f;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < tri.supers; s += kGroup) {
    const float ks = key[s];
    int rank = 0;
    for (int r = 0; r < tri.supers; ++r)
      rank += key[r] < ks || (key[r] == ks && r < s);
    ord[rank] = s;
    dis[rank] = ks;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kGroup) meshtrace_sync_kernel(
    float* __restrict__ state, int n, const float4* __restrict__ sph_g, int s,
    const float* __restrict__ rec, const float* __restrict__ sky_g,
    TriScene tri, uint32_t seed, uint32_t salt, int depth, float t_min,
    int has_dielectrics, int sky_on) {
  extern __shared__ float4 sph[];
  __shared__ __align__(128) float4 ring[kStages][kBlockVec];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ unsigned votes[2][kWarps];
  __shared__ float fold[kWarps][12];
  __shared__ float key[kMaxSupers];
  __shared__ int ord[kMaxSupers];
  __shared__ float dis[kMaxSupers];
  __shared__ float ray[6][kGroup];  // each lane's origin, direction
  __shared__ unsigned long long best_key[kGroup];  // hit_key of a lane
  __shared__ int passing[kGroup];  // lanes that sweep the staged block
  __shared__ int warp_count[kWarps];

  const int i = blockIdx.x * kGroup + threadIdx.x;
  float* col = state + i;  // row r of this lane at col[r * n]
  const bool live = i < n && col[12 * (size_t)n] > 0.0f;
  // a group without a live lane writes nothing: dead lanes keep every bit
  if (!__syncthreads_or(live)) return;
  for (int k = threadIdx.x; k < s; k += kGroup) sph[k] = sph_g[k];
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&full[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
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
  const int me = threadIdx.x;
  ray[0][me] = p.ox;
  ray[1][me] = p.oy;
  ray[2][me] = p.oz;
  ray[3][me] = p.dx;
  ray[4][me] = p.dy;
  ray[5][me] = p.dz;
  best_key[me] = hit_key(kBig, 0);

  // ---- the group's visit order -------------------------------------------
  visit_order(p, live && v[12] >= 0.5f, tri, fold, key, ord, dis);

  // a dead lane's bound 0 keeps it out of every vote
  float best_t = 0.0f;
  int best = 0;
  if (live) sphere_sweep(p, sph, s, t_min, best_t, best);

  // ---- the group's triangle sweep ---------------------------------------
  const float ivx = inv_dir(p.dx), ivy = inv_dir(p.dy), ivz = inv_dir(p.dz);
  const int warp = me >> 5;
  int vote_row = 0;
  uint32_t used = 0;  // blocks staged so far: block u in stage u % kStages,
                      // the (u / kStages)-th phase of its barrier
  for (int k = 0; k < tri.supers; ++k) {
    const float d = dis[k];
    if (!(d < kUnreached)) break;  // this super and the rest: unreachable
    const int sup = ord[k];
    const float lb = fminf(key_time(best_key[me]), best_t);
    // bit kTriSup: this lane may hit something here before its best hit;
    // bit j: its slab tests reach the super and its block j
    unsigned m = 0;
    if (live && d < lb) {
      m = 1u << kTriSup;
      if (slab_may(tri.sup + 2 * sup, p.ox, p.oy, p.oz, ivx, ivy, ivz, t_min,
                   lb))
        for (int j = 0; j < kTriSup; ++j)
          if (slab_may(tri.aabb + 2 * (sup * kTriSup + j), p.ox, p.oy, p.oz,
                       ivx, ivy, ivz, t_min, lb))
            m |= 1u << j;
    }
    m = block_or(m, votes, vote_row);
    // no live lane reaches it in time, nor any later (farther) super
    if (!(m >> kTriSup)) break;
    unsigned sweep = m & ((1u << kTriSup) - 1u);
    unsigned issue = sweep;  // thread 0's blocks still to copy
    if (threadIdx.x == 0)
      for (int q = 0; q < kStages && issue; ++q) {
        const int j = __ffs(issue) - 1;
        issue &= issue - 1u;
        const uint32_t st = (used + q) % kStages;
        stage_block(ring[st], tri.geo, sup * kTriSup + j, &full[st]);
      }
    while (sweep) {
      const int blk = sup * kTriSup + __ffs(sweep) - 1;
      sweep &= sweep - 1u;
      const uint32_t st = used % kStages;
      wait_stage(&full[st], (used / kStages) & 1u);
      // each lane's own cull against its best hit so far, then the passing
      // lanes listed in thread order
      const float bound = fminf(key_time(best_key[me]), best_t);
      const bool pass = live && slab_may(tri.aabb + 2 * blk, p.ox, p.oy, p.oz,
                                         ivx, ivy, ivz, t_min, bound);
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, pass);
      if ((me & 31) == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, count = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_count[w] : 0;
        count += warp_count[w];
      }
      if (pass)
        passing[before + __popc(ballot & ((1u << (me & 31)) - 1u))] = me;
      __syncthreads();
      // the (lane, row) pairs dealt to the group's threads, a lane's rows
      // to neighbouring threads; the lexicographic minimum of (t, row) by
      // atomicMin, so the earlier row wins a tie in any order
      const float4* rows = ring[st];
      const int base = blk * kTriBlock;
      for (int q = me; q < count * kTriBlock; q += kGroup) {
        const int ln = passing[q / kTriBlock], r = q % kTriBlock;
        const float4 g0 = rows[3 * r];
        const float4 g1 = rows[3 * r + 1];
        const float4 g2 = rows[3 * r + 2];
        float u, w;
        const float t = moller_trumbore(
            ray[0][ln], ray[1][ln], ray[2][ln], ray[3][ln], ray[4][ln],
            ray[5][ln], g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w, g2.x,
            t_min, u, w);
        if (t < kBig) {
          const unsigned long long key = hit_key(t, base + r);
          if (key < best_key[ln]) atomicMin(&best_key[ln], key);
        }
      }
      __syncthreads();  // every lane is done with stage st
      ++used;
      if (threadIdx.x == 0 && issue) {
        const int j = __ffs(issue) - 1;
        issue &= issue - 1u;
        stage_block(ring[st], tri.geo, sup * kTriSup + j, &full[st]);
      }
    }
  }
  if (!live) return;
  const unsigned long long won = best_key[me];
  const float tri_t = key_time(won);
  const int tri_idx = (int)(uint32_t)won;
  const bool tri_wins = tri_t < best_t;
  float tri_u = 0.f, tri_v = 0.f;
  if (tri_wins) {
    best_t = tri_t;
    // the winner's barycentrics, as its test computed them
    const float4 g0 = __ldg(tri.geo + 3 * tri_idx);
    const float4 g1 = __ldg(tri.geo + 3 * tri_idx + 1);
    const float4 g2 = __ldg(tri.geo + 3 * tri_idx + 2);
    moller_trumbore(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, g0.x, g0.y, g0.z,
                    g0.w, g1.x, g1.y, g1.z, g1.w, g2.x, t_min, tri_u, tri_v);
  }

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
  __shared__ float fold[kWarps][12];
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
    // the sphere table beside ~40 KB of static shared memory
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
