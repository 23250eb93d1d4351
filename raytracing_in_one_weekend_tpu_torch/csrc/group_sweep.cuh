// The group traversal of streamed triangle tables: one thread block is one
// group of kGroup lanes, each thread one lane, sweeping the triangles of
// TriScene's supers and blocks for the group's live lanes at once.  Shared
// by the bounce-synchronous sampler's bounce (meshtrace_sync.cu, one
// bounce a launch) and the batch kernel's streamed build
// (megatrace_batch.cu, every iteration of a batch in lockstep).  Plain
// model: ops/meshtrace.py::sync_traversal, step for step; the winners are
// those of the index-order sweep ops/megatrace.py::_tri_stream_sweep.
//
// The group walks the supers in its near-to-far order (`visit_order`,
// meshtrace.tile_super_order's: per group, a lower bound on the distance
// at which any live ray can enter each super, unreachable supers last;
// computed by the block itself with a few barriers, where the same order
// as torch glue took 2.4 ms of a 17.8 ms bounce on an H100) and stops at
// the first super that no live lane could reach before its best hit so
// far: the order puts the likely winners first, so the bounds shrink early
// and the far side of the mesh is never read.  At a super one block-wide
// vote says which of its 16 blocks some lane's slab test reaches; those
// blocks' geometry rows (192 x 48 B) are copied into a ring of kStages
// shared-memory stages by TMA bulk copies (cp.async.bulk with an
// mbarrier), the next blocks' copies in flight while the current one is
// tested.  Each lane keeps its own culls (the super and block slab tests
// against its own best hit).  The lanes that pass a block's test are
// listed, and their (lane, row) pairs are dealt to all the group's threads
// (rays in shared memory): with one thread a lane, a warp ran a block's
// 192 rows for any one lane that passed, which at bounce 1 of mesh_huge
// was 4.8 times the tests the lanes needed (chip_smoke phase 19's warp
// share).  A lane's best hit is one 64-bit key in shared memory, (t, row)
// in lexicographic order, lowered by atomicMin, so in any visit order and
// any dealing the winner is the plain version's: the nearest hit, the
// earlier row on a tie.
//
// Barriers: every thread of the block calls group_hit, live lane or not.
// A dead lane (live false) has bound 0, so it never votes, never passes a
// block and never wins.
#pragma once

#include <stdint.h>

#include "megatrace_bounce.cuh"

namespace rtiw {

// Lanes of a group: meshtrace.SYNC_GROUP, which the loaders check (PERF.md
// has the readings that chose 128 over 64 and 256).
constexpr int kGroup = 128;
constexpr int kGroupWarps = kGroup / 32;
constexpr int kStages = 3;  // shared-memory stages of the block ring
constexpr int kBlockVec = 3 * kTriBlock;  // float4s of one block's geometry
constexpr uint32_t kStageBytes = kBlockVec * sizeof(float4);  // 9216
constexpr float kUnreached = 1e29f;  // below the visit order's +inf
constexpr int kMaxSupers = 128;  // supers of TRI_STREAM_MAX triangles: 86

// A group's working set in shared memory (about 34 KB).
struct GroupShared {
  float4 ring[kStages][kBlockVec];
  uint64_t full[kStages];  // the ring's mbarriers
  unsigned votes[2][kGroupWarps];
  float fold[kGroupWarps][12];
  float key[kMaxSupers];
  int ord[kMaxSupers];
  float dis[kMaxSupers];
  float ray[6][kGroup];  // each lane's origin, direction
  unsigned long long best_key[kGroup];  // hit_key of a lane's best hit
  int passing[kGroup];  // lanes that sweep the current block
  int warp_count[kGroupWarps];
};

// What a group's traversal carries from one call of group_hit to the next:
// the vote row and the blocks staged so far (block u in stage u % kStages,
// the (u / kStages)-th phase of its barrier).
struct GroupCursor {
  int vote_row = 0;
  uint32_t used = 0;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Does the ray (o, 1/d = iv) meet the AABB at box[0] (lo) .. box[1] (hi)
// at or after t_min and before `bound`?  The JAX kernel's slab test.
__device__ __forceinline__ bool slab_may(const float4* box, float ox,
                                         float oy, float oz, float ivx,
                                         float ivy, float ivz, float t_min,
                                         float bound) {
  const float4 lo = __ldg(box);
  const float4 hi = __ldg(box + 1);
  const float bx0 = (lo.x - ox) * ivx, bx1 = (hi.x - ox) * ivx;
  const float by0 = (lo.y - oy) * ivy, by1 = (hi.y - oy) * ivy;
  const float bz0 = (lo.z - oz) * ivz, bz1 = (hi.z - oz) * ivz;
  const float b_near =
      fmaxf(fminf(bx0, bx1), fmaxf(fminf(by0, by1), fminf(bz0, bz1)));
  const float b_far =
      fminf(fmaxf(bx0, bx1), fminf(fmaxf(by0, by1), fmaxf(bz0, bz1)));
  return b_far >= fmaxf(b_near, t_min) && b_near < bound;
}

// Initialise the ring's barriers (thread 0); the caller's next
// __syncthreads publishes them.
__device__ __forceinline__ void group_init(GroupShared& g) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&g.full[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
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
                                             unsigned (*votes)[kGroupWarps],
                                             int& row) {
  m = __reduce_or_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31) == 0) votes[row][threadIdx.x >> 5] = m;
  __syncthreads();
  unsigned all = 0;
  for (int w = 0; w < kGroupWarps; ++w) all |= votes[row][w];
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
  for (int w = 0; w < kGroupWarps; ++w)
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

// The nearest triangle of each live lane of the group, given its path `p`
// and the nearest sphere hit best_t: on return tri_wins says whether a
// triangle is nearer, and then best_t is its t, tri_idx its row and
// (tri_u, tri_v) its barycentrics, as the lane's own test computes them.
// Every thread of the block calls it (live or not, which `live` says;
// `in_order` says whether the lane's ray counts in the visit order, as
// tile_super_order's row 12 >= 0.5).
__device__ __forceinline__ void group_hit(GroupShared& g, GroupCursor& c,
                                          const Path& p, bool live,
                                          bool in_order, const TriScene& tri,
                                          float t_min,
                                          float& best_t, bool& tri_wins,
                                          int& tri_idx, float& tri_u,
                                          float& tri_v) {
  const int me = threadIdx.x;
  g.ray[0][me] = p.ox;
  g.ray[1][me] = p.oy;
  g.ray[2][me] = p.oz;
  g.ray[3][me] = p.dx;
  g.ray[4][me] = p.dy;
  g.ray[5][me] = p.dz;
  g.best_key[me] = hit_key(kBig, 0);
  // its barriers also publish the rays and keys
  visit_order(p, in_order, tri, g.fold, g.key, g.ord, g.dis);
  // a dead lane's bound 0 keeps it out of every vote
  const float own_t = live ? best_t : 0.0f;

  const float ivx = inv_dir(p.dx), ivy = inv_dir(p.dy), ivz = inv_dir(p.dz);
  const int warp = me >> 5;
  for (int k = 0; k < tri.supers; ++k) {
    const float d = g.dis[k];
    if (!(d < kUnreached)) break;  // this super and the rest: unreachable
    const int sup = g.ord[k];
    const float lb = fminf(key_time(g.best_key[me]), own_t);
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
    m = block_or(m, g.votes, c.vote_row);
    // no live lane reaches it in time, nor any later (farther) super
    if (!(m >> kTriSup)) break;
    unsigned sweep = m & ((1u << kTriSup) - 1u);
    unsigned issue = sweep;  // thread 0's blocks still to copy
    if (me == 0)
      for (int q = 0; q < kStages && issue; ++q) {
        const int j = __ffs(issue) - 1;
        issue &= issue - 1u;
        const uint32_t st = (c.used + q) % kStages;
        stage_block(g.ring[st], tri.geo, sup * kTriSup + j, &g.full[st]);
      }
    while (sweep) {
      const int blk = sup * kTriSup + __ffs(sweep) - 1;
      sweep &= sweep - 1u;
      const uint32_t st = c.used % kStages;
      wait_stage(&g.full[st], (c.used / kStages) & 1u);
      // each lane's own cull against its best hit so far, then the passing
      // lanes listed in thread order
      const float bound = fminf(key_time(g.best_key[me]), own_t);
      const bool pass = live && slab_may(tri.aabb + 2 * blk, p.ox, p.oy,
                                         p.oz, ivx, ivy, ivz, t_min, bound);
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, pass);
      if ((me & 31) == 0) g.warp_count[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, count = 0;
      for (int w = 0; w < kGroupWarps; ++w) {
        before += w < warp ? g.warp_count[w] : 0;
        count += g.warp_count[w];
      }
      if (pass)
        g.passing[before + __popc(ballot & ((1u << (me & 31)) - 1u))] = me;
      __syncthreads();
      // the (lane, row) pairs dealt to the group's threads, a lane's rows
      // to neighbouring threads; the lexicographic minimum of (t, row) by
      // atomicMin, so the earlier row wins a tie in any order
      const float4* rows = g.ring[st];
      const int base = blk * kTriBlock;
      for (int q = me; q < count * kTriBlock; q += kGroup) {
        const int ln = g.passing[q / kTriBlock], r = q % kTriBlock;
        const float4 g0 = rows[3 * r];
        const float4 g1 = rows[3 * r + 1];
        const float4 g2 = rows[3 * r + 2];
        float u, w;
        const float t = moller_trumbore(
            g.ray[0][ln], g.ray[1][ln], g.ray[2][ln], g.ray[3][ln],
            g.ray[4][ln], g.ray[5][ln], g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
            g1.z, g1.w, g2.x, t_min, u, w);
        if (t < kBig) {
          const unsigned long long key = hit_key(t, base + r);
          if (key < g.best_key[ln]) atomicMin(&g.best_key[ln], key);
        }
      }
      __syncthreads();  // every lane is done with stage st
      ++c.used;
      if (me == 0 && issue) {
        const int j = __ffs(issue) - 1;
        issue &= issue - 1u;
        stage_block(g.ring[st], tri.geo, sup * kTriSup + j, &g.full[st]);
      }
    }
  }
  const unsigned long long won = g.best_key[me];
  const float tri_t = key_time(won);
  tri_idx = (int)(uint32_t)won;
  tri_wins = live && tri_t < best_t;
  tri_u = tri_v = 0.f;
  if (tri_wins) {
    best_t = tri_t;
    // the winner's barycentrics, as its test computed them
    const float4 g0 = __ldg(tri.geo + 3 * tri_idx);
    const float4 g1 = __ldg(tri.geo + 3 * tri_idx + 1);
    const float4 g2 = __ldg(tri.geo + 3 * tri_idx + 2);
    moller_trumbore(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, g0.x, g0.y, g0.z,
                    g0.w, g1.x, g1.y, g1.z, g1.w, g2.x, t_min, tri_u, tri_v);
  }
}

}  // namespace rtiw
