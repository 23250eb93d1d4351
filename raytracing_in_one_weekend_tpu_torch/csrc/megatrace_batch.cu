// Fused sample-batch path tracer for Hopper (sm_90a): one whole
// SampleBatchJob per launch, sphere scenes, scenes with rects and boxes
// (with or without spheres), convex volumes, moving spheres and textured
// albedos beside either, and mesh scenes of at most TRI_STREAM_MAX
// triangles, gradient or no sky.
//
// Replaces: ops/pallas_megatrace.py::_batch_kernel of the JAX package, its
// sphere arm, its rect/box arm, its convex-volume arm, its motion and
// texture arms, its triangle (VMEM) arm and its streamed-triangle arm
// (white-noise hash PRNG, dense sphere
// sweep, the one-sided rect and Majercik box tests, the Beer-Lambert
// volume walk, the Möller–Trumbore sweep over AABB-culled 192-row triangle
// blocks, Standard Lambert/GGX-metal, dielectric and isotropic scatter,
// gradient sky, per-pixel fold).
// Plain version: ops/megatrace.py::sample_batch_reference, which this
// kernel matches bit for bit up to log/exp2 (see the precision contract
// there): no --use_fast_math, -fmad=false, and the same explicit fmaf
// calls; sqrt/rsqrt/sin/cos are correctly rounded.
//
// What bounds it on this card: ALU work in the sphere sweep, and how much
// of it a warp's lanes share.  Every bounce of every path tests all S
// spheres (485 on the book cover, ~20 flops each), while device memory
// sees ~30 bytes per pixel (two floats in, 18 accumulators out) plus the
// optional tape.
//
// The sphere-only build (megatrace_sphere_kernel) runs one lane a thread
// and keeps the path in registers for the whole batch, so nothing
// round-trips through device memory between bounces.  Each block stages
// the sphere geometry (centre and |c|^2 - r^2, 16 bytes per sphere) in
// shared memory; every thread of a warp reads the same sphere at the same
// step, which is a broadcast.  Three choices fit it to the card (each
// measured against the others, PERF.md §6):
// - a register budget of kSphereBlocks = 6 blocks of 128 threads an SM
//   (80 registers, 24 warps an SM against 16 at the 124 registers of one
//   thread a lane with everything in registers), with no spills: the
//   camera row and sky, the same for every lane, and the lane's 18
//   accumulators, touched when a sample ends (the ray count once a
//   bounce), sit in shared memory;
// - the sweep kSweepStep = 15 spheres a step (sphere_sweep_steps): the
//   quadratics of a step are independent, so their loads and products
//   interleave, and one test of the largest discriminant skips the roots
//   when no lane needs them, instead of a branch a sphere;
// - lanes dealt to threads in 8x4 pixel tiles (tile_lane): a warp's rays
//   leave neighbouring pixels, so they meet the same spheres, take the
//   same material branches and end their paths closer together (the warp
//   runs until its longest lane ends).  A lane keeps everything that is
//   its own: the hash key of lane i, pixel i, out[k * n + i] and
//   tape[it * n + i]; only which thread runs it changes.
// The winner record (material, centre, 1/r: 64 bytes) is read once per
// bounce through the read-only cache.  A lane exits as soon as its last
// sample ends.  Pad rows of the JAX tables never hit and come last, so the
// loop runs over real spheres only and winner indices are unchanged.  The
// shading lives in megatrace_bounce.cuh, shared with the per-ray megatrace
// (megatrace_wave.cu).
//
// Rects and boxes take the sphere build's aux instantiation
// (megatrace_sphere_kernel<true>; the sphere-only one compiles none of it
// and keeps its SASS).  A scene holds few of them (the Cornell box 6 rects
// and 2 boxes), each row 48 bytes, so each block stages them all in shared
// memory after the spheres and finds the last row that can hit (trailing
// pad rows of the JAX tables never do, so they are not swept); each lane
// tests them after its sphere sweep, ~75 flops a rect and ~120 a box (the
// ray into the entity's frame by two quaternion rotations, then the plane
// or face distances), a rect and then a box winning only on a strictly
// smaller t, as in the JAX kernel.  JAX's 128 pad spheres are not swept in
// a scene without spheres: only their tape-code offset stays.  Its own
// launch bounds (kAuxBlocks) leave the tests registers.
//
// Convex volumes (spheres and boxes of a ProbabilisticVolume material) take
// the volume builds of the same kernel (kVol: megatrace_sphere_kernel<false,
// true> beside spheres, <true, true> beside rects and boxes; the builds
// without kVol compile none of it and keep their SASS).  A lane carries its
// medium (8 floats: id, density, albedo, emission), reset at each regen
// from the camera's row `vol0`, which sits in shared memory after the
// camera constants.  The sweep keeps only the winner, so its exit distance
// is computed once after it: a sphere's far root by the sweep's own float
// operations (sphere_exit), a box's slab exit (box_exit), none for a rect.
// The walk then costs a correctly rounded log and a few compares a bounce
// (shade); a pass through a volume or an exit from it takes an iteration
// without a scatter, as in the JAX kernel.  Its launch bounds (kVolBlocks)
// leave the medium registers.
//
// Triangles (megatrace_batch_kernel: one thread a lane in lane order,
// the camera and accumulators in registers, the header's sphere_sweep and
// the triangle arm): up to 4096 triangles are 192 KB of geometry, too
// much for shared memory beside the spheres, and a lane leaves the loop
// when its samples end, so no block-wide barrier can stage them.  Each
// lane reads them from device memory through the read-only cache instead
// (48 bytes a triangle, the whole table L1/L2-resident; the lanes of a
// warp that sweep a block read the same row at the same step).  The JAX
// kernel skips a 192-row block for a whole tile when no active lane's ray
// meets its AABB before the lane's best hit; here each lane makes that
// test for itself, which cannot change its winner (the AABB bounds every
// hit in the block) and skips more.  The Möller–Trumbore sweep costs ~56
// flops a triangle, three times a sphere's, so mesh scenes are ALU-bound
// in the blocks a ray cannot skip.
//
// Streamed meshes (TRI_MAX < T <= TRI_STREAM_MAX) take a kernel of their
// own, megatrace_stream_kernel.  The JAX kernel keeps such tables in HBM
// and DMAs a super-block of 16 blocks into VMEM when a tile may hit it; on
// Hopper 262,144 triangles are 46 MB of tables in device memory, and
// mesh_huge's (~18 MB) fit the 50 MB L2.  What bounds it is ALU work in
// the triangle sweep (56 flops a ray-triangle test, 26 an AABB) and how
// much of it a warp's lanes share: with one thread a lane walking the
// supers in index order, a warp ran a block's 192 rows whenever any one of
// its lanes passed the block's test.  Here a thread block is a group of
// kGroup = 128 lanes that run iteration `it` of the batch in lockstep: each
// live lane's sphere sweep, then group_sweep.cuh's group traversal (the
// bounce-synchronous sampler's: the group's near-to-far super order, an
// early stop, one vote per super for the blocks to stage by TMA, the
// (lane, row) pairs of each staged block dealt to all 128 threads, a
// lane's best hit as one (t, row) key lowered by atomicMin, so the winner
// is the index-order sweep's), then each live lane's shading.  A lane
// whose samples have ended (or that has none, or lies past n) is dead: it
// reaches every barrier, never votes and writes nothing; the block leaves
// the loop when no lane has samples left.  The camera and sky constants,
// the same for the whole block, sit in shared memory.  Lanes follow the
// caller's `pixel_index` (the renderer passes a Morton order, so a group
// is a 16x8 tile of pixels); the hash PRNG stays keyed by the lane, as in
// JAX.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "group_sweep.cuh"

namespace {

using namespace rtiw;

constexpr int kOutRows = 18;
constexpr int kThreads = 128;
constexpr int kConsts = 30;  // camera row (24) | sky bottom | sky top
constexpr int kSphereBlocks = 6;  // the sphere build's blocks an SM
constexpr int kAuxBlocks = 4;  // its aux build's: the rect and box tests
                               // need more registers than 80
constexpr int kVolBlocks = 4;  // its volume builds': the medium's 8 floats
constexpr int kVolConsts = 40;  // ... their constants: kConsts, 2 pad, vol0
constexpr int kMotionBlocks = 4;  // the motion builds': the moved centres
constexpr int kSweepStep = 15;  // spheres a step of its sweep: the
                               // most that fit 80 registers unspilled
constexpr int kTileW = 8, kTileH = 4;  // the sphere build's warp: a pixel
                                       // tile of kTileW x kTileH lanes

// The lane that thread t of the sphere build runs, of n lanes in rows of
// `width` (lane i is pixel (i % width, i / width)).  The threads first
// take the whole kTileW x kTileH tiles of the whole rows, a warp a tile,
// tile rows top down; then, in lane order, the lanes left over: each
// tiled row's last width % kTileW lanes, then the rows below the tiles.
// So any n and width map one thread to one lane; the plain twin is
// ops/megatrace.py::tile_lane_order.
__device__ __forceinline__ int tile_lane(int t, int n, int width) {
  const int tiles_x = width / kTileW;
  const int rows = width > 0 ? n / width / kTileH * kTileH : 0;
  const int tiled = tiles_x * rows * kTileW;
  if (t < tiled) {
    const int tile = t / (kTileW * kTileH), q = t % (kTileW * kTileH);
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    return (ty * kTileH + q / kTileW) * width + tx * kTileW + q % kTileW;
  }
  const int r = t - tiled, strip = width - tiles_x * kTileW;
  if (r < rows * strip) {
    const int y = r / strip;
    return y * width + tiles_x * kTileW + (r - y * strip);
  }
  return rows * width + (r - rows * strip);
}

// A thread's accumulators in the sphere build's shared array
// [kOutRows][kThreads]: row k of this thread's column (no bank conflicts).
struct SharedRow {
  float* col;  // &acc[0][threadIdx.x]
  __device__ __forceinline__ float& operator[](int k) const {
    return col[k * kThreads];
  }
};

// sphere_sweep (megatrace_bounce.cuh) kSweepStep spheres a step.  A step
// keeps only the discriminants of its spheres, and one test of the
// largest skips the roots when no lane needs them; a sphere whose
// discriminant is > 0 reads its row again and recomputes b by the same
// float arithmetic.  So each sphere's t is sphere_sweep's, the running
// minimum takes them in row order with the same strict <, and the winner
// is sphere_sweep's bit for bit.  With kMotion (the motion builds) each
// sphere moves: its centre at the path's time is c(t) = fmaf(m, ptime, c),
// m its row of `move`, and the quadratic's c term ((|o|^2 - 2 o.c(t)) +
// |c(t)|^2) + (-r^2) (sph's fourth column holds -r^2), the JAX kernel's
// operations (:379-390); ops/megatrace.py::_quadratic_bc is the plain
// version.
template <bool kMotion = false>
__device__ __forceinline__ void sphere_sweep_steps(const Path& p,
                                                   const float4* sph, int s,
                                                   float t_min,
                                                   float& best_t, int& best,
                                                   const float4* move =
                                                       nullptr,
                                                   float ptime = 0.f) {
  const float dx = p.dx, dy = p.dy, dz = p.dz, ox = p.ox, oy = p.oy,
              oz = p.oz;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float o_dot_d = dot3(ox, oy, oz, dx, dy, dz);
  const float o_sq = dot3(ox, oy, oz, ox, oy, oz);
  const float inv_a = 1.0f / a;
  best_t = kBig;
  best = 0;
  auto disc_of = [&](int row, float& b) {
    const float4 g = sph[row];
    if constexpr (kMotion) {
      const float4 m = move[row];
      const float cx = fmaf(m.x, ptime, g.x), cy = fmaf(m.y, ptime, g.y),
                  cz = fmaf(m.z, ptime, g.z);
      b = o_dot_d - dot3(dx, dy, dz, cx, cy, cz);
      const float c = (fmaf(-2.0f, dot3(ox, oy, oz, cx, cy, cz), o_sq) +
                       dot3(cx, cy, cz, cx, cy, cz)) +
                      g.w;
      return fmaf(b, b, -(a * c));
    } else {
      b = o_dot_d - dot3(dx, dy, dz, g.x, g.y, g.z);
      const float c =
          fmaf(-2.0f, dot3(ox, oy, oz, g.x, g.y, g.z), o_sq) + g.w;
      return fmaf(b, b, -(a * c));
    }
  };
  auto take = [&](float b, float disc, int row) {
    const float sq = sqrtf(disc);
    const float t_near = (-b - sq) * inv_a;
    const float t_far = (-b + sq) * inv_a;
    const float t = t_near > t_min ? t_near : (t_far > t_min ? t_far : kBig);
    if (t < best_t) {  // strict: the first row wins a tie (argmin)
      best_t = t;
      best = row;
    }
  };
  int k = 0;
  for (; k + kSweepStep <= s; k += kSweepStep) {
    float disc[kSweepStep];
    float most = -kBig;
#pragma unroll
    for (int j = 0; j < kSweepStep; ++j) {
      float b;
      disc[j] = disc_of(k + j, b);
      most = fmaxf(most, disc[j]);
    }
    if (most > 0.0f) {
#pragma unroll
      for (int j = 0; j < kSweepStep; ++j) {
        if (disc[j] > 0.0f) {
          float b;
          disc_of(k + j, b);
          take(b, disc[j], k + j);
        }
      }
    }
  }
  for (; k < s; ++k) {
    float b;
    const float disc = disc_of(k, b);
    if (disc > 0.0f) take(b, disc, k);
  }
}

// The far root of sphere row `row` of `sph` for the path's ray: the exit
// of a volume sphere it hit, by sphere_sweep_steps' float operations (so
// bit-equal to the root the sweep would take; the JAX kernel's
// t_exit_rows, :401-408), kBig at or before t_min; with kMotion at the
// centre c(t) of sphere_sweep_steps.
template <bool kMotion = false>
__device__ __forceinline__ float sphere_exit(const Path& p, const float4* sph,
                                             int row, float t_min,
                                             const float4* move = nullptr,
                                             float ptime = 0.f) {
  const float a = dot3(p.dx, p.dy, p.dz, p.dx, p.dy, p.dz);
  const float o_dot_d = dot3(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz);
  const float o_sq = dot3(p.ox, p.oy, p.oz, p.ox, p.oy, p.oz);
  float4 g = sph[row];
  float ct_sq = 0.0f;
  if constexpr (kMotion) {
    const float4 m = move[row];
    g.x = fmaf(m.x, ptime, g.x);
    g.y = fmaf(m.y, ptime, g.y);
    g.z = fmaf(m.z, ptime, g.z);
    ct_sq = dot3(g.x, g.y, g.z, g.x, g.y, g.z);
  }
  const float b = o_dot_d - dot3(p.dx, p.dy, p.dz, g.x, g.y, g.z);
  float c = fmaf(-2.0f, dot3(p.ox, p.oy, p.oz, g.x, g.y, g.z), o_sq);
  if constexpr (kMotion) c = c + ct_sq;
  c = c + g.w;
  const float disc = fmaf(b, b, -(a * c));
  const float t_far = (-b + sqrtf(fmaxf(disc, 0.0f))) * (1.0f / a);
  return t_far > t_min ? t_far : kBig;
}

// Start the next sample of a lane at pixel (px_row, py_row): the thin-lens
// camera ray (View.cs:38-48) of the camera row `cam` (origin, lower_left,
// horizontal, vertical, right, up, lens_radius, width, height) with the
// uniforms of hash base `base`, and a fresh path.
__device__ __forceinline__ void camera_ray(Path& p, const float* cam,
                                           uint32_t base, float px_row,
                                           float py_row, int jitter) {
  const float lens_radius = cam[18], width = cam[19], height = cam[20];
  const float jx = jitter ? uniform(base, 0) : 0.5f;
  const float jy = jitter ? uniform(base, 1) : 0.5f;
  const float un = (px_row + jx) / width;
  const float vn = (py_row + jy) / height;
  const float theta = uniform(base, 2) * kTwoPi;
  const float radius = sqrtf(uniform(base, 3)) * lens_radius;
  const float rdx = radius * cos_cr(theta);
  const float rdy = radius * sin_cr(theta);
  const float offx = fmaf(rdx, cam[12], rdy * cam[15]);
  const float offy = fmaf(rdx, cam[13], rdy * cam[16]);
  const float offz = fmaf(rdx, cam[14], rdy * cam[17]);
  float cdx = fmaf(vn, cam[9], fmaf(un, cam[6], cam[3] - offx));
  float cdy = fmaf(vn, cam[10], fmaf(un, cam[7], cam[4] - offy));
  float cdz = fmaf(vn, cam[11], fmaf(un, cam[8], cam[5] - offz));
  normalize3(cdx, cdy, cdz);
  p.ox = cam[0] + offx;
  p.oy = cam[1] + offy;
  p.oz = cam[2] + offz;
  p.dx = cdx;
  p.dy = cdy;
  p.dz = cdz;
  p.thx = p.thy = p.thz = 1.f;
  p.rx = p.ry = p.rz = 0.f;
  p.anx = p.any = p.anz = p.aax = p.aay = p.aaz = 0.f;
  p.got = false;
  p.events = 0.f;
  p.valid = false;
  p.active = true;
}

// A lane's bookkeeping after the bounce at path depth `depth`: its ray,
// the depth cut (depth exhaustion fails the sample,
// SampleBatchJob.cs:380-381) and, when the sample ended, its deltas into
// the accumulators `acc` (a register array, or the sphere build's
// SharedRow) and the fallback AOVs while the pixel has no valid sample yet
// (SampleBatchJob.cs:146-151; captured valid or not).  Returns the path's
// new depth.
template <typename Acc>
__device__ __forceinline__ int close_bounce(Path& p, int depth,
                                            int trace_depth, float cin,
                                            Acc& acc) {
  depth += 1;
  acc[11] += 1.0f;  // rays
  if (p.active && depth >= trace_depth) p.active = false;
  if (!p.active) {
    if (p.valid) {
      acc[0] += p.rx;
      acc[1] += p.ry;
      acc[2] += p.rz;
      acc[4] += p.anx;
      acc[5] += p.any;
      acc[6] += p.anz;
      acc[7] += p.aax;
      acc[8] += p.aay;
      acc[9] += p.aaz;
      acc[10] += p.events;
    }
    if (cin + acc[3] < 0.5f) {
      acc[12] = p.anx;
      acc[13] = p.any;
      acc[14] = p.anz;
      acc[15] = p.aax;
      acc[16] = p.aay;
      acc[17] = p.aaz;
    }
    if (p.valid) acc[3] += 1.0f;
  }
  return depth;
}

// A row of pack_aux_tables' geometry (16 floats, four float4) that can
// be hit: a rect whose from <= to on both axes, a box with two positive
// extents (each face test needs |x| < extent on the other two axes).  Pad
// rows (from (1, 1) > to (0, 0); extents 0) cannot.
__device__ __forceinline__ bool aux_live(const float4* row, bool box) {
  const float4 b = row[1], c = row[2];
  if (!box) return b.w <= c.y && c.x <= c.z;
  return (b.w > 0.0f) + (c.x > 0.0f) + (c.y > 0.0f) >= 2;
}

// The sphere build (see the top of this file): the batch of thread t's
// lane tile_lane(t, n, width), the camera row, sky and accumulators in
// shared memory, the sweep kSweepStep spheres a step, kSphereBlocks blocks
// an SM.  Its aux build (kAux; the sphere-only one compiles none of it)
// stages the scene's rects and boxes after the spheres (aux_geo: rect_rows
// rects, then box_rows boxes, pack_aux_tables' 16-float rows; aux_rec
// their 16-column records), sweeps them after the spheres (aux_sweep) and
// shades their winners, kAuxBlocks blocks an SM.  Its volume builds (kVol)
// read the camera's medium from consts[32..39], carry each lane's, and walk
// it (shade), kVolBlocks blocks an SM.  Its motion builds (kMotion) stage
// the spheres' move offsets (move_g, x y z 0 a row) after the spheres and
// the rects and boxes, draw each path's shutter time at its regen (stream
// 7 of the camera draws, the JAX kernel's :2745-2760) and sweep and shade
// the spheres at that time, kMotionBlocks blocks an SM (kVolBlocks with
// kVol).  Its texture builds (kTex) texture each winner's albedo
// (tex_albedo): the records `tex_rec` per material, a Perlin texture's
// tables (`perlin`, JAX's 8 x 256 rows, or null) staged in shared memory,
// the image atlas (`atlas`, img_w x img_h texels an image, or null) read
// through the read-only cache; kMotionBlocks blocks an SM.
template <bool kAux, bool kVol = false, bool kMotion = false,
          bool kTex = false>
__global__ void __launch_bounds__(kThreads, kVol      ? kVolBlocks
                                            : kAux    ? kAuxBlocks
                                            : kMotion ? kMotionBlocks
                                            : kTex    ? kMotionBlocks
                                                      : kSphereBlocks)
    megatrace_sphere_kernel(const float* __restrict__ lane_count,
                            const float* __restrict__ count_in,
                            const float* __restrict__ consts,
                            const float4* __restrict__ sph_g,
                            const float* __restrict__ rec,
                            float* __restrict__ out, float* __restrict__ tape,
                            int n, int s, int seed, int lane_base,
                            int samples, int trace_depth, float t_min,
                            int has_dielectrics, int sky_on, int jitter,
                            const float4* __restrict__ aux_geo,
                            const float* __restrict__ aux_rec, int rect_rows,
                            int box_rows, int rect_code, int box_code,
                            const float4* __restrict__ move_g = nullptr,
                            const float* __restrict__ tex_rec = nullptr,
                            const float* __restrict__ perlin = nullptr,
                            const float* __restrict__ atlas = nullptr,
                            int img_w = 0, int img_h = 0) {
  extern __shared__ float4 sph[];
  // camera row: origin, lower_left, horizontal, vertical, right, up,
  // lens_radius, width, height | sky bottom | sky top (| pad | vol0)
  constexpr int kCamFloats = kVol ? kVolConsts : kConsts;
  __shared__ float cam[kCamFloats];
  __shared__ float acc_rows[kOutRows][kThreads];
  // the sphere-only build declares nothing of the aux build's (its code,
  // and so its SASS, stay what they were before the aux build)
  [[maybe_unused]] std::conditional_t<kAux, AuxScene, char> aux{};
  if constexpr (kAux) {
    // the rows that can hit: the last live rect and box row + 1
    __shared__ int live[2];
    if (threadIdx.x < 2) live[threadIdx.x] = 0;
    __syncthreads();
    float4* staged = sph + s;
    for (int k = threadIdx.x; k < rect_rows + box_rows; k += kThreads) {
      const float4* row = aux_geo + 4 * k;
      staged[3 * k] = row[0];
      staged[3 * k + 1] = row[1];
      staged[3 * k + 2] = row[2];
      const bool box = k >= rect_rows;
      if (aux_live(row, box))
        atomicMax(&live[box], box ? k - rect_rows + 1 : k + 1);
    }
    __syncthreads();
    aux.geo = staged;
    aux.rec = aux_rec;
    aux.rects = live[0];
    aux.boxes = live[1];
    aux.rect_rows = rect_rows;
    aux.rect_code = rect_code;
    aux.box_code = box_code;
  }
  for (int k = threadIdx.x; k < s; k += kThreads) sph[k] = sph_g[k];
  [[maybe_unused]] const float4* move = nullptr;
  if constexpr (kMotion) {
    float4* staged = sph + s + (kAux ? 3 * (rect_rows + box_rows) : 0);
    for (int k = threadIdx.x; k < s; k += kThreads) staged[k] = move_g[k];
    move = staged;
  }
  [[maybe_unused]] std::conditional_t<kTex, TexScene, char> tex{};
  if constexpr (kTex) {
    __shared__ int perm[3 * 256];
    __shared__ float4 vec[256];
    if (perlin != nullptr) {
      for (int k = threadIdx.x; k < 256; k += kThreads) {
        perm[k] = (int)perlin[k];
        perm[256 + k] = (int)perlin[256 + k];
        perm[512 + k] = (int)perlin[512 + k];
        vec[k] = make_float4(perlin[768 + k], perlin[1024 + k],
                             perlin[1280 + k], 0.0f);
      }
      tex.perm = perm;
      tex.vec = vec;
    }
    tex.rec = tex_rec;
    tex.atlas = atlas;
    tex.img_w = img_w;
    tex.img_h = img_h;
  }
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = consts[threadIdx.x];
  const SharedRow acc{&acc_rows[0][threadIdx.x]};
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) acc[k] = 0.f;
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const float width = cam[19];
  const int i = tile_lane(t, n, (int)width);

  const float per_pixel = lane_count[i];
  const float cin = count_in[i];
  // global lane id through float32, as the JAX kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)((float)i + (float)lane_base);
  const uint32_t lane_key = (uint32_t)seed + lane * 9781u;
  const float pixel = (float)i;
  const float py_row = floorf(pixel / width);
  const float px_row = pixel - py_row * width;

  Path p{};  // idle until its first sample starts
  [[maybe_unused]] std::conditional_t<kVol, Medium, char> med{};
  [[maybe_unused]] float ptime = 0.f;  // the path's shutter time (kMotion)
  float started = 0.f;
  int depth = 0;

  const int iters = samples * trace_depth;
  int it = 0;
  for (; it < iters; ++it) {
    const uint32_t salt = (uint32_t)it * kSaltStep;
    if (!p.active) {
      if (started >= per_pixel) break;  // this lane's samples are done
      camera_ray(p, cam, lane_key + salt, px_row, py_row, jitter);
      if constexpr (kVol) {  // the camera's medium
#pragma unroll
        for (int k = 0; k < 8; ++k) med.v[k] = cam[32 + k];
      }
      if constexpr (kMotion) ptime = uniform(lane_key + salt, 7);
      depth = 0;
      started = started + 1.0f;
    }
    float best_t;
    int best;
    sphere_sweep_steps<kMotion>(p, sph, s, t_min, best_t, best, move, ptime);
    int winner;
    [[maybe_unused]] const TexScene* texp = nullptr;
    if constexpr (kTex) texp = &tex;
    if constexpr (kVol) {
      // the winner's exit: a sphere's far root, a box's slab exit, none
      // for a rect (the JAX kernel's t_exit, :428-431, :570, :637-660)
      float t_exit = best_t < kBig ? sphere_exit<kMotion>(p, sph, best, t_min,
                                                          move, ptime)
                                   : kBig;
      int aux_kind = 0, aux_idx = 0;
      const AuxScene* auxp = nullptr;
      if constexpr (kAux) {
        auxp = &aux;
        aux_sweep(p, aux, t_min, best_t, aux_kind, aux_idx);
        if (aux_kind == 1) {
          t_exit = kBig;
        } else if (aux_kind == 2) {
          const float o[3] = {p.ox, p.oy, p.oz}, d[3] = {p.dx, p.dy, p.dz};
          float g[12], bo[3], dl[3], inv[3];
          int axis;
          bool hi;
          aux_row(aux, aux.rect_rows + aux_idx, g);
          t_exit = box_exit(o, d, g, t_min, true, bo, dl, inv, axis, hi);
        }
      }
      winner = shade<false, kAux, true, kMotion, kTex>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, auxp, aux_kind, aux_idx, &med, t_exit, move, ptime,
          texp);
    } else if constexpr (kAux) {
      int aux_kind, aux_idx;
      aux_sweep(p, aux, t_min, best_t, aux_kind, aux_idx);
      winner = shade<false, true, false, kMotion, kTex>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, &aux, aux_kind, aux_idx, nullptr, kBig, move, ptime,
          texp);
    } else if constexpr (kMotion || kTex) {
      winner = shade<false, false, false, kMotion, kTex>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, nullptr, 0, 0, nullptr, kBig, move, ptime, texp);
    } else {
      winner = shade<false>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{});
    }
    if (tape != nullptr) tape[(size_t)it * n + i] = (float)winner;
    depth = close_bounce(p, depth, trace_depth, cin, acc);
  }
  if (tape != nullptr) {
    for (; it < iters; ++it) tape[(size_t)it * n + i] = -2.0f;  // idle
  }
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) out[(size_t)k * n + i] = acc[k];
}

// The VMEM-triangle build (kTris true; its template parameter and the
// unused pixel_index keep the code its builds had before the sphere and
// streamed builds became kernels of their own, chip_smoke.py --against).
template <bool kTris>
__global__ void __launch_bounds__(kThreads) megatrace_batch_kernel(
    const float* __restrict__ lane_count, const float* __restrict__ count_in,
    const float* __restrict__ pixel_index, const float* __restrict__ consts,
    const float4* __restrict__ sph_g,
    const float* __restrict__ rec, TriScene tri, float* __restrict__ out,
    float* __restrict__ tape, int n, int s, int seed, int lane_base,
    int samples, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int jitter) {
  extern __shared__ float4 sph[];
  for (int k = threadIdx.x; k < s; k += blockDim.x) sph[k] = sph_g[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // camera row: origin, lower_left, horizontal, vertical, right, up,
  // lens_radius, width, height | sky bottom | sky top
  float cam[kConsts];
#pragma unroll
  for (int k = 0; k < kConsts; ++k) cam[k] = __ldg(consts + k);
  const float width = cam[19];

  const float per_pixel = lane_count[i];
  const float cin = count_in[i];
  // global lane id through float32, as the JAX kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)((float)i + (float)lane_base);
  const uint32_t lane_key = (uint32_t)seed + lane * 9781u;
  const float pixel = (float)i;
  const float py_row = floorf(pixel / width);
  const float px_row = pixel - py_row * width;

  Path p{};  // idle until its first sample starts
  float started = 0.f;
  int depth = 0;
  float acc[kOutRows];
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) acc[k] = 0.f;

  const int iters = samples * trace_depth;
  int it = 0;
  for (; it < iters; ++it) {
    const uint32_t salt = (uint32_t)it * kSaltStep;
    if (!p.active) {
      if (started >= per_pixel) break;  // this lane's samples are done
      camera_ray(p, cam, lane_key + salt, px_row, py_row, jitter);
      depth = 0;
      started = started + 1.0f;
    }
    const int winner = bounce<kTris>(
        p, sph, s, rec, t_min, has_dielectrics != 0, sky_on != 0, cam + 24,
        lane_key + salt + kSaltBounce, depth, tri);
    if (tape != nullptr) tape[(size_t)it * n + i] = (float)winner;
    depth = close_bounce(p, depth, trace_depth, cin, acc);
  }
  if (tape != nullptr) {
    for (; it < iters; ++it) tape[(size_t)it * n + i] = -2.0f;  // idle
  }
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) out[(size_t)k * n + i] = acc[k];
}

// The streamed build: kGroup lanes a block in lockstep (see the top of
// this file); no tape.
__global__ void __launch_bounds__(kGroup) megatrace_stream_kernel(
    const float* __restrict__ lane_count, const float* __restrict__ count_in,
    const float* __restrict__ pixel_index, const float* __restrict__ consts,
    const float4* __restrict__ sph_g, const float* __restrict__ rec,
    TriScene tri, float* __restrict__ out, int n, int s, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter) {
  extern __shared__ float4 sph[];
  __shared__ __align__(128) GroupShared g;
  __shared__ float cam[kConsts];
  for (int k = threadIdx.x; k < s; k += kGroup) sph[k] = sph_g[k];
  if (threadIdx.x < kConsts) cam[threadIdx.x] = consts[threadIdx.x];
  group_init(g);
  __syncthreads();

  const int i = blockIdx.x * kGroup + threadIdx.x;
  // a lane past n has no samples
  const float per_pixel = i < n ? lane_count[i] : 0.f;
  const float cin = i < n ? count_in[i] : 0.f;
  // global lane id through float32, as the JAX kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)((float)i + (float)lane_base);
  const uint32_t lane_key = (uint32_t)seed + lane * 9781u;
  const float pixel =
      i >= n ? 0.f : pixel_index != nullptr ? pixel_index[i] : (float)i;
  const float py_row = floorf(pixel / cam[19]);
  const float px_row = pixel - py_row * cam[19];

  Path p{};  // idle until its first sample starts
  float started = 0.f;
  int depth = 0;
  float acc[kOutRows];
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) acc[k] = 0.f;
  GroupCursor cursor;

  const int iters = samples * trace_depth;
  for (int it = 0; it < iters; ++it) {
    // live: this lane bounces in iteration `it` (a sample in flight, or
    // one more to start); the block stops when no lane is
    const bool live = p.active || started < per_pixel;
    if (!__syncthreads_or(live)) break;
    const uint32_t salt = (uint32_t)it * kSaltStep;
    if (live && !p.active) {
      camera_ray(p, cam, lane_key + salt, px_row, py_row, jitter);
      depth = 0;
      started = started + 1.0f;
    }
    float best_t = 0.f;
    int best = 0;
    if (live) sphere_sweep(p, sph, s, t_min, best_t, best);
    bool tri_wins;
    int tri_idx;
    float tri_u, tri_v;
    group_hit(g, cursor, p, live, live, tri, t_min, best_t, tri_wins,
              tri_idx, tri_u, tri_v);
    if (live) {
      shade<true>(p, best_t, best, tri_wins, tri_idx, tri_u, tri_v, rec,
                  has_dielectrics != 0, sky_on != 0, cam + 24,
                  lane_key + salt + kSaltBounce, depth, tri);
      depth = close_bounce(p, depth, trace_depth, cin, acc);
    }
  }
  if (i < n) {
#pragma unroll
    for (int k = 0; k < kOutRows; ++k) out[(size_t)k * n + i] = acc[k];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() right after the launch (or the error of
// setting the streamed kernel's shared memory, or cudaErrorInvalidValue
// for a request the streamed kernel does not take).  tri_rows == 0 takes
// the sphere-only build; otherwise tri_geo holds (tri_rows, 12) floats,
// tri_aabb (tri_blocks, 8) and tri_rec (tri_rows, 32), and a triangle's
// tape code is tri_code_base + its row.  tri_supers > 0 takes the
// streamed kernel: tri_sup holds (tri_supers <= kMaxSupers, 8) floats,
// tri_blocks is 16 * tri_supers, tri_geo is 16-byte aligned (TMA copies
// it), there is no tape, and pixel_index (n floats, or null for lane i ->
// pixel i) names each lane's pixel.
extern "C" int rtiw_megatrace_batch(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const float* tri_geo, const float* tri_aabb, const float* tri_sup,
    const float* tri_rec, float* out, float* tape, int n, int s,
    int tri_rows, int tri_blocks, int tri_supers, int tri_code_base,
    int seed, int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, void* stream) {
  if (n > 0) {
    const size_t shmem = (size_t)s * sizeof(float4);
    TriScene tri;
    tri.geo = reinterpret_cast<const float4*>(tri_geo);
    tri.aabb = reinterpret_cast<const float4*>(tri_aabb);
    tri.sup = reinterpret_cast<const float4*>(tri_sup);
    tri.rec = tri_rec;
    tri.rows = tri_rows;
    tri.blocks = tri_blocks;
    tri.supers = tri_supers;
    tri.code_base = tri_code_base;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tri_supers > 0) {
      if (tri_supers > kMaxSupers || tape != nullptr ||
          reinterpret_cast<uintptr_t>(tri_geo) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      // the sphere table beside ~34 KB of static shared memory
      const cudaError_t err = cudaFuncSetAttribute(
          megatrace_stream_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      megatrace_stream_kernel<<<(n + kGroup - 1) / kGroup, kGroup, shmem,
                                st>>>(
          lane_count, count_in, pixel_index, consts,
          reinterpret_cast<const float4*>(sph), rec, tri, out, n, s, seed,
          lane_base, samples, trace_depth, t_min, has_dielectrics, sky_on,
          jitter);
    } else if (tri_rows > 0) {
      megatrace_batch_kernel<true><<<(n + kThreads - 1) / kThreads,
                                     kThreads, shmem, st>>>(
          lane_count, count_in, pixel_index, consts,
          reinterpret_cast<const float4*>(sph), rec, tri, out, tape, n, s,
          seed, lane_base, samples, trace_depth, t_min, has_dielectrics,
          sky_on, jitter);
    } else {
      megatrace_sphere_kernel<false><<<(n + kThreads - 1) / kThreads,
                                       kThreads, shmem, st>>>(
          lane_count, count_in, consts, reinterpret_cast<const float4*>(sph),
          rec, out, tape, n, s, seed, lane_base, samples, trace_depth, t_min,
          has_dielectrics, sky_on, jitter, nullptr, nullptr, 0, 0, 0, 0,
          nullptr, nullptr, nullptr, nullptr, 0, 0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// A build's occupancy for the report: blocks an SM (the occupancy API),
// registers a thread and local memory (stack and spills) a thread
// (cudaFuncGetAttributes), into info[0..2].
static int sphere_info(const void* kernel, size_t shmem, int* info) {
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  return 0;
}

// The sphere kernel's builds beyond rtiw_megatrace_batch's sphere build:
// megatrace_sphere_kernel<kAux = aux_rows > 0, kVol = has_vol, kMotion =
// move != null, kTex = tex_rec != null>.
using SphereKernel = decltype(&megatrace_sphere_kernel<false>);

template <bool kAux, bool kVol>
static SphereKernel ext_kernel_of(bool motion, bool tex) {
  if (motion)
    return tex ? megatrace_sphere_kernel<kAux, kVol, true, true>
               : megatrace_sphere_kernel<kAux, kVol, true, false>;
  return tex ? megatrace_sphere_kernel<kAux, kVol, false, true>
             : megatrace_sphere_kernel<kAux, kVol, false, false>;
}

static SphereKernel ext_kernel(int aux_rows, int has_vol, bool motion,
                               bool tex) {
  if (has_vol)
    return aux_rows > 0 ? ext_kernel_of<true, true>(motion, tex)
                        : ext_kernel_of<false, true>(motion, tex);
  return aux_rows > 0 ? ext_kernel_of<true, false>(motion, tex)
                      : ext_kernel_of<false, false>(motion, tex);
}

// The dynamic shared memory: the spheres, three float4 a rect or box row,
// then with motion a move offset a sphere.
static size_t ext_shmem(int s, int aux_rows, bool motion) {
  return ((size_t)s + 3 * (size_t)aux_rows + (motion ? (size_t)s : 0)) *
         sizeof(float4);
}

// The aux, volume, motion and texture builds (scenes with rects or boxes,
// spheres or none, convex volumes, moving spheres, checker, Perlin and
// image albedos, in any mix): the sphere build's arguments, then aux_geo
// ((rect_rows + box_rows) x 16 floats: pack_aux_tables' rect rows, then
// its box rows; 16-byte aligned) and aux_rec ((rect_rows + box_rows) x 16
// floats), both unused with no rows, the tape codes of rect row 0 and box
// row 0; `consts` kConsts floats, or with has_vol kVolConsts: the camera
// row and sky, 2 pad, then the camera's medium (vol0); `move` (s x 4
// floats: each sphere's move offset x y z, 0; 16-byte aligned) or null;
// `tex_rec` (a kTexCols-float texture record per material) or null,
// `perlin` (JAX's 8 x 256 table rows) or null, `atlas` ((A * img_h) x
// img_w x 3 floats) or null.  Returns cudaGetLastError() after the launch,
// or the error of setting its shared memory.
extern "C" int rtiw_megatrace_ext(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, const float* aux_geo,
    const float* aux_rec, float* out, float* tape, int n, int s,
    int rect_rows, int box_rows, int rect_code, int box_code, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, int has_vol,
    const float* move, const float* tex_rec, const float* perlin,
    const float* atlas, int img_w, int img_h, void* stream) {
  if (n > 0) {
    const int aux_rows = rect_rows + box_rows;
    const bool motion = move != nullptr;
    const SphereKernel kernel =
        ext_kernel(aux_rows, has_vol, motion, tex_rec != nullptr);
    const size_t shmem = ext_shmem(s, aux_rows, motion);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, shmem,
             static_cast<cudaStream_t>(stream)>>>(
        lane_count, count_in, consts, reinterpret_cast<const float4*>(sph),
        rec, out, tape, n, s, seed, lane_base, samples, trace_depth, t_min,
        has_dielectrics, sky_on, jitter,
        reinterpret_cast<const float4*>(aux_geo), aux_rec, rect_rows,
        box_rows, rect_code, box_code, reinterpret_cast<const float4*>(move),
        tex_rec, perlin, atlas, img_w, img_h);
  }
  return static_cast<int>(cudaGetLastError());
}

// sphere_info of a build for an s-sphere table, aux_rows rect and box rows
// and the flags (all 0: the sphere build).
extern "C" int rtiw_megatrace_ext_info(int s, int aux_rows, int has_vol,
                                       int has_motion, int has_tex,
                                       int* info) {
  const SphereKernel kernel =
      ext_kernel(aux_rows, has_vol, has_motion != 0, has_tex != 0);
  const size_t shmem = ext_shmem(s, aux_rows, has_motion != 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return sphere_info(reinterpret_cast<const void*>(kernel), shmem, info);
}

namespace {
__global__ void tile_lane_kernel(int n, int width, int* __restrict__ lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) lanes[t] = tile_lane(t, n, width);
}
}  // namespace

// lanes[t] = the lane thread t of the sphere build runs (tile_lane), for
// t < n: the map the kernel computes, read back.
extern "C" int rtiw_tile_lanes(int n, int width, int* lanes, void* stream) {
  if (n > 0)
    tile_lane_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(n, width, lanes);
  return static_cast<int>(cudaGetLastError());
}
