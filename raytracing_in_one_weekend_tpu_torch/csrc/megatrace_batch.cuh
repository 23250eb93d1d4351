// The batch kernel's device code (its kernels and their device
// functions; see megatrace_batch.cu's header for the design) and the
// host templates that launch each build, white (kNoise false) or a
// sampler flavor's noise build.  Two sources include it and compile in
// parallel: megatrace_batch.cu, the white builds' entry points, and
// megatrace_noise.cu, the noise builds' (ROADMAP steps 11 and 11b); each
// instantiates only the builds its entry points launch, so the white
// builds keep their SASS.

#pragma once

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
constexpr int kBlockedBlocks = 6;  // the static blocked build's
constexpr int kTriBlocks = 5;  // the triangle build's (its kTriRows tests
                               // a ray need more registers than 80)
constexpr int kTriAuxBlocks = 4;  // its aux build's: the rect and box tests
                                  // beside the dealt sweep's registers
constexpr int kTriVolBlocks = 4;  // its volume builds' and the streamed
                                  // kernel's (the streamed kernel's other
                                  // builds take no minimum): the medium
constexpr int kTriRows = 3;  // rows a thread loads at each step of its
                             // dealt sweep (192 = 2 x 32 x 3): three
                             // independent tests a ray (the plain model's
                             // megatrace.TRI_DEALT_ROWS)
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

// Row k of a table: through the read-only cache (kLdg: device memory), or
// a plain load (shared memory).
template <bool kLdg>
__device__ __forceinline__ float4 table_row(const float4* table, int k) {
  if constexpr (kLdg)
    return __ldg(table + k);
  else
    return table[k];
}

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
// version.  With kRun (the blocked builds' run of a block) it sweeps rows
// [k0, s) of `sph` and `move`, both in device memory and read through the
// read-only cache, into the best hit so far (best_t, best), which it
// does not reset.
template <bool kMotion = false, bool kRun = false>
__device__ __forceinline__ void sphere_sweep_steps(const Path& p,
                                                   const float4* sph, int s,
                                                   float t_min,
                                                   float& best_t, int& best,
                                                   const float4* move =
                                                       nullptr,
                                                   float ptime = 0.f,
                                                   int k0 = 0) {
  const float dx = p.dx, dy = p.dy, dz = p.dz, ox = p.ox, oy = p.oy,
              oz = p.oz;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float o_dot_d = dot3(ox, oy, oz, dx, dy, dz);
  const float o_sq = dot3(ox, oy, oz, ox, oy, oz);
  const float inv_a = 1.0f / a;
  if constexpr (!kRun) {
    best_t = kBig;
    best = 0;
  }
  auto disc_of = [&](int row, float& b) {
    const float4 g = table_row<kRun>(sph, row);
    if constexpr (kMotion) {
      const float4 m = table_row<kRun>(move, row);
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
  int k = k0;
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

// The blocked builds' sweep (more than SPH_CULL_MIN spheres): the nearest
// hit over the s rows of `sph`, in blocks of `rows` rows each bounded by a
// box of `boxes` (8 floats a block: min xyz, max xyz, 2 pad; shared
// memory), the rows and `move` in device memory.  A lane sweeps block b
// (sphere_sweep_steps' run) only when its ray meets the box at or after
// t_min and before its best hit so far, in block order; a block it skips
// holds no nearer hit, and a block's rows win only with a strictly
// smaller t, so the winner is the dense sweep's, the first row on a tie
// (the JAX kernel's blocked sweep, :433-527, with its predicate per lane;
// ops/megatrace.py::_blocked_sweep is the plain version).
template <bool kMotion>
__device__ __forceinline__ void sphere_sweep_blocked(
    const Path& p, const float4* sph, const float* boxes, int blocks,
    int rows, int s, float t_min, float& best_t, int& best,
    const float4* move, float ptime) {
  const float ivx = inv_dir(p.dx), ivy = inv_dir(p.dy), ivz = inv_dir(p.dz);
  best_t = kBig;
  best = 0;
  for (int b = 0; b < blocks; ++b) {
    const float* box = boxes + 8 * b;
    const float bx0 = (box[0] - p.ox) * ivx, bx1 = (box[3] - p.ox) * ivx;
    const float by0 = (box[1] - p.oy) * ivy, by1 = (box[4] - p.oy) * ivy;
    const float bz0 = (box[2] - p.oz) * ivz, bz1 = (box[5] - p.oz) * ivz;
    const float b_near = fmaxf(fminf(bx0, bx1),
                               fmaxf(fminf(by0, by1), fminf(bz0, bz1)));
    const float b_far = fminf(fmaxf(bx0, bx1),
                              fminf(fmaxf(by0, by1), fmaxf(bz0, bz1)));
    if (!(b_far >= fmaxf(b_near, t_min) && b_near < best_t)) continue;
    sphere_sweep_steps<kMotion, true>(p, sph, min((b + 1) * rows, s), t_min,
                                      best_t, best, move, ptime, b * rows);
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

// camera_ray with the four camera draws given (the noise builds: from a
// sampler flavor's table or pre-drawn rows): jitter (jx, jy), the lens
// disk's angle and radius uniforms (ut, ur).
__device__ __forceinline__ void camera_ray_u(Path& p, const float* cam,
                                             float jx, float jy, float ut,
                                             float ur, float px_row,
                                             float py_row) {
  const float lens_radius = cam[18], width = cam[19], height = cam[20];
  const float un = (px_row + jx) / width;
  const float vn = (py_row + jy) / height;
  const float theta = ut * kTwoPi;
  const float radius = sqrtf(ur) * lens_radius;
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

// The noise builds' camera draws of a regen at the lane's NoiseLane: the
// flavor's camera set (purpose kSaltCam, each channel rotated), or the
// pre-drawn row of the sample the regen starts (the JAX kernel's
// :2625-2690).
__device__ __forceinline__ void noise_camera(const NoiseLane& nl,
                                             float* u) {
  const NoiseScene& ns = nl.ns;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    u[c] = ns.tbl != nullptr
               ? noise_rotate(nl, noise_texel(nl, ns.cam, ns.t, c, kSaltCam),
                              kSaltCam, c)
               : __ldg(ns.uni + ((size_t)c * ns.samples + nl.k) * ns.n +
                       nl.lane);
  }
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

// Stage the scene's rects and boxes (aux_geo: rect_rows rects, then
// box_rows boxes, pack_aux_tables' 16-float rows) in shared memory at
// `staged`, three float4 a row, with the block's kStride threads, and find
// the rows that can hit (`live`, two shared ints: the last live rect and
// box row + 1); returns their AuxScene (aux_rec: their 16-column records
// in device memory).  Every thread of the block calls it: it holds two
// barriers.  The aux builds of the triangle build and the streamed kernel
// stage them so, as the sphere kernel's aux build does in its own code.
template <int kStride>
__device__ __forceinline__ AuxScene stage_aux(
    float4* staged, int* live, const float4* __restrict__ aux_geo,
    const float* __restrict__ aux_rec, int rect_rows, int box_rows,
    int rect_code, int box_code) {
  if (threadIdx.x < 2) live[threadIdx.x] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < rect_rows + box_rows; k += kStride) {
    const float4* row = aux_geo + 4 * k;
    staged[3 * k] = row[0];
    staged[3 * k + 1] = row[1];
    staged[3 * k + 2] = row[2];
    const bool box = k >= rect_rows;
    if (aux_live(row, box))
      atomicMax(&live[box], box ? k - rect_rows + 1 : k + 1);
  }
  __syncthreads();
  AuxScene aux;
  aux.geo = staged;
  aux.rec = aux_rec;
  aux.rects = live[0];
  aux.boxes = live[1];
  aux.rect_rows = rect_rows;
  aux.rect_code = rect_code;
  aux.box_code = box_code;
  return aux;
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
// through the read-only cache; kMotionBlocks blocks an SM.  Its blocked
// builds (kBlocked: more than SPH_CULL_MIN spheres, static or with
// kMotion; sphere scenes only) stage the scene's block AABBs (blk_g,
// `blocks` blocks of blk_rows rows, pack_sphere_blocks' 8 floats a block)
// in shared memory instead of the spheres, and sweep them with
// sphere_sweep_blocked, the spheres and move offsets read from device
// memory through the read-only cache; kBlockedBlocks blocks an SM
// (kMotionBlocks with kMotion).  Its cube builds (kCube; beside at most one
// of kAux, kVol, kMotion and kTex, not kBlocked) take a miss's radiance
// from the cubemap `cube` (cube_h rows of cube_w texels a face, six faces)
// instead of the gradient sky, with the launch bounds of the build they
// extend.  Its noise builds (kNoise, beside any of the other flags) take
// a sampler flavor's draws (`noise`, a NoiseScene: the camera's four at
// each regen, noise_camera, and with kMotion the shutter time; the
// scatter's seven, the Lambert and the isotropic directions in shade),
// each lane computing its own texel address from its pixel, with the
// launch bounds of the build they extend.
template <bool kAux, bool kVol = false, bool kMotion = false,
          bool kTex = false, bool kBlocked = false, bool kCube = false,
          bool kNoise = false>
__global__ void __launch_bounds__(kThreads, kVol       ? kVolBlocks
                                            : kAux     ? kAuxBlocks
                                            : kMotion  ? kMotionBlocks
                                            : kTex     ? kMotionBlocks
                                            : kBlocked ? kBlockedBlocks
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
                            int img_w = 0, int img_h = 0,
                            const float* __restrict__ blk_g = nullptr,
                            int blocks = 0, int blk_rows = 0,
                            const float* __restrict__ cube = nullptr,
                            int cube_w = 0, int cube_h = 0,
                            const NoiseScene noise = NoiseScene{}) {
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
    // the rows that can hit: the last live rect and box row + 1 (its own
    // loop, not stage_aux: sharing it changed two noise builds' SASS)
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
  if constexpr (kBlocked) {
    float* boxes = reinterpret_cast<float*>(sph);
    for (int k = threadIdx.x; k < 8 * blocks; k += kThreads)
      boxes[k] = blk_g[k];
  } else {
    for (int k = threadIdx.x; k < s; k += kThreads) sph[k] = sph_g[k];
  }
  [[maybe_unused]] const float4* move = nullptr;
  if constexpr (kMotion && kBlocked) {
    move = move_g;
  } else if constexpr (kMotion) {
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
  [[maybe_unused]] std::conditional_t<kCube, CubeScene, char> sky_cube{};
  if constexpr (kCube) {
    sky_cube.texels = cube;
    sky_cube.w = cube_w;
    sky_cube.h = cube_h;
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
  [[maybe_unused]] std::conditional_t<kNoise, NoiseLane, char> nl{};
  if constexpr (kNoise) {
    nl.ns = noise;
    nl.px = (int)px_row;
    nl.py = (int)py_row;
    nl.lane = i;
  }
  [[maybe_unused]] std::conditional_t<kVol, Medium, char> med{};
  [[maybe_unused]] float ptime = 0.f;  // the path's shutter time (kMotion)
  float started = 0.f;
  int depth = 0;

  const int iters = samples * trace_depth;
  int it = 0;
  for (; it < iters; ++it) {
    const uint32_t salt = (uint32_t)it * kSaltStep;
    if constexpr (kNoise) nl.seq = (noise.draw_base + it) % kNoiseWrap;
    if (!p.active) {
      if (started >= per_pixel) break;  // this lane's samples are done
      if constexpr (kNoise) {
        // the sample this regen starts (the plain version's clamp)
        nl.k = min((int)started, samples - 1);
        float u[4];
        noise_camera(nl, u);
        camera_ray_u(p, cam, jitter ? u[0] : 0.5f, jitter ? u[1] : 0.5f,
                     u[2], u[3], px_row, py_row);
      } else {
        camera_ray(p, cam, lane_key + salt, px_row, py_row, jitter);
      }
      if constexpr (kVol) {  // the camera's medium
#pragma unroll
        for (int k = 0; k < 8; ++k) med.v[k] = cam[32 + k];
      }
      if constexpr (kMotion) {
        // the path's shutter time: hash stream 7 of the camera draws, or
        // the flavor's scalar set at purpose 9 where it has one (the JAX
        // kernel's :2745-2760)
        if constexpr (kNoise)
          ptime = noise.tbl != nullptr && noise.scal >= 0
                      ? noise_scalar(nl, 7)
                      : uniform(lane_key + salt, 7);
        else
          ptime = uniform(lane_key + salt, 7);
      }
      depth = 0;
      started = started + 1.0f;
    }
    float best_t;
    int best;
    if constexpr (kBlocked)
      sphere_sweep_blocked<kMotion>(p, sph_g, reinterpret_cast<float*>(sph),
                                    blocks, blk_rows, s, t_min, best_t, best,
                                    move, ptime);
    else
      sphere_sweep_steps<kMotion>(p, sph, s, t_min, best_t, best, move,
                                  ptime);
    int winner;
    [[maybe_unused]] const TexScene* texp = nullptr;
    if constexpr (kTex) texp = &tex;
    [[maybe_unused]] const CubeScene* cubep = nullptr;
    if constexpr (kCube) cubep = &sky_cube;
    [[maybe_unused]] const NoiseLane* nlp = nullptr;
    if constexpr (kNoise) nlp = &nl;
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
      winner = shade<false, kAux, true, kMotion, kTex, kCube, kNoise>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, auxp, aux_kind, aux_idx, &med, t_exit, move, ptime,
          texp, cubep, nlp);
    } else if constexpr (kAux) {
      int aux_kind, aux_idx;
      aux_sweep(p, aux, t_min, best_t, aux_kind, aux_idx);
      winner = shade<false, true, false, kMotion, kTex, kCube, kNoise>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, &aux, aux_kind, aux_idx, nullptr, kBig, move, ptime,
          texp, cubep, nlp);
    } else if constexpr (kMotion || kTex) {
      winner = shade<false, false, false, kMotion, kTex, kCube, kNoise>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, nullptr, 0, 0, nullptr, kBig, move, ptime, texp,
          cubep, nlp);
    } else if constexpr (kCube) {
      winner = shade<false, false, false, false, false, true, kNoise>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, nullptr, 0, 0, nullptr, kBig, nullptr, 0.f, nullptr,
          cubep, nlp);
    } else {
      winner = shade<false, false, false, false, false, false, kNoise>(
          p, best_t, best, false, 0, 0.f, 0.f, rec, has_dielectrics != 0,
          sky_on != 0, cam + 24, lane_key + salt + kSaltBounce, depth,
          TriScene{}, nullptr, 0, 0, nullptr, kBig, nullptr, 0.f, nullptr,
          nullptr, nlp);
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

// The exit distance of a volume build's winner for the walk (the JAX
// kernel's t_exit, :428-431, :570, :637-660, :794, :1089): a sphere's far
// root (sphere_exit), a box's slab exit (box_exit), kBig for a rect, for a
// triangle (no interior: tri_wins) and on a miss.  best_t is the nearest
// hit of the spheres, rects and boxes (aux_kind 0: a sphere's, when below
// kBig); computed after the triangle sweep, from the winner alone, it is
// the value the sphere kernel's volume builds take before their aux sweep.
template <bool kAux>
__device__ __forceinline__ float exit_of(const Path& p, const float4* sph,
                                         const AuxScene* aux, float best_t,
                                         int best, bool tri_wins,
                                         int aux_kind, int aux_idx,
                                         float t_min) {
  if (tri_wins) return kBig;
  if constexpr (kAux) {
    if (aux_kind == 1) return kBig;
    if (aux_kind == 2) {
      const float o[3] = {p.ox, p.oy, p.oz}, d[3] = {p.dx, p.dy, p.dz};
      float g[12], bo[3], dl[3], inv[3];
      int axis;
      bool hi;
      aux_row(*aux, aux->rect_rows + aux_idx, g);
      return box_exit(o, d, g, t_min, true, bo, dl, inv, axis, hi);
    }
  }
  return best_t < kBig ? sphere_exit(p, sph, best, t_min) : kBig;
}

// A lane's best triangle hit as one 64-bit key ordered as (t, row): t's
// bits made monotone (a positive t's sign bit set, a negative t's bits
// flipped), then the row.  Of any set of hits the least key is the nearer
// one, the earlier row on a tie of t: the one an index-order sweep keeps
// with its strict <.
__device__ __forceinline__ unsigned long long tri_key(float t, int row) {
  const uint32_t b = __float_as_uint(t);
  const uint32_t m = b ^ ((b >> 31) != 0u ? 0xffffffffu : 0x80000000u);
  return ((unsigned long long)m << 32) | (uint32_t)row;
}

__device__ __forceinline__ float tri_key_t(unsigned long long key) {
  const uint32_t m = (uint32_t)(key >> 32);
  return __uint_as_float(m ^ ((m >> 31) != 0u ? 0x80000000u : 0xffffffffu));
}

// The triangle build's sweep, called by every thread of a warp on each
// iteration (`live`: the thread's lane has a ray this iteration): the
// nearest triangle of each live lane's ray after the spheres' best_t.  The
// blocks go in index order, and each live lane decides for itself whether
// it sweeps a block: its ray meets the block's AABB at or after t_min and
// before its best hit so far (the JAX kernel's per-tile skip, per lane;
// ops/megatrace.py::_tri_sweep).  The tests of the lanes that sweep a
// block are dealt to the warp's 32 threads: at each step of 32 kTriRows
// rows thread k loads rows r0 + k, r0 + k + 32, ... once and tests them
// against the ray of every such lane (the rays in the warp's shared slots
// `ray_o`, `ray_d`: a broadcast read; the kTriRows tests of a ray are
// independent, so their chains overlap), lowering that lane's key
// (tri_key, in `key`) by atomicMin on a hit.  So each (lane, triangle)
// test of the index-order sweep is made once, by the same moller_trumbore
// on the same floats, and the least key is its winner; the lane
// recomputes the winner's barycentrics once.
// Returns the lane's (t, row, u, v): kBig, 0, 0, 0 without a hit.
__device__ __forceinline__ void tri_sweep_dealt(
    const Path& p, bool live, const TriScene& tri, float t_min,
    float best_t, float4* ray_o, float2* ray_d, unsigned long long* key,
    int lane, float& tri_t, int& tri_idx, float& tri_u, float& tri_v) {
  __syncwarp();  // the warp's reads of the last iteration's slots are done
  ray_o[lane] = make_float4(p.ox, p.oy, p.oz, p.dx);
  ray_d[lane] = make_float2(p.dy, p.dz);
  key[lane] = tri_key(kBig, 0);
  const float ivx = inv_dir(p.dx), ivy = inv_dir(p.dy), ivz = inv_dir(p.dz);
  __syncwarp();
  for (int blk = 0; blk < tri.blocks; ++blk) {
    bool sweeps = false;
    if (live) {
      const float4 lo = __ldg(tri.aabb + 2 * blk);
      const float4 hi = __ldg(tri.aabb + 2 * blk + 1);
      const float bx0 = (lo.x - p.ox) * ivx, bx1 = (hi.x - p.ox) * ivx;
      const float by0 = (lo.y - p.oy) * ivy, by1 = (hi.y - p.oy) * ivy;
      const float bz0 = (lo.z - p.oz) * ivz, bz1 = (hi.z - p.oz) * ivz;
      const float b_near = fmaxf(fminf(bx0, bx1),
                                 fmaxf(fminf(by0, by1), fminf(bz0, bz1)));
      const float b_far = fminf(fmaxf(bx0, bx1),
                                fminf(fmaxf(by0, by1), fmaxf(bz0, bz1)));
      sweeps = b_far >= fmaxf(b_near, t_min) &&
               b_near < fminf(tri_key_t(key[lane]), best_t);
    }
    const unsigned lanes = __ballot_sync(0xffffffffu, sweeps);
    if (lanes == 0u) continue;
    const int end = min((blk + 1) * kTriBlock, tri.rows);
    for (int r0 = blk * kTriBlock + lane; r0 - lane < end;
         r0 += 32 * kTriRows) {
      // a row past the block's end loads the block's last row instead;
      // its tests go unused
      float4 g[kTriRows][3];
      bool in_block[kTriRows];
#pragma unroll
      for (int j = 0; j < kTriRows; ++j) {
        in_block[j] = r0 + 32 * j < end;
        const int r = in_block[j] ? r0 + 32 * j : end - 1;
        g[j][0] = __ldg(tri.geo + 3 * r);
        g[j][1] = __ldg(tri.geo + 3 * r + 1);
        g[j][2] = __ldg(tri.geo + 3 * r + 2);
      }
      for (unsigned m = lanes; m != 0u; m &= m - 1u) {
        const int src = __ffs(m) - 1;
        const float4 a = ray_o[src];
        const float2 b = ray_d[src];
        float t[kTriRows];
#pragma unroll
        for (int j = 0; j < kTriRows; ++j) {
          float u, v;
          t[j] = moller_trumbore(a.x, a.y, a.z, a.w, b.x, b.y, g[j][0].x,
                                 g[j][0].y, g[j][0].z, g[j][0].w, g[j][1].x,
                                 g[j][1].y, g[j][1].z, g[j][1].w, g[j][2].x,
                                 t_min, u, v);
        }
#pragma unroll
        for (int j = 0; j < kTriRows; ++j) {
          if (in_block[j] && t[j] < kBig)
            atomicMin(key + src, tri_key(t[j], r0 + 32 * j));
        }
      }
    }
    __syncwarp();
  }
  const unsigned long long best = key[lane];
  tri_t = tri_key_t(best);
  tri_idx = (int)(uint32_t)best;
  tri_u = tri_v = 0.f;
  if (tri_t < kBig) {
    const float4 g0 = __ldg(tri.geo + 3 * tri_idx);
    const float4 g1 = __ldg(tri.geo + 3 * tri_idx + 1);
    const float4 g2 = __ldg(tri.geo + 3 * tri_idx + 2);
    moller_trumbore(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, g0.x, g0.y, g0.z,
                    g0.w, g1.x, g1.y, g1.z, g1.w, g2.x, t_min, tri_u, tri_v);
  }
}

// The triangle build (meshes of at most TRI_MAX triangles, with spheres
// or without; see the top of this file): thread i runs lane i, the camera
// row, sky and accumulators in shared memory, kTriBlocks blocks an SM; the
// warp stays in the loop until its last lane's samples end, since every
// thread takes part in tri_sweep_dealt.  Its noise build (kNoise) takes a
// sampler flavor's draws (`noise`) as the sphere kernel's noise builds
// do, at lane i's pixel.  Its aux build (kAux; the others compile none of
// it) stages the scene's rects and boxes after the spheres (stage_aux) and
// sweeps them after the spheres and before the triangles (aux_sweep), so
// that the dealt sweep's culls take the nearest of the three, and shades a
// rect or box winner; kTriAuxBlocks blocks an SM.  Its volume builds
// (kVol, with or without kAux) read the camera's medium from
// consts[32..39], carry each lane's and walk it (shade): the dealt sweep
// culls by the nearest hit of the spheres, rects and boxes alone, as the
// JAX kernel's, and the walk's decision comes after it, the winner's exit
// (exit_of) computed there; kTriVolBlocks blocks an SM.
template <bool kNoise = false, bool kAux = false, bool kVol = false>
__global__ void __launch_bounds__(kThreads,
                                  kVol   ? kTriVolBlocks
                                  : kAux ? kTriAuxBlocks
                                         : kTriBlocks)
    megatrace_tri_kernel(
    const float* __restrict__ lane_count, const float* __restrict__ count_in,
    const float* __restrict__ consts, const float4* __restrict__ sph_g,
    const float* __restrict__ rec, TriScene tri, float* __restrict__ out,
    float* __restrict__ tape, int n, int s, int seed, int lane_base,
    int samples, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int jitter, const NoiseScene noise = NoiseScene{},
    const float4* __restrict__ aux_geo = nullptr,
    const float* __restrict__ aux_rec = nullptr, int rect_rows = 0,
    int box_rows = 0, int rect_code = 0, int box_code = 0) {
  extern __shared__ float4 sph[];
  // camera row: origin, lower_left, horizontal, vertical, right, up,
  // lens_radius, width, height | sky bottom | sky top (| pad | vol0)
  constexpr int kCamFloats = kVol ? kVolConsts : kConsts;
  __shared__ float cam[kCamFloats];
  __shared__ float acc_rows[kOutRows][kThreads];
  // each thread's ray and best triangle key, for its warp's sweep
  __shared__ float4 ray_o[kThreads];  // ox oy oz dx
  __shared__ float2 ray_d[kThreads];  // dy dz
  __shared__ unsigned long long key[kThreads];
  for (int k = threadIdx.x; k < s; k += kThreads) sph[k] = sph_g[k];
  [[maybe_unused]] std::conditional_t<kAux, AuxScene, char> aux{};
  if constexpr (kAux) {
    __shared__ int live_rows[2];
    aux = stage_aux<kThreads>(sph + s, live_rows, aux_geo, aux_rec,
                              rect_rows, box_rows, rect_code, box_code);
  }
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = consts[threadIdx.x];
  const SharedRow acc{&acc_rows[0][threadIdx.x]};
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) acc[k] = 0.f;
  __syncthreads();
  // thread i runs lane i; a thread past n has no lane and only joins its
  // warp's sweeps
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool has_lane = i < n;
  const float width = cam[19];
  const int warp = threadIdx.x & ~31, lane = threadIdx.x & 31;

  const float per_pixel = has_lane ? lane_count[i] : 0.f;
  const float cin = has_lane ? count_in[i] : 0.f;
  // global lane id through float32, as the JAX kernel keys its PRNG
  const uint32_t lane_id = (uint32_t)(int)((float)i + (float)lane_base);
  const uint32_t lane_key = (uint32_t)seed + lane_id * 9781u;
  const float pixel = (float)i;
  const float py_row = floorf(pixel / width);
  const float px_row = pixel - py_row * width;

  Path p{};  // idle until its first sample starts
  [[maybe_unused]] std::conditional_t<kNoise, NoiseLane, char> nl{};
  [[maybe_unused]] const NoiseLane* nlp = nullptr;
  if constexpr (kNoise) {
    nl.ns = noise;
    nl.px = (int)px_row;
    nl.py = (int)py_row;
    nl.lane = i;
    nlp = &nl;
  }
  [[maybe_unused]] std::conditional_t<kVol, Medium, char> med{};
  float started = 0.f;
  int depth = 0;

  const int iters = samples * trace_depth;
  int it = 0;
  for (; it < iters; ++it) {
    // live: this lane bounces in iteration `it` (a sample in flight, or
    // one more to start); the warp leaves when none of its lanes is
    const bool live = p.active || started < per_pixel;
    if (!__any_sync(0xffffffffu, live)) break;
    const uint32_t salt = (uint32_t)it * kSaltStep;
    if constexpr (kNoise) nl.seq = (noise.draw_base + it) % kNoiseWrap;
    float best_t = kBig;
    int best = 0;
    [[maybe_unused]] int aux_kind = 0, aux_idx = 0;
    if (live) {
      if (!p.active) {
        if constexpr (kNoise) {
          nl.k = min((int)started, samples - 1);
          float u[4];
          noise_camera(nl, u);
          camera_ray_u(p, cam, jitter ? u[0] : 0.5f, jitter ? u[1] : 0.5f,
                       u[2], u[3], px_row, py_row);
        } else {
          camera_ray(p, cam, lane_key + salt, px_row, py_row, jitter);
        }
        if constexpr (kVol) {  // the camera's medium
#pragma unroll
          for (int k = 0; k < 8; ++k) med.v[k] = cam[32 + k];
        }
        depth = 0;
        started = started + 1.0f;
      }
      sphere_sweep_steps(p, sph, s, t_min, best_t, best);
      if constexpr (kAux) aux_sweep(p, aux, t_min, best_t, aux_kind, aux_idx);
    }
    float tri_t, tri_u, tri_v;
    int tri_idx;
    tri_sweep_dealt(p, live, tri, t_min, best_t, ray_o + warp, ray_d + warp,
                    key + warp, lane, tri_t, tri_idx, tri_u, tri_v);
    if (live) {
      const bool tri_wins = tri_t < best_t;
      int winner;
      if constexpr (kVol) {
        [[maybe_unused]] const AuxScene* auxp = nullptr;
        if constexpr (kAux) auxp = &aux;
        winner = shade<true, kAux, true, false, false, false, kNoise>(
            p, tri_wins ? tri_t : best_t, best, tri_wins, tri_idx, tri_u,
            tri_v, rec, has_dielectrics != 0, sky_on != 0, cam + 24,
            lane_key + salt + kSaltBounce, depth, tri, auxp, aux_kind,
            aux_idx, &med,
            exit_of<kAux>(p, sph, auxp, best_t, best, tri_wins, aux_kind,
                          aux_idx, t_min),
            nullptr, 0.f, nullptr, nullptr, nlp);
      } else if constexpr (kAux)
        winner = shade<true, true, false, false, false, false, kNoise>(
            p, tri_wins ? tri_t : best_t, best, tri_wins, tri_idx, tri_u,
            tri_v, rec, has_dielectrics != 0, sky_on != 0, cam + 24,
            lane_key + salt + kSaltBounce, depth, tri, &aux, aux_kind,
            aux_idx, nullptr, kBig, nullptr, 0.f, nullptr, nullptr, nlp);
      else
        winner = shade<true, false, false, false, false, false, kNoise>(
            p, tri_wins ? tri_t : best_t, best, tri_wins, tri_idx, tri_u,
            tri_v, rec, has_dielectrics != 0, sky_on != 0, cam + 24,
            lane_key + salt + kSaltBounce, depth, tri, nullptr, 0, 0,
            nullptr, kBig, nullptr, 0.f, nullptr, nullptr, nlp);
      if (tape != nullptr) tape[(size_t)it * n + i] = (float)winner;
      depth = close_bounce(p, depth, trace_depth, cin, acc);
    } else if (tape != nullptr && has_lane) {
      tape[(size_t)it * n + i] = -2.0f;  // idle
    }
  }
  if (!has_lane) return;
  if (tape != nullptr) {
    for (; it < iters; ++it) tape[(size_t)it * n + i] = -2.0f;  // idle
  }
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) out[(size_t)k * n + i] = acc[k];
}

// The streamed build: kGroup lanes a block in lockstep (see the top of
// this file); no tape.  Its noise build (kNoise) takes a sampler
// flavor's pre-drawn rows (`noise`, without tables), lane i's column.  Its
// aux build (kAux; the others compile none of it) stages the scene's rects
// and boxes after the spheres (stage_aux) and sweeps them after the
// spheres and before the group traversal (aux_sweep), whose culls then
// take the nearest of the three, and shades a rect or box winner.  Its
// volume builds (kVol, with or without kAux) read the camera's medium
// from consts[32..39], carry each lane's (per-lane state: the group's
// traversal is unchanged) and walk it, the winner's exit (exit_of) taken
// after the traversal; kTriVolBlocks blocks an SM (its noise build
// beside rects and boxes took 152 registers and 3 blocks without it).
template <bool kNoise = false, bool kAux = false, bool kVol = false>
__global__ void __launch_bounds__(kGroup, kVol ? kTriVolBlocks : 0)
    megatrace_stream_kernel(
    const float* __restrict__ lane_count, const float* __restrict__ count_in,
    const float* __restrict__ pixel_index, const float* __restrict__ consts,
    const float4* __restrict__ sph_g, const float* __restrict__ rec,
    TriScene tri, float* __restrict__ out, int n, int s, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter,
    const NoiseScene noise = NoiseScene{},
    const float4* __restrict__ aux_geo = nullptr,
    const float* __restrict__ aux_rec = nullptr, int rect_rows = 0,
    int box_rows = 0, int rect_code = 0, int box_code = 0) {
  extern __shared__ float4 sph[];
  __shared__ __align__(128) GroupShared g;
  constexpr int kCamFloats = kVol ? kVolConsts : kConsts;
  __shared__ float cam[kCamFloats];
  for (int k = threadIdx.x; k < s; k += kGroup) sph[k] = sph_g[k];
  [[maybe_unused]] std::conditional_t<kAux, AuxScene, char> aux{};
  if constexpr (kAux) {
    __shared__ int live_rows[2];
    aux = stage_aux<kGroup>(sph + s, live_rows, aux_geo, aux_rec, rect_rows,
                            box_rows, rect_code, box_code);
  }
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = consts[threadIdx.x];
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
  [[maybe_unused]] std::conditional_t<kNoise, NoiseLane, char> nl{};
  [[maybe_unused]] const NoiseLane* nlp = nullptr;
  if constexpr (kNoise) {
    nl.ns = noise;
    nl.px = (int)px_row;
    nl.py = (int)py_row;
    nl.lane = i;
    nlp = &nl;
  }
  [[maybe_unused]] std::conditional_t<kVol, Medium, char> med{};
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
      if constexpr (kNoise) {
        nl.k = min((int)started, samples - 1);
        float u[4];
        noise_camera(nl, u);
        camera_ray_u(p, cam, jitter ? u[0] : 0.5f, jitter ? u[1] : 0.5f,
                     u[2], u[3], px_row, py_row);
      } else {
        camera_ray(p, cam, lane_key + salt, px_row, py_row, jitter);
      }
      if constexpr (kVol) {  // the camera's medium
#pragma unroll
        for (int k = 0; k < 8; ++k) med.v[k] = cam[32 + k];
      }
      depth = 0;
      started = started + 1.0f;
    }
    float best_t = 0.f;
    int best = 0;
    [[maybe_unused]] int aux_kind = 0, aux_idx = 0;
    if (live) {
      sphere_sweep(p, sph, s, t_min, best_t, best);
      if constexpr (kAux) aux_sweep(p, aux, t_min, best_t, aux_kind, aux_idx);
    }
    bool tri_wins;
    int tri_idx;
    float tri_u, tri_v;
    group_hit(g, cursor, p, live, live, tri, t_min, best_t, tri_wins,
              tri_idx, tri_u, tri_v);
    if (live) {
      if constexpr (kVol) {
        [[maybe_unused]] const AuxScene* auxp = nullptr;
        if constexpr (kAux) auxp = &aux;
        shade<true, kAux, true, false, false, false, kNoise>(
            p, best_t, best, tri_wins, tri_idx, tri_u, tri_v, rec,
            has_dielectrics != 0, sky_on != 0, cam + 24,
            lane_key + salt + kSaltBounce, depth, tri, auxp, aux_kind,
            aux_idx, &med,
            exit_of<kAux>(p, sph, auxp, best_t, best, tri_wins, aux_kind,
                          aux_idx, t_min),
            nullptr, 0.f, nullptr, nullptr, nlp);
      } else if constexpr (kAux)
        shade<true, true, false, false, false, false, kNoise>(
            p, best_t, best, tri_wins, tri_idx, tri_u, tri_v, rec,
            has_dielectrics != 0, sky_on != 0, cam + 24,
            lane_key + salt + kSaltBounce, depth, tri, &aux, aux_kind,
            aux_idx, nullptr, kBig, nullptr, 0.f, nullptr, nullptr, nlp);
      else
        shade<true, false, false, false, false, false, kNoise>(
            p, best_t, best, tri_wins, tri_idx, tri_u, tri_v, rec,
            has_dielectrics != 0, sky_on != 0, cam + 24,
            lane_key + salt + kSaltBounce, depth, tri, nullptr, 0, 0,
            nullptr, kBig, nullptr, 0.f, nullptr, nullptr, nlp);
      depth = close_bounce(p, depth, trace_depth, cin, acc);
    }
  }
  if (i < n) {
#pragma unroll
    for (int k = 0; k < kOutRows; ++k) out[(size_t)k * n + i] = acc[k];
  }
}

}  // namespace

// A sampler flavor's inputs as the *_noise entry points take them (a
// NoiseScene in host memory; the entry point fills in samples and n):
// usable when they hold the tables with positive sizes or the pre-drawn
// camera rows.
static bool noise_usable(const NoiseScene* noise) {
  if (noise == nullptr) return false;
  if (noise->tbl != nullptr)
    return noise->size >= 1 && noise->t >= 1 && noise->scal_t >= 1;
  return noise->uni != nullptr;
}

static NoiseScene noise_of(const NoiseScene* noise, int samples, int n) {
  NoiseScene ns = *noise;
  ns.samples = samples;
  ns.n = n;
  return ns;
}

// The rect and box rows an aux build of the triangle build or the
// streamed kernel takes (rtiw_megatrace_tri_aux): aux_geo (rect_rows +
// box_rows) x 16 floats, 16-byte aligned, aux_rec as many 16-column
// records, and the tape codes of rect row 0 and box row 0.  No rows: the
// builds without kAux.
struct AuxRows {
  const float* geo = nullptr;
  const float* rec = nullptr;
  int rect_rows = 0, box_rows = 0, rect_code = 0, box_code = 0;
};

// The dynamic shared memory of the triangle build and the streamed kernel:
// the spheres, then three float4 a rect or box row.
static size_t tri_shmem(int s, int aux_rows) {
  return ((size_t)s + 3 * (size_t)aux_rows) * sizeof(float4);
}

template <bool kNoise, bool kAux, bool kVol = false>
static int stream_launch(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const TriScene& tri, float* out, int n, int s, int seed, int lane_base,
    int samples, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int jitter, const NoiseScene& ns, const AuxRows& a,
    cudaStream_t st) {
  const size_t shmem = tri_shmem(s, a.rect_rows + a.box_rows);
  // the tables beside ~34 KB of static shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      megatrace_stream_kernel<kNoise, kAux, kVol>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  megatrace_stream_kernel<kNoise, kAux, kVol>
      <<<(n + kGroup - 1) / kGroup, kGroup, shmem, st>>>(
          lane_count, count_in, pixel_index, consts,
          reinterpret_cast<const float4*>(sph), rec, tri, out, n, s, seed,
          lane_base, samples, trace_depth, t_min, has_dielectrics, sky_on,
          jitter, ns, reinterpret_cast<const float4*>(a.geo), a.rec,
          a.rect_rows, a.box_rows, a.rect_code, a.box_code);
  return static_cast<int>(cudaGetLastError());
}

// The triangle build's launches with rect and box rows in `aux` beside the
// spheres in dynamic shared memory: its aux build, and with kVol its
// volume builds, with those rows or without (batch_launch's `vol`).
template <bool kNoise, bool kVol>
static int tri_aux_launch(const float* lane_count, const float* count_in,
                          const float* consts, const float* sph,
                          const float* rec, const TriScene& tri, float* out,
                          float* tape, int n, int s, int seed,
                          int lane_base, int samples, int trace_depth,
                          float t_min, int has_dielectrics, int sky_on,
                          int jitter, const NoiseScene& ns,
                          const AuxRows& aux, cudaStream_t st) {
  const bool has_aux = aux.rect_rows + aux.box_rows > 0;
  const auto kernel = has_aux ? megatrace_tri_kernel<kNoise, true, kVol>
                              : megatrace_tri_kernel<kNoise, false, kVol>;
  // the spheres, then the rect and box rows (up to AUX_MAX: 48 KB)
  const size_t shmem = tri_shmem(s, aux.rect_rows + aux.box_rows);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, shmem, st>>>(
      lane_count, count_in, consts, reinterpret_cast<const float4*>(sph),
      rec, tri, out, tape, n, s, seed, lane_base, samples, trace_depth,
      t_min, has_dielectrics, sky_on, jitter, ns,
      reinterpret_cast<const float4*>(aux.geo), aux.rec, aux.rect_rows,
      aux.box_rows, aux.rect_code, aux.box_code);
  return static_cast<int>(cudaGetLastError());
}

// rtiw_megatrace_batch's launches, white (kNoise false) or a flavor's
// (the triangle build and the streamed kernel; the streamed one takes
// the pre-drawn rows only, and the sphere-only build's noise twin is
// rtiw_megatrace_ext_noise's), and with rect and box rows in `aux` the
// aux builds of the triangle build and the streamed kernel
// (rtiw_megatrace_tri_aux's; never the sphere-only build); with `vol` the
// volume builds of those two, with rect and box rows or without
// (rtiw_megatrace_tri_vol's: `consts` holds kVolConsts floats).
template <bool kNoise>
static int batch_launch(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const float* tri_geo, const float* tri_aabb, const float* tri_sup,
    const float* tri_rec, float* out, float* tape, int n, int s,
    int tri_rows, int tri_blocks, int tri_supers, int tri_code_base,
    int seed, int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, const NoiseScene& ns,
    void* stream, const AuxRows& aux = AuxRows{}, bool vol = false) {
  const bool has_aux = aux.rect_rows + aux.box_rows > 0;
  if ((has_aux || vol) &&
      (tri_rows <= 0 ||
       (has_aux && (aux.geo == nullptr || aux.rec == nullptr ||
                    reinterpret_cast<uintptr_t>(aux.geo) % 16 != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
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
          reinterpret_cast<uintptr_t>(tri_geo) % 16 != 0 ||
          (kNoise && ns.tbl != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
      if (vol)
        return has_aux ? stream_launch<kNoise, true, true>(
                             lane_count, count_in, pixel_index, consts, sph,
                             rec, tri, out, n, s, seed, lane_base, samples,
                             trace_depth, t_min, has_dielectrics, sky_on,
                             jitter, ns, aux, st)
                       : stream_launch<kNoise, false, true>(
                             lane_count, count_in, pixel_index, consts, sph,
                             rec, tri, out, n, s, seed, lane_base, samples,
                             trace_depth, t_min, has_dielectrics, sky_on,
                             jitter, ns, aux, st);
      return has_aux
                 ? stream_launch<kNoise, true>(
                       lane_count, count_in, pixel_index, consts, sph, rec,
                       tri, out, n, s, seed, lane_base, samples, trace_depth,
                       t_min, has_dielectrics, sky_on, jitter, ns, aux, st)
                 : stream_launch<kNoise, false>(
                       lane_count, count_in, pixel_index, consts, sph, rec,
                       tri, out, n, s, seed, lane_base, samples, trace_depth,
                       t_min, has_dielectrics, sky_on, jitter, ns, aux, st);
    } else if (vol || (tri_rows > 0 && has_aux)) {
      return (vol ? tri_aux_launch<kNoise, true>
                  : tri_aux_launch<kNoise, false>)(
          lane_count, count_in, consts, sph, rec, tri, out, tape, n, s, seed,
          lane_base, samples, trace_depth, t_min, has_dielectrics, sky_on,
          jitter, ns, aux, st);
    } else if (tri_rows > 0) {
      megatrace_tri_kernel<kNoise>
          <<<(n + kThreads - 1) / kThreads, kThreads, shmem, st>>>(
              lane_count, count_in, consts,
              reinterpret_cast<const float4*>(sph), rec, tri, out, tape, n,
              s, seed, lane_base, samples, trace_depth, t_min,
              has_dielectrics, sky_on, jitter, ns);
    } else if constexpr (kNoise) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      // the table's size: rtiw_megatrace_ext_info may have set the
      // attribute to a smaller table's (the launch is refused above it)
      const cudaError_t err = cudaFuncSetAttribute(
          megatrace_sphere_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (err != cudaSuccess) return static_cast<int>(err);
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
// move != null, kTex = tex_rec != null>, or with a cubemap the cube build
// of at most one of those (cube_kernel; null for two or more); each with
// kNoise, its noise build.
using SphereKernel = decltype(&megatrace_sphere_kernel<false>);

template <bool kNoise>
static SphereKernel cube_kernel(int aux_rows, int has_vol, bool motion,
                                bool tex) {
  if ((aux_rows > 0) + (has_vol != 0) + motion + tex > 1) return nullptr;
  return aux_rows > 0 ? megatrace_sphere_kernel<true, false, false, false,
                                                false, true, kNoise>
         : has_vol    ? megatrace_sphere_kernel<false, true, false, false,
                                                false, true, kNoise>
         : motion     ? megatrace_sphere_kernel<false, false, true, false,
                                                false, true, kNoise>
         : tex        ? megatrace_sphere_kernel<false, false, false, true,
                                                false, true, kNoise>
                      : megatrace_sphere_kernel<false, false, false, false,
                                                false, true, kNoise>;
}

template <bool kAux, bool kVol, bool kNoise>
static SphereKernel ext_kernel_of(bool motion, bool tex) {
  if (motion)
    return tex ? megatrace_sphere_kernel<kAux, kVol, true, true, false,
                                         false, kNoise>
               : megatrace_sphere_kernel<kAux, kVol, true, false, false,
                                         false, kNoise>;
  return tex ? megatrace_sphere_kernel<kAux, kVol, false, true, false, false,
                                       kNoise>
             : megatrace_sphere_kernel<kAux, kVol, false, false, false,
                                       false, kNoise>;
}

template <bool kNoise>
static SphereKernel ext_kernel(int aux_rows, int has_vol, bool motion,
                               bool tex) {
  if (has_vol)
    return aux_rows > 0 ? ext_kernel_of<true, true, kNoise>(motion, tex)
                        : ext_kernel_of<false, true, kNoise>(motion, tex);
  return aux_rows > 0 ? ext_kernel_of<true, false, kNoise>(motion, tex)
                      : ext_kernel_of<false, false, kNoise>(motion, tex);
}

// The dynamic shared memory: the spheres, three float4 a rect or box row,
// then with motion a move offset a sphere.
static size_t ext_shmem(int s, int aux_rows, bool motion) {
  return ((size_t)s + 3 * (size_t)aux_rows + (motion ? (size_t)s : 0)) *
         sizeof(float4);
}

template <bool kNoise>
static int ext_launch(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, const float* aux_geo,
    const float* aux_rec, float* out, float* tape, int n, int s,
    int rect_rows, int box_rows, int rect_code, int box_code, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, int has_vol,
    const float* move, const float* tex_rec, const float* perlin,
    const float* atlas, int img_w, int img_h, const float* cube, int cube_w,
    int cube_h, const NoiseScene& ns, void* stream) {
  if (n > 0) {
    const int aux_rows = rect_rows + box_rows;
    const bool motion = move != nullptr;
    const SphereKernel kernel =
        cube != nullptr
            ? cube_kernel<kNoise>(aux_rows, has_vol, motion,
                                  tex_rec != nullptr)
            : ext_kernel<kNoise>(aux_rows, has_vol, motion,
                                 tex_rec != nullptr);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
        tex_rec, perlin, atlas, img_w, img_h, nullptr, 0, 0, cube, cube_w,
        cube_h, ns);
  }
  return static_cast<int>(cudaGetLastError());
}

// The blocked builds (more than SPH_CULL_MIN spheres, sphere scenes,
// static or with move != null moving; with kNoise their noise builds):
// the sphere build's arguments, then `boxes` (`blocks` x 8 floats:
// pack_sphere_blocks' rows, the first ceil(s / rows) of them) and `move`
// (s x 4 floats, or null).  Returns cudaGetLastError() after the launch,
// or the error of setting its shared memory.
template <bool kNoise>
static SphereKernel blocked_kernel(bool motion) {
  return motion ? megatrace_sphere_kernel<false, false, true, false, true,
                                          false, kNoise>
                : megatrace_sphere_kernel<false, false, false, false, true,
                                          false, kNoise>;
}

template <bool kNoise>
static int blocked_launch(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, const float* boxes,
    const float* move, float* out, float* tape, int n, int s, int blocks,
    int rows, int seed, int lane_base, int samples, int trace_depth,
    float t_min, int has_dielectrics, int sky_on, int jitter,
    const NoiseScene& ns, void* stream) {
  if (n > 0) {
    const SphereKernel kernel = blocked_kernel<kNoise>(move != nullptr);
    const size_t shmem = (size_t)blocks * 8 * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, shmem,
             static_cast<cudaStream_t>(stream)>>>(
        lane_count, count_in, consts, reinterpret_cast<const float4*>(sph),
        rec, out, tape, n, s, seed, lane_base, samples, trace_depth, t_min,
        has_dielectrics, sky_on, jitter, nullptr, nullptr, 0, 0, 0, 0,
        reinterpret_cast<const float4*>(move), nullptr, nullptr, nullptr, 0,
        0, boxes, blocks, rows, nullptr, 0, 0, ns);
  }
  return static_cast<int>(cudaGetLastError());
}

// sphere_info of the triangle build (kStream false) or the streamed
// kernel, each with kAux its aux build and with kVol its volume build, for
// tables of `bytes` bytes.
template <bool kNoise, bool kAux, bool kStream, bool kVol = false>
static int tri_info(size_t bytes, int* info) {
  const void* kernel =
      kStream ? reinterpret_cast<const void*>(
                    megatrace_stream_kernel<kNoise, kAux, kVol>)
              : reinterpret_cast<const void*>(
                    megatrace_tri_kernel<kNoise, kAux, kVol>);
  if (kStream || kAux || kVol) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return sphere_info(kernel, bytes, info);
}

// sphere_info of a build for an s-sphere table, aux_rows rect and box rows
// and the flags (all 0: the sphere build; has_cube: a cube build);
// blocks > 0 takes the blocked build (static or with has_motion) for a
// table of that many blocks; tri 1 takes the triangle build and tri 2 the
// streamed kernel, each with aux_rows > 0 its aux build and with has_vol
// its volume build; with `noise` the build's noise build.
template <bool kNoise>
static int build_info(int s, int aux_rows, int has_vol, int has_motion,
                      int has_tex, int blocks, int has_cube, int tri,
                      int* info) {
  if ((tri == 1 || tri == 2) && has_vol) {
    const size_t bytes = tri_shmem(s, aux_rows);
    if (tri == 1)
      return aux_rows > 0 ? tri_info<kNoise, true, false, true>(bytes, info)
                          : tri_info<kNoise, false, false, true>(bytes, info);
    return aux_rows > 0 ? tri_info<kNoise, true, true, true>(bytes, info)
                        : tri_info<kNoise, false, true, true>(bytes, info);
  }
  if (tri == 1 || tri == 2) {
    const size_t bytes = tri_shmem(s, aux_rows);
    if (tri == 1)
      return aux_rows > 0 ? tri_info<kNoise, true, false>(bytes, info)
                          : tri_info<kNoise, false, false>(bytes, info);
    return aux_rows > 0 ? tri_info<kNoise, true, true>(bytes, info)
                        : tri_info<kNoise, false, true>(bytes, info);
  }
  const SphereKernel kernel =
      blocks > 0 ? blocked_kernel<kNoise>(has_motion != 0)
      : has_cube ? cube_kernel<kNoise>(aux_rows, has_vol, has_motion != 0,
                                       has_tex != 0)
                 : ext_kernel<kNoise>(aux_rows, has_vol, has_motion != 0,
                                      has_tex != 0);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = blocks > 0 ? (size_t)blocks * 8 * sizeof(float)
                                  : ext_shmem(s, aux_rows, has_motion != 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return sphere_info(reinterpret_cast<const void*>(kernel), shmem, info);
}
