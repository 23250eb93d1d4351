// Fused sample-batch path tracer for Hopper (sm_90a): one whole
// SampleBatchJob per launch, sphere-only scenes, gradient or no sky.
//
// Replaces: ops/pallas_megatrace.py::_batch_kernel of the JAX package, its
// sphere-only arm (white-noise hash PRNG, dense sphere sweep, Standard
// Lambert/GGX-metal and dielectric scatter, gradient sky, per-pixel fold).
// Plain version: ops/megatrace.py::sample_batch_reference, which this
// kernel matches bit for bit up to log/exp2 (see the precision contract
// there): no --use_fast_math, -fmad=false, and the same explicit fmaf
// calls; sqrt/rsqrt/sin/cos are correctly rounded.
//
// What bounds it on this card: ALU and divergence in the sphere sweep.
// Every bounce of every path tests all S spheres (485 on the book cover,
// ~20 flops each), while device memory sees ~30 bytes per pixel (two
// floats in, 18 accumulators out) plus the optional tape.
//
// What this simple design does about it: one thread owns one lane and
// keeps the whole path state and its pixel's accumulators in registers
// for the whole batch, so nothing round-trips through device memory
// between bounces.  Each block stages the sphere geometry (centre and
// |c|^2 - r^2, 16 bytes per sphere) in shared memory; every thread of a
// warp reads the same sphere at the same step, which is a broadcast.  The
// winner's record (material, centre, 1/r: 64 bytes) is read once per
// bounce through the read-only cache.  A lane exits as soon as its last
// sample ends: unlike the TPU tile, a thread need not wait for its
// neighbours.  Pad rows of the JAX tables never hit and come last, so the
// loop runs over real spheres only and winner indices are unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "megatrace_common.cuh"

namespace {

using namespace rtiw;

constexpr int kRec = 16;  // record columns: 0-10 material | 11 id |
                          // 12-14 centre | 15 1/r
constexpr int kOutRows = 18;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) megatrace_batch_kernel(
    const float* __restrict__ lane_count, const float* __restrict__ count_in,
    const float* __restrict__ consts, const float4* __restrict__ sph_g,
    const float* __restrict__ rec, float* __restrict__ out,
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
  float cam[30];
#pragma unroll
  for (int k = 0; k < 30; ++k) cam[k] = __ldg(consts + k);
  const float lens_radius = cam[18], width = cam[19], height = cam[20];

  const float per_pixel = lane_count[i];
  const float cin = count_in[i];
  // global lane id through float32, as the JAX kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)((float)i + (float)lane_base);
  const uint32_t lane_key = (uint32_t)seed + lane * 9781u;
  const float pixel = (float)i;
  const float py_row = floorf(pixel / width);
  const float px_row = pixel - py_row * width;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float thx = 1.f, thy = 1.f, thz = 1.f, rx = 0.f, ry = 0.f, rz = 0.f;
  bool pactive = false, valid = false, got = false;
  float anx = 0.f, any = 0.f, anz = 0.f, aax = 0.f, aay = 0.f, aaz = 0.f;
  float events = 0.f, started = 0.f;
  int depth = 0;
  float acc[kOutRows];
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) acc[k] = 0.f;

  const int iters = samples * trace_depth;
  int it = 0;
  for (; it < iters; ++it) {
    const uint32_t salt = (uint32_t)it * kSaltStep;
    if (!pactive) {
      if (started >= per_pixel) break;  // this lane's samples are done
      // ---- regenerate: thin-lens camera ray (View.cs:38-48) ----------
      const uint32_t base = lane_key + salt;
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
      ox = cam[0] + offx;
      oy = cam[1] + offy;
      oz = cam[2] + offz;
      dx = cdx;
      dy = cdy;
      dz = cdz;
      thx = thy = thz = 1.f;
      rx = ry = rz = 0.f;
      anx = any = anz = aax = aay = aaz = 0.f;
      got = false;
      events = 0.f;
      depth = 0;
      valid = false;
      pactive = true;
      started = started + 1.0f;
    }

    // ---- dense sphere sweep ------------------------------------------
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float o_dot_d = dot3(ox, oy, oz, dx, dy, dz);
    const float o_sq = dot3(ox, oy, oz, ox, oy, oz);
    const float inv_a = 1.0f / a;
    float best_t = kBig;
    int best = 0;
    for (int k = 0; k < s; ++k) {
      const float4 g = sph[k];
      const float b = o_dot_d - dot3(dx, dy, dz, g.x, g.y, g.z);
      const float c = fmaf(-2.0f, dot3(ox, oy, oz, g.x, g.y, g.z), o_sq) + g.w;
      const float disc = fmaf(b, b, -(a * c));
      if (disc > 0.0f) {
        const float sq = sqrtf(disc);
        const float t_near = (-b - sq) * inv_a;
        const float t_far = (-b + sq) * inv_a;
        const float t = t_near > t_min ? t_near : (t_far > t_min ? t_far : kBig);
        if (t < best_t) {  // strict: the first index wins a tie (argmin)
          best_t = t;
          best = k;
        }
      }
    }
    const bool hit = best_t < kBig;
    if (tape != nullptr) tape[(size_t)it * n + i] = hit ? (float)best : -1.0f;

    // gradient sky (SampleBatchJob.cs:352-354), needed on a miss
    float skr = 0.f, skg = 0.f, skb = 0.f;
    if (!hit) {
      if (sky_on) {
        const float tsky = 0.5f * (dy + 1.0f);
        skr = fmaf(cam[27] - cam[24], tsky, cam[24]);
        skg = fmaf(cam[28] - cam[25], tsky, cam[25]);
        skb = fmaf(cam[29] - cam[26], tsky, cam[26]);
      }
      rx = fmaf(thx, skr, rx);
      ry = fmaf(thy, skg, ry);
      rz = fmaf(thz, skb, rz);
      if (!got) {
        anx = -dx;
        any = -dy;
        anz = -dz;
        aax = skr;
        aay = skg;
        aaz = skb;
        got = true;
      }
      pactive = false;
      valid = true;
    } else {
      const float* w = rec + (size_t)best * kRec;
      const float px = fmaf(best_t, dx, ox);
      const float py = fmaf(best_t, dy, oy);
      const float pz = fmaf(best_t, dz, oz);
      const float inv_r = __ldg(w + 15);
      const float nx = (px - __ldg(w + 12)) * inv_r;
      const float ny = (py - __ldg(w + 13)) * inv_r;
      const float nz = (pz - __ldg(w + 14)) * inv_r;
      const float mtype = __ldg(w + 0);
      const float alb_r = __ldg(w + 1), alb_g = __ldg(w + 2),
                  alb_b = __ldg(w + 3);
      const float em_r = __ldg(w + 4), em_g = __ldg(w + 5),
                  em_b = __ldg(w + 6);
      const float gloss = __ldg(w + 7), metallic = __ldg(w + 8),
                  parameter = __ldg(w + 9);
      float perfect = __ldg(w + 10);

      const uint32_t bbase = lane_key + salt + kSaltBounce;
      const float ua = uniform(bbase, 0), ub = uniform(bbase, 1);
      const float u_choice = uniform(bbase, 4);
      float sdx, sdy, sdz, srr, srg, srb, step_events;
      if (has_dielectrics && mtype > 0.5f) {
        // ---- dielectric (Material.cs:121-161) ------------------------
        const float d_rough = 1.0f - gloss;
        const float z = ua * 2.0f - 1.0f;
        const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        const float th = ub * kTwoPi;
        const float ssx = cos_cr(th) * r, ssy = sin_cr(th) * r, ssz = z;
        float drx = fmaf(d_rough, ssx, nx);
        float dry = fmaf(d_rough, ssy, ny);
        float drz = fmaf(d_rough, ssz, nz);
        normalize3(drx, dry, drz);
        const float ddot = dot3(dx, dy, dz, drx, dry, drz);
        const bool exiting = ddot > 0.0f;
        const float onx = exiting ? -drx : drx;
        const float ony = exiting ? -dry : dry;
        const float onz = exiting ? -drz : drz;
        const float ior = parameter;
        const float ni_over_nt = exiting ? ior : 1.0f / ior;
        const float cosine = exiting ? ior * ddot : -ddot;
        const float dt = dot3(dx, dy, dz, onx, ony, onz);
        const float disc_r =
            fmaf(-(ni_over_nt * ni_over_nt), fmaf(-dt, dt, 1.0f), 1.0f);
        const bool can_refract = disc_r > 0.0f;
        const float sq_r = sqrtf(can_refract ? disc_r : 0.0f);
        const float refl_prob = schlick(cosine, ior);
        const bool do_refract = can_refract && (u_choice > refl_prob);
        if (do_refract) {
          sdx = fmaf(ni_over_nt, fmaf(-onx, dt, dx), -(onx * sq_r));
          sdy = fmaf(ni_over_nt, fmaf(-ony, dt, dy), -(ony * sq_r));
          sdz = fmaf(ni_over_nt, fmaf(-onz, dt, dz), -(onz * sq_r));
          srr = alb_r;
          srg = alb_g;
          srb = alb_b;
        } else {
          sdx = fmaf(-(2.0f * ddot), drx, dx);
          sdy = fmaf(-(2.0f * ddot), dry, dy);
          sdz = fmaf(-(2.0f * ddot), drz, dz);
          srr = srg = srb = 1.0f;
        }
        step_events = 1.0f + d_rough;
        perfect = 1.0f;
      } else {
        // ---- Standard: Lambert / GGX metal (Material.cs:75-119) ------
        const float roughness = (1.0f - gloss) * (1.0f - gloss);
        float rnx = nx, rny = ny, rnz = nz;
        if (roughness > 0.0f) {
          float csx, csy, csz;
          cosine_hemisphere(ua, ub, nx, ny, nz, csx, csy, csz);
          rnx = fmaf(csx - nx, roughness, nx);
          rny = fmaf(csy - ny, roughness, ny);
          rnz = fmaf(csz - nz, roughness, nz);
          normalize3(rnx, rny, rnz);
        }
        const float spec_dot = dot3(dx, dy, dz, rnx, rny, rnz);
        const float incident_cos = -spec_dot;
        const float std_ior = fmaf(kIorSpan, metallic, kPlasticIor);
        const float fresnel = schlick(incident_cos, std_ior);
        const float masking =
            smith_masking(dot3(dx, dy, dz, nx, ny, nz), roughness);
        const float refl_chance =
            fminf(fmaxf(fresnel * gloss * masking, 0.0f), 1.0f);
        const bool take_spec =
            (refl_chance > 0.0f) && (u_choice < refl_chance);
        const bool take_metal =
            (metallic > 0.0f) && (uniform(bbase, 5) < metallic);
        if (take_spec || take_metal) {
          sdx = fmaf(-(2.0f * spec_dot), rnx, dx);
          sdy = fmaf(-(2.0f * spec_dot), rny, dy);
          sdz = fmaf(-(2.0f * spec_dot), rnz, dz);
        } else {
          cosine_hemisphere(uniform(bbase, 2), uniform(bbase, 3), nx, ny, nz,
                            sdx, sdy, sdz);
        }
        srr = take_spec ? 1.0f : alb_r;
        srg = take_spec ? 1.0f : alb_g;
        srb = take_spec ? 1.0f : alb_b;
        step_events =
            ((refl_chance > 0.0f && refl_chance < 1.0f) ? 1.0f : 0.0f) +
            ((metallic > 0.0f && metallic < 1.0f) ? 1.0f : 0.0f) +
            roughness * (refl_chance + (1.0f - refl_chance) * metallic) +
            (1.0f - refl_chance) * (1.0f - metallic);
      }

      // ---- fold, AOVs, events, advance ----------------------------------
      rx = fmaf(thx, em_r, rx);
      ry = fmaf(thy, em_g, ry);
      rz = fmaf(thz, em_b, rz);
      thx = thx * srr;
      thy = thy * srg;
      thz = thz * srb;
      const bool first_nonspec = !got && perfect < 0.5f;
      if ((depth == 0 && !got) || first_nonspec) {
        anx = nx;
        any = ny;
        anz = nz;
      }
      if (first_nonspec) {
        aax = em_r + srr;
        aay = em_g + srg;
        aaz = em_b + srb;
        got = true;
      }
      events = events + step_events * exp2f(-(float)depth);
      const float off =
          kSelfEps * (dot3(sdx, sdy, sdz, nx, ny, nz) >= 0.0f ? 1.0f : -1.0f);
      ox = fmaf(off, nx, px);
      oy = fmaf(off, ny, py);
      oz = fmaf(off, nz, pz);
      dx = sdx;
      dy = sdy;
      dz = sdz;
    }

    // ---- per-lane bookkeeping ------------------------------------------
    depth += 1;
    acc[11] += 1.0f;  // rays
    // depth exhaustion fails the sample (SampleBatchJob.cs:380-381)
    if (pactive && depth >= trace_depth) pactive = false;
    if (!pactive) {
      if (valid) {
        acc[0] += rx;
        acc[1] += ry;
        acc[2] += rz;
        acc[4] += anx;
        acc[5] += any;
        acc[6] += anz;
        acc[7] += aax;
        acc[8] += aay;
        acc[9] += aaz;
        acc[10] += events;
      }
      // fallback AOVs while the pixel has no valid sample yet
      // (SampleBatchJob.cs:146-151; captured valid or not)
      if (cin + acc[3] < 0.5f) {
        acc[12] = anx;
        acc[13] = any;
        acc[14] = anz;
        acc[15] = aax;
        acc[16] = aay;
        acc[17] = aaz;
      }
      if (valid) acc[3] += 1.0f;
    }
  }
  if (tape != nullptr) {
    for (; it < iters; ++it) tape[(size_t)it * n + i] = -2.0f;  // idle
  }
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) out[(size_t)k * n + i] = acc[k];
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() right after the launch.
extern "C" int rtiw_megatrace_batch(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, float* out, float* tape, int n, int s,
    int seed, int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const size_t shmem = (size_t)s * sizeof(float4);
    megatrace_batch_kernel<<<blocks, kThreads, shmem,
                             static_cast<cudaStream_t>(stream)>>>(
        lane_count, count_in, consts, reinterpret_cast<const float4*>(sph),
        rec, out, tape, n, s, seed, lane_base, samples, trace_depth, t_min,
        has_dielectrics, sky_on, jitter);
  }
  return static_cast<int>(cudaGetLastError());
}
