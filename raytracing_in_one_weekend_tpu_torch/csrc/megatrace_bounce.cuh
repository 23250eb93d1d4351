// One path-tracing bounce of one lane: the code the batch kernel
// (megatrace_batch.cu), the per-ray megatrace (megatrace_wave.cu) and the
// bounce-synchronous mesh sampler (meshtrace_sync.cu) share, as the JAX
// package's kernels share pallas_megatrace.py::_bounce_step.  The sampler
// runs its own cooperative triangle sweep between `sphere_sweep` and
// `shade`; the others call `bounce`, which runs all three.  The triangle
// arms are compile-time flags: the batch kernel's mesh builds take them,
// the sphere-only builds compile none of it.  Plain version:
// ops/megatrace.py::_bounce, under the precision contract of
// megatrace_common.cuh.
#pragma once

#include <stdint.h>

#include "megatrace_common.cuh"

namespace rtiw {

constexpr int kRec = 16;  // record columns: 0-10 material | 11 id |
                          // 12-14 centre | 15 1/r
constexpr int kTriRec = 32;  // triangle record columns: 0-10 material |
                             // 11 id | 12-20 vertex normals | 21-26 uvs
constexpr int kTriBlock = 192;  // triangle rows under one AABB
constexpr int kTriSup = 16;  // blocks under one super-block AABB

// A mesh scene's triangles, in device memory, read through the read-only
// cache: geometry rows (edge_a | edge_b | vert0 | pad, three float4 a
// row), one AABB per kTriBlock rows (lo | hi, two float4; a pad-only
// block holds a point at 1e30) and the records.  A streamed mesh adds one
// AABB per kTriSup blocks (`sup`, `supers`; its blocks are a multiple of
// kTriSup).  A triangle's tape code is code_base (the padded sphere rows)
// plus its row.
struct TriScene {
  const float4* geo = nullptr;
  const float4* aabb = nullptr;
  const float* rec = nullptr;
  const float4* sup = nullptr;
  int rows = 0, blocks = 0, code_base = 0, supers = 0;
};

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

// Sweep triangle block `blk` of `tri` when the ray meets its AABB before
// its best hit so far (best_t of the spheres, tri_t of earlier blocks): a
// row wins only with a strictly smaller t, so the first row wins a tie.
__device__ __forceinline__ void tri_block(
    const TriScene& tri, int blk, float ox, float oy, float oz, float dx,
    float dy, float dz, float ivx, float ivy, float ivz, float t_min,
    float best_t, float& tri_t, int& tri_idx, float& tri_u, float& tri_v) {
  if (!slab_may(tri.aabb + 2 * blk, ox, oy, oz, ivx, ivy, ivz, t_min,
                fminf(tri_t, best_t)))
    return;
  const int end = min((blk + 1) * kTriBlock, tri.rows);
  for (int k = blk * kTriBlock; k < end; ++k) {
    const float4 g0 = __ldg(tri.geo + 3 * k);
    const float4 g1 = __ldg(tri.geo + 3 * k + 1);
    const float4 g2 = __ldg(tri.geo + 3 * k + 2);
    float u, v;
    const float t = moller_trumbore(ox, oy, oz, dx, dy, dz, g0.x, g0.y, g0.z,
                                    g0.w, g1.x, g1.y, g1.z, g1.w, g2.x, t_min,
                                    u, v);
    if (t < tri_t) {
      tri_t = t;
      tri_idx = k;
      tri_u = u;
      tri_v = v;
    }
  }
}

// The state of one path (SampleBatchJob.cs:166-401).
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float thx, thy, thz, rx, ry, rz;
  float anx, any, anz, aax, aay, aaz;
  float events;
  bool active, valid, got;
};

// The dense sweep of the path `p` over the s spheres in shared memory
// `sph` (centre, |c|^2 - r^2): the nearest t after t_min (kBig on a miss)
// and its row, the first row on a tie.
__device__ __forceinline__ void sphere_sweep(const Path& p, const float4* sph,
                                             int s, float t_min,
                                             float& best_t, int& best) {
  const float dx = p.dx, dy = p.dy, dz = p.dz, ox = p.ox, oy = p.oy,
              oz = p.oz;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float o_dot_d = dot3(ox, oy, oz, dx, dy, dz);
  const float o_sq = dot3(ox, oy, oz, ox, oy, oz);
  const float inv_a = 1.0f / a;
  best_t = kBig;
  best = 0;
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
}

// The rest of a bounce once the sweeps have found the nearest hit at
// best_t (kBig: a miss) on sphere row `best` or, when tri_wins, triangle
// row tri_idx at barycentrics (tri_u, tri_v): the winner's record,
// Lambert / GGX-metal / dielectric scatter with the uniforms of hash base
// `bbase`, the gradient sky `sky` (bottom rgb, top rgb) or none, the fold,
// AOV capture and events at path depth `depth`, and the advance.  Returns
// the winner's tape code, -1 on a miss.
template <bool kTris>
__device__ __forceinline__ int shade(Path& p, float best_t, int best,
                                     bool tri_wins, int tri_idx, float tri_u,
                                     float tri_v, const float* __restrict__ rec,
                                     bool has_dielectrics, bool sky_on,
                                     const float* sky, uint32_t bbase,
                                     int depth, const TriScene& tri) {
  const float dx = p.dx, dy = p.dy, dz = p.dz, ox = p.ox, oy = p.oy,
              oz = p.oz;
  const bool hit = best_t < kBig;

  if (!hit) {
    // gradient sky (SampleBatchJob.cs:352-354)
    float skr = 0.f, skg = 0.f, skb = 0.f;
    if (sky_on) {
      const float tsky = 0.5f * (dy + 1.0f);
      skr = fmaf(sky[3] - sky[0], tsky, sky[0]);
      skg = fmaf(sky[4] - sky[1], tsky, sky[1]);
      skb = fmaf(sky[5] - sky[2], tsky, sky[2]);
    }
    p.rx = fmaf(p.thx, skr, p.rx);
    p.ry = fmaf(p.thy, skg, p.ry);
    p.rz = fmaf(p.thz, skb, p.rz);
    if (!p.got) {
      p.anx = -dx;
      p.any = -dy;
      p.anz = -dz;
      p.aax = skr;
      p.aay = skg;
      p.aaz = skb;
      p.got = true;
    }
    p.active = false;
    p.valid = true;
    return -1;
  }

  const float px = fmaf(best_t, dx, ox);
  const float py = fmaf(best_t, dy, oy);
  const float pz = fmaf(best_t, dz, oz);
  const float* w;
  float nx, ny, nz;
  if (kTris && tri_wins) {
    w = tri.rec + (size_t)tri_idx * kTriRec;
    tri_normal(w + 12, w + 15, w + 18, tri_u, tri_v, nx, ny, nz);
    best = tri.code_base + tri_idx;
  } else {
    w = rec + (size_t)best * kRec;
    const float inv_r = __ldg(w + 15);
    nx = (px - __ldg(w + 12)) * inv_r;
    ny = (py - __ldg(w + 13)) * inv_r;
    nz = (pz - __ldg(w + 14)) * inv_r;
  }
  const float mtype = __ldg(w + 0);
  const float alb_r = __ldg(w + 1), alb_g = __ldg(w + 2),
              alb_b = __ldg(w + 3);
  const float em_r = __ldg(w + 4), em_g = __ldg(w + 5), em_b = __ldg(w + 6);
  const float gloss = __ldg(w + 7), metallic = __ldg(w + 8),
              parameter = __ldg(w + 9);
  float perfect = __ldg(w + 10);

  const float ua = uniform(bbase, 0), ub = uniform(bbase, 1);
  const float u_choice = uniform(bbase, 4);
  float sdx, sdy, sdz, srr, srg, srb, step_events;
  if (has_dielectrics && mtype > 0.5f) {
    // ---- dielectric (Material.cs:121-161) ------------------------------
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
    // ---- Standard: Lambert / GGX metal (Material.cs:75-119) ------------
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
    const bool take_spec = (refl_chance > 0.0f) && (u_choice < refl_chance);
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

  // ---- fold, AOVs, events, advance --------------------------------------
  p.rx = fmaf(p.thx, em_r, p.rx);
  p.ry = fmaf(p.thy, em_g, p.ry);
  p.rz = fmaf(p.thz, em_b, p.rz);
  p.thx = p.thx * srr;
  p.thy = p.thy * srg;
  p.thz = p.thz * srb;
  const bool first_nonspec = !p.got && perfect < 0.5f;
  if ((depth == 0 && !p.got) || first_nonspec) {
    p.anx = nx;
    p.any = ny;
    p.anz = nz;
  }
  if (first_nonspec) {
    p.aax = em_r + srr;
    p.aay = em_g + srg;
    p.aaz = em_b + srb;
    p.got = true;
  }
  p.events = p.events + step_events * exp2f(-(float)depth);
  const float off =
      kSelfEps * (dot3(sdx, sdy, sdz, nx, ny, nz) >= 0.0f ? 1.0f : -1.0f);
  p.ox = fmaf(off, nx, px);
  p.oy = fmaf(off, ny, py);
  p.oz = fmaf(off, nz, pz);
  p.dx = sdx;
  p.dy = sdy;
  p.dz = sdz;
  return best;
}

// Bounce the active path `p` once: `sphere_sweep`, with kTris the sweep
// over the triangles of `tri` (a block is skipped when the ray misses its
// AABB or meets it beyond the best hit so far, and with kStream so is a
// whole super-block; a triangle wins only with a strictly smaller t, the
// earlier row on a tie), then `shade`.  Returns the winner's tape code
// (sphere row, or tri.code_base + triangle row), -1 on a miss.
template <bool kTris = false, bool kStream = false>
__device__ __forceinline__ int bounce(
    Path& p, const float4* sph, int s, const float* __restrict__ rec,
    float t_min, bool has_dielectrics, bool sky_on, const float* sky,
    uint32_t bbase, int depth, const TriScene& tri = TriScene{}) {
  const float dx = p.dx, dy = p.dy, dz = p.dz, ox = p.ox, oy = p.oy,
              oz = p.oz;
  float best_t;
  int best;
  sphere_sweep(p, sph, s, t_min, best_t, best);
  // ---- triangle sweep (kTris) -------------------------------------------
  bool tri_wins = false;
  int tri_idx = 0;
  float tri_u = 0.f, tri_v = 0.f;
  if (kTris) {
    const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
    float tri_t = kBig;
    if (kStream) {
      // the JAX kernel's two-level cull, per lane: one slab test for
      // kTriSup blocks, then the blocks of a super the ray may hit
      for (int sup = 0; sup < tri.supers; ++sup) {
        if (!slab_may(tri.sup + 2 * sup, ox, oy, oz, ivx, ivy, ivz, t_min,
                      fminf(tri_t, best_t)))
          continue;
        for (int blk = sup * kTriSup; blk < (sup + 1) * kTriSup; ++blk)
          tri_block(tri, blk, ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, t_min,
                    best_t, tri_t, tri_idx, tri_u, tri_v);
      }
    } else {
      // the same sweep written out, as the kTris build has compiled since
      // it was written (tri_block generates one more register here)
      for (int blk = 0; blk < tri.blocks; ++blk) {
        const float4 lo = __ldg(tri.aabb + 2 * blk);
        const float4 hi = __ldg(tri.aabb + 2 * blk + 1);
        const float bx0 = (lo.x - ox) * ivx, bx1 = (hi.x - ox) * ivx;
        const float by0 = (lo.y - oy) * ivy, by1 = (hi.y - oy) * ivy;
        const float bz0 = (lo.z - oz) * ivz, bz1 = (hi.z - oz) * ivz;
        const float b_near = fmaxf(fminf(bx0, bx1),
                                   fmaxf(fminf(by0, by1), fminf(bz0, bz1)));
        const float b_far = fminf(fmaxf(bx0, bx1),
                                  fminf(fmaxf(by0, by1), fmaxf(bz0, bz1)));
        if (!(b_far >= fmaxf(b_near, t_min) &&
              b_near < fminf(tri_t, best_t)))
          continue;
        const int end = min((blk + 1) * kTriBlock, tri.rows);
        for (int k = blk * kTriBlock; k < end; ++k) {
          const float4 g0 = __ldg(tri.geo + 3 * k);
          const float4 g1 = __ldg(tri.geo + 3 * k + 1);
          const float4 g2 = __ldg(tri.geo + 3 * k + 2);
          float u, v;
          const float t =
              moller_trumbore(ox, oy, oz, dx, dy, dz, g0.x, g0.y, g0.z, g0.w,
                              g1.x, g1.y, g1.z, g1.w, g2.x, t_min, u, v);
          if (t < tri_t) {  // strict: the first row wins a tie
            tri_t = t;
            tri_idx = k;
            tri_u = u;
            tri_v = v;
          }
        }
      }
    }
    tri_wins = tri_t < best_t;
    if (tri_wins) best_t = tri_t;
  }
  return shade<kTris>(p, best_t, best, tri_wins, tri_idx, tri_u, tri_v, rec,
                      has_dielectrics, sky_on, sky, bbase, depth, tri);
}

}  // namespace rtiw
