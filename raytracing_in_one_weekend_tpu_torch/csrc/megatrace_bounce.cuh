// One path-tracing bounce of one lane: the code the batch kernel
// (megatrace_batch.cu), the per-ray megatrace (megatrace_wave.cu) and the
// bounce-synchronous mesh sampler (meshtrace_sync.cu) share, as the JAX
// package's kernels share pallas_megatrace.py::_bounce_step.  The kernels
// of streamed tables (the sampler's bounce, the batch kernel's streamed
// build) run group_sweep.cuh's cooperative triangle sweep between
// `sphere_sweep` and `shade`; the batch kernel's sphere build runs its own
// sweep, with sphere_sweep's winner, before `shade`; the others call
// `bounce`, which runs all three.  The triangle arm is a compile-time flag: the batch kernel's mesh
// build takes it, the sphere-only builds compile none of it; so are the
// rect and box arm (kAux), the convex volume walk (kVol), unit-shutter
// motion (kMotion) and albedo textures (kTex) of the batch kernel's sphere
// builds.  Plain version:
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

// A scene's rects and boxes (the batch kernel's aux build): their kernel
// rows (aux_frame's 12 floats, three float4 a row: rects in rows
// [0, rect_rows), boxes after them) staged in shared memory, and their
// records in device memory (AUX_KERNEL_REC = 16 columns: material 0-10 |
// id 11 | a rect's world normal 12-14), box b at row rect_rows + b.  The
// sweep visits rects [0, rects) and boxes [0, boxes): the rows that can
// hit (trailing pad rows never do).  A rect's tape code is rect_code plus
// its row, a box's box_code plus its row (the JAX kernel's combined row
// space: after the padded spheres, the boxes after the padded rects).
struct AuxScene {
  const float4* geo = nullptr;
  const float* rec = nullptr;
  int rects = 0, boxes = 0, rect_rows = 0, rect_code = 0, box_code = 0;
};

// Row k of the staged aux table as aux_frame's 12 floats.
__device__ __forceinline__ void aux_row(const AuxScene& aux, int k,
                                        float* g) {
  const float4 a = aux.geo[3 * k], b = aux.geo[3 * k + 1],
               c = aux.geo[3 * k + 2];
  g[0] = a.x, g[1] = a.y, g[2] = a.z, g[3] = a.w;
  g[4] = b.x, g[5] = b.y, g[6] = b.z, g[7] = b.w;
  g[8] = c.x, g[9] = c.y, g[10] = c.z, g[11] = c.w;
}

constexpr int kTexCols = 16;  // texture record columns: 0 TextureType |
                              // 1-3 main | 4-6 secondary | 7 parameter |
                              // 8 atlas row base (image index * H)

// A scene's albedo textures (the batch kernel's texture builds): a record
// per material in device memory, read through the read-only cache; with a
// Perlin texture its permutations and gradient vectors staged in shared
// memory (`perm`: perm_x, perm_y, perm_z, 256 each; `vec`: 256 unit
// vectors x y z 0), else null; with an image atlas its texels, (A * H) x W
// x 3 floats in device memory, else null.
struct TexScene {
  const float* rec = nullptr;
  const int* perm = nullptr;
  const float4* vec = nullptr;
  const float* atlas = nullptr;
  int img_w = 0, img_h = 0;
};

// Surflet falloff 1 - (3 - 2|t|) t^2, 0 from |t| = 1 on (PerlinNoise.cs:
// 24-28; ops/megatrace.py::_falloff).
__device__ __forceinline__ float perlin_falloff(float t) {
  t = fabsf(t);
  return t >= 1.0f ? 0.0f : fmaf(-((3.0f - 2.0f * t) * t), t, 1.0f);
}

// Surflet gradient noise at p, clipped to [0, 1] (PerlinNoise.cs:36-52;
// ops/megatrace.py::perlin_rows).
__device__ __forceinline__ float perlin_noise(const TexScene& T, float px,
                                              float py, float pz) {
  const float p[3] = {px, py, pz};
  int pv[3][2];
  float fr[3][2], fa[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float cf = floorf(p[a]);
    const int ci = (int)cf;
    pv[a][0] = T.perm[a * 256 + (ci & 255)];
    pv[a][1] = T.perm[a * 256 + ((ci + 1) & 255)];
    fr[a][0] = p[a] - cf;
    fr[a][1] = fr[a][0] - 1.0f;
    fa[a][0] = perlin_falloff(fr[a][0]);
    fa[a][1] = perlin_falloff(fr[a][1]);
  }
  float result = 0.0f;
#pragma unroll
  for (int dk = 0; dk < 2; ++dk)
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        const float4 g = T.vec[pv[0][di] ^ pv[1][dj] ^ pv[2][dk]];
        const float dot =
            dot3(fr[0][di], fr[1][dj], fr[2][dk], g.x, g.y, g.z);
        result = fmaf(fa[0][di] * fa[1][dj] * fa[2][dk], dot, result);
      }
  return fminf(fmaxf(result, 0.0f), 1.0f);
}

// 7-octave fBm of perlin_noise, clipped to [0, 1] (PerlinNoise.cs:54-68),
// kept out of line so that the builds' other code keeps its registers.
__device__ __noinline__ float perlin_turbulence(const TexScene& T, float px,
                                                float py, float pz) {
  float acc = 0.0f, weight = 1.0f;
  for (int k = 0; k < 7; ++k) {
    acc = acc + weight * perlin_noise(T, px, py, pz);
    weight *= 0.5f;
    px = px * 2.0f;
    py = py * 2.0f;
    pz = pz * 2.0f;
  }
  return fminf(fmaxf(acc, 0.0f), 1.0f);
}

// The albedo (ar, ag, ab) of a winner of material `mat_id` after its
// texture (the JAX kernel's _bounce_textures, :2207-2295;
// ops/megatrace.py::bounce_textures): a checker by the dominant normal
// axis's projection, the Perlin marble, or the nearest atlas texel at the
// sphere uv (`sphere`: a sphere winner; rects and boxes read uv 0); other
// types keep the packed albedo.
__device__ __forceinline__ void tex_albedo(const TexScene& T, float mat_id,
                                           float nx, float ny, float nz,
                                           float px, float py, float pz,
                                           bool sphere, float& ar, float& ag,
                                           float& ab) {
  const float* tx = T.rec + (size_t)(int)mat_id * kTexCols;
  const float ttype = __ldg(tx);
  if (ttype > 1.5f && ttype < 2.5f) {
    // checker (textures._checker_uv: the dominant normal axis)
    const float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);
    const bool use_x = ax > ay && ax > az;
    const bool use_y = !use_x && ay > ax && ay > az;
    const float v0 = use_x ? nx : use_y ? ny : nz;
    const float v1 = use_x ? ny : use_y ? nz : nx;
    const float v2 = use_x ? nz : use_y ? nx : ny;
    const float safe0 = v0 == 0.0f ? 1.0f : v0;
    const float cu = fmaf(0.5f, v1 / safe0, 0.5f);
    const float cv = fmaf(0.5f, v2 / safe0, 0.5f);
    const float pif = kPiF * __ldg(tx + 7);
    const int k = sin_cr(pif * cu) * sin_cr(pif * cv) < 0.0f ? 1 : 4;
    ar = __ldg(tx + k);
    ag = __ldg(tx + k + 1);
    ab = __ldg(tx + k + 2);
  } else if (ttype > 2.5f && ttype < 3.5f && T.vec != nullptr) {
    // marble 0.5 (1 + sin(f z + 10 turbulence(p))) main
    const float turb = perlin_turbulence(T, px, py, pz);
    const float marble =
        0.5f * (1.0f + sin_cr(fmaf(__ldg(tx + 7), pz, 10.0f * turb)));
    ar = marble * __ldg(tx + 1);
    ag = marble * __ldg(tx + 2);
    ab = marble * __ldg(tx + 3);
  } else if (ttype > 3.5f && ttype < 4.5f && T.atlas != nullptr) {
    // the nearest texel at the sphere uv (Texture.cs:82-90)
    float u = 0.0f, v = 0.0f;
    if (sphere) {
      u = (atan2_cr(-nz, nx) + kPiF) * kHalfInvPiF;
      v = acos_cr(fminf(fmaxf(-ny, -1.0f), 1.0f)) * kInvPiF;
    }
    const int cx = min(max((int)(u * (float)T.img_w), 0), T.img_w - 1);
    const int cy = min(max((int)(v * (float)T.img_h), 0), T.img_h - 1);
    const float* texel =
        T.atlas + ((size_t)((int)__ldg(tx + 8) + cy) * T.img_w + cx) * 3;
    ar = __ldg(texel) * __ldg(tx + 1);
    ag = __ldg(texel + 1) * __ldg(tx + 2);
    ab = __ldg(texel + 2) * __ldg(tx + 3);
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

// The medium a path is in (the batch kernel's volume builds): the volume's
// material id (-1: none), its density, albedo rgb and emission rgb, in
// camera_containment_row's order (ops/megatrace.py VOL_KEYS).
struct Medium {
  float v[8];
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

// The rect and box sweep after the spheres' (the aux build): each rect,
// then each box, wins only with a strictly smaller t than the best so far,
// so the first row wins a tie and a box beats a rect only when nearer (the
// JAX kernel's order).  aux_kind: 0 the spheres' winner stands, 1 rect
// aux_idx, 2 box aux_idx.
__device__ __forceinline__ void aux_sweep(const Path& p, const AuxScene& aux,
                                          float t_min, float& best_t,
                                          int& aux_kind, int& aux_idx) {
  const float o[3] = {p.ox, p.oy, p.oz}, d[3] = {p.dx, p.dy, p.dz};
  aux_kind = 0;
  aux_idx = 0;
  float g[12];
  for (int k = 0; k < aux.rects; ++k) {
    aux_row(aux, k, g);
    const float t = rect_test(o, d, g, t_min);
    if (t < best_t) {
      best_t = t;
      aux_kind = 1;
      aux_idx = k;
    }
  }
  for (int k = 0; k < aux.boxes; ++k) {
    aux_row(aux, aux.rect_rows + k, g);
    const float t = box_test(o, d, g, t_min);
    if (t < best_t) {
      best_t = t;
      aux_kind = 2;
      aux_idx = k;
    }
  }
}

// The rest of a bounce once the sweeps have found the nearest hit at
// best_t (kBig: a miss) on sphere row `best` or, when tri_wins, triangle
// row tri_idx at barycentrics (tri_u, tri_v), or with kAux (the batch
// kernel's aux build; the other builds compile none of it) rect or box
// aux_idx of `aux` (aux_kind 1 or 2): the winner's record, with kVol (the
// volume builds) the convex volume walk in the medium `med` (t_exit: the
// winner's exit distance), Lambert / GGX-metal / dielectric or isotropic
// scatter with the uniforms of hash base `bbase`, the gradient sky `sky`
// (bottom rgb, top rgb) or none, the fold, AOV capture and events at path
// depth `depth`, and the advance.  Returns the winner's tape code, -1 on a
// miss.  With kMotion (the motion builds) a sphere winner's centre is
// taken at the path's shutter time `ptime`: fmaf(move[best], ptime,
// centre), its move offset a row of `move` (x, y, z, 0).  With kTex (the
// texture builds) the winner's albedo is textured (tex_albedo).
template <bool kTris, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false>
__device__ __forceinline__ int shade(Path& p, float best_t, int best,
                                     bool tri_wins, int tri_idx, float tri_u,
                                     float tri_v, const float* __restrict__ rec,
                                     bool has_dielectrics, bool sky_on,
                                     const float* sky, uint32_t bbase,
                                     int depth, const TriScene& tri,
                                     const AuxScene* aux = nullptr,
                                     int aux_kind = 0, int aux_idx = 0,
                                     Medium* med = nullptr,
                                     float t_exit = kBig,
                                     const float4* move = nullptr,
                                     float ptime = 0.f,
                                     const TexScene* tex = nullptr) {
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

  float px = fmaf(best_t, dx, ox);
  float py = fmaf(best_t, dy, oy);
  float pz = fmaf(best_t, dz, oz);
  const float* w;
  float nx, ny, nz;
  if constexpr (kAux) {
    if (aux_kind == 1) {
      w = aux->rec + (size_t)aux_idx * kRec;
      nx = __ldg(w + 12);  // a rect's normal is constant: the packed one
      ny = __ldg(w + 13);
      nz = __ldg(w + 14);
      best = aux->rect_code + aux_idx;
    } else if (aux_kind == 2) {
      const int row = aux->rect_rows + aux_idx;
      w = aux->rec + (size_t)row * kRec;
      float g[12], ln[3], n[3];
      aux_row(*aux, row, g);
      const float pt[3] = {px, py, pz};
      box_normal(pt, g, ln, n);
      nx = n[0];
      ny = n[1];
      nz = n[2];
      best = aux->box_code + aux_idx;
    } else {
      w = rec + (size_t)best * kRec;
      const float inv_r = __ldg(w + 15);
      if constexpr (kMotion) {
        const float4 m = move[best];
        nx = (px - fmaf(m.x, ptime, __ldg(w + 12))) * inv_r;
        ny = (py - fmaf(m.y, ptime, __ldg(w + 13))) * inv_r;
        nz = (pz - fmaf(m.z, ptime, __ldg(w + 14))) * inv_r;
      } else {
        nx = (px - __ldg(w + 12)) * inv_r;
        ny = (py - __ldg(w + 13)) * inv_r;
        nz = (pz - __ldg(w + 14)) * inv_r;
      }
    }
  } else {
    if (kTris && tri_wins) {
      w = tri.rec + (size_t)tri_idx * kTriRec;
      tri_normal(w + 12, w + 15, w + 18, tri_u, tri_v, nx, ny, nz);
      best = tri.code_base + tri_idx;
    } else {
      w = rec + (size_t)best * kRec;
      const float inv_r = __ldg(w + 15);
      if constexpr (kMotion) {
        const float4 m = move[best];
        nx = (px - fmaf(m.x, ptime, __ldg(w + 12))) * inv_r;
        ny = (py - fmaf(m.y, ptime, __ldg(w + 13))) * inv_r;
        nz = (pz - fmaf(m.z, ptime, __ldg(w + 14))) * inv_r;
      } else {
        nx = (px - __ldg(w + 12)) * inv_r;
        ny = (py - __ldg(w + 13)) * inv_r;
        nz = (pz - __ldg(w + 14)) * inv_r;
      }
    }
  }
  const float mtype = __ldg(w + 0);
  float alb_r = __ldg(w + 1), alb_g = __ldg(w + 2), alb_b = __ldg(w + 3);
  if constexpr (kTex) {
    bool sphere = true;
    if constexpr (kAux) sphere = aux_kind == 0;
    tex_albedo(*tex, __ldg(w + 11), nx, ny, nz, px, py, pz, sphere, alb_r,
               alb_g, alb_b);
  }
  float em_r = __ldg(w + 4), em_g = __ldg(w + 5), em_b = __ldg(w + 6);
  const float gloss = __ldg(w + 7), metallic = __ldg(w + 8),
              parameter = __ldg(w + 9);
  float perfect = __ldg(w + 10);

  // ---- probabilistic volume walk (kVol; SampleBatchJob.cs:212-303) -------
  // Inside a medium the segment up to the hit, at a volume's entry the
  // segment to its exit, ends in a Beer-Lambert scatter when the free path
  // is shorter; an entry without one passes the volume and an exit from
  // the own medium leaves it: both advance past the boundary, no scatter.
  [[maybe_unused]] bool vol_candidate = false, vol_scatter = false;
  [[maybe_unused]] float vm[8];
  if constexpr (kVol) {
    const bool in_vol = med->v[0] >= 0.0f;
    const float own[8] = {__ldg(w + 11), parameter, alb_r, alb_g,
                          alb_b, em_r, em_g, em_b};
#pragma unroll
    for (int k = 0; k < 8; ++k) vm[k] = in_vol ? med->v[k] : own[k];
    const bool hit_is_vol = mtype > 1.5f;  // PROBABILISTIC_VOLUME == 2
    const bool entering = dot3(dx, dy, dz, nx, ny, nz) < 0.0f;
    // free path d = -ln(u) / density (Material.cs:49-65)
    const float free_path = -log_cr(fmaxf(uniform(bbase, 6), 1e-12f)) /
                            fmaxf(vm[1], 1e-12f);
    const float seg_len = in_vol ? best_t : t_exit - best_t;
    vol_candidate = in_vol || (hit_is_vol && entering);
    vol_scatter = vol_candidate && free_path < seg_len;
    const bool pass_through =
        !in_vol && hit_is_vol && entering && !vol_scatter;
    const bool exits_own = in_vol && hit_is_vol && !entering &&
                           !vol_scatter && fabsf(own[0] - med->v[0]) < 0.5f;
    if (pass_through || exits_own) {
      const float step = (pass_through ? t_exit : best_t) + kSelfEps;
      p.ox = fmaf(step, dx, ox);
      p.oy = fmaf(step, dy, oy);
      p.oz = fmaf(step, dz, oz);
      // a probabilistic hit costs one event (SampleBatchJob.cs:332)
      p.events = p.events + 1.0f * exp2f(-(float)depth);
      med->v[0] = -1.0f;
      return best;
    }
    if (vol_scatter) {  // the in-medium scatter replaces the surface hit
      const float vol_t = in_vol ? free_path : best_t + free_path;
      px = fmaf(vol_t, dx, ox);
      py = fmaf(vol_t, dy, oy);
      pz = fmaf(vol_t, dz, oz);
      nx = -dx;
      ny = -dy;
      nz = -dz;
      em_r = vm[5];
      em_g = vm[6];
      em_b = vm[7];
    }
  }

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
  if constexpr (kVol) {
    if (vol_scatter) {
      // isotropic in-medium scatter (Material.cs:163-168): the medium's
      // albedo, 2 random events; the AOV capture's perfect flag is the
      // dielectric branch's (the JAX kernel's order)
      const float z = uniform(bbase, 2) * 2.0f - 1.0f;
      const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
      const float th = uniform(bbase, 3) * kTwoPi;
      sdx = cos_cr(th) * r;
      sdy = sin_cr(th) * r;
      sdz = z;
      srr = vm[2];
      srg = vm[3];
      srb = vm[4];
      step_events = 2.0f;
      perfect = (has_dielectrics && mtype > 0.5f) ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) med->v[k] = vm[k];  // enter the medium
    }
    if (vol_candidate) step_events = step_events + 1.0f;
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
// AABB or meets it beyond the best hit so far; a triangle wins only with a
// strictly smaller t, the earlier row on a tie), then `shade`.  Returns
// the winner's tape code (sphere row, or tri.code_base + triangle row), -1
// on a miss.
template <bool kTris = false>
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
    tri_wins = tri_t < best_t;
    if (tri_wins) best_t = tri_t;
  }
  return shade<kTris>(p, best_t, best, tri_wins, tri_idx, tri_u, tri_v, rec,
                      has_dielectrics, sky_on, sky, bbase, depth, tri);
}

}  // namespace rtiw
