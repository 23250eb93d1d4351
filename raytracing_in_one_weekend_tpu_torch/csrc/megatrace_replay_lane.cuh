// One lane of the tape replay (ops/megatrace_replay.replay_iteration) and
// its adjoint, derived by hand.  Used by the backward kernel
// (megatrace_bwd.cu); the code is host-and-device (megatrace_common.cuh),
// so a host build can hold it against torch.autograd of the plain replay.
//
// State: the 21 floats of STATE_KEYS (ops/megatrace_replay.py), in order.
// Of those, active/valid/started/depth_ct are decisions and counters with
// no gradient; the other 17 carry cotangents.  Every branch the forward
// takes is a constant of the tape and of the hash PRNG, so the adjoint
// follows the one branch this lane took.  The NaN guards of the primal
// are kept in the adjoint: the 1e-8 floors of the sphere and refraction
// discriminants, the r == 0 and degenerate-Smith branches, the 1e-12 log
// floors and the dielectric ior floor; each passes a derivative exactly
// where the plain replay's torch.clamp/torch.where would (and the lottery
// clip halves it at a tie, as the plain replay and jnp.clip do).
//
// Mesh scenes take the kTris instantiation (the sphere-only one compiles
// none of it): the entity table is kTriEntCols wide, a triangle winner
// (kind 3) takes Möller–Trumbore and the barycentric normal lerp instead
// of the sphere quadratic, and its cotangent row is kTriGradCols wide.
// The adjoint keeps the primal's guards there too: det == 0 divides by 1
// and passes no derivative, and the normal's 1e-24 floor passes one only
// where torch.clamp does.
//
// Scenes with rects or boxes take the kAux instantiation (again none of it
// in the others): a rect winner (kind 1) takes the ray in its frame and
// its plane distance, a box winner (kind 2) the Majercik face distance,
// and its cotangent row is kAuxGradCols wide (quaternion, material,
// position, extents).  Their normals are constants of the hit point: a
// rect's the packed rotated +Z (entity columns 7-9), a box's the rotated
// dominant face; both pass a derivative to the quaternion only.  The
// guards: dl.z == 0 divides by 1 and a box axis with dl == 0 by 1e-30,
// each passing no derivative to dl, as the plain replay's torch.where.
//
// Scenes with convex volumes take the kVol instantiations, beside spheres
// or (with kAux) rects and boxes.  The state grows by the medium, 8 floats
// after kLp (kVolStateVars), reset at regen from the camera's row vol0
// (consts after the sky, kScalVol constants).  Each iteration recomputes
// the walk's decisions bit for bit from the uniforms and the winner (the
// exit distance, the correctly rounded log of the free path, scatter,
// pass-through, own exit); the free path is detached, so the density
// moves only through the score terms lp: log(rho) - rho d on a scatter,
// -rho L on a survived segment.  The adjoint (step_vjp_vol) follows the
// branch taken: an in-medium scatter sends its point's cotangent to the
// ray (and, entering, to the surface's t), its albedo's and emission's to
// the medium; a skip sends the advance's to the exit's or the surface's t;
// the medium's cotangents pass to the previous state, to the winner's
// material or, at regen, to vol0's row of the scalar cotangents.
//
// Scenes with moving spheres take the kMotion instantiation (spheres only:
// no rects, boxes, volumes or triangles beside them).  The state grows by
// the path's shutter time (kPTime, after kLp), drawn at regen from the
// camera draws' stream 7 as the forward kernel draws it; a sphere winner's
// centre is c(t) = fmaf(m, t, c), m its move offset (entity columns
// 23-25), and the quadratic's c term the forward kernel's motion order
// ((|o|^2 - 2 o.c(t)) + |c(t)|^2) + (-r^2).  The adjoint is the static
// sphere's at c(t), and the move offset's cotangent the centre's times t
// (cotangent columns 13-15).
//
// Sphere scenes with checker or image albedos take the kTex instantiation
// (no Perlin marble, which the replay does not mirror; spheres only).  The
// entity rows carry the material's texture record after the 23 columns
// (kTexCols), and the environment the image atlas (LaneEnvTex).  The
// forward textures the winner's albedo as the forward kernel does
// (tex_forward); the adjoint sends the albedo's cotangent to the record's
// main or secondary colour (a checker; cotangent columns 13-15, 16-18) or,
// for an image, the texel times it to the main colour and the main colour
// times it to the fetched texel, whose index and cotangent ride four more
// floats after the row (kTexelSlots), summed into the texel plane by the
// caller.
#pragma once

#include <type_traits>

#include "megatrace_common.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

namespace rtiw {

constexpr int kStateVars = 21;
enum StateIdx {
  kOX = 0, kOY, kOZ, kDX, kDY, kDZ, kTHX, kTHY, kTHZ, kRX, kRY, kRZ,
  kActive, kValid, kStarted, kDepth, kCSX, kCSY, kCSZ, kCnt, kLp,
  // the volume builds' medium (megatrace_replay.VOL_STATE_KEYS): material
  // id (-1: none), density, albedo rgb, emission rgb
  kInId
};
constexpr int kVolStateVars = kStateVars + 8;
constexpr int kPTime = kStateVars;  // the motion build's shutter time
constexpr int kMotionStateVars = kStateVars + 1;
constexpr int kEntCols = 23;  // build_entity_rows layout, sphere scenes
constexpr int kTriEntCols = 38;  // ... mesh scenes (23-31 vertex normals)
constexpr int kGradCols = 13;  // entity columns 0-3 and 11-19
// mesh scenes: those, then columns 4-9 (a triangle's edge_b, vert0) and
// 23-31 (its vertex normals); columns 0-2 hold a triangle's edge_a
// (megatrace_replay.TRI_GRAD_COLS)
constexpr int kTriGradCols = 28;
// scenes with rects or boxes: kGradCols, then columns 4-9 (a position, a
// box's extents); columns 0-3 hold a quaternion
// (megatrace_replay.AUX_GRAD_COLS)
constexpr int kAuxGradCols = 19;
// moving spheres: entity columns 23-25 hold the move offsets; their
// cotangents follow kGradCols' (megatrace_replay.MOVE_COLS)
constexpr int kMotionEntCols = kEntCols + 3;
constexpr int kMotionGradCols = kGradCols + 3;
// checker and image albedos: entity columns 23-38 hold the texture record
// (TEX_COLS); the cotangents of its main and secondary colours follow
// kGradCols' (megatrace_replay.TEX_GRAD), then the fetched texel's index
// (-1: none) and its three cotangents
constexpr int kTexRecCols = 16;
constexpr int kTexEntCols = kEntCols + kTexRecCols;
constexpr int kTexGradCols = kGradCols + 6;
constexpr int kTexelSlots = 4;
// camera row 0-23 (origin, lower-left, horizontal, vertical, right, up,
// lens radius, width, height, pad) | sky bottom 24-26 | sky top 27-29
constexpr int kScal = 30;
// ... and in the volume builds | the camera's medium (vol0) 30-37
constexpr int kScalVol = kScal + 8;
enum CamIdx {
  kCO = 0, kLL = 3, kHH = 6, kVV = 9, kRR = 12, kUU = 15, kLens = 18,
  kWidth = 19, kHeight = 20, kSkyB = 24, kSkyT = 27, kVol0 = 30
};
// gradient columns: 0-2 center, 3 radius, 4-6 albedo, 7-9 emission,
// 10 gloss, 11 metallic, 12 parameter
enum GradIdx { kGC = 0, kGR = 3, kGAlb = 4, kGEm = 7, kGGloss = 10,
               kGMetal = 11, kGParam = 12, kGEb = 13, kGV0 = 16,
               kGNrm = 19, kGPos = 13, kGExt = 16, kGMove = 13, kGTex = 13 };

template <bool kTris, bool kAux = false, bool kMotion = false,
          bool kTex = false>
struct Layout {
  static constexpr int ent = kTris      ? kTriEntCols
                             : kMotion ? kMotionEntCols
                             : kTex    ? kTexEntCols
                                       : kEntCols;
  static constexpr int grad = kTris      ? kTriGradCols
                              : kAux    ? kAuxGradCols
                              : kMotion ? kMotionGradCols
                              : kTex    ? kTexGradCols
                                        : kGradCols;
  // the cotangent row's floats: its columns, and in the texture build the
  // texel's index and cotangent
  static constexpr int row = grad + (kTex ? kTexelSlots : 0);
};

struct LaneEnv {
  const float* cam;  // kScal constants
  const float* ent;  // (rows, kEntCols) entity table
  float per_pixel, px_row, py_row;
  uint32_t key;  // seed + global lane * 9781
  float trace_depth, t_min;
  bool has_diel, sky_on, jitter;
};

// ... of the texture build: the image atlas ((A * img_h) x img_w x 3
// floats) or null.
struct LaneEnvTex : LaneEnv {
  const float* atlas;
  int img_w, img_h;
};

RTIW_FN LaneEnv make_lane_env(const float* cam, const float* ent, int i,
                              float per_pixel, int seed, int lane_base,
                              int trace_depth, float t_min, int has_diel,
                              int sky_on, int jitter) {
  LaneEnv e;
  e.cam = cam;
  e.ent = ent;
  e.per_pixel = per_pixel;
  const float pixel = (float)i;
  e.py_row = floorf(pixel / cam[kWidth]);
  e.px_row = pixel - e.py_row * cam[kWidth];
  // global lane id through float32, as the forward kernel keys its PRNG
  const uint32_t lane = (uint32_t)(int)((float)i + (float)lane_base);
  e.key = (uint32_t)seed + lane * 9781u;
  e.trace_depth = (float)trace_depth;
  e.t_min = t_min;
  e.has_diel = has_diel != 0;
  e.sky_on = sky_on != 0;
  e.jitter = jitter != 0;
  return e;
}

// Forward values of one iteration that the adjoint reads.
struct Iter {
  bool regen, was_active, hit, near_root, rough, is_diel, take_spec,
      take_metal, spec_like, exiting, can_refract, do_refract, ok;
  // camera (regen lanes)
  float un, vn, sr3, cth, sth, rdx, rdy, off[3], q3[3];
  // state after regen
  float o[3], d[3], th[3], rad[3], lp, valid, depth;
  // winner (hit lanes)
  int w;
  bool tri;  // a triangle (kTris builds only)
  float c[3], r, alb[3], em[3], gloss, metal, param;
  float a, b, cc, disc, sq, inv_a, t, p[3], inv_r, n[3];
  // triangle winner: Möller–Trumbore's terms and the normal lerp
  float eb[3], v0[3], nrm[9], pv[3], tv[3], qv[3], det, inv_det, mu, mv, mt,
      bu, bv, tn[3];
  float ua, ub, uc, ud;
  // Standard scatter
  float roughness, cs[3], q[3], rn[3], spec_dot, std_ior, fresnel, cos_dn,
      masking, x, rc;
  // dielectric
  float ss[3], q2[3], dr[3], ddot, on[3], ior, ni, cosine, dt, m, disc_r,
      sq_r, wv[3], rp;
  // scatter result, sky and fold
  float sd[3], sr[3], lp_inc, off_n, tsky, em2[3], rad_new[3];
};

// ... and of a rect or box winner (the kAux build).
struct IterAux : Iter {
  int kind;  // 0 sphere, 1 rect, 2 box
  int face;  // a box's face axis
  float ol[3], dl[3], sdiv, wsg, dp, ln[3];
};

// ... and of the volume walk (the kVol builds).
template <class Base>
struct IterVol : Base {
  float med[8];  // the medium after regen
  float vm[8];  // the walk's: the medium inside one, else the winner's
  float pe[3], ne[3];  // an in-medium scatter's point and normal
  float t_exit, free_path, seg_len, vol_t, skip_t, rho, d_obs, l_obs;
  bool in_vol, vol_candidate, vol_scatter, pass_through, skip, survive;
  float xbo[3], xdl[3], xinv[3];  // a box winner's slab exit (box_exit)
  int xaxis;
  bool xhi;
};

// ... and of a moving sphere (the kMotion build): the path's shutter time
// and the winner's move offset.
struct IterMotion : Iter {
  float ptime, m[3];
};

// ... and of a textured winner (the kTex build): which colour the albedo
// took (0 the packed one, 1 the checker's main, 2 its secondary, 3 an
// image texel times main), the texel's index and value and the main colour.
struct IterTex : Iter {
  int tex_kind, texel;
  float texv[3], tmain[3];
};

template <bool kAux, bool kVol = false, bool kMotion = false,
          bool kTex = false>
using IterOf = typename std::conditional<
    kTex, IterTex,
    typename std::conditional<
        kMotion, IterMotion,
        typename std::conditional<
            kVol,
            IterVol<typename std::conditional<kAux, IterAux, Iter>::type>,
            typename std::conditional<kAux, IterAux, Iter>::type>::type>::
        type>::type;

RTIW_FN void norm3(const float* x, float* y) {
  const float inv = rsqrt_cr(fmaxf(dot3(x[0], x[1], x[2], x[0], x[1], x[2]),
                                   1e-12f));
  y[0] = x[0] * inv;
  y[1] = x[1] * inv;
  y[2] = x[2] * inv;
}

RTIW_FN float dotv(const float* a, const float* b) {
  return dot3(a[0], a[1], a[2], b[0], b[1], b[2]);
}

RTIW_FN float log_floor(float x) { return logf(fmaxf(x, 1e-12f)); }

// The sweep's quadratic at a sphere winner (centre c, radius r): the hit
// distance, point and outward normal.
RTIW_FN void sphere_hit(Iter& I, float t_min) {
  const float* o = I.o;
  const float* d = I.d;
  const float* c = I.c;
  I.a = dotv(d, d);
  I.b = dotv(o, d) - dotv(d, c);
  const float cmr2 = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2] - I.r * I.r;
  I.cc = (dotv(o, o) - 2.0f * dotv(o, c)) + cmr2;
  I.disc = fmaf(I.b, I.b, -(I.a * I.cc));
  I.sq = sqrtf(fmaxf(I.disc, 1e-8f));
  I.inv_a = 1.0f / I.a;
  const float t_near = (-I.b - I.sq) * I.inv_a;
  const float t_far = (-I.b + I.sq) * I.inv_a;
  I.near_root = t_near > t_min;
  I.t = I.near_root ? t_near : t_far;
  I.inv_r = 1.0f / (I.r != 0.0f ? I.r : 1.0f);
  for (int k = 0; k < 3; ++k) {
    I.p[k] = fmaf(I.t, d[k], o[k]);
    I.n[k] = (I.p[k] - c[k]) * I.inv_r;
  }
}

// sphere_hit of a moving sphere (the kMotion build; c holds the centre at
// the path's time): the forward kernel's motion quadratic.
RTIW_FN void sphere_hit_moving(Iter& I, float t_min) {
  const float* o = I.o;
  const float* d = I.d;
  const float* c = I.c;
  I.a = dotv(d, d);
  I.b = dotv(o, d) - dotv(d, c);
  I.cc = ((dotv(o, o) - 2.0f * dotv(o, c)) + dotv(c, c)) + -(I.r * I.r);
  I.disc = fmaf(I.b, I.b, -(I.a * I.cc));
  I.sq = sqrtf(fmaxf(I.disc, 1e-8f));
  I.inv_a = 1.0f / I.a;
  const float t_near = (-I.b - I.sq) * I.inv_a;
  const float t_far = (-I.b + I.sq) * I.inv_a;
  I.near_root = t_near > t_min;
  I.t = I.near_root ? t_near : t_far;
  I.inv_r = 1.0f / (I.r != 0.0f ? I.r : 1.0f);
  for (int k = 0; k < 3; ++k) {
    I.p[k] = fmaf(I.t, d[k], o[k]);
    I.n[k] = (I.p[k] - c[k]) * I.inv_r;
  }
}

// The winner's albedo after its texture record `tx` (the texture build;
// ops/megatrace.py::bounce_textures, the forward kernel's tex_albedo): a
// checker by the dominant normal axis's projection, or the nearest atlas
// texel at the sphere uv times the main colour; other types (the Perlin
// marble is not replayed) keep the packed albedo.
RTIW_FN void tex_forward(IterTex& I, const LaneEnvTex& E, const float* tx) {
  I.tex_kind = 0;
  I.texel = -1;
  const float ttype = tx[0];
  const float* n = I.n;
  if (ttype > 1.5f && ttype < 2.5f) {
    const float ax = fabsf(n[0]), ay = fabsf(n[1]), az = fabsf(n[2]);
    const bool use_x = ax > ay && ax > az;
    const bool use_y = !use_x && ay > ax && ay > az;
    const float v0 = use_x ? n[0] : use_y ? n[1] : n[2];
    const float v1 = use_x ? n[1] : use_y ? n[2] : n[0];
    const float v2 = use_x ? n[2] : use_y ? n[0] : n[1];
    const float safe0 = v0 == 0.0f ? 1.0f : v0;
    const float cu = fmaf(0.5f, v1 / safe0, 0.5f);
    const float cv = fmaf(0.5f, v2 / safe0, 0.5f);
    const float pif = kPiF * tx[7];
    I.tex_kind = sin_cr(pif * cu) * sin_cr(pif * cv) < 0.0f ? 1 : 2;
    const int k0 = I.tex_kind == 1 ? 1 : 4;
    for (int k = 0; k < 3; ++k) I.alb[k] = tx[k0 + k];
  } else if (ttype > 3.5f && ttype < 4.5f && E.atlas != nullptr) {
    const float u = (atan2_cr(-n[2], n[0]) + kPiF) * kHalfInvPiF;
    const float v = acos_cr(fminf(fmaxf(-n[1], -1.0f), 1.0f)) * kInvPiF;
    int cx = (int)(u * (float)E.img_w), cy = (int)(v * (float)E.img_h);
    cx = cx < 0 ? 0 : cx > E.img_w - 1 ? E.img_w - 1 : cx;
    cy = cy < 0 ? 0 : cy > E.img_h - 1 ? E.img_h - 1 : cy;
    I.tex_kind = 3;
    I.texel = ((int)tx[8] + cy) * E.img_w + cx;
    for (int k = 0; k < 3; ++k) {
      I.texv[k] = E.atlas[(size_t)I.texel * 3 + k];
      I.tmain[k] = tx[1 + k];
      I.alb[k] = I.texv[k] * I.tmain[k];
    }
  }
}

// Möller–Trumbore of the lane's ray at a triangle winner (c holds its
// edge_a) and the barycentric normal lerp, in the forward kernel's
// expressions (megatrace_common.cuh::moller_trumbore, tri_normal): the hit
// distance, point and unit normal.  The tape guarantees det != 0; it still
// divides by 1 where det == 0, as the plain replay does.
RTIW_FN void tri_hit(Iter& I) {
  const float* o = I.o;
  const float* d = I.d;
  const float* ea = I.c;
  const float* eb = I.eb;
  I.pv[0] = fmaf(d[1], ea[2], -(d[2] * ea[1]));
  I.pv[1] = fmaf(d[2], ea[0], -(d[0] * ea[2]));
  I.pv[2] = fmaf(d[0], ea[1], -(d[1] * ea[0]));
  I.det = dotv(eb, I.pv);
  I.inv_det = 1.0f / (I.det != 0.0f ? I.det : 1.0f);
  for (int k = 0; k < 3; ++k) I.tv[k] = o[k] - I.v0[k];
  I.mu = dotv(I.tv, I.pv);
  I.bu = I.mu * I.inv_det;
  I.qv[0] = fmaf(I.tv[1], eb[2], -(I.tv[2] * eb[1]));
  I.qv[1] = fmaf(I.tv[2], eb[0], -(I.tv[0] * eb[2]));
  I.qv[2] = fmaf(I.tv[0], eb[1], -(I.tv[1] * eb[0]));
  I.mv = dotv(d, I.qv);
  I.bv = I.mv * I.inv_det;
  I.mt = dotv(ea, I.qv);
  I.t = I.mt * I.inv_det;
  const float w0 = 1.0f - I.bu - I.bv;
  for (int k = 0; k < 3; ++k) {
    I.p[k] = fmaf(I.t, d[k], o[k]);
    I.tn[k] = fmaf(I.nrm[6 + k], I.bv,
                   fmaf(I.nrm[k], w0, I.nrm[3 + k] * I.bu));
  }
  const float inv = rsqrt_cr(fmaxf(dotv(I.tn, I.tn), 1e-24f));
  for (int k = 0; k < 3; ++k) I.n[k] = I.tn[k] * inv;
}

// A rect or box winner (entity row e: quat | position | a rect's packed
// normal or a box's extents), the forward kernel's expressions
// (megatrace_common.cuh::rect_test, box_test, box_normal): the hit
// distance, point and normal.
RTIW_FN void aux_hit(IterAux& A, const float* e, float t_min) {
  const float* o = A.o;
  const float* d = A.d;
  aux_frame(o, d, e, A.ol, A.dl);
  if (A.kind == 1) {
    A.sdiv = A.dl[2] != 0.0f ? A.dl[2] : 1.0f;
    A.t = -A.ol[2] / A.sdiv;
    for (int k = 0; k < 3; ++k) {
      A.p[k] = fmaf(A.t, d[k], o[k]);
      A.n[k] = e[7 + k];
    }
    return;
  }
  float bo[3], dp[3], winding;
  for (int k = 0; k < 3; ++k) bo[k] = fmaf(A.dl[k], t_min, A.ol[k]);
  int a = box_face(bo, A.dl, e + 7, dp, winding);
  if (a < 0) a = 2;  // the tape guarantees a face; the plain replay's z
  A.face = a;
  A.dp = dp[a];
  A.sdiv = A.dl[a] == 0.0f ? 1e-30f : A.dl[a];
  A.wsg = winding * -sign_of(A.dl[a]);
  A.t = dp[a] + t_min;
  for (int k = 0; k < 3; ++k) A.p[k] = fmaf(A.t, d[k], o[k]);
  box_normal(A.p, e, A.ln, A.n);
}

// The convex volume walk at a hit (the kVol builds), after the winner's
// hit point and normal: its exit distance, the medium the walk is in, the
// free path and the decisions, the score terms (added to I.lp) and, on an
// in-medium scatter, its point, normal, emission and isotropic direction.
// Returns whether the walk took the iteration (a scatter in the medium or
// a skip), so that the material scatter does not run.
template <bool kAux, class V>
RTIW_FN bool volume_walk(V& I, const LaneEnv& E, const float* e, float mtype,
                         float u_free) {
  const float* d = I.d;
  int kind = 0;
  if constexpr (kAux) kind = I.kind;
  I.t_exit = kBig;
  if (kind == 0) {  // a sphere's far root
    const float t_far = (-I.b + I.sq) * I.inv_a;
    if (t_far > E.t_min) I.t_exit = t_far;
  } else if (kind == 2) {
    I.t_exit = box_exit(I.o, d, e, E.t_min, false, I.xbo, I.xdl, I.xinv,
                        I.xaxis, I.xhi);
  }
  I.in_vol = I.med[0] >= 0.0f;
  const bool hit_is_vol = mtype > 1.5f;
  const bool entering = dotv(d, I.n) < 0.0f;
  const float own[8] = {e[22], I.param, I.alb[0], I.alb[1],
                        I.alb[2], I.em[0], I.em[1], I.em[2]};
  for (int k = 0; k < 8; ++k) I.vm[k] = I.in_vol ? I.med[k] : own[k];
  I.free_path = -log_cr(fmaxf(u_free, 1e-12f)) / fmaxf(I.vm[1], 1e-12f);
  I.seg_len = I.in_vol ? I.t : I.t_exit - I.t;
  I.vol_candidate = I.in_vol || (hit_is_vol && entering);
  I.vol_scatter = I.vol_candidate && I.free_path < I.seg_len;
  I.vol_t = I.in_vol ? I.free_path : I.t + I.free_path;
  I.pass_through = !I.in_vol && hit_is_vol && entering && !I.vol_scatter;
  const bool exits_own = I.in_vol && hit_is_vol && !entering &&
                         !I.vol_scatter && fabsf(e[22] - I.med[0]) < 0.5f;
  I.skip = I.pass_through || exits_own;
  I.skip_t = I.skip ? (I.pass_through ? I.t_exit : I.t) : 0.0f;
  I.survive = I.vol_candidate && !I.vol_scatter;
  I.rho = fmaxf(I.vm[1], 1e-8f);
  I.d_obs = I.vol_scatter ? I.free_path : 0.0f;
  I.l_obs = I.survive ? fminf(I.seg_len, 1e6f) : 0.0f;
  I.lp = (I.lp + (I.vol_scatter ? logf(I.rho) - I.rho * I.d_obs : 0.0f)) +
         (I.survive ? -I.rho * I.l_obs : 0.0f);
  if (I.vol_scatter) {
    for (int k = 0; k < 3; ++k) {
      I.pe[k] = fmaf(I.vol_t, d[k], I.o[k]);
      I.ne[k] = -d[k];
      I.em[k] = I.vm[5 + k];
      I.sr[k] = I.vm[2 + k];
    }
    // isotropic direction (Material.cs:163-168), no lottery
    const float z = I.uc * 2.0f - 1.0f;
    const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    const float th = I.ud * kTwoPi;
    I.sd[0] = cos_cr(th) * r;
    I.sd[1] = sin_cr(th) * r;
    I.sd[2] = z;
    I.lp_inc = 0.0f;
    I.off_n = kSelfEps * (dotv(I.sd, I.ne) >= 0.0f ? 1.0f : -1.0f);
  } else if (I.skip) {
    for (int k = 0; k < 3; ++k) I.em[k] = 0.0f;  // no scatter, no emission
  }
  I.is_diel = false;
  return I.vol_scatter || I.skip;
}

// Regen, one bounce at the tape's winner, fold: everything but the state
// update, which step_forward applies.
template <bool kTris = false, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false>
RTIW_FN void iter_forward(const float* s, float code, int it,
                          const LaneEnv& E, Iter& I) {
  const float* cam = E.cam;
  I.regen = s[kActive] < 0.5f && s[kStarted] < E.per_pixel;
  for (int k = 0; k < 3; ++k) {
    I.o[k] = s[kOX + k];
    I.d[k] = s[kDX + k];
    I.th[k] = s[kTHX + k];
    I.rad[k] = s[kRX + k];
  }
  I.lp = s[kLp];
  I.valid = s[kValid];
  I.depth = s[kDepth];
  const uint32_t salt = (uint32_t)it * kSaltStep;
  if (I.regen) {
    // ---- thin-lens camera ray (View.cs:38-48) -------------------------
    const uint32_t base = E.key + salt;
    const float jx = E.jitter ? uniform(base, 0) : 0.5f;
    const float jy = E.jitter ? uniform(base, 1) : 0.5f;
    I.un = (E.px_row + jx) / cam[kWidth];
    I.vn = (E.py_row + jy) / cam[kHeight];
    const float theta = uniform(base, 2) * kTwoPi;
    I.sr3 = sqrtf(uniform(base, 3));
    const float radius = I.sr3 * cam[kLens];
    I.cth = cos_cr(theta);
    I.sth = sin_cr(theta);
    I.rdx = radius * I.cth;
    I.rdy = radius * I.sth;
    for (int k = 0; k < 3; ++k) {
      I.off[k] = fmaf(I.rdx, cam[kRR + k], I.rdy * cam[kUU + k]);
      I.q3[k] = fmaf(I.vn, cam[kVV + k],
                     fmaf(I.un, cam[kHH + k], cam[kLL + k] - I.off[k]));
    }
    norm3(I.q3, I.d);
    for (int k = 0; k < 3; ++k) {
      I.o[k] = cam[kCO + k] + I.off[k];
      I.th[k] = 1.0f;
      I.rad[k] = 0.0f;
    }
    I.lp = 0.0f;
    I.valid = 0.0f;
    I.depth = 0.0f;
  }
  if constexpr (kVol) {  // the medium: the camera's at regen; no walk yet
    auto& V = static_cast<IterOf<kAux, true>&>(I);
    for (int k = 0; k < 8; ++k)
      V.med[k] = I.regen ? cam[kVol0 + k] : s[kInId + k];
    V.in_vol = V.vol_candidate = V.vol_scatter = V.pass_through = V.skip =
        V.survive = false;
  }
  if constexpr (kMotion) {  // the path's shutter time: drawn at regen
    static_cast<IterMotion&>(I).ptime =
        I.regen ? uniform(E.key + salt, 7) : s[kPTime];
  }
  I.was_active = I.regen || s[kActive] > 0.5f;
  I.hit = false;
  I.ok = false;
  if (!I.was_active) return;  // idle lane: an identity step

  I.hit = code >= -0.5f;
  const uint32_t bbase = E.key + salt + kSaltBounce;
  I.ua = uniform(bbase, 0);
  I.ub = uniform(bbase, 1);
  I.uc = uniform(bbase, 2);
  I.ud = uniform(bbase, 3);
  const float u_choice = uniform(bbase, 4), u_choice2 = uniform(bbase, 5);
  const float* d = I.d;
  if (I.hit) {
    // ---- the winner: its hit point and normal ----------------------------
    I.w = (int)code;
    const float* e =
        E.ent + (size_t)I.w * Layout<kTris, kAux, kMotion, kTex>::ent;
    for (int k = 0; k < 3; ++k) {
      I.c[k] = e[k];
      I.alb[k] = e[11 + k];
      I.em[k] = e[14 + k];
    }
    if constexpr (kMotion) {  // the centre at the path's time
      IterMotion& M = static_cast<IterMotion&>(I);
      for (int k = 0; k < 3; ++k) {
        M.m[k] = e[kEntCols + k];
        I.c[k] = fmaf(M.m[k], M.ptime, e[k]);
      }
    }
    I.r = e[3];
    const float mtype = e[10];
    I.gloss = e[17];
    I.metal = e[18];
    I.param = e[19];
    I.tri = kTris && e[21] > 2.5f;
    bool aux = false;
    if constexpr (kAux) {
      IterAux& A = static_cast<IterAux&>(I);
      A.kind = e[21] > 1.5f ? 2 : e[21] > 0.5f ? 1 : 0;
      aux = A.kind != 0;
      if (aux) aux_hit(A, e, E.t_min);
    }
    if (kTris && I.tri) {
      for (int k = 0; k < 3; ++k) {
        I.eb[k] = e[4 + k];
        I.v0[k] = e[7 + k];
      }
      for (int k = 0; k < 9; ++k) I.nrm[k] = e[23 + k];
      tri_hit(I);
    } else if (kMotion) {
      sphere_hit_moving(I, E.t_min);
    } else if (!aux) {
      sphere_hit(I, E.t_min);
    }
    if constexpr (kTex)
      tex_forward(static_cast<IterTex&>(I),
                  static_cast<const LaneEnvTex&>(E), e + kEntCols);
    const float* n = I.n;
    bool walked = false;  // the volume walk took the iteration (kVol)
    if constexpr (kVol)
      walked = volume_walk<kAux>(static_cast<IterOf<kAux, true>&>(I), E, e,
                                 mtype, uniform(bbase, 6));
    if (!walked) {
      I.is_diel = E.has_diel && mtype > 0.5f;
      if (!I.is_diel) {
        // ---- Standard: Lambert / GGX metal (Material.cs:75-119) ----------
        I.roughness = (1.0f - I.gloss) * (1.0f - I.gloss);
        I.rough = I.roughness > 0.0f;
        cosine_hemisphere(I.ua, I.ub, n[0], n[1], n[2], I.cs[0], I.cs[1],
                          I.cs[2]);
        for (int k = 0; k < 3; ++k)
          I.q[k] = fmaf(I.cs[k] - n[k], I.roughness, n[k]);
        if (I.rough) {
          norm3(I.q, I.rn);
        } else {
          for (int k = 0; k < 3; ++k) I.rn[k] = n[k];
        }
        I.spec_dot = dotv(d, I.rn);
        I.std_ior = fmaf(kIorSpan, I.metal, kPlasticIor);
        I.fresnel = schlick(-I.spec_dot, I.std_ior);
        I.cos_dn = dotv(d, n);
        I.masking = smith_masking(I.cos_dn, I.roughness);
        I.x = I.fresnel * I.gloss * I.masking;
        I.rc = fminf(fmaxf(I.x, 0.0f), 1.0f);
        I.take_spec = I.rc > 0.0f && u_choice < I.rc;
        I.take_metal = I.metal > 0.0f && u_choice2 < I.metal;
        I.spec_like = I.take_spec || I.take_metal;
        if (I.spec_like) {
          for (int k = 0; k < 3; ++k)
            I.sd[k] = fmaf(-(2.0f * I.spec_dot), I.rn[k], d[k]);
        } else {
          cosine_hemisphere(I.uc, I.ud, n[0], n[1], n[2], I.sd[0], I.sd[1],
                            I.sd[2]);
        }
        for (int k = 0; k < 3; ++k) I.sr[k] = I.take_spec ? 1.0f : I.alb[k];
        I.lp_inc = I.take_spec
                       ? log_floor(I.rc)
                       : log_floor(1.0f - I.rc) +
                             (I.take_metal ? log_floor(I.metal)
                                           : log_floor(1.0f - I.metal));
      } else {
        // ---- dielectric (Material.cs:121-161) ------------------------------
        const float d_rough = 1.0f - I.gloss;
        const float z = I.ua * 2.0f - 1.0f;
        const float rz = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        const float th = I.ub * kTwoPi;
        I.ss[0] = cos_cr(th) * rz;
        I.ss[1] = sin_cr(th) * rz;
        I.ss[2] = z;
        for (int k = 0; k < 3; ++k) I.q2[k] = fmaf(d_rough, I.ss[k], n[k]);
        norm3(I.q2, I.dr);
        I.ddot = dotv(d, I.dr);
        I.exiting = I.ddot > 0.0f;
        for (int k = 0; k < 3; ++k) I.on[k] = I.exiting ? -I.dr[k] : I.dr[k];
        I.ior = fmaxf(I.param, 1e-3f);
        I.ni = I.exiting ? I.ior : 1.0f / I.ior;
        I.cosine = I.exiting ? I.ior * I.ddot : -I.ddot;
        I.dt = dotv(d, I.on);
        I.m = fmaf(-I.dt, I.dt, 1.0f);
        I.disc_r = fmaf(-(I.ni * I.ni), I.m, 1.0f);
        I.can_refract = I.disc_r > 0.0f;
        I.sq_r = sqrtf(I.can_refract ? fmaxf(I.disc_r, 1e-8f) : 1.0f);
        for (int k = 0; k < 3; ++k) I.wv[k] = fmaf(-I.on[k], I.dt, d[k]);
        I.rp = schlick(I.cosine, I.ior);
        I.do_refract = I.can_refract && u_choice > I.rp;
        for (int k = 0; k < 3; ++k) {
          if (I.do_refract) {
            I.sd[k] = fmaf(I.ni, I.wv[k], -(I.on[k] * I.sq_r));
            I.sr[k] = I.alb[k];
          } else {
            I.sd[k] = fmaf(-(2.0f * I.ddot), I.dr[k], d[k]);
            I.sr[k] = 1.0f;
          }
        }
        I.lp_inc = !I.can_refract ? 0.0f
                   : I.do_refract ? log_floor(1.0f - I.rp)
                                  : log_floor(I.rp);
      }
      I.off_n = kSelfEps * (dotv(I.sd, n) >= 0.0f ? 1.0f : -1.0f);
    }
    for (int k = 0; k < 3; ++k) I.em2[k] = I.em[k];
  } else {
    // ---- gradient sky (SampleBatchJob.cs:352-354) ------------------------
    I.tsky = 0.5f * (d[1] + 1.0f);
    for (int k = 0; k < 3; ++k)
      I.em2[k] = E.sky_on ? fmaf(cam[kSkyT + k] - cam[kSkyB + k], I.tsky,
                                 cam[kSkyB + k])
                          : 0.0f;
  }
  for (int k = 0; k < 3; ++k) I.rad_new[k] = fmaf(I.th[k], I.em2[k], I.rad[k]);
  // termination: a miss ends the sample validly, depth exhaustion fails it
  const float depth = I.depth + 1.0f;
  const bool active = I.hit && !(depth > E.trace_depth - 0.5f);
  I.ok = !active && (!I.hit || I.valid > 0.5f);
}

// One replay iteration of a volume build, in place (kVolStateVars).
template <bool kAux>
RTIW_FN void step_forward_vol(float* s, float code, int it,
                              const LaneEnv& E) {
  IterOf<kAux, true> I;
  iter_forward<false, kAux, true>(s, code, it, E, I);
  if (!I.was_active) return;
  const bool scat = I.hit && !I.skip;
  const float* pt = I.vol_scatter ? I.pe : I.p;
  const float* nn = I.vol_scatter ? I.ne : I.n;
  for (int k = 0; k < 3; ++k) {
    s[kOX + k] = scat     ? fmaf(I.off_n, nn[k], pt[k])
                 : I.skip ? fmaf(I.skip_t + kSelfEps, I.d[k], I.o[k])
                          : I.o[k];
    s[kDX + k] = scat ? I.sd[k] : I.d[k];
    s[kTHX + k] = scat ? I.th[k] * I.sr[k] : I.th[k];
    s[kRX + k] = I.rad_new[k];
    if (I.ok) s[kCSX + k] = s[kCSX + k] + I.rad_new[k];
  }
  s[kLp] = scat ? I.lp + I.lp_inc : I.lp;
  s[kStarted] = s[kStarted] + (I.regen ? 1.0f : 0.0f);
  s[kDepth] = I.depth + 1.0f;
  s[kValid] = I.hit ? I.valid : 1.0f;
  s[kActive] = (I.hit && !(s[kDepth] > E.trace_depth - 0.5f)) ? 1.0f : 0.0f;
  if (I.ok) s[kCnt] = s[kCnt] + 1.0f;
  // the medium: entered on a scatter, left on a skip
  for (int k = 0; k < 8; ++k)
    s[kInId + k] = I.vol_scatter ? I.vm[k] : I.med[k];
  if (I.skip) s[kInId] = -1.0f;
}

// One replay iteration, in place.
template <bool kTris = false, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false>
RTIW_FN void step_forward(float* s, float code, int it, const LaneEnv& E) {
  if constexpr (kVol) {
    step_forward_vol<kAux>(s, code, it, E);
    return;
  }
  IterOf<kAux, false, kMotion, kTex> I;
  iter_forward<kTris, kAux, false, kMotion, kTex>(s, code, it, E, I);
  if (!I.was_active) return;
  if constexpr (kMotion) s[kPTime] = I.ptime;
  for (int k = 0; k < 3; ++k) {
    s[kOX + k] = I.hit ? fmaf(I.off_n, I.n[k], I.p[k]) : I.o[k];
    s[kDX + k] = I.hit ? I.sd[k] : I.d[k];
    s[kTHX + k] = I.hit ? I.th[k] * I.sr[k] : I.th[k];
    s[kRX + k] = I.rad_new[k];
    if (I.ok) s[kCSX + k] = s[kCSX + k] + I.rad_new[k];
  }
  s[kLp] = I.hit ? I.lp + I.lp_inc : I.lp;
  s[kStarted] = s[kStarted] + (I.regen ? 1.0f : 0.0f);
  s[kDepth] = I.depth + 1.0f;
  s[kValid] = I.hit ? I.valid : 1.0f;
  s[kActive] = (I.hit && !(s[kDepth] > E.trace_depth - 0.5f)) ? 1.0f : 0.0f;
  if (I.ok) s[kCnt] = s[kCnt] + 1.0f;
}

// ---------------------------------------------------------------------------
// Adjoints of the helpers
// ---------------------------------------------------------------------------

// y = x / |x| (|x|^2 floored at 1e-12): gx = inv gy - inv^3 (gy.x) x.
RTIW_FN void norm3_vjp(const float* x, const float* gy, float* gx) {
  const float s2 = dotv(x, x);
  const float inv = rsqrt_cr(fmaxf(s2, 1e-12f));
  const float k = s2 >= 1e-12f ? -inv * inv * inv * dotv(gy, x) : 0.0f;
  for (int j = 0; j < 3; ++j) gx[j] = inv * gy[j] + k * x[j];
}

// Cotangent of n (added to gn) of cosine_hemisphere(u, v, n) given g.
RTIW_FN void cosine_hemisphere_vjp(float u, float v, const float* n,
                                   const float* g, float* gn) {
  const float r = sqrtf(u);
  const float th = v * kTwoPi;
  const float x = r * cos_cr(th);
  const float z = r * sin_cr(th);
  const float y = sqrtf(fmaxf(1.0f - u, 0.0f));
  const float nx = n[0], ny = n[1];
  const float sign = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float den = sign + n[2];
  const float a = -1.0f / den;
  // out = z * (b, ny^2 a + sign, -ny) + x * (sign nx^2 a + 1, sign b,
  //       -sign nx) + y * n, with b = nx ny a
  float ga = 0.0f, gb = 0.0f;
  for (int k = 0; k < 3; ++k) gn[k] += y * g[k];
  const float gt0 = x * g[0], gt1 = x * g[1], gt2 = x * g[2];
  const float gb0 = z * g[0], gb1 = z * g[1], gb2 = z * g[2];
  gn[0] += gt0 * sign * 2.0f * nx * a;
  ga += gt0 * sign * nx * nx;
  gb += sign * gt1;
  gn[0] -= sign * gt2;
  gb += gb0;
  gn[1] += gb1 * 2.0f * ny * a;
  ga += gb1 * ny * ny;
  gn[1] -= gb2;
  gn[0] += gb * ny * a;
  gn[1] += gb * nx * a;
  ga += gb * nx * ny;
  gn[2] += ga / (den * den);  // da/dnz = 1 / den^2
}

// f = (1 - r0) m^5 + r0, m = max(1 - cos, 0), r0 = ((1 - ior)/(1 + ior))^2.
RTIW_FN void schlick_vjp(float cosine, float ior, float gf, float& gcos,
                         float& gior) {
  const float q = (1.0f - ior) / (1.0f + ior);
  const float r0 = q * q;
  const float m_raw = 1.0f - cosine;
  const float m = fmaxf(m_raw, 0.0f);
  const float m4 = m * m * m * m;
  const float gm = gf * 5.0f * (1.0f - r0) * m4;
  const float gr0 = gf * (1.0f - m4 * m);
  gcos = m_raw >= 0.0f ? -gm : 0.0f;
  gior = 2.0f * q * gr0 * (-2.0f / ((1.0f + ior) * (1.0f + ior)));
}

RTIW_FN void smith_masking_vjp(float cos_theta, float roughness, float gG,
                               float& gcos, float& grough) {
  gcos = 0.0f;
  grough = 0.0f;
  const float sq_cos = cos_theta * cos_theta;
  if (sq_cos < 1e-12f) return;  // degenerate: constant masking
  const float sq_sin_raw = 1.0f - sq_cos;
  const float sq_tan = fmaxf(sq_sin_raw, 0.0f) / sq_cos;
  const float xl = logf(fmaxf(roughness, 1e-3f));
  const float alpha = roughness_to_alpha(roughness);
  const float root = sqrtf(fmaf(alpha * alpha, sq_tan, 1.0f));
  const float lam = (-1.0f + root) / 2.0f;
  const float G = 1.0f / (1.0f + lam);
  const float glam = -gG * G * G;
  const float gs = glam * 0.25f / root;
  const float galpha = gs * 2.0f * alpha * sq_tan;
  const float gtan = gs * alpha * alpha;
  float gsq_cos = -gtan * sq_tan / sq_cos;
  if (sq_sin_raw >= 0.0f) gsq_cos -= gtan / sq_cos;
  gcos = 2.0f * cos_theta * gsq_cos;
  if (roughness >= 1e-3f) {
    const float dalpha = 0.819955f + 2.0f * 0.1734f * xl +
                         3.0f * 0.0171201f * xl * xl +
                         4.0f * 0.000640711f * xl * xl * xl;
    grough = galpha * dalpha / roughness;
  }
}

// Cotangents of a sphere winner's hit point p and normal n (gp is
// updated in place, gn read) into the ray (go, gd) and the winner row's
// centre and radius (ge).
RTIW_FN void sphere_hit_vjp(const Iter& I, float* gp, const float* gn,
                            float* go, float* gd, float* ge) {
  const float* o = I.o;
  const float* d = I.d;
  const float* c = I.c;
  float gc[3], ginv_r = 0.0f, gr = 0.0f;
  for (int k = 0; k < 3; ++k) {
    gp[k] += gn[k] * I.inv_r;
    gc[k] = -gn[k] * I.inv_r;
    ginv_r += gn[k] * (I.p[k] - c[k]);
  }
  if (I.r != 0.0f) gr -= ginv_r * I.inv_r * I.inv_r;
  const float gt = dotv(gp, d);
  for (int k = 0; k < 3; ++k) {
    gd[k] += I.t * gp[k];
    go[k] += gp[k];
  }
  // t = (-b -+ sq) / a
  float gb = -gt * I.inv_a;
  const float gsq = I.near_root ? -gt * I.inv_a : gt * I.inv_a;
  const float ginv_a = gt * (I.near_root ? (-I.b - I.sq) : (-I.b + I.sq));
  float ga = -ginv_a * I.inv_a * I.inv_a;
  const float gdisc = I.disc >= 1e-8f ? gsq * 0.5f / I.sq : 0.0f;
  gb += 2.0f * I.b * gdisc;
  ga -= I.cc * gdisc;
  const float gcc = -I.a * gdisc;
  // cc = |o - c|^2 - r^2, b = d.(o - c), a = d.d: the derivatives of
  // the expanded forms the primal rounds, taken in (o - c) form, which
  // does not cancel (the plain replay does the same)
  for (int k = 0; k < 3; ++k) {
    const float oc = o[k] - c[k];
    const float gq = 2.0f * oc * gcc + d[k] * gb;
    gc[k] -= gq;
    go[k] += gq;
    gd[k] += oc * gb + 2.0f * d[k] * ga;
  }
  gr -= 2.0f * I.r * gcc;
  for (int k = 0; k < 3; ++k) ge[kGC + k] += gc[k];
  ge[kGR] += gr;
}

// Cotangents of a triangle winner's hit point p and unit normal n (gp,
// gn) into the ray (go, gd) and the winner row: edge_a, edge_b, vert0 and
// the three vertex normals (ge, the kTriGradCols layout).
RTIW_FN void tri_hit_vjp(const Iter& I, const float* gp, const float* gn,
                         float* go, float* gd, float* ge) {
  const float* d = I.d;
  // n = tn rsqrt(max(|tn|^2, 1e-24))
  const float l2 = dotv(I.tn, I.tn);
  const float inv = rsqrt_cr(fmaxf(l2, 1e-24f));
  const float kn = l2 >= 1e-24f ? -inv * inv * inv * dotv(gn, I.tn) : 0.0f;
  // tn = n0 (1 - u - v) + n1 u + n2 v
  const float w0 = 1.0f - I.bu - I.bv;
  float gw0 = 0.0f, gu = 0.0f, gv = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float gtn = inv * gn[k] + kn * I.tn[k];
    ge[kGNrm + k] += gtn * w0;
    ge[kGNrm + 3 + k] += gtn * I.bu;
    ge[kGNrm + 6 + k] += gtn * I.bv;
    gw0 += gtn * I.nrm[k];
    gu += gtn * I.nrm[3 + k];
    gv += gtn * I.nrm[6 + k];
  }
  gu -= gw0;
  gv -= gw0;
  // p = t d + o
  const float gt = dotv(gp, d);
  for (int k = 0; k < 3; ++k) {
    gd[k] += I.t * gp[k];
    go[k] += gp[k];
  }
  // (t, u, v) = (ea.qv, tv.pv, d.qv) / det
  const float ginv = gt * I.mt + gu * I.mu + gv * I.mv;
  const float gmt = gt * I.inv_det, gmu = gu * I.inv_det,
              gmv = gv * I.inv_det;
  const float gdet = I.det != 0.0f ? -ginv * I.inv_det * I.inv_det : 0.0f;
  float gqv[3], gpv[3], gtv[3], gea[3], geb[3];
  for (int k = 0; k < 3; ++k) {
    gqv[k] = gmt * I.c[k] + gmv * d[k];
    gea[k] = gmt * I.qv[k];
    gd[k] += gmv * I.qv[k];
    gtv[k] = gmu * I.pv[k];
    gpv[k] = gmu * I.tv[k] + gdet * I.eb[k];
    geb[k] = gdet * I.pv[k];
  }
  // qv = tv x eb: gtv += eb x gqv, geb += gqv x tv
  gtv[0] += I.eb[1] * gqv[2] - I.eb[2] * gqv[1];
  gtv[1] += I.eb[2] * gqv[0] - I.eb[0] * gqv[2];
  gtv[2] += I.eb[0] * gqv[1] - I.eb[1] * gqv[0];
  geb[0] += gqv[1] * I.tv[2] - gqv[2] * I.tv[1];
  geb[1] += gqv[2] * I.tv[0] - gqv[0] * I.tv[2];
  geb[2] += gqv[0] * I.tv[1] - gqv[1] * I.tv[0];
  // pv = d x ea: gd += ea x gpv, gea += gpv x d
  gd[0] += I.c[1] * gpv[2] - I.c[2] * gpv[1];
  gd[1] += I.c[2] * gpv[0] - I.c[0] * gpv[2];
  gd[2] += I.c[0] * gpv[1] - I.c[1] * gpv[0];
  gea[0] += gpv[1] * d[2] - gpv[2] * d[1];
  gea[1] += gpv[2] * d[0] - gpv[0] * d[2];
  gea[2] += gpv[0] * d[1] - gpv[1] * d[0];
  // tv = o - v0
  for (int k = 0; k < 3; ++k) {
    go[k] += gtv[k];
    ge[kGC + k] += gea[k];
    ge[kGEb + k] += geb[k];
    ge[kGV0 + k] -= gtv[k];
  }
}

// r = q v q* (quat_rotate): cotangents of q (gq, 4) and v (gv, 3), added,
// given r's (g).  t = 2 q_v x v, r = v + w t + q_v x t.
RTIW_FN void quat_rotate_vjp(const float* q, const float* v, const float* g,
                             float* gq, float* gv) {
  const float t[3] = {2.0f * (q[1] * v[2] - q[2] * v[1]),
                      2.0f * (q[2] * v[0] - q[0] * v[2]),
                      2.0f * (q[0] * v[1] - q[1] * v[0])};
  // gt = w g + g x q_v; gq_v += t x g; gw += g.t
  const float gt[3] = {q[3] * g[0] + (g[1] * q[2] - g[2] * q[1]),
                       q[3] * g[1] + (g[2] * q[0] - g[0] * q[2]),
                       q[3] * g[2] + (g[0] * q[1] - g[1] * q[0])};
  gq[0] += t[1] * g[2] - t[2] * g[1];
  gq[1] += t[2] * g[0] - t[0] * g[2];
  gq[2] += t[0] * g[1] - t[1] * g[0];
  gq[3] += dotv(g, t);
  // t = 2 q_v x v: gq_v += 2 v x gt, gv += 2 gt x q_v
  gq[0] += 2.0f * (v[1] * gt[2] - v[2] * gt[1]);
  gq[1] += 2.0f * (v[2] * gt[0] - v[0] * gt[2]);
  gq[2] += 2.0f * (v[0] * gt[1] - v[1] * gt[0]);
  gv[0] += g[0] + 2.0f * (gt[1] * q[2] - gt[2] * q[1]);
  gv[1] += g[1] + 2.0f * (gt[2] * q[0] - gt[0] * q[2]);
  gv[2] += g[2] + 2.0f * (gt[0] * q[1] - gt[1] * q[0]);
}

// Cotangents of a rect or box winner's hit point p and normal n (gp, gn)
// into the ray (go, gd) and the winner row: quaternion, position and a
// box's extents (ge, the kAuxGradCols layout).
RTIW_FN void aux_hit_vjp(const IterAux& A, const float* e, float t_min,
                         const float* gp, const float* gn, float* go,
                         float* gd, float* ge) {
  const float* d = A.d;
  const float q[4] = {e[0], e[1], e[2], e[3]};
  const float gt = dotv(gp, d);
  for (int k = 0; k < 3; ++k) {
    gd[k] += A.t * gp[k];
    go[k] += gp[k];
  }
  float gol[3] = {0.0f, 0.0f, 0.0f}, gdl[3] = {0.0f, 0.0f, 0.0f};
  float gq[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gv[3] = {0.0f, 0.0f, 0.0f};
  if (A.kind == 1) {
    // t = -ol.z / dl.z; n = q (0, 0, 1) q*
    gol[2] = -gt / A.sdiv;
    if (A.dl[2] != 0.0f) gdl[2] = -gt * A.t / A.sdiv;
    const float up[3] = {0.0f, 0.0f, 1.0f};
    quat_rotate_vjp(q, up, gn, gq, gv);
  } else {
    // t = (ext_a wsg - bo_a) / dl_a + t_min, bo = ol + dl t_min;
    // n = q ln q*
    const int a = A.face;
    ge[kGExt + a] += gt * A.wsg / A.sdiv;
    const float gbo = -gt / A.sdiv;
    if (A.dl[a] != 0.0f) gdl[a] -= gt * A.dp / A.sdiv;
    gol[a] += gbo;
    gdl[a] += gbo * t_min;
    quat_rotate_vjp(q, A.ln, gn, gq, gv);
  }
  // ol = q* (o - pos) q, dl = q* d q
  const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  float gqc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float rel[3], gr[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) rel[k] = A.o[k] - e[4 + k];
  quat_rotate_vjp(qc, rel, gol, gqc, gr);
  for (int k = 0; k < 3; ++k) {
    go[k] += gr[k];
    ge[kGPos + k] -= gr[k];
  }
  quat_rotate_vjp(qc, d, gdl, gqc, gd);
  for (int k = 0; k < 3; ++k) ge[kGC + k] += gq[k] - gqc[k];
  ge[kGR] += gq[3] + gqc[3];
}

// The volume builds' extra distances: a cotangent gt of a sphere winner's
// root (near: the hit's, t_near; else the far one, the exit) into the ray
// and the winner's centre and radius, as sphere_hit_vjp takes its t.
RTIW_FN void sphere_root_vjp(const Iter& I, bool near, float gt, float* go,
                             float* gd, float* ge) {
  const float* o = I.o;
  const float* d = I.d;
  // t = (-b -+ sq) / a
  float gb = -gt * I.inv_a;
  const float gsq = near ? -gt * I.inv_a : gt * I.inv_a;
  const float ginv_a = gt * (near ? (-I.b - I.sq) : (-I.b + I.sq));
  float ga = -ginv_a * I.inv_a * I.inv_a;
  const float gdisc = I.disc >= 1e-8f ? gsq * 0.5f / I.sq : 0.0f;
  gb += 2.0f * I.b * gdisc;
  ga -= I.cc * gdisc;
  const float gcc = -I.a * gdisc;
  for (int k = 0; k < 3; ++k) {
    const float oc = o[k] - I.c[k];
    const float gq = 2.0f * oc * gcc + d[k] * gb;
    ge[kGC + k] -= gq;
    go[k] += gq;
    gd[k] += oc * gb + 2.0f * d[k] * ga;
  }
  ge[kGR] -= 2.0f * I.r * gcc;
}

// ol = q* (o - pos) q, dl = q* d q: the cotangents gol, gdl of a rect's or
// box's frame into the ray (go, gd) and the row's quaternion and
// position (ge, the kAuxGradCols layout).
RTIW_FN void frame_vjp(const float* e, const float* o, const float* d,
                       const float* gol, const float* gdl, float* go,
                       float* gd, float* ge) {
  const float qc[4] = {-e[0], -e[1], -e[2], e[3]};
  float gqc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float rel[3], gr[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) rel[k] = o[k] - e[4 + k];
  quat_rotate_vjp(qc, rel, gol, gqc, gr);
  for (int k = 0; k < 3; ++k) {
    go[k] += gr[k];
    ge[kGPos + k] -= gr[k];
  }
  quat_rotate_vjp(qc, d, gdl, gqc, gd);
  for (int k = 0; k < 3; ++k) ge[kGC + k] -= gqc[k];
  ge[kGR] += gqc[3];
}

// A cotangent gt of a rect's or box's hit distance (aux_hit's t) alone.
RTIW_FN void aux_t_vjp(const IterAux& A, const float* e, float t_min,
                       float gt, float* go, float* gd, float* ge) {
  float gol[3] = {0.0f, 0.0f, 0.0f}, gdl[3] = {0.0f, 0.0f, 0.0f};
  if (A.kind == 1) {
    gol[2] = -gt / A.sdiv;
    if (A.dl[2] != 0.0f) gdl[2] = -gt * A.t / A.sdiv;
  } else {
    const int a = A.face;
    ge[kGExt + a] += gt * A.wsg / A.sdiv;
    const float gbo = -gt / A.sdiv;
    if (A.dl[a] != 0.0f) gdl[a] -= gt * A.dp / A.sdiv;
    gol[a] += gbo;
    gdl[a] += gbo * t_min;
  }
  frame_vjp(e, A.o, A.d, gol, gdl, go, gd, ge);
}

// A cotangent gt of a box winner's slab exit (box_exit with 1 / 1e-30 on
// a parallel axis): t = (+-ext_a - bo_a) inv_a + t_min on its far axis a,
// bo = ol + dl t_min, inv = 1 / dl (no derivative where dl == 0).
template <class V>
RTIW_FN void box_exit_vjp(const V& I, const float* e, float t_min, float gt,
                          float* go, float* gd, float* ge) {
  float gol[3] = {0.0f, 0.0f, 0.0f}, gdl[3] = {0.0f, 0.0f, 0.0f};
  const int a = I.xaxis;
  const float sgn = I.xhi ? 1.0f : -1.0f;
  ge[kGExt + a] += gt * I.xinv[a] * sgn;
  const float gbo = -gt * I.xinv[a];
  if (I.xdl[a] != 0.0f)
    gdl[a] -= gt * (sgn * e[7 + a] - I.xbo[a]) * I.xinv[a] * I.xinv[a];
  gol[a] += gbo;
  gdl[a] += gbo * t_min;
  frame_vjp(e, I.o, I.d, gol, gdl, go, gd, ge);
}

// The gradient sky's adjoint on a miss: the fold's cotangents (grad) into
// the sky colours (gs) and the direction's y (gd).  This and regen_vjp are
// step_vjp's own code for the volume builds; step_vjp keeps it inline (as
// functions they changed its builds' SASS).
RTIW_FN void sky_vjp(const Iter& I, const LaneEnv& E, const float* grad,
                     float* gd, float* gs) {
  if (!E.sky_on) return;
  const float* cam = E.cam;
  float gtsky = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float gem = grad[k] * I.th[k];
    gtsky += gem * (cam[kSkyT + k] - cam[kSkyB + k]);
    gs[kSkyT + k] += gem * I.tsky;
    gs[kSkyB + k] += gem * (1.0f - I.tsky);
  }
  gd[1] += 0.5f * gtsky;
}

// The camera ray's adjoint at regen: the cotangents of the new origin and
// direction into the camera row (gs).
RTIW_FN void regen_vjp(const Iter& I, const LaneEnv& E, const float* go,
                       const float* gd, float* gs) {
  const float* cam = E.cam;
  float gq3[3], goff[3];
  norm3_vjp(I.q3, gd, gq3);
  float gun = 0.0f, gvn = 0.0f, grdx = 0.0f, grdy = 0.0f;
  for (int k = 0; k < 3; ++k) {
    gs[kCO + k] += go[k];
    goff[k] = go[k] - gq3[k];
    gs[kLL + k] += gq3[k];
    gs[kHH + k] += I.un * gq3[k];
    gun += cam[kHH + k] * gq3[k];
    gs[kVV + k] += I.vn * gq3[k];
    gvn += cam[kVV + k] * gq3[k];
    gs[kRR + k] += I.rdx * goff[k];
    gs[kUU + k] += I.rdy * goff[k];
    grdx += cam[kRR + k] * goff[k];
    grdy += cam[kUU + k] * goff[k];
  }
  gs[kLens] += (grdx * I.cth + grdy * I.sth) * I.sr3;
  // un = (pixel - py_row width + jx) / width, py_row a constant
  gs[kWidth] += gun * (-(E.py_row + I.un) / cam[kWidth]);
  gs[kHeight] += gvn * (-I.vn / cam[kHeight]);
}

// ---------------------------------------------------------------------------
// The iteration's adjoint
// ---------------------------------------------------------------------------

// Standard scatter: cotangents of (sd, sr, lp_inc) into n, d and the
// winner's albedo, gloss and metallic.
RTIW_FN void standard_vjp(const Iter& I, const float* gsd, const float* gsr,
                          float glp_inc, float* gn, float* gd, float* ge) {
  const float* n = I.n;
  const float* d = I.d;
  if (!I.take_spec)
    for (int k = 0; k < 3; ++k) ge[kGAlb + k] += gsr[k];
  float grc = 0.0f, gmet = 0.0f, ggloss = 0.0f, grough = 0.0f;
  if (I.take_spec) {
    if (I.rc >= 1e-12f) grc += glp_inc / I.rc;
  } else {
    if (1.0f - I.rc >= 1e-12f) grc -= glp_inc / (1.0f - I.rc);
    if (I.take_metal) {
      if (I.metal >= 1e-12f) gmet += glp_inc / I.metal;
    } else {
      if (1.0f - I.metal >= 1e-12f) gmet -= glp_inc / (1.0f - I.metal);
    }
  }
  float grn[3] = {0.0f, 0.0f, 0.0f};
  float gspec = 0.0f;
  if (I.spec_like) {
    // sd = d - 2 spec_dot rn
    for (int k = 0; k < 3; ++k) {
      gd[k] += gsd[k];
      grn[k] += -2.0f * I.spec_dot * gsd[k];
    }
    gspec += -2.0f * dotv(gsd, I.rn);
  } else {
    cosine_hemisphere_vjp(I.uc, I.ud, n, gsd, gn);
  }
  // rc = clip(fresnel * gloss * masking, 0, 1); the derivative is split
  // in half at a tie (x == 0 on every Lambert hit), as jnp.clip's is
  const float gx = (I.x > 0.0f && I.x < 1.0f)     ? grc
                   : (I.x == 0.0f || I.x == 1.0f) ? 0.5f * grc
                                                   : 0.0f;
  const float gfres = gx * I.gloss * I.masking;
  ggloss += gx * I.fresnel * I.masking;
  const float gmask = gx * I.fresnel * I.gloss;
  float gcdn, gr_s;
  smith_masking_vjp(I.cos_dn, I.roughness, gmask, gcdn, gr_s);
  grough += gr_s;
  for (int k = 0; k < 3; ++k) {
    gd[k] += gcdn * n[k];
    gn[k] += gcdn * d[k];
  }
  float ginc, gior;
  schlick_vjp(-I.spec_dot, I.std_ior, gfres, ginc, gior);
  gspec -= ginc;
  gmet += kIorSpan * gior;
  for (int k = 0; k < 3; ++k) {
    gd[k] += gspec * I.rn[k];
    grn[k] += gspec * d[k];
  }
  if (I.rough) {
    // rn = normalize(n + (cs - n) roughness), cs = cosine_hemisphere(n)
    float gq[3], gcs[3];
    norm3_vjp(I.q, grn, gq);
    for (int k = 0; k < 3; ++k) {
      gcs[k] = gq[k] * I.roughness;
      gn[k] += gq[k] * (1.0f - I.roughness);
      grough += gq[k] * (I.cs[k] - n[k]);
    }
    cosine_hemisphere_vjp(I.ua, I.ub, n, gcs, gn);
  } else {
    for (int k = 0; k < 3; ++k) gn[k] += grn[k];
  }
  ggloss += -2.0f * (1.0f - I.gloss) * grough;
  ge[kGGloss] += ggloss;
  ge[kGMetal] += gmet;
}

// Dielectric scatter: cotangents of (sd, sr, lp_inc) into n, d and the
// winner's albedo, gloss and parameter (ior).
RTIW_FN void dielectric_vjp(const Iter& I, const float* gsd,
                            const float* gsr, float glp_inc, float* gn,
                            float* gd, float* ge) {
  const float* d = I.d;
  if (I.do_refract)
    for (int k = 0; k < 3; ++k) ge[kGAlb + k] += gsr[k];
  float grp = 0.0f;
  if (I.can_refract) {
    if (I.do_refract) {
      if (1.0f - I.rp >= 1e-12f) grp -= glp_inc / (1.0f - I.rp);
    } else {
      if (I.rp >= 1e-12f) grp += glp_inc / I.rp;
    }
  }
  float gdr[3] = {0.0f, 0.0f, 0.0f}, gon[3] = {0.0f, 0.0f, 0.0f};
  float gddot = 0.0f, gdt = 0.0f, gni = 0.0f, gior = 0.0f, gsq_r = 0.0f;
  if (I.do_refract) {
    // sd = ni (d - on dt) - on sq_r
    gni += dotv(gsd, I.wv);
    gsq_r -= dotv(I.on, gsd);
    float gw[3];
    for (int k = 0; k < 3; ++k) {
      gw[k] = I.ni * gsd[k];
      gon[k] -= I.sq_r * gsd[k];
      gd[k] += gw[k];
      gon[k] -= I.dt * gw[k];
    }
    gdt -= dotv(I.on, gw);
  } else {
    // sd = d - 2 ddot dr
    for (int k = 0; k < 3; ++k) {
      gd[k] += gsd[k];
      gdr[k] += -2.0f * I.ddot * gsd[k];
    }
    gddot += -2.0f * dotv(gsd, I.dr);
  }
  float gcos, gior_s;
  schlick_vjp(I.cosine, I.ior, grp, gcos, gior_s);
  gior += gior_s;
  if (I.can_refract && I.disc_r >= 1e-8f) {
    // disc_r = 1 - ni^2 (1 - dt^2)
    const float gdisc = gsq_r * 0.5f / I.sq_r;
    gni += gdisc * (-2.0f * I.ni * I.m);
    gdt += -gdisc * I.ni * I.ni * (-2.0f * I.dt);
  }
  for (int k = 0; k < 3; ++k) {
    gd[k] += gdt * I.on[k];
    gon[k] += gdt * d[k];
  }
  if (I.exiting) {
    gior += gcos * I.ddot;
    gddot += gcos * I.ior;
    gior += gni;
  } else {
    gddot -= gcos;
    gior -= gni / (I.ior * I.ior);
  }
  if (I.param >= 1e-3f) ge[kGParam] += gior;
  for (int k = 0; k < 3; ++k) {
    gdr[k] += I.exiting ? -gon[k] : gon[k];
    gd[k] += gddot * I.dr[k];
    gdr[k] += gddot * d[k];
  }
  // dr = normalize(n + (1 - gloss) ss)
  float gq2[3];
  norm3_vjp(I.q2, gdr, gq2);
  for (int k = 0; k < 3; ++k) gn[k] += gq2[k];
  ge[kGGloss] -= dotv(gq2, I.ss);
}

// Adjoint of step_forward_vol (kVolStateVars; gs kScalVol), as step_vjp.
template <bool kAux>
RTIW_FN int step_vjp_vol(const float* s, float* g, float code, int it,
                         const LaneEnv& E, float* ge, float* gs) {
  IterOf<kAux, true> I;
  iter_forward<false, kAux, true>(s, code, it, E, I);
  for (int k = 0; k < Layout<false, kAux>::grad; ++k) ge[k] = 0.0f;
  g[kActive] = g[kValid] = g[kStarted] = g[kDepth] = g[kInId] = 0.0f;
  if (!I.was_active) return -1;

  // ---- accumulators with the score-function carrier --------------------
  float grad[3], go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
  float gth[3], gn[3] = {0.0f, 0.0f, 0.0f}, gp[3] = {0.0f, 0.0f, 0.0f};
  float glp = g[kLp];
  for (int k = 0; k < 3; ++k) grad[k] = g[kRX + k];
  if (I.ok) {
    for (int k = 0; k < 3; ++k) grad[k] += g[kCSX + k];
    glp += g[kCSX] * I.rad_new[0] + g[kCSX + 1] * I.rad_new[1] +
           g[kCSX + 2] * I.rad_new[2] + g[kCnt];
  }
  // ---- the medium out: the walk's on a scatter, else the one in ---------
  float gvm[8] = {}, gmed[8] = {};
  for (int k = 1; k < 8; ++k) (I.vol_scatter ? gvm : gmed)[k] = g[kInId + k];
  // ---- advance and fold --------------------------------------------------
  const bool scat = I.hit && !I.skip;
  float gsd[3] = {0.0f, 0.0f, 0.0f}, gsr[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) {
    if (scat) {
      gn[k] += I.off_n * g[kOX + k];
      gp[k] += g[kOX + k];
      gsd[k] = g[kDX + k];
      gth[k] = g[kTHX + k] * I.sr[k];
      gsr[k] = g[kTHX + k] * I.th[k];
    } else {
      go[k] = g[kOX + k];
      gd[k] = g[kDX + k];
      gth[k] = g[kTHX + k];
    }
    gth[k] += grad[k] * I.em2[k];  // rad_new = th em2 + rad
  }
  if (!I.hit) {
    sky_vjp(I, E, grad, gd, gs);
  } else {
    const float* e = E.ent + (size_t)I.w * Layout<false, kAux>::ent;
    float gt_surf = 0.0f, gt_exit = 0.0f;
    bool surface = false;  // the surface's point and normal reach the out
    if (I.skip) {
      // o' = o + (skip_t + eps) d: to the exit's or the surface's t
      const float gst = dotv(g + kOX, I.d);
      for (int k = 0; k < 3; ++k) gd[k] += (I.skip_t + kSelfEps) * g[kOX + k];
      (I.pass_through ? gt_exit : gt_surf) += gst;
    } else if (I.vol_scatter) {
      // the medium's emission and albedo; pe = o + vol_t d, ne = -d; the
      // isotropic direction is a constant
      for (int k = 0; k < 3; ++k) {
        gvm[5 + k] += grad[k] * I.th[k];
        gvm[2 + k] += gsr[k];
        go[k] += gp[k];
        gd[k] += I.vol_t * gp[k] - gn[k];
      }
      if (!I.in_vol) gt_surf += dotv(gp, I.d);  // vol_t = t + free path
    } else {
      surface = true;
      for (int k = 0; k < 3; ++k) ge[kGEm + k] += grad[k] * I.th[k];
      if (I.is_diel)
        dielectric_vjp(I, gsd, gsr, glp, gn, gd, ge);
      else
        standard_vjp(I, gsd, gsr, glp, gn, gd, ge);
    }
    // ---- the score terms: d lp / d rho ----------------------------------
    float grho = 0.0f;
    if (I.vol_scatter) grho += glp * (1.0f / I.rho - I.d_obs);
    if (I.survive) grho -= glp * I.l_obs;
    if (I.vm[1] >= 1e-8f) gvm[1] += grho;
    // ---- the walk's medium: the one in, or the winner's material ---------
    for (int k = 1; k < 8; ++k) {
      if (I.in_vol)
        gmed[k] += gvm[k];
      else
        ge[k == 1 ? kGParam : k < 5 ? kGAlb + k - 2 : kGEm + k - 5] += gvm[k];
    }
    // ---- the winner's geometry: point, normal, distance, exit -----------
    int kind = 0;
    if constexpr (kAux) kind = I.kind;
    if (kind != 0) {
      if constexpr (kAux) {
        if (surface) aux_hit_vjp(I, e, E.t_min, gp, gn, go, gd, ge);
        if (gt_surf != 0.0f) aux_t_vjp(I, e, E.t_min, gt_surf, go, gd, ge);
        if (gt_exit != 0.0f && kind == 2 && I.t_exit < kBig)
          box_exit_vjp(I, e, E.t_min, gt_exit, go, gd, ge);
      }
    } else {
      if (surface) sphere_hit_vjp(I, gp, gn, go, gd, ge);
      if (gt_surf != 0.0f)
        sphere_root_vjp(I, I.near_root, gt_surf, go, gd, ge);
      if (gt_exit != 0.0f && I.t_exit < kBig)
        sphere_root_vjp(I, false, gt_exit, go, gd, ge);
    }
  }

  // ---- regen: the camera ray, the camera's medium ------------------------
  if (I.regen) {
    regen_vjp(I, E, go, gd, gs);
    for (int k = 1; k < 8; ++k) gs[kVol0 + k] += gmed[k];
    for (int k = 0; k < 3; ++k) {
      g[kOX + k] = g[kDX + k] = g[kTHX + k] = g[kRX + k] = 0.0f;
    }
    g[kLp] = 0.0f;
    for (int k = 1; k < 8; ++k) g[kInId + k] = 0.0f;
  } else {
    for (int k = 0; k < 3; ++k) {
      g[kOX + k] = go[k];
      g[kDX + k] = gd[k];
      g[kTHX + k] = gth[k];
      g[kRX + k] = grad[k];
    }
    g[kLp] = glp;
    for (int k = 1; k < 8; ++k) g[kInId + k] = gmed[k];
  }
  return I.hit ? I.w : -1;
}

// Adjoint of step_forward.  g holds the cotangent of the output state on
// entry and of the input state on exit.  ge (Layout<kTris>::grad) receives
// the winner row's cotangent and gs (kScal) accumulates the camera and sky
// cotangents.  Returns the winner row, or -1 when ge is unused.
template <bool kTris = false, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false>
RTIW_FN int step_vjp(const float* s, float* g, float code, int it,
                     const LaneEnv& E, float* ge, float* gs) {
  if constexpr (kVol) return step_vjp_vol<kAux>(s, g, code, it, E, ge, gs);
  IterOf<kAux, false, kMotion, kTex> I;
  iter_forward<kTris, kAux, false, kMotion, kTex>(s, code, it, E, I);
  for (int k = 0; k < Layout<kTris, kAux, kMotion, kTex>::grad; ++k)
    ge[k] = 0.0f;
  if constexpr (kTex) {
    ge[kTexGradCols] = -1.0f;  // no texel
    for (int k = 1; k < kTexelSlots; ++k) ge[kTexGradCols + k] = 0.0f;
  }
  g[kActive] = g[kValid] = g[kStarted] = g[kDepth] = 0.0f;
  if (!I.was_active) return -1;
  const float* cam = E.cam;

  // ---- accumulators with the score-function carrier --------------------
  float grad[3], go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
  float gth[3], gn[3] = {0.0f, 0.0f, 0.0f}, gp[3] = {0.0f, 0.0f, 0.0f};
  float glp = g[kLp];
  for (int k = 0; k < 3; ++k) grad[k] = g[kRX + k];
  if (I.ok) {
    // cs += rad + sg(rad) (lp - sg(lp)); cnt += 1 + (lp - sg(lp))
    for (int k = 0; k < 3; ++k) grad[k] += g[kCSX + k];
    glp += g[kCSX] * I.rad_new[0] + g[kCSX + 1] * I.rad_new[1] +
           g[kCSX + 2] * I.rad_new[2] + g[kCnt];
  }
  // ---- advance and fold --------------------------------------------------
  float gsd[3] = {0.0f, 0.0f, 0.0f}, gsr[3] = {0.0f, 0.0f, 0.0f};
  const float glp_inc = I.hit ? glp : 0.0f;
  for (int k = 0; k < 3; ++k) {
    if (I.hit) {
      gn[k] += I.off_n * g[kOX + k];
      gp[k] += g[kOX + k];
      gsd[k] = g[kDX + k];
      gth[k] = g[kTHX + k] * I.sr[k];
      gsr[k] = g[kTHX + k] * I.th[k];
    } else {
      go[k] = g[kOX + k];
      gd[k] = g[kDX + k];
      gth[k] = g[kTHX + k];
    }
    gth[k] += grad[k] * I.em2[k];  // rad_new = th em2 + rad
  }
  if (!I.hit) {
    if (E.sky_on) {
      float gtsky = 0.0f;
      for (int k = 0; k < 3; ++k) {
        const float gem = grad[k] * I.th[k];
        gtsky += gem * (cam[kSkyT + k] - cam[kSkyB + k]);
        gs[kSkyT + k] += gem * I.tsky;
        gs[kSkyB + k] += gem * (1.0f - I.tsky);
      }
      gd[1] += 0.5f * gtsky;
    }
  } else {
    for (int k = 0; k < 3; ++k) ge[kGEm + k] += grad[k] * I.th[k];
    if (I.is_diel)
      dielectric_vjp(I, gsd, gsr, glp_inc, gn, gd, ge);
    else
      standard_vjp(I, gsd, gsr, glp_inc, gn, gd, ge);

    // ---- hit point and normal -------------------------------------------
    bool aux = false;
    if constexpr (kAux) {
      aux = I.kind != 0;
      if (aux)
        aux_hit_vjp(I, E.ent + (size_t)I.w * Layout<kTris, kAux>::ent,
                    E.t_min, gp, gn, go, gd, ge);
    }
    if (kTris && I.tri)
      tri_hit_vjp(I, gp, gn, go, gd, ge);
    else if (!aux)
      sphere_hit_vjp(I, gp, gn, go, gd, ge);
    if constexpr (kMotion) {  // c(t) = m t + c: the centre's times t
      for (int k = 0; k < 3; ++k) ge[kGMove + k] = ge[kGC + k] * I.ptime;
    }
    if constexpr (kTex) {
      // the albedo the scatter used came from the texture: its cotangent
      // goes to the checker's colour, or to the image's main colour and
      // texel, not to the packed albedo
      if (I.tex_kind == 1 || I.tex_kind == 2) {
        const int c0 = kGTex + (I.tex_kind == 1 ? 0 : 3);
        for (int k = 0; k < 3; ++k) {
          ge[c0 + k] = ge[kGAlb + k];
          ge[kGAlb + k] = 0.0f;
        }
      } else if (I.tex_kind == 3) {
        ge[kTexGradCols] = (float)I.texel;
        for (int k = 0; k < 3; ++k) {
          ge[kGTex + k] = ge[kGAlb + k] * I.texv[k];
          ge[kTexGradCols + 1 + k] = ge[kGAlb + k] * I.tmain[k];
          ge[kGAlb + k] = 0.0f;
        }
      }
    }
  }

  // ---- regen -------------------------------------------------------------
  if (I.regen) {
    float gq3[3], goff[3];
    norm3_vjp(I.q3, gd, gq3);
    float gun = 0.0f, gvn = 0.0f, grdx = 0.0f, grdy = 0.0f;
    for (int k = 0; k < 3; ++k) {
      gs[kCO + k] += go[k];
      goff[k] = go[k] - gq3[k];
      gs[kLL + k] += gq3[k];
      gs[kHH + k] += I.un * gq3[k];
      gun += cam[kHH + k] * gq3[k];
      gs[kVV + k] += I.vn * gq3[k];
      gvn += cam[kVV + k] * gq3[k];
      gs[kRR + k] += I.rdx * goff[k];
      gs[kUU + k] += I.rdy * goff[k];
      grdx += cam[kRR + k] * goff[k];
      grdy += cam[kUU + k] * goff[k];
    }
    gs[kLens] += (grdx * I.cth + grdy * I.sth) * I.sr3;
    // un = (pixel - py_row width + jx) / width, py_row a constant
    gs[kWidth] += gun * (-(E.py_row + I.un) / cam[kWidth]);
    gs[kHeight] += gvn * (-I.vn / cam[kHeight]);
    for (int k = 0; k < 3; ++k) {
      g[kOX + k] = g[kDX + k] = g[kTHX + k] = g[kRX + k] = 0.0f;
    }
    g[kLp] = 0.0f;
  } else {
    for (int k = 0; k < 3; ++k) {
      g[kOX + k] = go[k];
      g[kDX + k] = gd[k];
      g[kTHX + k] = gth[k];
      g[kRX + k] = grad[k];
    }
    g[kLp] = glp;
  }
  return I.hit ? I.w : -1;
}

// ---------------------------------------------------------------------------
// Paths: the tape scan and one path's backward
// ---------------------------------------------------------------------------
//
// The adjoint is local to a path.  A regen iteration overwrites o, d, th,
// rad, lp, valid and depth, so step_vjp passes them no cotangent; it never
// writes the cotangents of cs and cnt, which stay the lane's own from the
// first iteration to the last.  So each path (a regen, then one iteration
// a bounce until a miss, the depth limit or the tape's end) runs its
// backward alone from the regen state, its own tape codes and the lane's
// color and count cotangents: no checkpoint, nothing from another path.

// scan_lane and path_backward call their functors (device-only ones in the
// kernels, host-only ones in host_backward) from host-and-device code
#ifdef __CUDACC__
#define RTIW_EXEC_CHECK_OFF _Pragma("nv_exec_check_disable")
#else
#define RTIW_EXEC_CHECK_OFF
#endif

constexpr int kMaxDepth = 64;  // deepest trace_depth the path codes hold
// a path's states hold these: o, d, th, rad, lp, valid, depth
constexpr int kPathVars = 15;
// ... and in the volume builds the medium's 8
constexpr int kVolPathVars = kPathVars + 8;

RTIW_FN int path_var(int k) {
  return k < 12 ? k : k == 12 ? kLp : k == 13 ? kValid : kDepth;
}

// A path in the table: (lane, it0 * kMaxDepth + length - 1).
RTIW_FN int path_code(int it0, int len) { return it0 * kMaxDepth + len - 1; }

// Walks lane i's tape column by the plain replay's rules (regen when idle
// and started < per_pixel; a path ends at a miss, code < -0.5, or when its
// depth reaches trace_depth; the lane is done once it is idle with every
// sample started) and calls emit(it0, length) for each path, a path cut by
// the tape's end included.
RTIW_EXEC_CHECK_OFF
template <class Emit>
RTIW_FN void scan_lane(const float* tape, int n, int i, int iters,
                       float per_pixel, int trace_depth, Emit emit) {
  bool active = false;
  float started = 0.0f;
  int depth = 0, it0 = 0;
  for (int it = 0; it < iters; ++it) {
    if (!active) {
      if (!(started < per_pixel)) return;
      started += 1.0f;
      active = true;
      depth = 0;
      it0 = it;
    }
    depth += 1;
    if (!(tape[(size_t)it * n + i] >= -0.5f) || depth >= trace_depth) {
      emit(it0, it - it0 + 1);
      active = false;
    }
  }
  if (active) emit(it0, iters - it0);
}

// The state a path's first iteration reads: idle, nothing started (so it
// regenerates), the rest as the regen overwrites it.
RTIW_FN void path_start(float* st) {
  for (int k = 0; k < kStateVars; ++k) st[k] = 0.0f;
  st[kTHX] = st[kTHY] = st[kTHZ] = 1.0f;
}

// A path's history: the 15 path variables of the input states of its
// iterations 1..L-1, in slots 0..L-2 of a per-thread array (local memory
// on the card).
struct ArrayHist {
  float* a;
  RTIW_FN void store(int slot, const float* st) const {
#pragma unroll
    for (int k = 0; k < kPathVars; ++k)
      a[slot * kPathVars + k] = st[path_var(k)];
  }
  RTIW_FN void load(int slot, float* st) const {
#pragma unroll
    for (int k = 0; k < kPathVars; ++k)
      st[path_var(k)] = a[slot * kPathVars + k];
  }
};

// ... of a volume build: the path variables, then the medium.
struct VolHist {
  float* a;
  RTIW_FN void store(int slot, const float* st) const {
#pragma unroll
    for (int k = 0; k < kVolPathVars; ++k)
      a[slot * kVolPathVars + k] =
          st[k < kPathVars ? path_var(k) : kInId + k - kPathVars];
  }
  RTIW_FN void load(int slot, float* st) const {
#pragma unroll
    for (int k = 0; k < kVolPathVars; ++k)
      st[k < kPathVars ? path_var(k) : kInId + k - kPathVars] =
          a[slot * kVolPathVars + k];
  }
};

// One path's backward: lane `lane`, iterations it0 .. it0+len-1.  Runs the
// path forward once, keeping the input state of each iteration in `hist`,
// then applies step_vjp in reverse from the lane's color and count
// cotangents.  `steps` >= len is the longest path of the thread's warp:
// the reverse loop runs that many times so that every thread of a warp
// reaches add_ent (a warp collective on the card) together, a shorter
// path idle (w = -1) at its top steps.  gs receives the camera and sky
// cotangents; add_ent(w, ge) each step's winner row (w = -1: none).
// The motion build's shutter time is the path's from its regen on: the
// forward sets it in st[kPTime], and nothing after it resets that slot.
RTIW_EXEC_CHECK_OFF
template <bool kTris = false, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false, class Hist, class AddEnt>
RTIW_FN void path_backward(const float* tape, int n, int lane, int it0,
                           int len, int steps, const LaneEnv& E,
                           float cot_r, float cot_g, float cot_b,
                           float cot_count, const Hist& hist, float* gs,
                           AddEnt& add_ent) {
  constexpr int nv = kVol      ? kVolStateVars
                     : kMotion ? kMotionStateVars
                               : kStateVars;
  float st[nv];
  path_start(st);
  if constexpr (kVol || kMotion)
    for (int k = kStateVars; k < nv; ++k) st[k] = 0.0f;
  for (int j = 0; j + 1 < len; ++j) {
    step_forward<kTris, kAux, kVol, kMotion, kTex>(
        st, tape[(size_t)(it0 + j) * n + lane], it0 + j, E);
    hist.store(j, st);
  }
  float g[nv], ge[Layout<kTris, kAux, kMotion, kTex>::row];
  for (int k = 0; k < nv; ++k) g[k] = 0.0f;
  g[kCSX] = cot_r;
  g[kCSY] = cot_g;
  g[kCSZ] = cot_b;
  g[kCnt] = cot_count;
  for (int j = steps - 1; j >= 0; --j) {
    int w = -1;
    if (j < len) {
      path_start(st);
      if (j > 0) {  // mid-path: active, so started is not read
        hist.load(j - 1, st);
        st[kActive] = 1.0f;
      }
      w = step_vjp<kTris, kAux, kVol, kMotion, kTex>(
          st, g, tape[(size_t)(it0 + j) * n + lane], it0 + j, E, ge, gs);
    }
    add_ent(w, ge);
  }
}

RTIW_FN void add_row(float* row, const float* ge, int cols) {
  for (int k = 0; k < cols; ++k) {
    if (ge[k] == 0.0f) continue;
#ifdef __CUDA_ARCH__
    atomicAdd(row + k, ge[k]);
#else
    row[k] += ge[k];
#endif
  }
}

// Adds a winner row's cotangent into the (rows, kGradCols) table `base`
// (w < 0: no winner).
struct EntityAdd {
  float* base;
  RTIW_FN void operator()(int w, const float* ge) const {
    if (w >= 0) add_row(base + w * kGradCols, ge, kGradCols);
  }
};

// The motion build: (rows, kMotionGradCols) rows, the move offsets' last.
struct MotionEntityAdd {
  float* base;
  RTIW_FN void operator()(int w, const float* ge) const {
    if (w >= 0) add_row(base + w * kMotionGradCols, ge, kMotionGradCols);
  }
};

// The texture build: (rows, kTexGradCols) rows, the texture colours'
// last, and the texel's cotangent into the (A * H * W, 3) plane `texels`.
struct TexEntityAdd {
  float* base;
  float* texels;
  RTIW_FN void operator()(int w, const float* ge) const {
    if (w < 0) return;
    add_row(base + w * kTexGradCols, ge, kTexGradCols);
    if (ge[kTexGradCols] >= 0.0f)
      add_row(texels + (size_t)ge[kTexGradCols] * 3, ge + kTexGradCols + 1,
              3);
  }
};

// Mesh scenes: spheres as EntityAdd; a triangle (code w >= tri_base, the
// padded sphere count) into the (T_pad, kTriGradCols) table `tri`, in
// device memory on the card (4096 rows of 28 floats do not fit in shared
// memory).
struct MeshEntityAdd {
  float* base;
  float* tri;
  int tri_base;
  RTIW_FN void operator()(int w, const float* ge) const {
    if (w >= tri_base)
      add_row(tri + (size_t)(w - tri_base) * kTriGradCols, ge, kTriGradCols);
    else if (w >= 0)
      add_row(base + w * kGradCols, ge, kGradCols);
  }
};

// Scenes with rects or boxes: spheres as EntityAdd; a rect or box (code w
// >= aux_base, the padded sphere count) into the (R_pad + B_pad,
// kAuxGradCols) table `aux`.
struct AuxEntityAdd {
  float* base;
  float* aux;
  int aux_base;
  RTIW_FN void operator()(int w, const float* ge) const {
    if (w >= aux_base)
      add_row(aux + (size_t)(w - aux_base) * kAuxGradCols, ge, kAuxGradCols);
    else if (w >= 0)
      add_row(base + w * kGradCols, ge, kGradCols);
  }
};

#ifndef __CUDACC__
// The kernels' schedule on the host, one thread at a time: the scan counts
// the paths of each length, the grouping lays the lengths out longest
// first, the scan again scatters each path to its place, and the paths'
// backwards run in that order, each sum added in place (dscal: the camera
// and sky cotangents, kScal, and vol0's in the volume builds, kScalVol).
// `ent` is the entity table the tape indexes.
// `atlas` (img_w, img_h) is the texture build's image atlas.
template <bool kTris = false, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false, class AddEnt>
inline void host_backward(const float* tape, const float* lane_count,
                          const float* cam, const float* ent,
                          const float* cot, int n, int samples,
                          int trace_depth, int seed, int lane_base,
                          float t_min, int has_diel, int sky_on, int jitter,
                          float* dscal, AddEnt add_ent,
                          const float* atlas = nullptr, int img_w = 0,
                          int img_h = 0) {
  const int iters = samples * trace_depth;
  std::vector<long> offset(trace_depth, 0);
  for (int i = 0; i < n; ++i)
    scan_lane(tape, n, i, iters, lane_count[i], trace_depth,
              [&](int, int len) { ++offset[len - 1]; });
  long total = 0;
  for (int l = trace_depth - 1; l >= 0; --l) {
    const long c = offset[l];
    offset[l] = total;
    total += c;
  }
  std::vector<int> paths(2 * total);
  for (int i = 0; i < n; ++i)
    scan_lane(tape, n, i, iters, lane_count[i], trace_depth,
              [&](int it0, int len) {
                const long p = offset[len - 1]++;
                paths[2 * p] = i;
                paths[2 * p + 1] = path_code(it0, len);
              });
  std::vector<float> hist((size_t)(kVol ? kVolPathVars : kPathVars) *
                          trace_depth);
  const std::conditional_t<kVol, VolHist, ArrayHist> h{hist.data()};
  for (long p = 0; p < total; ++p) {
    const int lane = paths[2 * p], code = paths[2 * p + 1];
    const int len = code % kMaxDepth + 1;
    LaneEnvTex E;
    static_cast<LaneEnv&>(E) =
        make_lane_env(cam, ent, lane, lane_count[lane], seed, lane_base,
                      trace_depth, t_min, has_diel, sky_on, jitter);
    E.atlas = atlas;
    E.img_w = img_w;
    E.img_h = img_h;
    path_backward<kTris, kAux, kVol, kMotion, kTex>(
        tape, n, lane, code / kMaxDepth, len, len, E, cot[lane],
        cot[n + lane], cot[2 * n + lane], cot[3 * n + lane], h, dscal,
        add_ent);
  }
}
#endif

}  // namespace rtiw
