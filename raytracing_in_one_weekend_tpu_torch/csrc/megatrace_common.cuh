// Per-lane math shared by the forward batch kernel (megatrace_batch.cu) and
// the backward kernel (megatrace_bwd.cu), under one precision contract with
// their plain PyTorch versions (ops/megatrace.py): no --use_fast_math,
// -fmad=false, fmaf exactly where written; sqrtf is IEEE, and rsqrt, sin,
// cos and the volume walk's log are taken in FP64 and rounded once
// (correctly rounded).
//
// The helpers are host-and-device functions: the same lane code also
// compiles as plain C++ (RTIW_FN is `inline` there), which lets a host
// build check it against the plain versions without a card.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RTIW_FN __host__ __device__ __forceinline__
#else
#define RTIW_FN inline
#endif

namespace rtiw {

constexpr float kBig = 1e30f;
constexpr float kSelfEps = 1e-3f;  // Ray.OffsetTowards epsilon (Ray.cs:19)
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPiF = 3.141592653589793f;
constexpr float kHalfInvPiF = (float)(0.5 / 3.141592653589793);
constexpr float kInvPiF = (float)(1.0 / 3.141592653589793);
constexpr float kInv2_24 = 1.0f / 16777216.0f;
constexpr float kPlasticIor = 1.5f;
constexpr float kIorSpan = (float)(1.1 - 1.5);  // METAL_IOR - PLASTIC_IOR
constexpr uint32_t kSaltStep = 1013904223u;
constexpr uint32_t kSaltBounce = 7919u;

RTIW_FN float rsqrt_cr(float x) {
  return (float)(1.0 / sqrt((double)x));
}
RTIW_FN float sin_cr(float x) { return (float)sin((double)x); }
RTIW_FN float cos_cr(float x) { return (float)cos((double)x); }
RTIW_FN float log_cr(float x) { return (float)log((double)x); }
RTIW_FN float atan2_cr(float y, float x) {
  return (float)atan2((double)y, (double)x);
}
RTIW_FN float acos_cr(float x) { return (float)acos((double)x); }

RTIW_FN float dot3(float ax, float ay, float az, float bx, float by,
                  float bz) {
  return fmaf(az, bz, fmaf(ax, bx, ay * by));
}

RTIW_FN void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrt_cr(fmaxf(dot3(x, y, z, x, y, z), 1e-12f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// lowbias32 integer hash (public-domain constants).
RTIW_FN uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// U[0,1) with 24 mantissa bits for stream k; base = seed + lane*9781 +
// salt (all mod 2^32, as the JAX kernels' wrapping int32 sums).
RTIW_FN float uniform(uint32_t base, int k) {
  return (float)(lowbias32(base + (uint32_t)k * 6271u) >> 8) * kInv2_24;
}

// Cosine-weighted hemisphere direction about unit n (Duff et al. basis).
RTIW_FN void cosine_hemisphere(
    float u, float v, float nx, float ny, float nz,
    float& ox, float& oy, float& oz) {
  const float r = sqrtf(u);
  const float th = v * kTwoPi;
  const float x = r * cos_cr(th);
  const float z = r * sin_cr(th);
  const float y = sqrtf(fmaxf(1.0f - u, 0.0f));
  const float sign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + nz);
  const float b = nx * ny * a;
  const float tx = fmaf(sign * nx * nx, a, 1.0f), ty = sign * b,
              tz = -sign * nx;
  const float bx = b, by = fmaf(ny * ny, a, sign), bz = -ny;
  ox = fmaf(z, bx, fmaf(x, tx, y * nx));
  oy = fmaf(z, by, fmaf(x, ty, y * ny));
  oz = fmaf(z, bz, fmaf(x, tz, y * nz));
}

RTIW_FN float schlick(float cosine, float ior) {
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  const float m = fmaxf(1.0f - cosine, 0.0f);
  return fmaf((1.0f - r0) * m * m * m * m, m, r0);
}

RTIW_FN float roughness_to_alpha(float roughness) {
  const float x = logf(fmaxf(roughness, 1e-3f));
  return 1.62142f + 0.819955f * x + 0.1734f * x * x +
         0.0171201f * x * x * x + 0.000640711f * x * x * x * x;
}

// Möller–Trumbore (HitTests.cs:116-150) of the ray (o, d) against the
// triangle (edge_a, edge_b, vert0): t, or kBig without a hit (det == 0
// takes inv_det = 1 and never hits), and the barycentrics (u, v).  The
// products XLA's CPU compile contracts are fused (a cross product's
// x*y - z*w is fmaf(x, y, -(z*w)), a 3-dot is dot3); plain version:
// ops/megatrace.py::moller_trumbore.
RTIW_FN float moller_trumbore(float ox, float oy, float oz, float dx,
                              float dy, float dz, float eax, float eay,
                              float eaz, float ebx, float eby, float ebz,
                              float v0x, float v0y, float v0z, float t_min,
                              float& u, float& v) {
  const float pvx = fmaf(dy, eaz, -(dz * eay));
  const float pvy = fmaf(dz, eax, -(dx * eaz));
  const float pvz = fmaf(dx, eay, -(dy * eax));
  const float det = dot3(ebx, eby, ebz, pvx, pvy, pvz);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  u = dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv_det;
  const float qvx = fmaf(tvy, ebz, -(tvz * eby));
  const float qvy = fmaf(tvz, ebx, -(tvx * ebz));
  const float qvz = fmaf(tvx, eby, -(tvy * ebx));
  v = dot3(dx, dy, dz, qvx, qvy, qvz) * inv_det;
  const float t = dot3(eax, eay, eaz, qvx, qvy, qvz) * inv_det;
  const bool ok = det != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  (u + v) <= 1.0f && t > t_min;
  return ok ? t : kBig;
}

// 1 / c with |c| floored at 1e-12: the AABB slab test's inverse.
RTIW_FN float inv_dir(float c) {
  return 1.0f / (fabsf(c) < 1e-12f ? (c >= 0.0f ? 1e-12f : -1e-12f) : c);
}

// Barycentric lerp of the vertex normals n0, n1, n2 (each 3 floats),
// normalised after the lerp (Entity.cs:65).
RTIW_FN void tri_normal(const float* n0, const float* n1, const float* n2,
                        float u, float v, float& nx, float& ny, float& nz) {
  const float w0 = 1.0f - u - v;
  const float tx = fmaf(n2[0], v, fmaf(n0[0], w0, n1[0] * u));
  const float ty = fmaf(n2[1], v, fmaf(n0[1], w0, n1[1] * u));
  const float tz = fmaf(n2[2], v, fmaf(n0[2], w0, n1[2] * u));
  const float inv = rsqrt_cr(fmaxf(dot3(tx, ty, tz, tx, ty, tz), 1e-24f));
  nx = tx * inv;
  ny = ty * inv;
  nz = tz * inv;
}

// v rotated by the quaternion (qx, qy, qz, qw): t = 2 q_v x v, v + w t +
// q_v x t, with the products the JAX kernel's CPU compile contracts fused
// (a cross product's x*y - z*w is fmaf(x, y, -(z*w)), v + w t is
// fmaf(w, t, v)); plain version: ops/megatrace.py::_quat_rotate.  The
// frame of a rect or box is entered with the conjugate (-qx, -qy, -qz,
// qw).
RTIW_FN void quat_rotate(float qx, float qy, float qz, float qw, float vx,
                         float vy, float vz, float* r) {
  const float tx = 2.0f * fmaf(qy, vz, -(qz * vy));
  const float ty = 2.0f * fmaf(qz, vx, -(qx * vz));
  const float tz = 2.0f * fmaf(qx, vy, -(qy * vx));
  r[0] = fmaf(qw, tx, vx) + fmaf(qy, tz, -(qz * ty));
  r[1] = fmaf(qw, ty, vy) + fmaf(qz, tx, -(qx * tz));
  r[2] = fmaf(qw, tz, vz) + fmaf(qx, ty, -(qy * tx));
}

// A rect's or box's kernel row, 12 floats (pack_aux_tables' geo columns
// 0-11): quat xyzw | pos | rect: xy_from, xy_to; box: extents.
// The ray (o, d) in the entity's frame: ol = q* (o - pos), dl = q* d.
RTIW_FN void aux_frame(const float* o, const float* d, const float* g,
                       float* ol, float* dl) {
  quat_rotate(-g[0], -g[1], -g[2], g[3], o[0] - g[4], o[1] - g[5],
              o[2] - g[6], ol);
  quat_rotate(-g[0], -g[1], -g[2], g[3], d[0], d[1], d[2], dl);
}

// One-sided local-XY rect (HitTests.cs:62-78): t = -ol.z / dl.z (dl.z == 0
// divides by 1), a hit only from the front (dl.z < 0), after t_min, with
// the local hit point inside [from, to]; kBig otherwise.  Plain version:
// ops/megatrace.py::rect_test.
RTIW_FN float rect_test(const float* o, const float* d, const float* g,
                        float t_min) {
  float ol[3], dl[3];
  aux_frame(o, d, g, ol, dl);
  const float t = -ol[2] / (dl[2] == 0.0f ? 1.0f : dl[2]);
  const float hx = fmaf(t, dl[0], ol[0]);
  const float hy = fmaf(t, dl[1], ol[1]);
  const bool ok = dl[2] < 0.0f && t > t_min && hx >= g[7] && hx <= g[9] &&
                  hy >= g[8] && hy <= g[10];
  return ok ? t : kBig;
}

RTIW_FN float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// The Majercik box test's terms (HitTests.cs:81-113) for the ray in the
// box frame (bo = ol + dl t_min, dl): each face's plane distance dp (with
// the inside/outside winding, -1 from inside) and the face whose hit lies
// within the other two extents, the first of x, y, z (-1: none).  Plain
// version: ops/megatrace.py::box_parts.
RTIW_FN int box_face(const float* bo, const float* dl, const float* ext,
                     float* dp, float& winding) {
  const float rel = fmaxf(fabsf(bo[0]) / fmaxf(ext[0], 1e-30f),
                          fmaxf(fabsf(bo[1]) / fmaxf(ext[1], 1e-30f),
                                fabsf(bo[2]) / fmaxf(ext[2], 1e-30f)));
  winding = rel < 1.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 3; ++k)
    dp[k] = (ext[k] * winding * -sign_of(dl[k]) - bo[k]) /
            (dl[k] == 0.0f ? 1e-30f : dl[k]);
  for (int a = 0; a < 3; ++a) {
    const int u = (a + 1) % 3, v = (a + 2) % 3;
    if (dp[a] >= 0.0f && fabsf(fmaf(dl[u], dp[a], bo[u])) < ext[u] &&
        fabsf(fmaf(dl[v], dp[a], bo[v])) < ext[v])
      return a;
  }
  return -1;
}

// The box test: t of the ray (o, d) against the box row g, kBig on a miss.
RTIW_FN float box_test(const float* o, const float* d, const float* g,
                       float t_min) {
  float bo[3], dl[3], dp[3], winding;
  aux_frame(o, d, g, bo, dl);
  for (int k = 0; k < 3; ++k) bo[k] = fmaf(dl[k], t_min, bo[k]);
  const int a = box_face(bo, dl, g + 7, dp, winding);
  return a < 0 ? kBig : dp[a] + t_min;
}

// The world normal of the box row g at its surface point p: the local face
// of the dominant |p_local| / extent axis (extents floored at 1e-12, the
// first axis on a tie, sign(0) = 0), rotated back (plain version:
// ops/megatrace.py::box_normal).  Writes the local normal to ln.
RTIW_FN void box_normal(const float* p, const float* g, float* ln,
                        float* n) {
  float pl[3], re[3];
  quat_rotate(-g[0], -g[1], -g[2], g[3], p[0] - g[4], p[1] - g[5],
              p[2] - g[6], pl);
  for (int k = 0; k < 3; ++k) re[k] = fabsf(pl[k]) / fmaxf(g[7 + k], 1e-12f);
  const int a = (re[0] >= re[1] && re[0] >= re[2]) ? 0 : re[1] >= re[2] ? 1
                                                                         : 2;
  for (int k = 0; k < 3; ++k) ln[k] = k == a ? sign_of(pl[k]) : 0.0f;
  quat_rotate(g[0], g[1], g[2], g[3], ln[0], ln[1], ln[2], n);
}

// min and max that return NaN when either argument is NaN, as
// torch.minimum and torch.maximum do (fminf and fmaxf return the other).
RTIW_FN float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
RTIW_FN float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// The slabs of the box row g for the ray (o, d): the JAX kernel's slab
// exit (:637-660) for the volume walk.  In the box frame, offset by t_min
// as in box_test (bo = ol + dl t_min), axis k's two slab distances are
// (-+ext_k - bo_k) * inv_k, inv_k = 1 / dl_k; an axis the ray runs
// parallel to takes inv = inf (parallel_inf, the forward kernel's) or
// 1 / 1e-30 (the tape replay's, whose adjoint must stay finite).  Returns
// the exit, the least far distance + t_min, or kBig when it is at or
// before t_min or after the greatest near one; `axis` and `hi` name the
// far distance taken (hi: the +ext side), and bo, dl, inv are kept for
// the adjoint.  Plain version: ops/megatrace.py::box_exit.
RTIW_FN float box_exit(const float* o, const float* d, const float* g,
                       float t_min, bool parallel_inf, float* bo, float* dl,
                       float* inv, int& axis, bool& hi) {
  aux_frame(o, d, g, bo, dl);
  float near = 0.0f, far = 0.0f;
  for (int k = 2; k >= 0; --k) {
    bo[k] = fmaf(dl[k], t_min, bo[k]);
    inv[k] = 1.0f / (dl[k] == 0.0f ? 1e-30f : dl[k]);
    if (parallel_inf && dl[k] == 0.0f) inv[k] = INFINITY;
    const float t0 = (-g[7 + k] - bo[k]) * inv[k];
    const float t1 = (g[7 + k] - bo[k]) * inv[k];
    const float lo = min_nan(t0, t1), h = max_nan(t0, t1);
    if (k == 2 || h < far) {
      axis = k;
      hi = !(t0 > t1);
    }
    near = k == 2 ? lo : max_nan(lo, near);
    far = k == 2 ? h : min_nan(h, far);
  }
  const float b_far = far + t_min;
  return (b_far > t_min && near + t_min < b_far) ? b_far : kBig;
}

RTIW_FN float smith_masking(float cos_theta, float roughness) {
  const float sq_cos = cos_theta * cos_theta;
  const float sq_sin = fmaxf(1.0f - sq_cos, 0.0f);
  const bool degenerate = sq_cos < 1e-12f;
  const float safe = degenerate ? 1.0f : sq_cos;
  const float sq_tan = (degenerate ? 0.0f : sq_sin) / safe;
  const float alpha = roughness_to_alpha(roughness);
  float lam = (-1.0f + sqrtf(fmaf(alpha * alpha, sq_tan, 1.0f))) / 2.0f;
  lam = degenerate ? 0.0f : lam;
  return 1.0f / (1.0f + lam);
}

// The nearest texel of a cubemap of w x h faces (+x, -x, +y, -y, +z, -z,
// each h rows of w texels) along the direction (dx, dy, dz): its index
// (face * h + y) * w + x (ops/megatrace.py::cube_texels, through
// core/environment.py::cubemap_index, the JAX package's _sample_cubemap,
// Texture.cs:172-210): the major axis (ties to x, then y), the face's
// numerators, one IEEE division by the major component, then
// min(int((uv + 1) * (size / 2)), size - 1).  No hardware cubemap fetch:
// its face select and coordinates are not these float32 operations, and a
// direction on a face or texel edge would pick another texel.
RTIW_FN int cube_texel(float dx, float dy, float dz, int w, int h) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const bool use_x = ax >= ay && ax >= az;
  const bool use_y = ay > ax && ay >= az;
  const bool pos = use_x ? dx >= 0.0f : use_y ? dy >= 0.0f : dz >= 0.0f;
  const float u_num = use_x   ? (dx >= 0.0f ? -dz : dz)
                      : use_y ? dx
                              : (dz >= 0.0f ? dx : -dx);
  const float v_num = use_x ? -dy : use_y ? (dy >= 0.0f ? dz : -dz) : -dy;
  const float major = fmaxf(use_x ? ax : use_y ? ay : az, 1e-12f);
  int cx = (int)((u_num / major + 1.0f) * ((float)w * 0.5f));
  int cy = (int)((v_num / major + 1.0f) * ((float)h * 0.5f));
  cx = cx < 0 ? 0 : cx > w - 1 ? w - 1 : cx;
  cy = cy < 0 ? 0 : cy > h - 1 ? h - 1 : cy;
  const int face = (use_x ? 0 : use_y ? 2 : 4) + (pos ? 0 : 1);
  return (face * h + cy) * w + cx;
}

}  // namespace rtiw
