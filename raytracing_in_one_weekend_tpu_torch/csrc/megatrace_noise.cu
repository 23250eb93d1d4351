// The batch kernel's noise builds (ROADMAP steps 11 and 11b): the entry
// points of the builds a sampler flavor takes (blue or spatio-temporal
// blue noise), each build of megatrace_batch.cu with the kNoise flag
// (the sphere kernel's sphere, aux, volume, motion, texture, cube and
// blocked builds in any mix they take, the triangle build, the streamed
// kernel, and the aux and volume builds of those two).  Their kernels are
// megatrace_batch.cuh's, instantiated here only, so this source compiles
// beside megatrace_batch.cu.  Replaces:
// ops/pallas_megatrace.py::_batch_kernel of the JAX package, its
// noise-table arm (pack_noise_tables :2126, _stbn_rows :2366, _cp_rotate
// :2444, their uses :2625-2822) and pre-drawn rows, in each of its arms.
// Plain version: ops/megatrace.py::sample_batch_reference with the
// noise_* arguments.  What bounds them: the builds they extend (the
// sweeps' ALU work); a flavored draw adds a texel load through the
// read-only cache and ~15 flops (megatrace_batch.cu's header).

#include "megatrace_batch.cuh"

// sizeof(NoiseScene), for the caller's check of its copy of the layout.
extern "C" int rtiw_noise_scene_bytes() {
  return static_cast<int>(sizeof(NoiseScene));
}

// rtiw_megatrace_batch's noise builds (tri_rows > 0: the triangle build's,
// the tables or the pre-drawn rows; with tri_supers > 0 the streamed
// kernel's, the pre-drawn rows only): its arguments, then `noise` (see
// noise_usable).  No tape.  cudaErrorInvalidValue for unusable noise
// inputs, a sphere-only request or the streamed kernel with tables.
extern "C" int rtiw_megatrace_batch_noise(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const float* tri_geo, const float* tri_aabb, const float* tri_sup,
    const float* tri_rec, float* out, int n, int s, int tri_rows,
    int tri_blocks, int tri_supers, int tri_code_base, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, const NoiseScene* noise,
    void* stream) {
  if (n > 0 && !noise_usable(noise))
    return static_cast<int>(cudaErrorInvalidValue);
  return batch_launch<true>(
      lane_count, count_in, pixel_index, consts, sph, rec, tri_geo, tri_aabb,
      tri_sup, tri_rec, out, nullptr, n, s, tri_rows, tri_blocks, tri_supers,
      tri_code_base, seed, lane_base, samples, trace_depth, t_min,
      has_dielectrics, sky_on, jitter,
      n > 0 ? noise_of(noise, samples, n) : NoiseScene{}, stream);
}

// rtiw_megatrace_tri_aux's noise builds (the aux builds of the triangle
// build, tables or pre-drawn rows, and of the streamed kernel, pre-drawn
// rows only): its arguments but the tape, then `noise` (see
// noise_usable).  No tape.
extern "C" int rtiw_megatrace_tri_aux_noise(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const float* tri_geo, const float* tri_aabb, const float* tri_sup,
    const float* tri_rec, float* out, int n, int s, int tri_rows,
    int tri_blocks, int tri_supers, int tri_code_base, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, const float* aux_geo,
    const float* aux_rec, int rect_rows, int box_rows, int rect_code,
    int box_code, const NoiseScene* noise, void* stream) {
  if ((n > 0 && !noise_usable(noise)) || rect_rows + box_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return batch_launch<true>(
      lane_count, count_in, pixel_index, consts, sph, rec, tri_geo, tri_aabb,
      tri_sup, tri_rec, out, nullptr, n, s, tri_rows, tri_blocks, tri_supers,
      tri_code_base, seed, lane_base, samples, trace_depth, t_min,
      has_dielectrics, sky_on, jitter,
      n > 0 ? noise_of(noise, samples, n) : NoiseScene{}, stream,
      AuxRows{aux_geo, aux_rec, rect_rows, box_rows, rect_code, box_code});
}

// rtiw_megatrace_tri_vol's noise builds (the volume builds of the
// triangle build, tables or pre-drawn rows, and of the streamed kernel,
// pre-drawn rows only; rect and box rows or none): its arguments but the
// tape, then `noise` (see noise_usable).  No tape.
extern "C" int rtiw_megatrace_tri_vol_noise(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const float* tri_geo, const float* tri_aabb, const float* tri_sup,
    const float* tri_rec, float* out, int n, int s, int tri_rows,
    int tri_blocks, int tri_supers, int tri_code_base, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, const float* aux_geo,
    const float* aux_rec, int rect_rows, int box_rows, int rect_code,
    int box_code, const NoiseScene* noise, void* stream) {
  if ((n > 0 && !noise_usable(noise)) || rect_rows < 0 || box_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return batch_launch<true>(
      lane_count, count_in, pixel_index, consts, sph, rec, tri_geo, tri_aabb,
      tri_sup, tri_rec, out, nullptr, n, s, tri_rows, tri_blocks, tri_supers,
      tri_code_base, seed, lane_base, samples, trace_depth, t_min,
      has_dielectrics, sky_on, jitter,
      n > 0 ? noise_of(noise, samples, n) : NoiseScene{}, stream,
      AuxRows{aux_geo, aux_rec, rect_rows, box_rows, rect_code, box_code},
      true);
}

// The noise builds of the sphere kernel but the blocked ones (a sampler
// flavor, ops/megatrace.py::sample_batch's noise_* arguments): with no
// rect, box, volume, motion, texture or cube tables the sphere build's,
// else rtiw_megatrace_ext's build of them; its arguments but the tape,
// then `noise` (see noise_usable: the in-kernel tables or the pre-drawn
// rows).  Lane i renders pixel i; no tape.  cudaErrorInvalidValue for
// unusable noise inputs.
extern "C" int rtiw_megatrace_ext_noise(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, const float* aux_geo,
    const float* aux_rec, float* out, int n, int s, int rect_rows,
    int box_rows, int rect_code, int box_code, int seed, int lane_base,
    int samples, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int jitter, int has_vol, const float* move,
    const float* tex_rec, const float* perlin, const float* atlas, int img_w,
    int img_h, const float* cube, int cube_w, int cube_h,
    const NoiseScene* noise, void* stream) {
  if (n > 0 && !noise_usable(noise))
    return static_cast<int>(cudaErrorInvalidValue);
  return ext_launch<true>(
      lane_count, count_in, consts, sph, rec, aux_geo, aux_rec, out, nullptr,
      n, s, rect_rows, box_rows, rect_code, box_code, seed, lane_base,
      samples, trace_depth, t_min, has_dielectrics, sky_on, jitter, has_vol,
      move, tex_rec, perlin, atlas, img_w, img_h, cube, cube_w, cube_h,
      n > 0 ? noise_of(noise, samples, n) : NoiseScene{}, stream);
}

// The blocked builds' noise builds: rtiw_megatrace_blocked's arguments but
// the tape, then `noise` (see noise_usable).  Lane i renders pixel i, the
// pre-drawn rows' column i; no tape.
extern "C" int rtiw_megatrace_blocked_noise(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, const float* boxes,
    const float* move, float* out, int n, int s, int blocks, int rows,
    int seed, int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, const NoiseScene* noise,
    void* stream) {
  if (n > 0 && !noise_usable(noise))
    return static_cast<int>(cudaErrorInvalidValue);
  return blocked_launch<true>(
      lane_count, count_in, consts, sph, rec, boxes, move, out, nullptr, n,
      s, blocks, rows, seed, lane_base, samples, trace_depth, t_min,
      has_dielectrics, sky_on, jitter,
      n > 0 ? noise_of(noise, samples, n) : NoiseScene{}, stream);
}

// build_info of the noise builds (tri 1: the triangle build's, tri 2: the
// streamed kernel's, each with aux_rows > 0 its aux build's).
extern "C" int rtiw_megatrace_noise_info(int s, int aux_rows, int has_vol,
                                         int has_motion, int has_tex,
                                         int blocks, int has_cube, int tri,
                                         int* info) {
  return build_info<true>(s, aux_rows, has_vol, has_motion, has_tex, blocks,
                          has_cube, tri, info);
}
