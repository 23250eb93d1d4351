// Fused sample-batch path tracer for Hopper (sm_90a): one whole
// SampleBatchJob per launch, sphere scenes of any sphere count (white
// noise, or a sampler flavor's tables), scenes with
// rects and boxes
// (with or without spheres), convex volumes, moving spheres and textured
// albedos beside either, and mesh scenes of at most TRI_STREAM_MAX
// triangles (with or without spheres, rects and boxes), gradient or no
// sky; a cubemap sky beside spheres alone or beside one of rects and
// boxes, volumes, motion and textures.
//
// Replaces: ops/pallas_megatrace.py::_batch_kernel of the JAX package, its
// sphere arm (the dense and the blocked sweep), its rect/box arm, its convex-volume arm, its motion and
// texture arms, its cubemap branch (:1372-1416), its noise-table arm
// (pack_noise_tables :2126, _stbn_rows :2366, _cp_rotate :2444, their uses
// :2625-2822) and pre-drawn rows, its triangle (VMEM) arm
// and its streamed-triangle arm, each with its convex-volume walk
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
// Sphere scenes of more than SPH_CULL_MIN = 1024 spheres take the blocked
// builds (kBlocked, static or with kMotion; the JAX kernel's blocked
// sweep, :433-527).  sphere_field's 4,099 spheres are 65.6 KB of
// geometry, which shared memory holds only at one to three blocks an SM,
// and a scene of 16k spheres not at all; the table stays in L2 (50 MB).
// So each block stages only the AABBs of the Morton-sorted table's blocks
// of blk_rows rows (pack_sphere_blocks: 32 bytes a block), and a lane
// sweeps a block's rows (sphere_sweep_steps' run, read through the
// read-only cache) only when its ray meets the block's box before its
// best hit so far.  The 8x4 pixel tiles of a warp give the cull the
// coherence JAX buys with Morton lanes.  Measured on sphere_field
// (PERF.md §6, the blocked sweep): 64 rows a block against 32, 128 and
// 256; the per-lane test against a warp vote; __ldg against staging a
// kept block per warp in shared memory; 6 blocks an SM against 5.
//
// A sampler flavor (blue or spatio-temporal blue noise, ROADMAP steps 11
// and 11b) takes the noise builds: kNoise, the last flag of the sphere
// kernel (each of its builds: sphere, aux, volume, motion, texture, cube
// and blocked), of the triangle build and of the streamed kernel; the
// builds without it compile none of it and keep their SASS.  The JAX
// kernel fetches a tile row a pixel row and rotates it by a one-hot
// matmul; here each lane reads its own texel, tile[t, (py + offy) % S,
// (px + offx) % S], through the read-only cache: the table is 128 KB
// (blue) or 512 KB (eight STBN slices), which L2 holds, and the lanes of
// a warp's pixel tile read neighbouring texels.  A regen's four camera
// draws (and a moving scene's shutter time, purpose 9), and with a scalar
// set the bounce's seven scatter draws, cost a texel load and ~15 flops
// each against the ~8,700 flops of a cover bounce's sweep.  The pre-drawn
// route (widths the tile side does not divide, and the Morton-lane
// classes: more than SPH_CULL_MIN spheres, streamed meshes) reads each
// lane's row of the (4 * samples) x n camera draws and (3 * samples) x n
// first-bounce cosines instead, its column the lane's (the renderer
// permutes the columns with the lanes); the streamed kernel takes only
// these.

// A cubemap sky takes the cube builds (kCube, the last flag: the sphere
// build's, and the aux, volume, motion and texture builds' each with it;
// the builds without it compile none of it and keep their SASS).  A miss
// picks its texel by the plain version's float32 operations
// (megatrace_common.cuh::cube_texel: ~25 operations, once a path) and reads
// it from device memory through the read-only cache, as the atlas texel
// is read: the faces are not staged (a 6 x 512 x 512 HDR map is 18.9 MB,
// which L2 holds and shared memory never does), and no hardware cubemap
// texture fetches them (its face select and coordinates are not IEEE
// float32, so an edge direction would take another texel than the plain
// version and the JAX package).
//
// Meshes of at most TRI_MAX triangles (beside spheres) take the triangle
// build, megatrace_tri_kernel.  What bounds it is ALU work in the
// Möller–Trumbore tests (~56 flops each, three times a sphere's; a bounce
// on mesh_showcase tests 243.6 of its 908 triangles in the blocks its ray
// cannot skip), and how much of it a warp's lanes share.  With one thread
// a lane walking the 192-row blocks, a warp ran a block's rows whenever
// any one of its lanes needed them: 0.34-0.40 of its lane slots tested a
// triangle (PERF.md §6).  Here the lanes still decide block by block, in
// index order, whether their ray meets the block's AABB before their best
// hit (the JAX kernel's per-tile skip, made per lane, as before), but
// their tests are dealt to the warp's 32 threads (tri_sweep_dealt): at
// each step a thread loads kTriRows rows and tests them against the ray of
// every lane that sweeps the block, so every slot runs a test of the
// index-order sweep.  A lane's best hit is one (t, row) key in shared
// memory lowered by atomicMin, so the winner is the index-order sweep's
// whatever order the tests run in (a strictly smaller t, the earlier row
// on a tie).  The warp leaves the loop when its last lane's samples end;
// until then a lane without a sample only joins the sweeps.  The rows are
// read through the read-only cache: a table of TRI_MAX rows is 196.6 KB,
// which shared memory holds at one block an SM, and the copy a block would
// make measured slower than L1 on mesh_showcase (PERF.md §6).  The
// kTriRows tests of a ray are independent chains that hide each other's
// latency.  As in the sphere build, the camera row, sky and accumulators
// sit in shared memory under a register budget (kTriBlocks blocks an SM,
// no spills).  Thread i runs lane i: the dealt tests cost the same
// whichever lanes share a warp, and the sphere build's 8x4 tiles measured
// slower here (PERF.md §6).
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

// Convex volumes beside a mesh (ROADMAP step 7.2b; book 2's smoke beside a
// scanned mesh) take the volume builds of the triangle build and the
// streamed kernel (kVol, their last flag, with or without kAux; the
// builds without it compile none of it and keep their SASS).  A lane
// carries its medium as the sphere kernel's volume builds do, reset at
// each regen from vol0 (the constants' 32-39).  The sweeps and their culls
// are unchanged (the triangle sweep culls by the nearest sphere, rect or
// box, as in the JAX kernel: the walk shortens nothing before it); after
// them the winner's exit distance is computed once (exit_of: a sphere's
// far root, a box's slab exit, none for a rect or a triangle, which has
// no interior), and shade walks the medium.  A segment inside a medium
// that ends at a triangle scatters in it or survives to the surface.
//
// Rects and boxes beside a mesh (ROADMAP step 7.1b; a Cornell box with a
// mesh in it) take the aux builds of the triangle build and the streamed
// kernel (kAux, their last flag; the builds without it compile none of it
// and keep their SASS).  Each block stages the rect and box rows after
// the spheres, as the sphere kernel's aux build does (stage_aux), and a
// lane sweeps them (aux_sweep, ~75 flops a rect, ~120 a box) after its
// spheres and before its triangles: the triangle sweep's culls then test
// each block's AABB against the nearest of the spheres, rects and boxes,
// and a triangle wins only with a strictly smaller t, in the JAX kernel's
// order (spheres, rects, boxes, triangles).  Its tape codes follow the
// padded spheres, rects and boxes (tri_code_base).  A mesh without
// spheres sweeps no sphere row: JAX's 128 pad spheres leave only their
// code offset.  The triangle build's aux build runs kTriAuxBlocks = 4
// blocks an SM, as the sphere kernel's aux build does.
//
// The kernels and the launch templates are megatrace_batch.cuh's; this
// source holds the white builds' entry points, megatrace_noise.cu the
// noise builds', so that the two compile in parallel.
#include "megatrace_batch.cuh"

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() right after the launch (or the error of
// setting the streamed kernel's shared memory, or cudaErrorInvalidValue
// for a request the streamed kernel does not take, or the error of
// setting the sphere build's shared memory).  tri_rows == 0 takes
// the sphere-only build; otherwise (the triangle build, or with tri_supers
// > 0 the streamed kernel) tri_geo holds (tri_rows, 12) floats,
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
  return batch_launch<false>(
      lane_count, count_in, pixel_index, consts, sph, rec, tri_geo, tri_aabb,
      tri_sup, tri_rec, out, tape, n, s, tri_rows, tri_blocks, tri_supers,
      tri_code_base, seed, lane_base, samples, trace_depth, t_min,
      has_dielectrics, sky_on, jitter, NoiseScene{}, stream);
}

// The aux builds of the triangle build and the streamed kernel (rects and
// boxes beside a mesh, with spheres or without): rtiw_megatrace_batch's
// arguments with tri_rows > 0, then aux_geo ((rect_rows + box_rows) x 16
// floats: pack_aux_tables' rect rows, then its box rows; 16-byte aligned)
// and aux_rec (as many 16-column records), the tape codes of rect row 0
// and box row 0, and at least one rect or box row; tri_code_base then
// follows the padded rects and boxes.  cudaErrorInvalidValue for a request
// without triangles or rows.
extern "C" int rtiw_megatrace_tri_aux(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const float* tri_geo, const float* tri_aabb, const float* tri_sup,
    const float* tri_rec, float* out, float* tape, int n, int s,
    int tri_rows, int tri_blocks, int tri_supers, int tri_code_base,
    int seed, int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, const float* aux_geo,
    const float* aux_rec, int rect_rows, int box_rows, int rect_code,
    int box_code, void* stream) {
  if (rect_rows + box_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return batch_launch<false>(
      lane_count, count_in, pixel_index, consts, sph, rec, tri_geo, tri_aabb,
      tri_sup, tri_rec, out, tape, n, s, tri_rows, tri_blocks, tri_supers,
      tri_code_base, seed, lane_base, samples, trace_depth, t_min,
      has_dielectrics, sky_on, jitter, NoiseScene{}, stream,
      AuxRows{aux_geo, aux_rec, rect_rows, box_rows, rect_code, box_code});
}

// The volume builds of the triangle build and the streamed kernel (convex
// volumes beside a mesh, with spheres or without, with rects and boxes or
// without): rtiw_megatrace_tri_aux's arguments, with `consts` kVolConsts
// floats (the camera row and sky, 2 pad, then the camera's medium vol0)
// and rect_rows + box_rows >= 0 (0: no rect or box sweep).
// cudaErrorInvalidValue for a request without triangles.
extern "C" int rtiw_megatrace_tri_vol(
    const float* lane_count, const float* count_in, const float* pixel_index,
    const float* consts, const float* sph, const float* rec,
    const float* tri_geo, const float* tri_aabb, const float* tri_sup,
    const float* tri_rec, float* out, float* tape, int n, int s,
    int tri_rows, int tri_blocks, int tri_supers, int tri_code_base,
    int seed, int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, const float* aux_geo,
    const float* aux_rec, int rect_rows, int box_rows, int rect_code,
    int box_code, void* stream) {
  if (rect_rows < 0 || box_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return batch_launch<false>(
      lane_count, count_in, pixel_index, consts, sph, rec, tri_geo, tri_aabb,
      tri_sup, tri_rec, out, tape, n, s, tri_rows, tri_blocks, tri_supers,
      tri_code_base, seed, lane_base, samples, trace_depth, t_min,
      has_dielectrics, sky_on, jitter, NoiseScene{}, stream,
      AuxRows{aux_geo, aux_rec, rect_rows, box_rows, rect_code, box_code},
      true);
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
// img_w x 3 floats) or null; `cube` ((6 * cube_h) x cube_w x 3 floats, the
// faces) or null: with a cube, at most one of the aux, volume, motion and
// texture tables (else cudaErrorInvalidValue).  Returns cudaGetLastError()
// after the launch, or the error of setting its shared memory.
extern "C" int rtiw_megatrace_ext(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, const float* aux_geo,
    const float* aux_rec, float* out, float* tape, int n, int s,
    int rect_rows, int box_rows, int rect_code, int box_code, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, int has_vol,
    const float* move, const float* tex_rec, const float* perlin,
    const float* atlas, int img_w, int img_h, const float* cube, int cube_w,
    int cube_h, void* stream) {
  return ext_launch<false>(
      lane_count, count_in, consts, sph, rec, aux_geo, aux_rec, out, tape, n,
      s, rect_rows, box_rows, rect_code, box_code, seed, lane_base, samples,
      trace_depth, t_min, has_dielectrics, sky_on, jitter, has_vol, move,
      tex_rec, perlin, atlas, img_w, img_h, cube, cube_w, cube_h,
      NoiseScene{}, stream);
}

// The blocked builds (blocked_launch).
extern "C" int rtiw_megatrace_blocked(
    const float* lane_count, const float* count_in, const float* consts,
    const float* sph, const float* rec, const float* boxes,
    const float* move, float* out, float* tape, int n, int s, int blocks,
    int rows, int seed, int lane_base, int samples, int trace_depth,
    float t_min, int has_dielectrics, int sky_on, int jitter,
    void* stream) {
  return blocked_launch<false>(lane_count, count_in, consts, sph, rec, boxes,
                               move, out, tape, n, s, blocks, rows, seed,
                               lane_base, samples, trace_depth, t_min,
                               has_dielectrics, sky_on, jitter, NoiseScene{},
                               stream);
}

// build_info of the white builds.
extern "C" int rtiw_megatrace_ext_info(int s, int aux_rows, int has_vol,
                                       int has_motion, int has_tex,
                                       int blocks, int has_cube, int* info) {
  return build_info<false>(s, aux_rows, has_vol, has_motion, has_tex, blocks,
                           has_cube, 0, info);
}

// sphere_info of the triangle build (megatrace_tri_kernel), or with
// `stream` the streamed kernel, beside an s-sphere table; with aux_rows >
// 0 its aux build's for that many rect and box rows; with has_vol its
// volume build's (with or without rect and box rows).
extern "C" int rtiw_megatrace_tri_info(int s, int aux_rows, int stream,
                                       int has_vol, int* info) {
  return build_info<false>(s, aux_rows, has_vol, 0, 0, 0, 0, stream ? 2 : 1,
                           info);
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
