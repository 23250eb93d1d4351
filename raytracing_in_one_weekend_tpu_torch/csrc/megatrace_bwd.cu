// Backward of the fused batch kernel for Hopper (sm_90a): the reverse
// sweep of the tape replay, sphere scenes, scenes with rects and boxes,
// convex volumes beside either, and mesh scenes of at most TRI_MAX
// triangles, gradient or no sky.
//
// Replaces: ops/megatrace_bwd.py::_bwd_kernel of the JAX package, its
// sphere, rect/box, volume and triangle arms.  Plain version:
// ops/megatrace_bwd.py::replay_grad_reference (torch.autograd over
// ops/megatrace_replay.replay).  The JAX kernel takes
// its adjoint from jax.vjp inside the kernel body; here it is derived by
// hand (megatrace_replay_lane.cuh::step_vjp) and checked iteration by
// iteration against torch.autograd of the plain replay_iteration through
// the second entry point, rtiw_replay_step_vjp.
//
// What bounds it on this card: ALU work.  Each live iteration is run
// forward twice (the path's forward sweep, step_vjp's own recompute) and
// once in reverse; device memory sees the tape (read by the scan, then
// twice a live iteration by the path kernel) and a path table of 8 bytes a
// path.  The parent design (one thread a lane, a 21-float checkpoint every
// trace_depth iterations, a 64-deep local history) spent ~46% of its time
// in same-address shared-memory atomics (PERF.md §6, step 0).
//
// The design rests on the adjoint being local to a path
// (megatrace_replay_lane.cuh, "Paths").  Three launches:
//  1. tape_scan_kernel (count): one thread a lane walks its tape column
//     (the [it][lane] layout makes the reads coalesce) and counts its paths
//     by length, per block;
//  2. the wrapper turns the counts into each block's offsets, lengths
//     longest first (a prefix sum in torch), and tape_scan_kernel
//     (scatter) scans again, writing (lane, it0 * 64 + length - 1) to the
//     path table: grouped by length, so the 32 paths of a warp share one
//     length and no warp waits for another path's length;
//  3. megatrace_paths_kernel: one thread a path.  Persistent blocks take
//     warps of 32 paths from a counter.  A path runs forward from its regen
//     state with step_forward, keeping the 15 floats each iteration reads
//     (o, d, th, rad, lp, valid, depth) in a per-thread array in local
//     memory (L1; shared-memory slots measured no faster), then applies
//     step_vjp in reverse.
// Winner-row cotangents: the threads of a warp whose step hit the same row
// sum their rows first (__match_any_sync, then a shuffle tree over each
// row's peers), and one thread a row adds it with one atomic a column:
// sphere rows into a shared (s, 13) table flushed once a block, triangle
// rows (up to TRI_MAX x 28) into device memory.  Camera and sky cotangents
// (30) accumulate in a shared row per thread, touched only at regen and
// sky-miss steps, and are summed per warp at each path's end.  What the TPU
// kernel needed and this one drops: the (8, 128) lane packing, the one-hot
// MXU winner fetch and scatter, the VMEM history budget, and the fixed
// checkpoint blocks that its lockstep lane tiles forced.
//
// Mesh scenes take a second instantiation (kTris; the sphere-only one
// compiles none of it): the entity table is the whole padded row space
// (38 columns), a triangle winner's adjoint runs Möller–Trumbore and the
// normal lerp backwards (megatrace_replay_lane.cuh::tri_hit_vjp), and its
// 28-column cotangent row goes to device memory.  Scenes with rects or
// boxes take a third (kAux): the whole padded row space (23 columns), a
// rect or box winner's adjoint through its frame and plane or face
// distance (aux_hit_vjp), and its 19-column cotangent row to device memory
// by the same warp sums, one atomic a row and column: a scene of a few
// rects and boxes (the Cornell box's 8) has every warp's paths hitting the
// same rows, which the warp sum turns into at most one atomic a distinct
// row of the warp and column.
//
// Scenes with convex volumes take the kVol builds (beside spheres, or with
// kAux beside rects and boxes; the others compile none of it): a path's
// state grows by the medium's 8 floats (23 floats an iteration in the
// local history), the constants by the camera's medium row vol0, and the
// scalar cotangents by its 8 (kScalVol, summed per warp with the camera's
// and the sky's).  The tape and its scan are the same: a volume scatter or
// a pass through a volume keeps its winner's code and takes one iteration.
//
// Scenes with moving spheres take the kMotion build (spheres only): a
// path's state grows by its shutter time, and a sphere's cotangent row by
// its move offset's three columns (kMotionGradCols, summed per warp and in
// shared memory as the others).
//
// Sphere scenes with checker or image albedos take the kTex build: a
// sphere's cotangent row grows by its texture record's main and secondary
// colours (kTexGradCols, summed as the others), and each fetched texel's
// cotangent goes into the texel plane `datlas` (the atlas's shape) by a
// global atomic, the lanes of a warp that fetched one texel summing theirs
// first (a 64 x 128 image takes many hits a texel).

#include <cuda_runtime.h>
#include <stdint.h>

#include "megatrace_replay_lane.cuh"

namespace {

using namespace rtiw;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGsStride = kScal + 1;  // odd: a warp's rows and columns
//                                       both spread over the 32 banks

// The scan: count mode (paths == nullptr) writes each block's path count
// per length to counts[block][length - 1]; scatter mode writes each path
// to paths[offsets[block][length - 1] + its rank in the block].
__global__ void __launch_bounds__(kThreads) tape_scan_kernel(
    const float* __restrict__ tape, const float* __restrict__ lane_count,
    int* __restrict__ counts, const int* __restrict__ offsets,
    int2* __restrict__ paths, int n, int iters, int trace_depth) {
  __shared__ int s_count[kMaxDepth];
  for (int k = threadIdx.x; k < trace_depth; k += blockDim.x) s_count[k] = 0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = (size_t)blockIdx.x * trace_depth;
  if (i < n)
    scan_lane(tape, n, i, iters, lane_count[i], trace_depth,
              [&](int it0, int len) {
                const int r = atomicAdd(&s_count[len - 1], 1);
                if (paths != nullptr)
                  paths[offsets[row + len - 1] + r] =
                      make_int2(i, path_code(it0, len));
              });
  __syncthreads();
  if (paths == nullptr)
    for (int k = threadIdx.x; k < trace_depth; k += blockDim.x)
      counts[row + k] = s_count[k];
}

// Position of the k-th (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// A warp's winner rows: every thread calls it at every reverse step.  The
// threads with the same row w >= 0 (its peers) sum their cotangent rows by
// a shuffle tree over their ranks among the peers, and the first of them
// adds the sum (Add: EntityAdd or MeshEntityAdd, one atomic a nonzero
// column).
template <bool kTris, bool kAux, class Add, bool kMotion = false>
struct WarpEntityAdd {
  Add add;
  __device__ void operator()(int w, float* ge) const {
    constexpr int cols = Layout<kTris, kAux, kMotion>::grad;
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(kFull, w);
    const int cnt = __popc(peers);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const unsigned most = __reduce_max_sync(kFull, w >= 0 ? cnt : 1);
    for (int s = 1; s < (int)most; s <<= 1) {
      const bool take = (rank & (2 * s - 1)) == 0 && rank + s < cnt;
      const int src = take ? nth_bit(peers, rank + s) : lane;
#pragma unroll
      for (int k = 0; k < cols; ++k) {
        const float v = __shfl_sync(kFull, ge[k], src);
        if (take) ge[k] += v;
      }
    }
    if (rank == 0) add(w, ge);
  }
};

// The texture build's rows: the peers of each sphere row summed as
// WarpEntityAdd does, added into the shared (s, kTexGradCols) table; then
// the peers of each fetched texel (the row's slot kTexGradCols, -1: none;
// none on a thread without a row this step) summed the same way, the
// first adding the sum into the texel plane.
struct WarpTexAdd {
  float* base;
  float* texels;
  template <int kCols>
  __device__ static bool peer_sum(int key, float* v) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(kFull, key);
    const int cnt = __popc(peers);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const unsigned most = __reduce_max_sync(kFull, key >= 0 ? cnt : 1);
    for (int s = 1; s < (int)most; s <<= 1) {
      const bool take = (rank & (2 * s - 1)) == 0 && rank + s < cnt;
      const int src = take ? nth_bit(peers, rank + s) : lane;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float x = __shfl_sync(kFull, v[k], src);
        if (take) v[k] += x;
      }
    }
    return rank == 0 && key >= 0;
  }
  __device__ void operator()(int w, float* ge) const {
    if (peer_sum<kTexGradCols>(w, ge))
      add_row(base + w * kTexGradCols, ge, kTexGradCols);
    // a thread past its path's end (w < 0) holds an earlier step's row
    const int texel = w >= 0 ? (int)ge[kTexGradCols] : -1;
    if (peer_sum<3>(texel, ge + kTexGradCols + 1))
      add_row(texels + (size_t)texel * 3, ge + kTexGradCols + 1, 3);
  }
};

// The volume builds' scalar rows: kScalVol cotangents, an odd stride.
constexpr int kGsStrideVol = kScalVol + 1;

// Sums the camera and sky cotangents of a warp's 32 rows (row t at
// s_gs + t * kGsStride) into s_sum and zeroes the rows; every thread of
// the warp calls it.
__device__ void flush_scal(float* warp_rows, float* own_row, float* s_sum) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < kScal) {
    float v = 0.0f;
    for (int t = 0; t < 32; ++t) v += warp_rows[t * kGsStride + lane];
    if (v != 0.0f) atomicAdd(s_sum + lane, v);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kScal; ++k) own_row[k] = 0.0f;
  __syncwarp();
}

// flush_scal of the volume builds: kScalVol cotangents a row.
__device__ void flush_scal_vol(float* warp_rows, float* own_row,
                               float* s_sum) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int c = lane; c < kScalVol; c += 32) {
    float v = 0.0f;
    for (int t = 0; t < 32; ++t) v += warp_rows[t * kGsStrideVol + c];
    if (v != 0.0f) atomicAdd(s_sum + c, v);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kScalVol; ++k) own_row[k] = 0.0f;
  __syncwarp();
}

// The plain row adder of each build.
template <bool kTris, bool kAux, bool kMotion = false>
struct RowAdd {
  using type = EntityAdd;
  __device__ static EntityAdd make(float* base, float*, int) {
    return EntityAdd{base};
  }
};
template <>
struct RowAdd<false, false, true> {
  using type = MotionEntityAdd;
  __device__ static MotionEntityAdd make(float* base, float*, int) {
    return MotionEntityAdd{base};
  }
};
template <>
struct RowAdd<true, false> {
  using type = MeshEntityAdd;
  __device__ static MeshEntityAdd make(float* base, float* tri,
                                       int tri_base) {
    return MeshEntityAdd{base, tri, tri_base};
  }
};
template <>
struct RowAdd<false, true> {
  using type = AuxEntityAdd;
  __device__ static AuxEntityAdd make(float* base, float* aux,
                                      int aux_base) {
    return AuxEntityAdd{base, aux, aux_base};
  }
};

// Three blocks an SM (at most 168 registers, some spilled) measured
// faster on an H100 than the compiler's 242 at 64 spp, and four slower
// (PERF.md, kernel #2).  The kAux build passes its rect and box rows'
// table as dent_tri and the padded sphere count as tri_base.  The kVol
// builds read kScalVol constants and write as many scalar cotangents.
// The kMotion build's sphere rows are kMotionGradCols wide, the kTex
// build's kTexGradCols; the kTex build reads the atlas `atlas` (img_w x
// img_h texels an image, or null) and writes the texel plane `datlas`.
template <bool kTris, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false>
__global__ void __launch_bounds__(kThreads, 3) megatrace_paths_kernel(
    const float* __restrict__ tape, const int2* __restrict__ paths,
    int total, int* __restrict__ next_warp,
    const float* __restrict__ lane_count, const float* __restrict__ consts,
    const float* __restrict__ ent, const float* __restrict__ cot,
    float* __restrict__ dent, float* __restrict__ dscal,
    float* __restrict__ dent_tri, int tri_base, int n, int s, int seed,
    int lane_base, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int jitter, const float* __restrict__ atlas = nullptr,
    float* __restrict__ datlas = nullptr, int img_w = 0, int img_h = 0) {
  constexpr int kS = kVol ? kScalVol : kScal;
  constexpr int kStride = kVol ? kGsStrideVol : kGsStride;
  constexpr int kRow = kMotion ? kMotionGradCols
                       : kTex  ? kTexGradCols
                               : kGradCols;
  extern __shared__ float smem[];
  float* s_dent = smem;            // (s, kRow)
  float* s_gs = s_dent + s * kRow;  // (kThreads, kStride)
  __shared__ float s_cam[kS], s_sum[kS];
  for (int k = threadIdx.x; k < s * kRow + kThreads * kStride;
       k += blockDim.x)
    smem[k] = 0.0f;
  if (threadIdx.x < kS) {
    s_cam[threadIdx.x] = consts[threadIdx.x];
    s_sum[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* gs = s_gs + threadIdx.x * kStride;
  float* warp_gs = s_gs + (threadIdx.x - lane) * kStride;
  // a path's states, in local memory (L1): shared-memory slots laid out
  // [slot][var][thread] measured no faster on an H100 (PERF.md, kernel #2)
  float states[(kMaxDepth - 1) * (kVol ? kVolPathVars : kPathVars)];
  const std::conditional_t<kVol, VolHist, ArrayHist> hist{states};
  auto add = [&] {
    if constexpr (kTex)
      return WarpTexAdd{s_dent, datlas};
    else
      return WarpEntityAdd<kTris, kAux,
                           typename RowAdd<kTris, kAux, kMotion>::type,
                           kMotion>{
          RowAdd<kTris, kAux, kMotion>::make(s_dent, dent_tri, tri_base)};
  }();
  for (;;) {
    int w0 = 0;
    if (lane == 0) w0 = atomicAdd(next_warp, 1) * 32;
    w0 = __shfl_sync(kFull, w0, 0);
    if (w0 >= total) break;
    const int p = w0 + lane;
    int i = 0, it0 = 0, len = 0;
    if (p < total) {
      const int2 q = paths[p];
      i = q.x;
      it0 = q.y / kMaxDepth;
      len = q.y % kMaxDepth + 1;
    }
    const int steps = (int)__reduce_max_sync(kFull, (unsigned)len);
    std::conditional_t<kTex, LaneEnvTex, LaneEnv> E;
    static_cast<LaneEnv&>(E) =
        make_lane_env(s_cam, ent, i, lane_count[i], seed, lane_base,
                      trace_depth, t_min, has_dielectrics, sky_on, jitter);
    if constexpr (kTex) {
      E.atlas = atlas;
      E.img_w = img_w;
      E.img_h = img_h;
    }
    path_backward<kTris, kAux, kVol, kMotion, kTex>(
        tape, n, i, it0, len, steps, E, cot[i], cot[n + i], cot[2 * n + i],
        cot[3 * n + i], hist, gs, add);
    if constexpr (kVol)
      flush_scal_vol(warp_gs, gs, s_sum);
    else
      flush_scal(warp_gs, gs, s_sum);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < s * kRow; k += blockDim.x) {
    const float v = s_dent[k];
    if (v != 0.0f) atomicAdd(dent + k, v);
  }
  if (threadIdx.x < kS && s_sum[threadIdx.x] != 0.0f)
    atomicAdd(dscal + threadIdx.x, s_sum[threadIdx.x]);
}

// One iteration's VJP on every lane: the hand derivation, exposed so that
// it can be held against torch.autograd of the plain replay_iteration.
template <bool kTris, bool kAux = false, bool kVol = false,
          bool kMotion = false, bool kTex = false>
__global__ void __launch_bounds__(kThreads) replay_step_vjp_kernel(
    const float* __restrict__ state, const float* __restrict__ codes,
    const float* __restrict__ cot_out, const float* __restrict__ lane_count,
    const float* __restrict__ consts, const float* __restrict__ ent,
    float* __restrict__ cot_in, float* __restrict__ cot_ent,
    float* __restrict__ cot_scal, int n, int it, int seed, int lane_base,
    int trace_depth, float t_min, int has_dielectrics, int sky_on,
    int jitter, const float* __restrict__ atlas = nullptr, int img_w = 0,
    int img_h = 0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  std::conditional_t<kTex, LaneEnvTex, LaneEnv> E;
  static_cast<LaneEnv&>(E) =
      make_lane_env(consts, ent, i, lane_count[i], seed, lane_base,
                    trace_depth, t_min, has_dielectrics, sky_on, jitter);
  if constexpr (kTex) {
    E.atlas = atlas;
    E.img_w = img_w;
    E.img_h = img_h;
  }
  constexpr int cols = Layout<kTris, kAux, kMotion, kTex>::grad;
  constexpr int nv = kVol      ? kVolStateVars
                     : kMotion ? kMotionStateVars
                               : kStateVars;
  constexpr int kS = kVol ? kScalVol : kScal;
  float st[nv], g[nv], ge[Layout<kTris, kAux, kMotion, kTex>::row], gs[kS];
  for (int k = 0; k < nv; ++k) {
    st[k] = state[(size_t)k * n + i];
    g[k] = cot_out[(size_t)k * n + i];
  }
  for (int k = 0; k < kS; ++k) gs[k] = 0.0f;
  step_vjp<kTris, kAux, kVol, kMotion, kTex>(st, g, codes[i], it, E, ge, gs);
  for (int k = 0; k < nv; ++k) cot_in[(size_t)k * n + i] = g[k];
  for (int k = 0; k < cols; ++k) cot_ent[(size_t)k * n + i] = ge[k];
  for (int k = 0; k < kS; ++k) cot_scal[(size_t)k * n + i] = gs[k];
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`
// and returns the CUDA error of the launch (0 when it was accepted).
//
// rtiw_bwd_scan: with paths == nullptr it writes counts (blocks,
// trace_depth), blocks = ceil(n / 128), each block's path count per length;
// else it writes each path to paths (2 ints a path) at offsets (blocks,
// trace_depth) plus its rank in the block.
extern "C" int rtiw_bwd_scan(const float* tape, const float* lane_count,
                             int* counts, const int* offsets, int* paths,
                             int n, int samples, int trace_depth,
                             void* stream) {
  if (n <= 0) return 0;
  if (trace_depth < 1 || trace_depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  tape_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tape, lane_count, counts, offsets, reinterpret_cast<int2*>(paths), n,
      samples * trace_depth, trace_depth);
  return static_cast<int>(cudaGetLastError());
}

// rtiw_bwd_paths: the backward of the `total` paths of the scan's table.
// `dent` (s, 13), `dscal` (30; 38 in the volume builds) and `next_warp`
// (1 int) must be zeroed by the caller.  A mesh scene (kind 1) passes a
// zeroed `dent_rows` (T_pad, 28), `row_base` = the padded sphere count (the first triangle's tape
// code) and the whole (s_pad + T_pad, 38) entity table; a scene with rects
// or boxes (kind 2) a zeroed `dent_rows` (R_pad + B_pad, 19), row_base the
// same and the whole (s_pad + R_pad + B_pad, 23) table; a sphere scene
// (kind 0) dent_rows = nullptr and its (s, 23) rows.  Kinds 3 and 4 are
// kinds 0 and 2 with convex volumes: `consts` holds kScalVol floats (vol0
// after the sky) and dscal as many.  Kind 5 is kind 0 with moving spheres:
// its (s, 26) rows hold the move offsets in columns 23-25 and `dent` is
// (s, 16).  Kind 6 is kind 0 with checker or image albedos: its (s, 39)
// rows hold the texture records in columns 23-38, `dent` is (s, 19), and
// with an image `atlas` and a zeroed `datlas` ((A * img_h) x img_w x 3
// floats each) take the atlas and its texel plane.
extern "C" int rtiw_bwd_paths(
    const float* tape, const int* paths, int total, int* next_warp,
    const float* lane_count, const float* consts, const float* ent,
    const float* cot, float* dent, float* dscal, float* dent_rows,
    int row_base, int n, int s, int seed, int lane_base, int trace_depth,
    float t_min, int has_dielectrics, int sky_on, int jitter, int kind,
    const float* atlas, float* datlas, int img_w, int img_h, void* stream) {
  if (total <= 0) return 0;
  if (trace_depth < 1 || trace_depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const bool vol = kind == 3 || kind == 4;
  const int row = kind == 5   ? kMotionGradCols
                  : kind == 6 ? kTexGradCols
                              : kGradCols;
  const size_t shmem =
      ((size_t)s * row + kThreads * (vol ? kGsStrideVol : kGsStride)) *
      sizeof(float);
  if (kind < 0 || kind > 6 ||
      (kind == 1 || kind == 2 || kind == 4) != (dent_rows != nullptr) ||
      (atlas != nullptr) != (datlas != nullptr))
    return (int)cudaErrorInvalidValue;
  // the build: 0 sphere scenes, 1 mesh scenes, 2 rects or boxes, 3 and 4
  // those of 0 and 2 with convex volumes, 5 moving spheres
  auto kernel = kind == 1   ? megatrace_paths_kernel<true, false>
                : kind == 2 ? megatrace_paths_kernel<false, true>
                : kind == 3 ? megatrace_paths_kernel<false, false, true>
                : kind == 4 ? megatrace_paths_kernel<false, true, true>
                : kind == 5 ? megatrace_paths_kernel<false, false, false, true>
                : kind == 6
                    ? megatrace_paths_kernel<false, false, false, false, true>
                    : megatrace_paths_kernel<false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, shmem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent blocks: one flush of the shared sums each
  const long wanted = ((long)total + kThreads - 1) / kThreads;
  const int blocks = (int)(wanted < (long)sms * per_sm ? wanted
                                                       : (long)sms * per_sm);
  kernel<<<blocks, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      tape, reinterpret_cast<const int2*>(paths), total, next_warp,
      lane_count, consts, ent, cot, dent, dscal, dent_rows, row_base, n, s,
      seed, lane_base, trace_depth, t_min, has_dielectrics, sky_on, jitter,
      atlas, datlas, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtiw_replay_step_vjp(
    const float* state, const float* codes, const float* cot_out,
    const float* lane_count, const float* consts, const float* ent,
    float* cot_in, float* cot_ent, float* cot_scal, int n, int it, int seed,
    int lane_base, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int jitter, int kind, const float* atlas, int img_w,
    int img_h, void* stream) {
  if (kind < 0 || kind > 6) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    auto kernel =
        kind == 1   ? replay_step_vjp_kernel<true, false>
        : kind == 2 ? replay_step_vjp_kernel<false, true>
        : kind == 3 ? replay_step_vjp_kernel<false, false, true>
        : kind == 4 ? replay_step_vjp_kernel<false, true, true>
        : kind == 5 ? replay_step_vjp_kernel<false, false, false, true>
        : kind == 6
            ? replay_step_vjp_kernel<false, false, false, false, true>
            : replay_step_vjp_kernel<false, false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        state, codes, cot_out, lane_count, consts, ent, cot_in, cot_ent,
        cot_scal, n, it, seed, lane_base, trace_depth, t_min,
        has_dielectrics, sky_on, jitter, atlas, img_w, img_h);
  }
  return static_cast<int>(cudaGetLastError());
}
