// Backward of the fused batch kernel for Hopper (sm_90a): the reverse
// sweep of the tape replay, sphere scenes and mesh scenes of at most
// TRI_MAX triangles, gradient or no sky.
//
// Replaces: ops/megatrace_bwd.py::_bwd_kernel of the JAX package, its
// sphere and triangle arms.  Plain version: ops/megatrace_bwd.py::replay_grad_reference
// (torch.autograd over ops/megatrace_replay.replay).  The JAX kernel takes
// its adjoint from jax.vjp inside the kernel body; here it is derived by
// hand (megatrace_replay_lane.cuh::step_vjp) and checked iteration by
// iteration against torch.autograd of the plain replay_iteration through
// the second entry point, rtiw_replay_step_vjp.
//
// What bounds it on this card: ALU work and local-memory traffic per lane.
// A lane runs its live iterations three times forward (the checkpoint
// sweep, the block re-run, the adjoint's own recompute) and once in
// reverse; device memory sees the tape (4 bytes per lane and iteration,
// read twice) and 21 floats of block checkpoint per lane and block.
//
// The simple design: one thread per lane.  Phase 1 sweeps the tape forward
// and stores the 21-float state at each block boundary (every trace_depth
// iterations) to a global scratch laid out [block][var][lane], so the
// stores coalesce.  Phase 2 walks the blocks in reverse, re-runs each into
// a per-thread history (local memory) and applies the hand VJP of each
// iteration.  A lane's tape is idle (-2) from its last sample on, so both
// phases stop there.  Winner rows are a plain gather.  Entity-row
// cotangents (13 columns) accumulate in shared memory per CTA with
// atomics and are flushed once per CTA; the camera and sky cotangents are
// reduced by warp shuffle, one atomic per warp and value.  What the TPU
// kernel needed and this one drops: the (8, 128) lane packing, the one-hot
// MXU winner fetch and scatter, and the VMEM history budget.
//
// Mesh scenes take a second instantiation (kTris; the sphere-only one
// compiles none of it): the entity table is the whole padded row space
// (38 columns), a triangle winner's adjoint runs Möller–Trumbore and the
// normal lerp backwards (megatrace_replay_lane.cuh::tri_hit_vjp), and its
// 28-column cotangent row goes to device memory with atomics: 4096 rows
// of it (459 KB) do not fit in shared memory, where the sphere rows stay.

#include <cuda_runtime.h>
#include <stdint.h>

#include "megatrace_replay_lane.cuh"

namespace {

using namespace rtiw;

constexpr int kThreads = 128;

template <bool kTris>
__global__ void __launch_bounds__(kThreads) megatrace_bwd_kernel(
    const float* __restrict__ tape, const float* __restrict__ lane_count,
    const float* __restrict__ consts, const float* __restrict__ ent,
    const float* __restrict__ cot, float* __restrict__ ckpt,
    float* __restrict__ dent, float* __restrict__ dscal,
    float* __restrict__ dent_tri, int tri_base, int n, int s, int seed,
    int lane_base, int iters, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter) {
  extern __shared__ float s_dent[];  // (s, kGradCols)
  __shared__ float s_cam[kScal];
  for (int k = threadIdx.x; k < s * kGradCols; k += blockDim.x)
    s_dent[k] = 0.0f;
  if (threadIdx.x < kScal) s_cam[threadIdx.x] = consts[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float gs[kScal];
#pragma unroll
  for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
  if (i < n) {
    const LaneEnv E = make_lane_env(s_cam, ent, i, lane_count[i], seed,
                                    lane_base, trace_depth, t_min,
                                    has_dielectrics, sky_on, jitter);
    if constexpr (kTris)
      lane_backward<true>(tape, n, i, iters, E, cot[i], cot[n + i],
                          cot[2 * n + i], cot[3 * n + i], ckpt, gs,
                          MeshEntityAdd{s_dent, dent_tri, tri_base});
    else
      lane_backward(tape, n, i, iters, E, cot[i], cot[n + i],
                    cot[2 * n + i], cot[3 * n + i], ckpt, gs,
                    EntityAdd{s_dent});
  }
  __syncthreads();
  for (int k = threadIdx.x; k < s * kGradCols; k += blockDim.x) {
    const float v = s_dent[k];
    if (v != 0.0f) atomicAdd(dent + k, v);
  }
#pragma unroll
  for (int k = 0; k < kScal; ++k) {
    float v = gs[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0 && v != 0.0f) atomicAdd(dscal + k, v);
  }
}

// One iteration's VJP on every lane: the hand derivation, exposed so that
// it can be held against torch.autograd of the plain replay_iteration.
template <bool kTris>
__global__ void __launch_bounds__(kThreads) replay_step_vjp_kernel(
    const float* __restrict__ state, const float* __restrict__ codes,
    const float* __restrict__ cot_out, const float* __restrict__ lane_count,
    const float* __restrict__ consts, const float* __restrict__ ent,
    float* __restrict__ cot_in, float* __restrict__ cot_ent,
    float* __restrict__ cot_scal, int n, int it, int seed, int lane_base,
    int trace_depth, float t_min, int has_dielectrics, int sky_on,
    int jitter) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneEnv E = make_lane_env(consts, ent, i, lane_count[i], seed,
                                  lane_base, trace_depth, t_min,
                                  has_dielectrics, sky_on, jitter);
  constexpr int cols = Layout<kTris>::grad;
  float st[kStateVars], g[kStateVars], ge[cols], gs[kScal];
  for (int k = 0; k < kStateVars; ++k) {
    st[k] = state[(size_t)k * n + i];
    g[k] = cot_out[(size_t)k * n + i];
  }
  for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
  step_vjp<kTris>(st, g, codes[i], it, E, ge, gs);
  for (int k = 0; k < kStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
  for (int k = 0; k < cols; ++k) cot_ent[(size_t)k * n + i] = ge[k];
  for (int k = 0; k < kScal; ++k) cot_scal[(size_t)k * n + i] = gs[k];
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`
// and returns the CUDA error of the launch (0 when it was accepted).
// `dent` (s, 13) and `dscal` (30) must be zeroed by the caller; `ckpt`
// holds (iters / trace_depth) * 21 * n floats.  A mesh scene passes a
// zeroed `dent_tri` (T_pad, 28), `tri_base` = the padded sphere count (the
// first triangle's tape code) and the whole (s_pad + T_pad, 38) entity
// table; a sphere scene passes dent_tri = nullptr and its (s, 23) rows.
extern "C" int rtiw_megatrace_bwd(
    const float* tape, const float* lane_count, const float* consts,
    const float* ent, const float* cot, float* ckpt, float* dent,
    float* dscal, float* dent_tri, int tri_base, int n, int s, int seed,
    int lane_base, int samples, int trace_depth, float t_min,
    int has_dielectrics, int sky_on, int jitter, void* stream) {
  if (n <= 0) return 0;
  if (trace_depth > rtiw::kMaxHistory) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)s * kGradCols * sizeof(float);
  auto kernel = dent_tri != nullptr ? megatrace_bwd_kernel<true>
                                    : megatrace_bwd_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      tape, lane_count, consts, ent, cot, ckpt, dent, dscal, dent_tri,
      tri_base, n, s, seed, lane_base, samples * trace_depth, trace_depth,
      t_min, has_dielectrics, sky_on, jitter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtiw_replay_step_vjp(
    const float* state, const float* codes, const float* cot_out,
    const float* lane_count, const float* consts, const float* ent,
    float* cot_in, float* cot_ent, float* cot_scal, int n, int it, int seed,
    int lane_base, int trace_depth, float t_min, int has_dielectrics,
    int sky_on, int jitter, int has_tris, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    auto kernel = has_tris ? replay_step_vjp_kernel<true>
                           : replay_step_vjp_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        state, codes, cot_out, lane_count, consts, ent, cot_in, cot_ent,
        cot_scal, n, it, seed, lane_base, trace_depth, t_min,
        has_dielectrics, sky_on, jitter);
  }
  return static_cast<int>(cudaGetLastError());
}
