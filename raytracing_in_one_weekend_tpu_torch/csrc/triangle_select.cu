// Nearest-triangle selection for Hopper (sm_90a): every ray against every
// triangle by Möller–Trumbore, the nearest t and its row.
//
// Replaces: ops/pallas_triangle.py::_kernel (triangle_select) of the JAX
// package, the detached selection under the differentiable wavefront's
// intersect.nearest_hit for meshes of at most 4096 triangles; the winner is
// then evaluated again with gradients.  Plain version:
// ops/triangle_select.py::triangle_select_reference, which this kernel
// matches bit for bit: the same Möller–Trumbore as the batch kernel
// (megatrace_common.cuh::moller_trumbore: fmaf exactly where written,
// -fmad=false, IEEE division).
//
// Tile rule, kept from the JAX kernel so that the outputs match lane for
// lane: rays go in tiles of 256 (one CUDA block); a tile with no active ray
// writes (1e30, 0) and sweeps nothing, while the inactive rays of a live
// tile are swept like the others.
//
// What bounds it on this card: ALU.  Each (ray, triangle) pair costs ~56
// flops (two cross products, three 3-dots, a division, the hit test; the
// count chip_smoke.py's bound uses); at 512x512 rays and mesh_showcase's
// 908 triangles that is ~13 GFLOP, ~0.2 ms at the FP32 peak, against
// ~8 MB of rays in and results out (2.5 us at 3.35 TB/s).
//
// What this simple design does about it: one thread owns one ray in
// registers; each block stages the triangle table (edge_a, edge_b, vert0:
// 36 bytes a triangle) in shared memory, 1024 triangles at a time, and
// every thread of a warp reads the same triangle at the same step (a
// broadcast).  The TPU kernel's (8, N) ray layout and its padding rows are
// gone: the loop runs over the real triangles only, which keeps every
// winner row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "megatrace_common.cuh"

namespace {

using namespace rtiw;

constexpr int kThreads = 256;  // the JAX kernel's RAY_TILE
constexpr int kChunk = 1024;  // triangles staged in shared memory at a time
constexpr int kTriCols = 9;  // edge_a | edge_b | vert0

__global__ void __launch_bounds__(kThreads) triangle_select_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const uint8_t* __restrict__ active, const float* __restrict__ tri_g,
    float* __restrict__ t_out, int* __restrict__ idx_out, int n, int t_rows,
    float t_min) {
  __shared__ float sh[kChunk * kTriCols];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  const bool act = in_range && active[i] != 0;
  if (!__syncthreads_or(act)) {
    // no active ray in this tile: the miss sentinel and row 0
    if (in_range) {
      t_out[i] = kBig;
      idx_out[i] = 0;
    }
    return;
  }
  const int j = in_range ? i : 0;
  const float ox = origin[3 * j], oy = origin[3 * j + 1],
              oz = origin[3 * j + 2];
  const float dx = direction[3 * j], dy = direction[3 * j + 1],
              dz = direction[3 * j + 2];
  float best_t = kBig;
  int best = 0;
  for (int base = 0; base < t_rows; base += kChunk) {
    const int count = min(kChunk, t_rows - base);
    __syncthreads();
    for (int k = threadIdx.x; k < count * kTriCols; k += blockDim.x)
      sh[k] = tri_g[(size_t)base * kTriCols + k];
    __syncthreads();
    if (!in_range) continue;
    for (int k = 0; k < count; ++k) {
      const float* g = sh + k * kTriCols;
      float u, v;
      const float t = moller_trumbore(ox, oy, oz, dx, dy, dz, g[0], g[1],
                                      g[2], g[3], g[4], g[5], g[6], g[7],
                                      g[8], t_min, u, v);
      if (t < best_t) {  // strict: the first row wins a tie (argmin)
        best_t = t;
        best = base + k;
      }
    }
  }
  if (!in_range) return;
  t_out[i] = best_t;
  idx_out[i] = best;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() right after the launch.  tri holds (t_rows, 9)
// floats: edge_a | edge_b | vert0.
extern "C" int rtiw_triangle_select(const float* origin,
                                    const float* direction,
                                    const uint8_t* active, const float* tri,
                                    float* t_out, int* idx_out, int n,
                                    int t_rows, float t_min, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    triangle_select_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        origin, direction, active, tri, t_out, idx_out, n, t_rows, t_min);
  }
  return static_cast<int>(cudaGetLastError());
}
