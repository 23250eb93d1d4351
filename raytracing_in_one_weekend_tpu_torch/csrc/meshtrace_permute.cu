// The bounce-synchronous sampler's lane permutations for Hopper (sm_90a):
// the pair compaction between bounces and the restore at the end of a wave.
// Both move the (24, n) float32 path state (row 23 the lane id) column by
// column and are exact permutations.
//
// pair_compact_kernel replaces ops/pallas_meshtrace.py::_pair_compact_kernel
// of the JAX package: a stable 9-class partition of each pair of 1024-lane
// tiles, live lanes by direction octant 4(dx > 0) + 2(dy > 0) + (dz > 0)
// (-0.0 is not positive), then dead lanes (row 12 <= 0.5).  JAX builds the
// destinations from exclusive sums done as one-hot matrix products and
// permutes by another product.  Here one block of 1024 threads takes a pair
// (each thread two lanes, one per tile); per 32-lane chunk and class a warp
// ballot counts the lanes, one warp scans the 9 x 64 counts (class-major),
// and a lane's destination is its (class, chunk) offset plus the lanes of
// its class before it in its warp.  That is a stable counting sort, JAX's
// destination.  A partial pair at the end (fewer than 2048 lanes) is
// copied as it is, as JAX leaves it.
//
// The restore replaces ops/pallas_meshtrace.py::_restore_kernel: the
// inverse permutation, column j to column state[23][j].  JAX gathers each
// tile from the tiles within 8 of it (its VMEM holds no more) by one-hot
// products.  Here it is a gather with coalesced stores, in two launches:
// restore_index_kernel writes the inverse index inv[id[j]] = j (one
// scattered 4-byte store a lane instead of 24), and a gather kernel writes
// out[r][i] = in[r][inv[i]] row by row.  The compaction moves a lane by at
// most one tile a pass and the sampler runs at most 8 passes a wave, so a
// tile's sources lie within 8 tiles of it, and the stable passes keep
// neighbouring lanes together: the reads come in runs from a band that the
// caches hold, so restore_gather_kernel reads them through L1 with __ldg
// (a variant that staged each tile's span of a row in shared memory first
// was slower, PERF.md).  A lane id that is out of range, not an integer,
// or not a permutation (a hole: no column carries id i) stops the kernel
// with __trap(), so the next synchronise raises instead of returning
// columns nobody wrote.
//
// What bounds them on this card: bytes.  Each reads and writes 96 bytes a
// lane (2 x 24 x 4 x n); the compaction's reads are coalesced and its
// writes scattered within a pair; the restore's writes are coalesced.
// Plain versions: ops/meshtrace.py::pair_compact_reference,
// restore_reference, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 24;
constexpr int kAliveRow = 12;
constexpr int kLaneRow = 23;
constexpr int kTile = 1024;
constexpr int kPair = 2 * kTile;
constexpr int kChunks = kPair / 32;  // 64 warp-sized chunks a pair
constexpr int kClasses = 9;
constexpr int kScanPerLane = kClasses * kChunks / 32;  // 18

__global__ void __launch_bounds__(kTile) pair_compact_kernel(
    const float* __restrict__ in, int ld_in, float* __restrict__ out,
    int ld_out, int n) {
  __shared__ int base[kClasses * kChunks];  // counts, then offsets
  const int pair0 = blockIdx.x * kPair;
  const int len = min(kPair, n - pair0);
  if (len < kPair) {  // a partial pair stays as it is
    for (int j = threadIdx.x; j < len; j += kTile)
      for (int r = 0; r < kRows; ++r)
        out[(size_t)r * ld_out + pair0 + j] = in[(size_t)r * ld_in + pair0 + j];
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cls[2];
  unsigned mine[2] = {0u, 0u};
  for (int h = 0; h < 2; ++h) {
    const size_t j = (size_t)pair0 + h * kTile + threadIdx.x;
    const bool alive = in[(size_t)kAliveRow * ld_in + j] > 0.5f;
    const int octant = (in[3 * (size_t)ld_in + j] > 0.0f ? 4 : 0) +
                       (in[4 * (size_t)ld_in + j] > 0.0f ? 2 : 0) +
                       (in[5 * (size_t)ld_in + j] > 0.0f ? 1 : 0);
    cls[h] = alive ? octant : 8;
    for (int c = 0; c < kClasses; ++c) {
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, cls[h] == c);
      if (cls[h] == c) mine[h] = ballot;
      if (lane == 0) base[c * kChunks + h * 32 + warp] = __popc(ballot);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the counts in (class, chunk) order: each lane sums
    // 18 consecutive entries, the warp scans the sums, each lane writes
    int local = 0;
    for (int k = 0; k < kScanPerLane; ++k) local += base[lane * kScanPerLane + k];
    int incl = local;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - local;
    for (int k = 0; k < kScanPerLane; ++k) {
      const int count = base[lane * kScanPerLane + k];
      base[lane * kScanPerLane + k] = run;
      run += count;
    }
  }
  __syncthreads();
  const unsigned before = (1u << lane) - 1u;
  for (int h = 0; h < 2; ++h) {
    const size_t src = (size_t)pair0 + h * kTile + threadIdx.x;
    const size_t dst = (size_t)pair0 + base[cls[h] * kChunks + h * 32 + warp] +
                       __popc(mine[h] & before);
    for (int r = 0; r < kRows; ++r)
      out[(size_t)r * ld_out + dst] = in[(size_t)r * ld_in + src];
  }
}

constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads) restore_index_kernel(
    const float* __restrict__ in, int* __restrict__ inv, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float id = in[(size_t)kLaneRow * n + j];
  if (!(id >= 0.0f && id < (float)n)) __trap();  // not a lane id (or NaN)
  inv[(int)id] = j;
}

// Output column i from the source column inv[i], checked: in range and
// carrying id i (inv is not initialised, so a hole holds whatever was
// there).
__global__ void __launch_bounds__(kGatherThreads) restore_gather_kernel(
    const float* __restrict__ in, const int* __restrict__ inv,
    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int src = __ldg(inv + i);
  if (src < 0 || src >= n ||
      __ldg(in + (size_t)kLaneRow * n + src) != (float)i)
    __trap();
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = __ldg(in + (size_t)r * n + src);
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[(size_t)r * n + i] = v[r];
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() right after the launch.  pair_compact: `in`
// has n columns with row stride ld_in (a column slice of a wider state),
// `out` row stride ld_out.  restore: both (24, n) contiguous.
extern "C" int rtiw_pair_compact(const float* in, int ld_in, float* out,
                                 int ld_out, int n, void* stream) {
  if (n > 0)
    pair_compact_kernel<<<(n + kPair - 1) / kPair, kTile, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        in, ld_in, out, ld_out, n);
  return static_cast<int>(cudaGetLastError());
}

// restore: `inv` is n int32 of scratch (not initialised).
extern "C" int rtiw_restore(const float* in, int* inv, float* out, int n,
                            void* stream) {
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = (n + kGatherThreads - 1) / kGatherThreads;
    restore_index_kernel<<<blocks, kGatherThreads, 0, st>>>(in, inv, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    restore_gather_kernel<<<blocks, kGatherThreads, 0, st>>>(in, inv, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
