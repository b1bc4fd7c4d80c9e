// PartialReduce of a materialized fp32 score matrix for Hopper (sm_90a),
// bound with ctypes through a plain C interface.
//
// Replaces the TPU's hardware PartialReduce that lax.approx_max_k runs at
// hm_retrieval_tpu/ops/exact_topk.py:63 (exact_topk_scores),
// hm_retrieval_tpu/indices/brute_force.py:238 (the "approx" engine),
// hm_retrieval_tpu/indices/quantized.py:473 (the quantized scan, per chunk)
// and hm_retrieval_tpu/parallel/distributed_topk.py:283 (the sharded
// quantized scan, per shard). That is an XLA operation, not a Pallas kernel:
// the TPU reduces each row of x to L bin maxima, then sorts them. This
// kernel is the reduction; the sort of the L maxima (topk_pair) stays in
// Python, in ops/partial_reduce.py.
//
// What it computes. x is (B, n) fp32, row-major. Bin j of a row holds the
// columns j, j + L, j + 2L, ..., j + (T - 1) L, T = 2^r, the row taken as
// padded with -inf to L * T entries (L * T >= n). For each (row b, bin j)
// the kernel writes the bin's largest value to vals[b, j] and, among equal
// values, its lowest column to rows[b, j]: the answer of one walk in
// increasing t with a strict >, starting from (-inf, j). So a bin whose
// entries are all -inf (a bin made only of padding included) returns -inf
// and column j, which is >= n for a bin of padding alone; a NaN never wins a
// bin; -0.0 and +0.0 are equal, and the lower column wins.
//
// Bound. One read of x and one write of the (B, L) values and columns:
// B * n * 4 + B * L * 8 bytes over the card's memory bandwidth. There is no
// arithmetic to speak of.
//
// Design: a split walk. A bin's T columns are cut into S contiguous
// segments of T / S steps (S a power of two, at most kMaxSplit). Thread
// (j, s) walks columns (s T/S + u) L + j, u ascending, with a strict >, from
// (-inf, its segment's first column), kU independent loads at a time (kU =
// min(T / S, 8), a template parameter), all issued before any compare, so
// a segment's walk is T / (S kU) rounds of memory latency. A warp holds 32
// consecutive bins of one segment, so each step of a warp reads one
// 128-byte line. Two kernels, each instantiated for kU = 1, 2, 4, 8:
// - S = 1 (the unsplit walk): one thread a (row, bin), blocks of 256 bins,
//   no shared memory. Where B * L already fills the card this is the whole
//   design.
// - S > 1: a block is bx consecutive bins (threadIdx.x, a multiple of 32)
//   by the S segments (threadIdx.y). The S partials of a bin meet in
//   dynamic shared memory and the segment-0 thread merges them in
//   increasing s under "x beats y iff x.v > y.v or (x.v == y.v and x.col <
//   y.col)"; no atomics, so the order never depends on timing. A segment's
//   partial is never NaN (its walk starts from -inf with a strict >), and
//   the columns of distinct segments differ, so the merge gives the single
//   walk's answer bit for bit.
// The host (ops/partial_reduce.py::split_plan) picks S: it doubles S while
// each thread keeps at least one full round of loads and the B * L * S
// threads still fit the card at once, so a short, wide-T launch (B = 1 at
// r = 9: 256 threads walking 512 loads each) spreads over many SMs in few
// rounds, and S = 1 where B * L already fills the card or T <= 8. Rows go
// along the grid's y (a grid-stride loop over rows beyond the grid's y
// limit). Each element is read once.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSplit = 32;
constexpr int kMaxThreads = kWarp * kMaxSplit;  // 32 bins x 32 segments
constexpr int kMinThreads = 256;                // a block's threads at S = 1
constexpr int kMaxUnroll = 8;                   // loads in flight a thread
constexpr int kMaxGridY = 65535;

// Bins a block: kMinThreads / S, and never fewer than a warp's 32.
int block_bins(int split) {
  return split >= kMinThreads / kWarp ? kWarp : kMinThreads / split;
}

// The walk of one segment: `steps` columns from `first`, L apart, kU loads
// at a time; (best, arg) start at (-inf, first).
template <int kU>
__device__ __forceinline__ void walk(const float* __restrict__ xr, int n,
                                     int L, int64_t first, int steps,
                                     float& best, int& arg) {
  best = -INFINITY;
  arg = static_cast<int>(first);
  for (int u0 = 0; u0 < steps; u0 += kU) {
    const int64_t base = first + static_cast<int64_t>(u0) * L;
    if (base >= n) break;  // the rest of the segment is padding
    float v[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int64_t col = base + static_cast<int64_t>(i) * L;
      v[i] = u0 + i < steps && col < n ? __ldg(xr + col) : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      if (v[i] > best) {
        best = v[i];
        arg = static_cast<int>(base + static_cast<int64_t>(i) * L);
      }
    }
  }
}

// S = 1: one thread a (row, bin), kMinThreads bins a block.
template <int kU>
__global__ void __launch_bounds__(kMinThreads)
    walk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                int* __restrict__ rows, int B, int n, int L, int T) {
  const int j = blockIdx.x * kMinThreads + threadIdx.x;
  if (j >= L) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    float best;
    int arg;
    walk<kU>(x + static_cast<int64_t>(b) * n, n, L, j, T, best, arg);
    const int64_t out = static_cast<int64_t>(b) * L + j;
    vals[out] = best;
    rows[out] = arg;
  }
}

// S > 1: blockDim = (bins, S); the partials merge in dynamic shared memory
// (bins * S floats, then bins * S ints).
template <int kU>
__global__ void __launch_bounds__(kMaxThreads)
    split_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ rows, int B, int n, int L, int T) {
  extern __shared__ float part_v[];
  const int bx = blockDim.x;
  const int split = blockDim.y;
  int* part_c = reinterpret_cast<int*>(part_v + bx * split);
  const int j = blockIdx.x * bx + threadIdx.x;
  const int steps = T / split;
  const int64_t first = static_cast<int64_t>(threadIdx.y) * steps * L + j;
  const int slot = threadIdx.y * bx + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    float best = -INFINITY;
    int arg = static_cast<int>(first);
    if (j < L)
      walk<kU>(x + static_cast<int64_t>(b) * n, n, L, first, steps, best,
               arg);
    part_v[slot] = best;
    part_c[slot] = arg;
    __syncthreads();
    if (threadIdx.y == 0 && j < L) {
      for (int s = 1; s < split; ++s) {
        const float v = part_v[s * bx + threadIdx.x];
        const int c = part_c[s * bx + threadIdx.x];
        if (v > best || (v == best && c < arg)) {
          best = v;
          arg = c;
        }
      }
      const int64_t out = static_cast<int64_t>(b) * L + j;
      vals[out] = best;
      rows[out] = arg;
    }
    __syncthreads();  // the partials are read before the next row's
  }
}

template <int kU>
cudaError_t launch(const float* x, float* vals, int* rows, int B, int n,
                   int L, int T, int split, cudaStream_t stream) {
  const int grid_y = B < kMaxGridY ? B : kMaxGridY;
  if (split == 1) {
    const dim3 grid((L + kMinThreads - 1) / kMinThreads, grid_y);
    walk_kernel<kU><<<grid, kMinThreads, 0, stream>>>(x, vals, rows, B, n,
                                                      L, T);
  } else {
    const int bx = block_bins(split);
    const dim3 grid((L + bx - 1) / bx, grid_y);
    const size_t smem = static_cast<size_t>(bx) * split * 8;
    split_kernel<kU><<<grid, dim3(bx, split), smem, stream>>>(x, vals, rows,
                                                              B, n, L, T);
  }
  return cudaGetLastError();
}

}  // namespace

// x (B, n) fp32 -> vals (B, L) fp32, rows (B, L) int32, over bins of
// T = 2^r columns each, every bin's walk split into `split` segments (a
// power of two, 1 <= split <= min(T, 32)); L * T >= n and L * T < 2^31.
// Launches on `stream` and does not synchronise. Returns a CUDA error code
// (0 = success).
extern "C" int partial_reduce(const void* x, void* vals, void* rows, int B,
                              int n, int L, int r, int split, void* stream) {
  if (B <= 0 || n <= 0 || L <= 0 || r < 0 || r > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t T = int64_t{1} << r;
  if (L * T < n || L * T >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (split < 1 || split > kMaxSplit || split > T || (split & (split - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t steps = T / split;
  const auto* xf = static_cast<const float*>(x);
  auto* vf = static_cast<float*>(vals);
  auto* ri = static_cast<int*>(rows);
  auto* st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(T);
  cudaError_t err;
  if (steps >= kMaxUnroll)
    err = launch<kMaxUnroll>(xf, vf, ri, B, n, L, t, split, st);
  else if (steps == 4)
    err = launch<4>(xf, vf, ri, B, n, L, t, split, st);
  else if (steps == 2)
    err = launch<2>(xf, vf, ri, B, n, L, t, split, st);
  else
    err = launch<1>(xf, vf, ri, B, n, L, t, split, st);
  return static_cast<int>(err);
}

// The kernels' largest registers and local (spilled) bytes a thread over
// all eight instances, as the compiler left them, and the launch limits:
// out[0] = registers, out[1] = local bytes, out[2] = most threads a block,
// out[3] = most shared bytes a block, out[4] = largest split. Returns a
// CUDA error code (0 = success).
extern "C" int partial_reduce_launch_info(int* out) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(walk_kernel<1>),
      reinterpret_cast<const void*>(walk_kernel<2>),
      reinterpret_cast<const void*>(walk_kernel<4>),
      reinterpret_cast<const void*>(walk_kernel<8>),
      reinterpret_cast<const void*>(split_kernel<1>),
      reinterpret_cast<const void*>(split_kernel<2>),
      reinterpret_cast<const void*>(split_kernel<4>),
      reinterpret_cast<const void*>(split_kernel<8>)};
  out[0] = out[1] = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs > out[0] ? fa.numRegs : out[0];
    const int local = static_cast<int>(fa.localSizeBytes);
    out[1] = local > out[1] ? local : out[1];
  }
  out[2] = kMaxThreads;
  out[3] = kMaxThreads * 8;
  out[4] = kMaxSplit;
  return 0;
}
