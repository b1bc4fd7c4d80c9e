// PartialReduce of a materialized fp32 score matrix for Hopper (sm_90a),
// bound with ctypes through a plain C interface.
//
// Replaces the TPU's hardware PartialReduce that lax.approx_max_k runs at
// hm_retrieval_tpu/ops/exact_topk.py:63 (exact_topk_scores) and
// hm_retrieval_tpu/indices/brute_force.py:238 (the "approx" engine). That
// is an XLA operation, not a Pallas kernel: the TPU reduces each row of x
// to L bin maxima, then sorts them. This kernel is the reduction; the sort
// of the L maxima (topk_pair) stays in Python, in ops/partial_reduce.py.
//
// What it computes. x is (B, n) fp32, row-major. Bin j of a row holds the
// columns j, j + L, j + 2L, ..., j + (T - 1) L, T = 2^r, the row taken as
// padded with -inf to L * T entries (L * T >= n). For each (row b, bin j)
// the kernel writes the bin's largest value to vals[b, j] and, among equal
// values, its lowest column to rows[b, j]. The walk is in increasing t
// with a strict >, starting from (-inf, j), so a bin whose entries are all
// -inf (a bin made only of padding included) returns -inf and column j,
// which is >= n for a bin of padding alone. A NaN never wins a bin.
//
// Bound. One read of x and one write of the (B, L) values and columns:
// B * n * 4 + B * L * 8 bytes over the card's memory bandwidth. There is no
// arithmetic to speak of.
//
// Design. One thread per (row, bin): thread j of a row walks its T
// columns, so at each step t the 32 threads of a warp read 32 consecutive
// floats (one 128-byte line), and the T loads of a thread are independent,
// unrolled so that several are in flight. Blocks of 256 threads tile the
// bins along x; rows go along y (a grid-stride loop over rows beyond the
// grid's y limit). Nothing is staged in shared memory: each element is read
// once. This is the simple kernel; a wide-T row at small B (few threads,
// long walks) is where a later design would split the walk.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
    partial_reduce_kernel(const float* __restrict__ x,
                          float* __restrict__ vals, int* __restrict__ rows,
                          int B, int n, int L, int T) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= L) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* xr = x + static_cast<int64_t>(b) * n;
    float best = -INFINITY;
    int arg = j;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const int64_t col = static_cast<int64_t>(t) * L + j;
      const float v = col < n ? __ldg(xr + col) : -INFINITY;
      if (v > best) {
        best = v;
        arg = static_cast<int>(col);
      }
    }
    const int64_t out = static_cast<int64_t>(b) * L + j;
    vals[out] = best;
    rows[out] = arg;
  }
}

}  // namespace

// x (B, n) fp32 -> vals (B, L) fp32, rows (B, L) int32, over bins of
// T = 2^r columns each; L * T >= n and L * T < 2^31. Launches on `stream`
// and does not synchronise. Returns a CUDA error code (0 = success).
extern "C" int partial_reduce(const void* x, void* vals, void* rows, int B,
                              int n, int L, int r, void* stream) {
  if (B <= 0 || n <= 0 || L <= 0 || r < 0 || r > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t T = int64_t{1} << r;
  if (L * T < n || L * T >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + kThreads - 1) / kThreads, B < kMaxGridY ? B : kMaxGridY);
  partial_reduce_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(rows), B, n, L, static_cast<int>(T));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's registers and local (spilled) bytes a thread, as the
// compiler left them: out[0] = registers, out[1] = local bytes,
// out[2] = threads a block. Returns a CUDA error code (0 = success).
extern "C" int partial_reduce_launch_info(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, partial_reduce_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = kThreads;
  return 0;
}
