// Streaming top-k-per-bin passes of the exact top-k retrieval, for Hopper
// (sm_90a), bound with ctypes through a plain C interface.
//
// Replaces three kernels of hm_retrieval_tpu/ops/pallas_retrieval.py:
//   ::_bin_max2_first_kernel  (launcher bin_max2_first_round: top-2, round 1,
//                              no thresholds)
//   ::_bin_max2_kernel        (launcher bin_max2_round: top-2 below the
//                              thresholds, refinement rounds)
//   ::_bin_max_kernel         (launcher bin_max_round: top-1 below the
//                              thresholds; round 1 is a launch with +inf / -1
//                              thresholds, as in the JAX driver)
// All three launchers instantiate ONE template, bin_max_kernel<kThreshold,
// kKeep>, so every pass computes the score of a (query row, catalog row) pair
// with the same code and the same tile configuration: the refinement rounds
// are exact only because every pass reproduces identical fp32 scores.
//
// What it computes. The catalog C (n_pad x E, bf16, n_pad % L == 0) is read
// in chunks of L rows; bin b of chunk c is catalog row c*L + b. For each
// (query row, bin) cell the kernel keeps the lexicographic top-kKeep (m1, a1
// and, for kKeep = 2, m2, a2) under the order (score desc, index asc) of the
// fp32 scores Q @ C^T, over rows < n_valid and, with kThreshold, only over
// elements strictly below the cell's threshold (thr_s, thr_i). Unfilled slots
// hold -inf / BIG_IDX.
//
// Design. A block owns a tile of BM query rows x BN bins for the whole run
// and walks every chunk c = 0 .. n_pad/L - 1 in increasing order, keeping
// its cells' state in registers. The strict '>' of the top-k update gives
// the index-ascending tie order only because each cell sees its chunks in
// increasing order, so no cell is split across blocks and no chunk is
// reordered. Per chunk, the block's BN catalog rows are staged in shared
// memory through a STAGES-deep cp.async ring while the query tile stays
// resident; four warps compute their 16 x BN scores with mma.sync
// m16n8k16 (bf16 operands, fp32 accumulation), then run the eligibility
// test, the n_valid mask and the top-2 (or top-1) cascade per cell. The
// keep-1 pass shares everything but the cascade and writes two outputs.
//
// What bounds it on the H100. One pass reads the catalog once (27 MB at
// the H&M catalog, E=128, against 4-6 MB of (B, L) state, 4 MB for keep 1),
// and its product is 2*B*n_pad*E operations: at B = 128 rows the pass is
// bound by memory bytes, not by the tensor cores. This first version reads
// each catalog row once per 64-row query tile (the re-reads hit the 50 MB L2)
// and makes no attempt at TMA or wgmma; its time against that bound is in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // query rows per block
constexpr int BN = 32;             // bins per block
constexpr int WARPS = BM / 16;     // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int NT = BN / 8;         // n-tiles of 8 bins per warp
constexpr int STAGES = 4;          // catalog tiles in flight
constexpr int PAD = 8;             // bf16 of row padding in shared memory
constexpr int BIG_IDX = 0x7fffffff;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Grid: (L / BN, ceil(B / BM)). Dynamic shared memory:
// (BM + STAGES * BN) * (E + PAD) bf16.
template <bool kThreshold, int kKeep>
__global__ void __launch_bounds__(THREADS)
    bin_max_kernel(const __nv_bfloat16* __restrict__ q,   // (B, E)
                    const __nv_bfloat16* __restrict__ c,   // (n_pad, E)
                    const float* __restrict__ thr_s,       // (B, L)
                    const int* __restrict__ thr_i,         // (B, L)
                    float* __restrict__ m1_out, int* __restrict__ a1_out,
                    float* __restrict__ m2_out, int* __restrict__ a2_out,
                    int B, int E, int L, int n_chunks, int n_valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = E + PAD;  // shared row stride, in bf16
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sc = sq + BM * ld;  // STAGES x (BN x ld)

  const int bin0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group id: fragment row / column
  const int t = lane & 3;   // thread in group
  const int vecs = E / 8;   // 16-byte vectors per row

  // Query tile, resident for the whole run; rows past B are zeros.
  for (int v = tid; v < BM * vecs; v += THREADS) {
    const int r = v / vecs, cv = v % vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < B)
      val = *reinterpret_cast<const uint4*>(q + (size_t)(row0 + r) * E +
                                            cv * 8);
    *reinterpret_cast<uint4*>(sq + r * ld + cv * 8) = val;
  }

  auto load_chunk = [&](int chunk) {
    if (chunk < n_chunks) {
      const __nv_bfloat16* src = c + ((size_t)chunk * L + bin0) * E;
      __nv_bfloat16* dst = sc + (chunk % STAGES) * BN * ld;
      for (int v = tid; v < BN * vecs; v += THREADS) {
        const int r = v / vecs, cv = v % vecs;
        cp_async16(dst + r * ld + cv * 8, src + (size_t)r * E + cv * 8);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // Cell (j, e) of this thread: row g (e < 2) or g + 8 (e >= 2) of the
  // warp's 16, bin j*8 + 2t + (e & 1) of the block's BN: the mma
  // accumulator layout.
  float m1[NT][4], m2[NT][4], ts[NT][4];
  int a1[NT][4], a2[NT][4], ti[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      m1[j][e] = -CUDART_INF_F;
      m2[j][e] = -CUDART_INF_F;
      a1[j][e] = BIG_IDX;
      a2[j][e] = BIG_IDX;
      ts[j][e] = CUDART_INF_F;
      ti[j][e] = -1;
      if (kThreshold) {
        const int row = row0 + warp * 16 + g + (e >> 1) * 8;
        if (row < B) {
          const size_t o = (size_t)row * L + bin0 + j * 8 + 2 * t + (e & 1);
          ts[j][e] = thr_s[o];
          ti[j][e] = thr_i[o];
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_chunk(s);

  const __nv_bfloat16* qa = sq + (warp * 16) * ld;
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();  // chunk ch has landed
    __syncthreads();              // ... for every thread; slot ch-1 is free
    load_chunk(ch + STAGES - 1);
    const __nv_bfloat16* cs = sc + (ch % STAGES) * BN * ld;

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int k0 = 0; k0 < E; k0 += 16) {
      uint32_t a[4];
      a[0] = ld_u32(qa + g * ld + k0 + 2 * t);
      a[1] = ld_u32(qa + (g + 8) * ld + k0 + 2 * t);
      a[2] = ld_u32(qa + g * ld + k0 + 8 + 2 * t);
      a[3] = ld_u32(qa + (g + 8) * ld + k0 + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* cb = cs + (j * 8 + g) * ld + k0;
        uint32_t b[2];
        b[0] = ld_u32(cb + 2 * t);
        b[1] = ld_u32(cb + 8 + 2 * t);
        mma_bf16_16816(acc[j], a, b);
      }
    }

    const int base = ch * L + bin0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int flat = base + j * 8 + 2 * t + (e & 1);
        float s = acc[j][e];
        bool ok = flat < n_valid;
        if (kThreshold)
          ok = ok && (s < ts[j][e] || (s == ts[j][e] && flat > ti[j][e]));
        s = ok ? s : -CUDART_INF_F;
        const bool gt1 = s > m1[j][e];
        if (kKeep == 2) {
          const bool gt2 = s > m2[j][e];
          m2[j][e] = gt1 ? m1[j][e] : (gt2 ? s : m2[j][e]);
          a2[j][e] = gt1 ? a1[j][e] : (gt2 ? flat : a2[j][e]);
        }
        m1[j][e] = gt1 ? s : m1[j][e];
        a1[j][e] = gt1 ? flat : a1[j][e];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + warp * 16 + g + (e >> 1) * 8;
      if (row < B) {
        const size_t o = (size_t)row * L + bin0 + j * 8 + 2 * t + (e & 1);
        m1_out[o] = m1[j][e];
        a1_out[o] = a1[j][e];
        if (kKeep == 2) {
          m2_out[o] = m2[j][e];
          a2_out[o] = a2[j][e];
        }
      }
    }
  }
}

template <bool kThreshold, int kKeep>
int launch(const void* q, const void* c, const void* thr_s, const void* thr_i,
           void* m1, void* a1, void* m2, void* a2, int B, int E, int n_pad,
           int L, int n_valid, void* stream) {
  if (B <= 0 || E <= 0 || E % 16 != 0 || L <= 0 || L % BN != 0 ||
      n_pad <= 0 || n_pad % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (size_t)(BM + STAGES * BN) * (E + PAD) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      bin_max_kernel<kThreshold, kKeep>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L / BN, (B + BM - 1) / BM);
  bin_max_kernel<kThreshold, kKeep>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(c),
          static_cast<const float*>(thr_s), static_cast<const int*>(thr_i),
          static_cast<float*>(m1), static_cast<int*>(a1),
          static_cast<float*>(m2), static_cast<int*>(a2), B, E, L, n_pad / L,
          n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher returns cudaGetLastError() after the launch (0 = success).
extern "C" int bin_max2_first_round(const void* q, const void* c, void* m1,
                                    void* a1, void* m2, void* a2, int B,
                                    int E, int n_pad, int L, int n_valid,
                                    void* stream) {
  return launch<false, 2>(q, c, nullptr, nullptr, m1, a1, m2, a2, B, E, n_pad,
                          L, n_valid, stream);
}

extern "C" int bin_max2_round(const void* q, const void* c, const void* thr_s,
                              const void* thr_i, void* m1, void* a1, void* m2,
                              void* a2, int B, int E, int n_pad, int L,
                              int n_valid, void* stream) {
  return launch<true, 2>(q, c, thr_s, thr_i, m1, a1, m2, a2, B, E, n_pad, L,
                         n_valid, stream);
}

extern "C" int bin_max_round(const void* q, const void* c, const void* thr_s,
                             const void* thr_i, void* m, void* a, int B, int E,
                             int n_pad, int L, int n_valid, void* stream) {
  return launch<true, 1>(q, c, thr_s, thr_i, m, a, nullptr, nullptr, B, E,
                         n_pad, L, n_valid, stream);
}
