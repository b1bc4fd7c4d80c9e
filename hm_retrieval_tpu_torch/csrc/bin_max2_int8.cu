// Top-2-per-bin single pass over an int8 catalog with one global scale, for
// Hopper (sm_90a), bound with ctypes through a plain C interface: the
// survivor selection of the global-scale quantized index's one-pass engine.
//
// Replaces one kernel of hm_retrieval_tpu/ops/pallas_retrieval.py:
//   ::_bin_max2_raw_fold_kernel  (launcher bin_max2_raw_fold_pass, F >= 1,
//                                 raw dot products)
// It is the last kernel still in the port's first design, and the next to
// become an instance of bin_max2.cu's cluster-split template (the raw one:
// no scale, no bias); the per-row single passes and the int8 rounds already
// are.
//
// What it computes. The catalog is read in sub-tiles of L rows: sub-tile u
// holds catalog rows u*L .. u*L + L - 1, and bin b of sub-tile u is row
// u*L + b. F consecutive sub-tiles make one chunk (chunk c = sub-tiles
// c*F .. c*F + F - 1), and the catalog holds full chunks of real rows only.
// Per (query row, bin) cell, the score of row u*L + b is the raw q . codes.
// Within a chunk the F scores of a cell are max-reduced in increasing slot
// order (a tie keeps the lower slot: take = s_t > s), and the winner goes
// through the cell's top-2 cascade (gt1 = s > m1, gt2 = s > m2). The outputs
// (m1, a1, m2, a2), each (B, L), hold the scores and the catalog rows
// u*L + b of the winners; an unfilled slot keeps -inf / BIG_IDX. The row
// written is the JAX wrapper's globalized chunk id (chunk*F + slot)*L + bin,
// computed as u*L + bin.
//
// Design. A block owns BM = 64 query rows x BN = 32 bins for the whole run,
// one warp per 16 rows, grid (L / BN, ceil(B / BM)), and walks the sub-tiles
// u = 0 .. n_sub-1 in increasing order with the cell state in registers: the
// strict '>' of tournament and cascade gives the (score desc, index asc)
// order only under that walk. The block stages its BN rows of each sub-tile
// as int8 through a STAGES-deep cp.async ring; the query tile stays resident
// in shared memory as bf16. Each warp computes 16 x BN scores with mma.sync
// m16n8k16 on bf16 with fp32 sums; the int8 codes are converted to bf16 in
// registers as the B fragments are built, which is exact (|code| <= 127
// fits bf16's 8-bit significand). The ring is per sub-tile, so shared memory
// does not grow with F: the tiles need 384 * E + 5,120 bytes, so E <= 576
// fits a block (the wrappers' INT8_KERNEL_MAX_E).
//
// What bounds it on the H100 (SXM: 3.35 TB/s, 989 TFLOP/s bf16, published for
// its 700 W limit). At the H&M served shapes (E = 128, L = 2048, 102,400
// full-chunk rows) one pass moves 13-17 MB (codes and the four (B, L)
// outputs) and does 2*B*rows*E operations: bound by bytes at B <= 128 and by
// operations at B = 1024. This first version makes no attempt at TMA or
// wgmma, and at B <= 64 uses 64 blocks of one query tile; its times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // query rows per block
constexpr int BN = 32;           // bins per block
constexpr int WARPS = BM / 16;   // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int NT = BN / 8;       // n-tiles of 8 bins per warp
constexpr int STAGES = 8;        // sub-tiles in flight
constexpr int QPAD = 8;          // bf16 of query row padding in shared memory
constexpr int CPAD = 16;         // bytes of code row padding in shared memory
constexpr int BIG_IDX = 0x7fffffff;
constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90

size_t smem_bytes(int E) {
  return (size_t)BM * (E + QPAD) * sizeof(__nv_bfloat16) +
         (size_t)STAGES * BN * (E + CPAD);
}

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

// Two consecutive int8 codes -> bf16x2, the lower index in the low half.
__device__ __forceinline__ uint32_t codes_bf16x2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(v.x),
                                           static_cast<float>(v.y));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Grid: (L / BN, ceil(B / BM)). Dynamic shared memory: smem_bytes(E).
__global__ void __launch_bounds__(THREADS)
    raw_fold_kernel(const __nv_bfloat16* __restrict__ q,  // (B, E)
                    const int8_t* __restrict__ codes,     // (n_sub*L, E)
                    float* __restrict__ m1_out, int* __restrict__ a1_out,
                    float* __restrict__ m2_out, int* __restrict__ a2_out,
                    int B, int E, int L, int F, int n_sub) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = E + QPAD;  // shared query row stride, in bf16
  const int ldc = E + CPAD;  // shared code row stride, in bytes
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int8_t* sc = reinterpret_cast<int8_t*>(sq + BM * ldq);  // STAGES x BN x ldc

  const int bin0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group id: fragment row / column
  const int t = lane & 3;   // thread in group

  // Query tile, resident for the whole run; rows past B are zeros.
  const int qvecs = E / 8;  // 16-byte vectors per bf16 row
  for (int v = tid; v < BM * qvecs; v += THREADS) {
    const int r = v / qvecs, cv = v % qvecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < B)
      val = *reinterpret_cast<const uint4*>(q + (size_t)(row0 + r) * E +
                                            cv * 8);
    *reinterpret_cast<uint4*>(sq + r * ldq + cv * 8) = val;
  }

  const int cvecs = E / 16;  // 16-byte vectors per int8 row
  auto load_sub = [&](int u) {
    if (u < n_sub) {
      const int stage = u % STAGES;
      const int8_t* src = codes + ((size_t)u * L + bin0) * E;
      int8_t* dst = sc + stage * BN * ldc;
      for (int v = tid; v < BN * cvecs; v += THREADS) {
        const int r = v / cvecs, cv = v % cvecs;
        cp_async16(dst + r * ldc + cv * 16, src + (size_t)r * E + cv * 16);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // Cell (j, e) of this thread: row g (e < 2) or g + 8 (e >= 2) of the
  // warp's 16, bin j*8 + 2t + (e & 1) of the block's BN: the mma
  // accumulator layout. fs / fi: the fold tournament's winner so far.
  float m1[NT][4], m2[NT][4], fs[NT][4];
  int a1[NT][4], a2[NT][4], fi[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      m1[j][e] = -CUDART_INF_F;
      m2[j][e] = -CUDART_INF_F;
      a1[j][e] = BIG_IDX;
      a2[j][e] = BIG_IDX;
      fs[j][e] = -CUDART_INF_F;
      fi[j][e] = BIG_IDX;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_sub(s);

  const __nv_bfloat16* qa = sq + (warp * 16) * ldq;
  int slot = 0;  // u % F
  for (int u = 0; u < n_sub; ++u) {
    cp_async_wait<STAGES - 2>();  // sub-tile u has landed
    __syncthreads();              // ... for every thread; slot u-1 is free
    load_sub(u + STAGES - 1);
    const int stage = u % STAGES;
    const int8_t* cs = sc + stage * BN * ldc;

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int k0 = 0; k0 < E; k0 += 16) {
      uint32_t a[4];
      a[0] = ld_u32(qa + g * ldq + k0 + 2 * t);
      a[1] = ld_u32(qa + (g + 8) * ldq + k0 + 2 * t);
      a[2] = ld_u32(qa + g * ldq + k0 + 8 + 2 * t);
      a[3] = ld_u32(qa + (g + 8) * ldq + k0 + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* cb = cs + (j * 8 + g) * ldc + k0;
        uint32_t b[2];
        b[0] = codes_bf16x2(cb + 2 * t);
        b[1] = codes_bf16x2(cb + 8 + 2 * t);
        mma_bf16_16816(acc[j], a, b);
      }
    }

    const int base = u * L + bin0;
    const bool last = slot == F - 1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int flat = base + col;
        const float s = acc[j][e];
        if (slot == 0 || s > fs[j][e]) {
          fs[j][e] = s;
          fi[j][e] = flat;
        }
        if (last) {
          const float x = fs[j][e];
          const int xi = fi[j][e];
          const bool gt1 = x > m1[j][e];
          const bool gt2 = x > m2[j][e];
          m2[j][e] = gt1 ? m1[j][e] : (gt2 ? x : m2[j][e]);
          a2[j][e] = gt1 ? a1[j][e] : (gt2 ? xi : a2[j][e]);
          m1[j][e] = gt1 ? x : m1[j][e];
          a1[j][e] = gt1 ? xi : a1[j][e];
        }
      }
    }
    slot = last ? 0 : slot + 1;
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
        m2_out[o] = m2[j][e];
        a2_out[o] = a2[j][e];
      }
    }
  }
}

int launch(const void* q, const void* codes, void* m1, void* a1, void* m2,
           void* a2, int B, int E, int n_rows, int L, int F, void* stream) {
  if (B <= 0 || E <= 0 || E % 16 != 0 || L <= 0 || L % BN != 0 || F <= 0 ||
      n_rows <= 0 || n_rows % L != 0 || (n_rows / L) % F != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(E);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      raw_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L / BN, (B + BM - 1) / BM);
  raw_fold_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(codes),
      static_cast<float*>(m1), static_cast<int*>(a1), static_cast<float*>(m2),
      static_cast<int*>(a2), B, E, L, F, n_rows / L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launcher returns cudaGetLastError() after the launch (0 = success),
// or cudaErrorInvalidValue without launching for shapes the tiles do not
// cover, including a width E whose tiles overflow shared memory.
extern "C" int bin_max2_raw_fold_pass(const void* q, const void* codes,
                                      void* m1, void* a1, void* m2, void* a2,
                                      int B, int E, int n_full, int L, int F,
                                      void* stream) {
  return launch(q, codes, m1, a1, m2, a2, B, E, n_full, L, F, stream);
}
