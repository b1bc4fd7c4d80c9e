// Streaming top-k-per-bin passes of the exact top-k retrieval, of the exact
// int8 rounds and of the int8 single passes, for Hopper (sm_90a), bound with
// ctypes through a plain C interface.
//
// Replaces all eight kernels of hm_retrieval_tpu/ops/pallas_retrieval.py:
//   ::_bin_max2_first_kernel          (launcher bin_max2_first_round: top-2,
//                                      round 1, no thresholds)
//   ::_bin_max2_kernel                (launcher bin_max2_round: top-2 below
//                                      the thresholds, refinement rounds)
//   ::_bin_max_kernel                 (launcher bin_max_round: top-1 below
//                                      the thresholds; round 1 is a launch
//                                      with +inf / -1 thresholds, as in the
//                                      JAX driver)
//   ::_bin_max2_scaled_first_kernel   (launcher bin_max2_scaled_first_round:
//                                      round 1 of the int8 rounds)
//   ::_bin_max2_scaled_kernel         (launcher bin_max2_scaled_round: int8
//                                      rounds 2.. below the thresholds)
//   ::_bin_max2_scaled_nomask_kernel  (launcher bin_max2_scaled_single_pass:
//                                      the int8 single pass, no fold)
//   ::_bin_max2_scaled_fold_kernel    (launcher bin_max2_scaled_fold_pass:
//                                      the int8 single pass with the fold
//                                      tournament)
//   ::_bin_max2_raw_fold_kernel       (launcher bin_max2_raw_fold_pass: the
//                                      single pass of the global-scale
//                                      index, raw dot products, F >= 1)
// All eight launchers instantiate ONE template, bin_max_kernel<kThreshold,
// kKeep, kSteps, kCat, kFold, kSliced>, so every pass computes the score of
// a (query row, catalog row) pair with the same code: the refinement rounds
// are exact only because every pass reproduces identical fp32 scores.
//
// What it computes. The catalog C (n_pad x E) is read in sub-tiles of L
// rows: bin b of sub-tile u is catalog row u*L + b. Its kind (Catalog) is
// bf16 rows; int8 codes with an fp32 scale and bias a row (kScaled); or raw
// int8 codes under one global scale (kRaw), which the driver applies to the
// k winners. The score of a (query row, catalog row) pair is the fp32 sum of
// Q @ C^T, for kScaled __fmaf_rn(sum, scale[row], bias[row]) (bias 0 or
// -inf; a -inf bias scores -inf); for kRaw the sum as it stands, with no
// epilogue at all (an identity written as fmaf(sum, 1, 0) would turn a -0
// sum into +0). For each (query row, bin) cell the kernel keeps the
// lexicographic top-kKeep (m1, a1 and, for kKeep = 2, m2, a2) under the
// order (score desc, index asc), over rows < n_valid and, with kThreshold,
// only over elements strictly below the cell's threshold (thr_s, thr_i).
// Unfilled slots hold -inf / BIG_IDX. With kFold, F consecutive sub-tiles
// make one fold chunk (chunk c = sub-tiles c*F .. c*F + F - 1, n_pad %
// (F*L) == 0): within a chunk a cell's F scores are reduced in increasing
// slot order (slot 0 taken unconditionally, a later slot where it scores
// strictly higher, so a tie keeps the lower slot), and only the winner, with
// its row u*L + b, enters the cascade. The single passes have no n_valid
// mask: the per-row passes carry validity and padding in the bias as -inf,
// and the raw pass is given full chunks of real rows only. The no-fold
// single passes (and the fold passes at F = 1, the same functions) are the
// int8 instances of the rounds' first pass, launched with n_valid = n_pad,
// so no tournament and no mask is run; the fold passes at F > 1 are the
// kFold = true instances, which compile the mask out.
//
// Design. Grid (c, L / BN, ceil(B / BM)) in clusters of c blocks along x.
// The c blocks of a cluster share one tile of up to BM = 128 query rows x
// BN = 32 bins, so every row of a launch of up to 128 rows sits in one
// block and each catalog tile is staged once per launch (once per 128-row
// group beyond). A warp computes 32 rows x 16 bins: two 16-row m-tiles that
// share each B fragment, the second skipped when it holds no real row. The
// warps of a block form `groups` groups of wpg = 2 * ceil(rows / 32) warps
// (all of the block's rows and bins), and groups = 8 / wpg, so that at
// small B the warps that would have computed all-zero row tiles walk chunks
// of their own instead: 8 warps a block at every B, one block an SM.
// Each cell's walk over the n chunks (fold chunks with kFold, sub-tiles
// otherwise) is cut into S = c * groups contiguous segments of whole
// chunks: segment s = rank * groups + group walks chunks [s * n / S,
// (s + 1) * n / S) in increasing order, and their sub-tiles in increasing
// order (a segment may be empty). A group stages its segment's BN x E
// sub-tiles through its own cp.async ring of `stages` slots (a named
// barrier of the group's threads a step); an int8 slot holds the BN code
// rows (and, kScaled, their BN scales and BN biases; a raw slot holds the
// codes alone and nothing reads scales or biases), and once it has landed
// the group converts its codes into one bf16 tile of its own (exact:
// |code| <= 128 has at most 8 significant bits), behind a second barrier.
// Its warps read
// their B fragments with ldmatrix and compute their scores with mma.sync
// m16n8k16 (bf16 operands, fp32 accumulation, k in increasing 16-wide
// steps; at E = 128 the query's A fragments stay in registers and E is
// known to the compiler), apply the kScaled epilogue, then (kFold) the
// tournament, then the eligibility test, the n_valid mask (only on a chunk
// that crosses n_valid) and the top-2 (or top-1) cascade of the single walk
// per cell, in registers; the cells hold sub-tile numbers, and the
// threshold's row index becomes a sub-tile number once, so the per-element
// work is compares and selects only. At the end every group writes its
// partial cells to shared memory, the groups of a block merge into one
// partial, and after cluster.sync() each block merges its share of the
// cells over the c blocks' partials, read through distributed shared memory
// (map_shared_rank), and writes them out. No atomics, no second launch; a
// last cluster.sync() keeps every block's shared memory alive until the
// others have read it.
//
// Why the split is exact. Within a segment the strict '>' cascade over
// increasing catalog rows yields the lexicographic top-kKeep of that
// segment's admitted elements: a later element ties an earlier one only
// with a larger index, and strict '>' keeps the earlier. The top-kKeep of a
// set under a strict total order does not depend on the order of the walk,
// and the top-kKeep of a union of disjoint sets is the top-kKeep of the
// union of their top-kKeeps. The n_valid mask and the threshold test are
// per element, so every segment admits exactly the elements the single walk
// admits. The merge compares explicitly, x beats y iff x.s > y.s ||
// (x.s == y.s && x.i < y.i), so it restores the index order between
// segments, and an unfilled (-inf, BIG_IDX) slot loses to every admitted
// element (scores that never pass '>' against -inf, such as -inf or NaN,
// are never admitted, in the single walk as in a segment; so a -inf bias
// row is never admitted). Identical scores: every (query row, catalog row)
// score comes from the same mma.sync sequence, at the same position of the
// mma tile (row % 16, bin % 8) and in the same k-order, in every segment,
// block shape, pass and kernel of the template, and the kScaled epilogue
// reads nothing but that sum and its own row's scale and bias, so it gives
// every segment and pass the same fp32 score too. The k-order and tile
// positions are those of the int8 rounds' and the raw pass's earlier
// single-walk kernels, so the template gives the scores they gave.
//
// Why the fold split is exact. A segment holds whole fold chunks, so each
// chunk's tournament sees all F of its sub-tiles in increasing slot order,
// as in the single walk, and every segment admits exactly the winners the
// single walk admits: one element per (chunk, cell), whatever the split.
// The cell stores the winner's sub-tile u = c*F + slot, and row_of turns it
// into row u*L + b, as the JAX wrapper globalizes (c*F + slot)*L + b. The
// winners of distinct chunks order as their chunks do, since their rows lie
// in disjoint increasing ranges, and the tournament already kept the lowest
// slot of a tie within a chunk; so the segment's strict '>' cascade over
// increasing chunks gives the lexicographic top-kKeep of its winners, and
// the merge above, unchanged, gives the single walk's. A split inside a
// chunk would not: two sub-tiles of one (chunk, bin) in two segments would
// each send a winner, and both rows could survive.
//
// What bounds it on the H100. One bf16 pass reads the catalog once (27 MB at
// the H&M catalog, E = 128; an int8 pass 13-17 MB of codes and, kScaled,
// 0.9-1 MB of scales and biases) and writes 2-4 (B, L) outputs; its product
// is 2 * B *
// n_pad * E operations, so by the roofline the pass is bound by memory bytes
// at B <= 128 and by operations at B = 1024 (the single pass: 0.0347 ms of
// tensor work against 0.0155 ms of bytes over 131,072 rows at the published
// 989 TFLOP/s and 3.35 TB/s of the H100 SXM at its 700 W limit; PERF.md times
// the passes on an NVIDIA H100 80GB HBM3 at 700 W). The launcher picks the
// cluster size (pick_cluster): the largest whose whole grid the card holds at
// once, by its occupancy query; every group keeps up to `stages - 1` tiles in
// flight. At B = 128 the per-chunk compute, not the bytes, sets the pace: by
// the ablation of bin_max_bench.py the ring alone takes about half of kernel
// 1's time, and the mma.sync steps and the cascade add to it one after the
// other, since each of the SM's 8 warps runs both and no other warp hides
// them (PERF.md). The int8 instances move half the bytes but are slower than
// the bf16 ones: converting each landed tile (and its second barrier) is
// their largest part at every B and does not overlap the mma steps;
// converting the B fragments in registers instead would keep the conversion
// and repeat it on the warps that share a bin half.
// At B = 1024 the single passes run 8 row groups of 64 bin tiles, one block
// each (no cluster fits the 512 blocks in one wave), and each block walks
// every chunk: the conversion, the mma.sync steps and the cascade (about 8
// compares and selects per score at E = 128, on the SM's 128 lanes about
// what the mma costs at the tensor-core peak) run one after the other on
// each warp, each of the 8 row groups converts the same codes again, and
// mma.sync does not reach the peak that bounds the pass.
//
// The walks over E (Walk). The whole-E instances (kWhole) keep the block's
// (tile_rows, E) query tile resident and stage whole BN x E sub-tiles, so
// at 128 query rows their shared memory grows with E until two ring slots
// no longer fit (231,424 of 232,448 bytes at E = 576 for int8). Past the
// widths they took before (whole_e_max: 512 bf16, 576 int8) every pass
// runs a K-sliced walk instead, which streams the catalog in slices of EK =
// 128 columns (the last one E % EK wide where EK does not divide E): ring
// step i of a segment stages slice i % nsl of its sub-tile i / nsl (BN x
// EK, bf16 or int8 codes, the kScaled scales and biases with the last
// slice), and an int8 slice converts into the group's bf16 tile of one
// slice. The warp's accumulators stay in registers across a sub-tile's
// slices, whose mma.sync steps run k in increasing 16-wide steps at the
// same fragment positions, so each score is the one accumulator chain of
// the whole-E instances, with the same bits; the epilogue, tournament,
// mask, threshold test and cascade run once, after the sub-tile's last
// slice. Segments and the merges are the whole-E instances'.
//   The resident walk (kResident) keeps the block's query tile resident
// for the whole walk, as the whole-E instances do, and streams only the
// catalog's slices: slice s reads its A fragments at column s * EK of the
// tile. A block then holds fewer query rows: the most of 128, 64 and 32
// whose (rows, E + PAD) bf16 tile fits beside two ring slots and the
// partial cells (shape_for: 128 to E = 576, 64 to 1,488, 32 to 3,296), so
// B = 128 runs 2 or 4 row-group blocks a bin tile at E = 1024 or 2048,
// each reading the bin tile's catalog slices itself (from L2 where the
// other row group's read left them). Each block's rows start at a multiple
// of 32, so a score keeps its fragment position (row % 16, bin % 8). A
// full slice runs unrolled (slice_scores), its fragments loaded two mma
// steps ahead, and its copies index 16-byte vectors by constants.
// What bounds it at E = 1024, B = 128 on the H100 (PERF.md, the ablation of
// bin_max_bench.py): the walk's own compute, its ldmatrix reads of both
// operands from shared memory and its mma.sync steps, takes about two
// thirds of the time and the slice copies the rest, the two adding up
// rather than overlapping; at E = 2048 the copies of 4 row groups lead.
//   The re-read walk (kReread), past E = 3,296 where 32 query rows no
// longer fit, stages the block's query slice (real rows x EK; the rows past
// them are zeroed once) beside the catalog slice in every ring slot: the
// query is read again for every sub-tile, from L2 (B x E x 2 bytes per BN
// catalog rows and row group), four times the catalog's bytes at B = 128.
//   The walk is chosen by E and the catalog's kind alone (walk_for), never
// by B, the pass or the round, so every round of a refinement runs one
// walk; the wrappers can force the resident or the re-read walk at any E
// where it fits, and phase 2 of chip_smoke.py holds all three walks to the
// same bits. PERF.md times them on the H100.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128;           // query rows per block, at most
constexpr int BN = 32;            // bins per block
constexpr int WM = 2;             // 16-row m-tiles per warp (32 rows)
constexpr int WN = 2;             // 8-bin n-tiles per warp (16 bins)
constexpr int MAX_WARPS = 8;      // warps per block
constexpr int MAX_STAGES = 12;    // ring depth of a warp group, at most
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int PAD = 8;            // bf16 of row padding in shared memory
constexpr int PS = BN + 8;        // row stride of the partial cells
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block
constexpr int A_STEPS = 8;        // E = 128: A fragments kept in registers
constexpr int EK = 128;           // k slice of the sliced walks
constexpr int BIG_IDX = 0x7fffffff;

// The catalog's kind (the C interface passes it as 0, 1, 2): bf16 rows;
// int8 codes with an fp32 scale and bias a row; raw int8 codes, whose sum is
// the score.
enum class Catalog { kBf16 = 0, kScaled = 1, kRaw = 2 };

__host__ __device__ constexpr bool is_int8(Catalog cat) {
  return cat != Catalog::kBf16;
}

// The walk over E of a pass (the C interface's walk selector: 1 forces the
// resident walk, 2 the re-read walk, 0 lets E and the kind choose): whole
// BN x E sub-tiles with the query tile resident; K slices of the catalog
// with the query tile resident; K slices of the catalog and of the query.
enum class Walk { kWhole = 0, kResident = 1, kReread = 2 };

// The widest E of a kind's whole-E instances, the widths they took before
// the sliced walks (at 128 query rows the int8 kind's fill 231,424 of a
// block's 232,448 bytes at 576); past it every pass of that kind runs a
// sliced walk, so no whole-E instance runs at a width it never ran at.
constexpr int whole_e_max(Catalog cat) { return is_int8(cat) ? 576 : 512; }

// Bytes of one ring slot: BN catalog rows of width E as bf16 (row stride
// E + PAD), or as int8 codes (row stride E), for kScaled followed by their
// BN scales and BN biases. The host's shape_for and the kernel's ring both
// take it from here.
__host__ __device__ constexpr int slot_bytes(int E, Catalog cat) {
  return cat == Catalog::kBf16     ? BN * (E + PAD) * 2
         : cat == Catalog::kScaled ? BN * E + 2 * BN * 4
                                   : BN * E;
}

// Bytes a group keeps beside its ring: for int8, the bf16 tile its warps
// read, converted from the landed slot.
__host__ __device__ constexpr int tile_bytes(int E, Catalog cat) {
  return is_int8(cat) ? BN * (E + PAD) * 2 : 0;
}

// Bytes of one ring slot of the re-read walk: the catalog's slice (a slot
// of width EK), then the query slice of tile_rows bf16 rows (row stride
// EK + PAD).
__host__ __device__ constexpr int sliced_slot_bytes(int tile_rows,
                                                    Catalog cat) {
  return slot_bytes(EK, cat) + tile_rows * (EK + PAD) * 2;
}

// Block shape of a launch over B query rows of width E. It depends on B, E,
// the catalog's kind and the walk only, never on the pass, and it never
// changes what a score is.
struct Shape {
  int rows;    // query rows a block holds: a multiple of 32, at most BM
  int wpg;     // warps per group: 2 per 32-row pair of m-tiles
  int groups;  // warp groups, each walking its own segment
  int stages;  // ring depth of each group
  int smem;    // dynamic shared memory, bytes
};

// The shape of a block of tile_rows query rows: the most warp groups that
// keep at least two ring slots each.
Shape shape_at(int tile_rows, int E, Catalog cat, Walk walk) {
  Shape s;
  s.rows = tile_rows;
  s.wpg = tile_rows / 32 * (BN / (8 * WN));
  const bool sliced = walk != Walk::kWhole;
  // the re-read walk keeps no query tile: its slots hold query slices
  const int stage = walk == Walk::kReread ? sliced_slot_bytes(tile_rows, cat)
                                          : slot_bytes(sliced ? EK : E, cat);
  const int tile = tile_bytes(sliced ? EK : E, cat);
  const int qbytes = walk == Walk::kReread ? 0 : tile_rows * (E + PAD) * 2;
  const int part = 2 * tile_rows * PS * 8;  // keep-2 partial cells a group
  for (s.groups = MAX_WARPS / s.wpg;; --s.groups) {
    s.stages = (SMEM_MAX - qbytes - s.groups * tile) / (s.groups * stage);
    if (s.stages > MAX_STAGES) s.stages = MAX_STAGES;
    const int ring = s.groups * (s.stages * stage + tile);
    const int parts = s.groups * part;
    s.smem = qbytes + (ring > parts ? ring : parts);
    if ((s.stages >= 2 && s.smem <= SMEM_MAX) || s.groups == 1) break;
  }
  return s;
}

bool fits(const Shape& s) { return s.stages >= 2 && s.smem <= SMEM_MAX; }

// A block holds min(B, BM) query rows rounded up to 32; in the resident
// walk, the most of 128, 64 and 32 (capped so) whose query tile fits beside
// two ring slots and the partial cells. The grid has ceil(B / rows) row
// groups.
Shape shape_for(int B, int E, Catalog cat, Walk walk) {
  const int need = ((B < BM ? B : BM) + 31) / 32 * 32;
  for (int cap = BM;; cap /= 2) {
    const Shape s = shape_at(need < cap ? need : cap, E, cat, walk);
    if (walk != Walk::kResident || fits(s) || cap == 32) return s;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n groups are pending (n < MAX_STAGES); waiting for
// more than needed is always safe.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 11: cp_async_wait<11>(); break;
    case 10: cp_async_wait<10>(); break;
    case 9: cp_async_wait<9>(); break;
    case 8: cp_async_wait<8>(); break;
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// Barrier of one warp group (named barrier id, its thread count).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-wide k step of m-tile mm's 16 x 16 scores: A fragment a, B
// fragments b of the warp's two n-tiles.
__device__ __forceinline__ void mma_step(float (&acc)[WN][4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_bf16_16816(acc[0], a, b[0], b[1]);
  mma_bf16_16816(acc[1], a, b[2], b[3]);
}

// acc[mm][jj][e] += the score of query row mm * 16 + g + (e >> 1) * 8 of the
// warp's 32 and bin jj * 8 + 2t + (e & 1) of its 16 in a staged tile, summed
// in 16-wide mma steps of increasing k: the one k-order of every pass,
// whether the A fragments come from registers (kSteps = E / 16 > 0) or from
// shared memory (kSteps = 0). The second m-tile is skipped unless `two`.
// ldmatrix.x4: lane l gives the address of row l & 7 of matrix l >> 3;
// pa[mm] points at m-tile mm's A matrices (rows 0-7 | 8-15) x (k 0-7 |
// 8-15) -> a0..a3, pb at the B matrices (bins 0-7, k 0-7), (0-7, 8-15),
// (8-15, 0-7), (8-15, 8-15) -> b0, b1 of the two n-tiles.
template <int kSteps>
__device__ __forceinline__ void tile_scores(
    const __nv_bfloat16* const (&pa)[WM], const __nv_bfloat16* pb, int E,
    bool two, const uint32_t (&areg)[WM][kSteps > 0 ? kSteps : 1][4],
    float (&acc)[WM][WN][4]) {
  if (kSteps > 0) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      uint32_t b[4];
      ldmatrix_x4(b, pb + k * 16);
      mma_step(acc[0], areg[0][k], b);
      if (two) mma_step(acc[1], areg[1][k], b);
    }
  } else {
    for (int k0 = 0; k0 < E; k0 += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4(b, pb + k0);
      ldmatrix_x4(a, pa[0] + k0);
      mma_step(acc[0], a, b);
      if (two) {
        ldmatrix_x4(a, pa[1] + k0);
        mma_step(acc[1], a, b);
      }
    }
  }
}

// One full K slice (EK columns) of the sliced walks: as tile_scores<0> over
// EK columns (k in increasing 16-wide steps, the same fragment positions,
// so the same sums), unrolled, each step's fragments loaded two steps
// ahead of its mma.sync so that the ldmatrix latency overlaps the earlier
// steps' products.
__device__ __forceinline__ void slice_scores(
    const __nv_bfloat16* const (&pa)[WM], const __nv_bfloat16* pb, bool two,
    float (&acc)[WM][WN][4]) {
  constexpr int kK = EK / 16, kAhead = 2;
  uint32_t a[kAhead + 1][WM][4], b[kAhead + 1][4];
  auto fetch = [&](int k) {
    const int f = k % (kAhead + 1);
    ldmatrix_x4(b[f], pb + k * 16);
    ldmatrix_x4(a[f][0], pa[0] + k * 16);
    if (two) ldmatrix_x4(a[f][1], pa[1] + k * 16);
  };
#pragma unroll
  for (int k = 0; k < kAhead; ++k) fetch(k);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (k + kAhead < kK) fetch(k + kAhead);
    const int f = k % (kAhead + 1);
    mma_step(acc[0], a[f][0], b[f]);
    if (two) mma_step(acc[1], a[f][1], b[f]);
  }
}

// Rows 0 .. n-1 of `vpr` 16-byte vectors each, one cp.async a vector, by
// the group's threads (row strides in bytes: dld in shared memory, sld in
// global memory).
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dld,
                                           const unsigned char* src,
                                           size_t sld, int n, int vpr,
                                           int gtid, int gthreads) {
  for (int v = gtid; v < n * vpr; v += gthreads) {
    const int r = v / vpr, cv = v - r * vpr;
    cp_async16(dst + r * dld + cv * 16, src + r * sld + cv * 16);
  }
}

// Codes 2h and 2h + 1 of the four int8 codes in w as bf16x2, the lower in
// the low half. Exact: the fp32 with bits 0x4B0000uu is 2^23 + uu, so with
// uu = code + 128 it less 2^23 + 128 is the code; a value of at most 8
// significant bits is the upper half of its fp32, which is its bf16.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int h) {
  const uint32_t u = w ^ 0x80808080u;  // code + 128, one byte each
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + 2 * h)) -
      8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + 2 * h)) -
      8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// A landed int8 slot's BN code rows (row stride E bytes) into the group's
// bf16 tile (row stride ld), 8 codes a thread and step.
__device__ __forceinline__ void codes_to_bf16(const unsigned char* src,
                                              __nv_bfloat16* dst, int E,
                                              int ld, int gtid,
                                              int gthreads) {
  const int vecs = E / 8;
  for (int v = gtid; v < BN * vecs; v += gthreads) {
    const int r = v / vecs, cv = v % vecs;
    const uint2 w = *reinterpret_cast<const uint2*>(src + r * E + cv * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + cv * 8) =
        make_uint4(codes_bf16x2(w.x, 0), codes_bf16x2(w.x, 1),
                   codes_bf16x2(w.y, 0), codes_bf16x2(w.y, 1));
  }
}

// Running lexicographic top-kKeep of one cell in the merge.
template <int kKeep>
struct Top {
  float s1, s2;
  int i1, i2;

  // Empty: both slots (neg_inf = -inf, BIG_IDX).
  __device__ __forceinline__ explicit Top(float neg_inf)
      : s1(neg_inf), s2(neg_inf), i1(BIG_IDX), i2(BIG_IDX) {}

  static __device__ __forceinline__ bool beats(float xs, int xi, float ys,
                                               int yi) {
    return xs > ys || (xs == ys && xi < yi);
  }

  __device__ __forceinline__ void take(float s, int i) {
    if (beats(s, i, s1, i1)) {
      if (kKeep == 2) {
        s2 = s1;
        i2 = i1;
      }
      s1 = s;
      i1 = i;
    } else if (kKeep == 2 && beats(s, i, s2, i2)) {
      s2 = s;
      i2 = i;
    }
  }
};

// Cell offset `o` merged over n <= kMax partials (slot k of partial p at
// ps[p][k * stride + o], pi[p][...]), in increasing partial order. All
// loads come before the first comparison.
template <int kKeep, int kMax>
__device__ __forceinline__ Top<kKeep> merged(const float* const (&ps)[kMax],
                                             const int* const (&pi)[kMax],
                                             int n, int o, int stride) {
  float s[kMax][kKeep];
  int ix[kMax][kKeep];
#pragma unroll
  for (int p = 0; p < kMax; ++p)
#pragma unroll
    for (int k = 0; k < kKeep; ++k)
      if (p < n) {
        s[p][k] = ps[p][k * stride + o];
        ix[p][k] = pi[p][k * stride + o];
      }
  Top<kKeep> top(-CUDART_INF_F);
#pragma unroll
  for (int p = 0; p < kMax; ++p)
#pragma unroll
    for (int k = 0; k < kKeep; ++k)
      if (p < n) top.take(s[p][k], ix[p][k]);
  return top;
}

// Block (32 * wpg, groups) threads, grid (c, L / BN, ceil(B / rows)) in
// clusters of (c, 1, 1). Dynamic shared memory (shape_for(B, E, kCat,
// kWalk).smem): the query tile (none in the re-read walk), then the groups'
// rings (and, for int8, each group's bf16 tile), which the partial cells
// reuse after the walk. n_chunks counts the chunks of the walk: fold chunks
// of `fold` sub-tiles with kFold, sub-tiles otherwise (fold is read only
// with kFold). The sliced walks (kSteps = 0) stage the catalog in slices of
// EK columns, the re-read walk the query's too.
template <bool kThreshold, int kKeep, int kSteps, Catalog kCat, bool kFold,
          Walk kWalk>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
    bin_max_kernel(const __nv_bfloat16* __restrict__ q,  // (B, E)
                   const void* __restrict__ c,  // (n_pad, E) bf16 or int8
                   const float* __restrict__ scales,  // (n_pad,), kScaled
                   const float* __restrict__ bias,    // (n_pad,), kScaled
                   const float* __restrict__ thr_s,   // (B, L)
                   const int* __restrict__ thr_i,     // (B, L)
                   float* __restrict__ m1_out, int* __restrict__ a1_out,
                   float* __restrict__ m2_out, int* __restrict__ a2_out,
                   int B, int E, int L, int n_chunks, int n_valid,
                   int fold, int stages) {
  constexpr bool kInt8 = is_int8(kCat);
  constexpr bool kSliced = kWalk != Walk::kWhole;
  constexpr bool kReread = kWalk == Walk::kReread;
  static_assert(!kSliced || kSteps == 0, "a slice reads A from shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());

  const int gthreads = blockDim.x;  // threads of a warp group
  const int tile_rows = gthreads / 2;  // 32 rows a warp, 2 warps a pair
  const int groups = blockDim.y;
  const int grp = threadIdx.y;
  const int gtid = threadIdx.x;  // thread in its group
  const int tid = grp * gthreads + gtid;
  const int nthreads = gthreads * groups;
  const int warp = gtid >> 5;
  const int wrow = (warp >> 1) * 32;  // the warp's 32 rows of the tile
  const int wbin = (warp & 1) * 16;   // its 16 bins of the block's BN
  const int lane = gtid & 31;
  const int g = lane >> 2;  // mma group id: fragment row / column
  const int t = lane & 3;   // thread in group
  const int bin0 = blockIdx.y * BN;
  const int row0 = blockIdx.z * (kWalk == Walk::kResident ? tile_rows : BM);
  const int rows = min(B - row0, tile_rows);  // real rows of the block
  const bool active = wrow < rows;            // m-tile 0 holds a real row
  const bool two = wrow + 16 < rows;          // so does m-tile 1
  // the staged width: E, known to the compiler at kSteps > 0, or one slice
  const int Ek = kSliced ? EK : kSteps > 0 ? 16 * kSteps : E;
  const int ld = Ek + PAD;  // shared row stride of a staged tile, in bf16
  const int vecs = Ek / 8;  // 16-byte vectors per bf16 row
  // the resident query tile's width and row stride (the re-read walk: its
  // slices', ld)
  const int qw = kSliced ? E : Ek;
  const int qld = kReread ? ld : qw + PAD;
  // a ring slot: the catalog's sub-tile (slice), then (kReread) the query
  // slice
  const int cbytes = slot_bytes(Ek, kCat);
  const int stage = kReread ? cbytes + tile_rows * ld * 2 : cbytes;
  const int F = kFold ? fold : 1;  // sub-tiles a chunk
  const int nsl = kSliced ? (E + Ek - 1) / Ek : 1;  // slices a sub-tile

  unsigned char* ring = smem_raw + (kReread ? 0 : tile_rows * qld * 2);
  // this group's ring, then (int8) its bf16 tile
  unsigned char* sc = ring + grp * (stages * stage + tile_bytes(Ek, kCat));
  __nv_bfloat16* sconv = reinterpret_cast<__nv_bfloat16*>(sc + stages * stage);
  // the query: the resident tile, or (kReread) slot 0's query slice
  __nv_bfloat16* sq =
      reinterpret_cast<__nv_bfloat16*>(kReread ? sc + cbytes : smem_raw);

  if constexpr (kReread) {
    // The query slices' rows past the block's real rows, zeroed once in
    // every slot of the group's ring: the loads write the real rows only.
    const int pad = (tile_rows - rows) * vecs;
    for (int v = gtid; v < stages * pad; v += gthreads) {
      const int sl = v / pad, r = rows + v % pad / vecs, cv = v % vecs;
      *reinterpret_cast<uint4*>(sq + sl * (stage / 2) + r * ld + cv * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    // Query tile, resident for the whole run, in one cp.async group of its
    // own; rows past B are zeros.
    const int qvecs = qw / 8;
    for (int v = tid; v < tile_rows * qvecs; v += nthreads) {
      const int r = v / qvecs, cv = v % qvecs;
      if (r < rows)
        cp_async16(sq + r * qld + cv * 8,
                   q + (size_t)(row0 + r) * qw + cv * 8);
      else
        *reinterpret_cast<uint4*>(sq + r * qld + cv * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  }

  // This group's segment of the chunk walk: whole chunks, one sub-tile a
  // step (kSliced: nsl steps a sub-tile), starting at sub-tile u0.
  const int nseg = csize * groups;
  const int seg = rank * groups + grp;
  const int ch0 = static_cast<int>((long long)seg * n_chunks / nseg);
  const int steps =
      F * (static_cast<int>((long long)(seg + 1) * n_chunks / nseg) - ch0);
  const int u0 = ch0 * F;

  // Stage step i of the segment into ring slot `slot` (one cp.async group,
  // empty past the end so that the count of groups stays fixed).
  auto load = [&](int i, int slot) {
    if constexpr (kSliced) {
      if (i < steps * nsl) {
        // slice i % nsl, columns k0 .. k0 + w - 1, of sub-tile u0 + i / nsl
        const int u = i / nsl, k0 = (i - u * nsl) * Ek;
        const int w = min(Ek, E - k0);
        const size_t row = (size_t)(u0 + u) * L + bin0;  // the tile's first
        unsigned char* dst = sc + slot * stage;
        // the catalog slice: BN rows of w columns, a full slice's count of
        // 16-byte vectors known to the compiler
        const int esize = kInt8 ? 1 : 2;  // bytes of a catalog element
        const unsigned char* src = static_cast<const unsigned char*>(c) +
                                   (row * E + k0) * esize;
        const int dld = kInt8 ? Ek : ld * 2;  // the slot's row stride
        if (w == Ek)
          stage_rows(dst, dld, src, (size_t)E * esize, BN, EK * esize / 16,
                     gtid, gthreads);
        else
          stage_rows(dst, dld, src, (size_t)E * esize, BN, w * esize / 16,
                     gtid, gthreads);
        if constexpr (kCat == Catalog::kScaled) {
          // with the last slice, which the epilogue follows
          if (k0 + w == E && gtid < 2 * (BN / 4)) {
            const int which = gtid / (BN / 4), cv = gtid % (BN / 4);
            cp_async16(dst + BN * Ek + which * BN * 4 + cv * 16,
                       (which ? bias : scales) + row + cv * 4);
          }
        }
        if constexpr (kReread) {
          // the query slice of the block's real rows
          const unsigned char* qs =
              reinterpret_cast<const unsigned char*>(q + (size_t)row0 * E + k0);
          if (w == Ek)
            stage_rows(dst + cbytes, ld * 2, qs, (size_t)E * 2, rows,
                       EK * 2 / 16, gtid, gthreads);
          else
            stage_rows(dst + cbytes, ld * 2, qs, (size_t)E * 2, rows,
                       w * 2 / 16, gtid, gthreads);
        }
      }
    } else if (i < steps) {
      const size_t row = (size_t)(u0 + i) * L + bin0;  // the tile's first
      unsigned char* dst = sc + slot * stage;
      if constexpr (kInt8) {
        const int8_t* src = static_cast<const int8_t*>(c) + row * Ek;
        const int cvecs = Ek / 16;  // 16-byte vectors per int8 row
        for (int v = gtid; v < BN * cvecs; v += gthreads) {
          const int r = v / cvecs, cv = v % cvecs;
          cp_async16(dst + r * Ek + cv * 16, src + (size_t)r * Ek + cv * 16);
        }
        if constexpr (kCat == Catalog::kScaled) {
          if (gtid < 2 * (BN / 4)) {  // BN scales, then BN biases
            const int which = gtid / (BN / 4), cv = gtid % (BN / 4);
            cp_async16(dst + BN * Ek + which * BN * 4 + cv * 16,
                       (which ? bias : scales) + row + cv * 4);
          }
        }
      } else {
        const __nv_bfloat16* src =
            static_cast<const __nv_bfloat16*>(c) + row * Ek;
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
        for (int v = gtid; v < BN * vecs; v += gthreads) {
          const int r = v / vecs, cv = v % vecs;
          cp_async16(d + r * ld + cv * 8, src + (size_t)r * Ek + cv * 8);
        }
      }
    }
    cp_async_commit();
  };

  // Cell (mm, jj, e) of this thread: row wrow + mm * 16 + g + (e >> 1) * 8
  // of the block's tile, bin wbin + jj * 8 + 2t + (e & 1) of its BN (the mma
  // accumulator layout), catalog row u * L + bin0 + that bin of sub-tile u.
  // During the walk a1 and a2 hold sub-tile numbers (BIG_IDX: unfilled),
  // and the threshold's index ti is held as tc = floor((ti - bin0 - bin) /
  // L), so that the row test flat > ti is the sub-tile test u > tc. With
  // kFold, (fs, fu) is the running winner of the chunk's tournament.
  float m1[WM][WN][4], m2[WM][WN][4], ts[WM][WN][4], fs[WM][WN][4];
  int a1[WM][WN][4], a2[WM][WN][4], tc[WM][WN][4], fu[WM][WN][4];
  const int bin_t = bin0 + wbin + 2 * t;  // the bin of cell (0, 0, 0)
#pragma unroll
  for (int mm = 0; mm < WM; ++mm) {
#pragma unroll
    for (int jj = 0; jj < WN; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m1[mm][jj][e] = -CUDART_INF_F;
        m2[mm][jj][e] = -CUDART_INF_F;
        a1[mm][jj][e] = BIG_IDX;
        a2[mm][jj][e] = BIG_IDX;
        ts[mm][jj][e] = CUDART_INF_F;
        tc[mm][jj][e] = -1;
        fs[mm][jj][e] = -CUDART_INF_F;
        fu[mm][jj][e] = BIG_IDX;
        if (kThreshold) {
          const int row = row0 + wrow + mm * 16 + g + (e >> 1) * 8;
          const int bin = bin_t + jj * 8 + (e & 1);
          if (row < B) {
            const size_t o = (size_t)row * L + bin;
            ts[mm][jj][e] = thr_s[o];
            // floor((ti - bin) / L), or -1 below 0: the same test for
            // every chunk >= 0
            const int ti = thr_i[o];
            tc[mm][jj][e] = ti < bin ? -1 : (ti - bin) / L;
          }
        }
      }
    }
  }

  for (int i = 0; i < stages - 1; ++i) load(i, i);
  cp_async_wait_dyn(stages - 1);  // the query tile has landed ...
  __syncthreads();                // ... for every thread

  const int r8 = lane & 7, mi = lane >> 3;
  const __nv_bfloat16* pa[WM];
#pragma unroll
  for (int mm = 0; mm < WM; ++mm)
    pa[mm] = sq + (wrow + mm * 16 + r8 + (mi & 1) * 8) * qld + (mi >> 1) * 8;
  // B fragments: from the landed bf16 slot, or from the group's bf16 tile
  const __nv_bfloat16* pb =
      (kInt8 ? sconv : reinterpret_cast<const __nv_bfloat16*>(sc)) +
      (wbin + r8 + (mi >> 1) * 8) * ld + (mi & 1) * 8;
  uint32_t areg[WM][kSteps > 0 ? kSteps : 1][4];
  if (kSteps > 0) {
#pragma unroll
    for (int mm = 0; mm < WM; ++mm)
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        ldmatrix_x4(areg[mm][k], pa[mm] + k * 16);
  }

  // The kScaled epilogue of one chunk's sums: score = sum * scale + bias of
  // the cell's catalog row, from the landed slot's scales and biases.
  auto scaled = [&](float (&acc)[WM][WN][4], int landed) {
    const float* sb = reinterpret_cast<const float*>(sc + landed * stage +
                                                     BN * Ek);
#pragma unroll
    for (int jj = 0; jj < WN; ++jj) {
      const int b = wbin + jj * 8 + 2 * t;
      const float2 s2 = *reinterpret_cast<const float2*>(sb + b);
      const float2 b2 = *reinterpret_cast<const float2*>(sb + BN + b);
#pragma unroll
      for (int mm = 0; mm < WM; ++mm)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mm][jj][e] = __fmaf_rn(acc[mm][jj][e], e & 1 ? s2.y : s2.x,
                                     e & 1 ? b2.y : b2.x);
    }
  };

  // The cascade of one step's scores into the cells, each score from
  // sub-tile index(mm, jj, e); `masked` (a compile-time flag) applies the
  // n_valid mask, which a sub-tile whose bins all lie below n_valid does
  // not need.
  auto cascade = [&](const float (&acc)[WM][WN][4], auto index,
                     auto masked) {
#pragma unroll
    for (int mm = 0; mm < WM; ++mm) {
      if (mm == 1 && !two) break;
#pragma unroll
      for (int jj = 0; jj < WN; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // An element that is not admitted counts as -inf, which never
          // passes '>': it is folded into both tests.
          const float s = acc[mm][jj][e];
          const int ch = index(mm, jj, e);
          bool ok = true;
          if (decltype(masked)::value)
            ok = ch * L + bin_t + jj * 8 + (e & 1) < n_valid;
          if (kThreshold)
            ok = ok & ((s < ts[mm][jj][e]) |
                       ((s == ts[mm][jj][e]) & (ch > tc[mm][jj][e])));
          const bool gt1 = ok & (s > m1[mm][jj][e]);
          if (kKeep == 2) {
            const bool gt2 = ok & (s > m2[mm][jj][e]);
            m2[mm][jj][e] = gt1 ? m1[mm][jj][e] : (gt2 ? s : m2[mm][jj][e]);
            a2[mm][jj][e] = gt1 ? a1[mm][jj][e] : (gt2 ? ch : a2[mm][jj][e]);
          }
          m1[mm][jj][e] = gt1 ? s : m1[mm][jj][e];
          a1[mm][jj][e] = gt1 ? ch : a1[mm][jj][e];
        }
      }
    }
  };

  // The fold tournament of sub-tile u's scores (kFold): the first slot of a
  // chunk is taken unconditionally, a later one where it scores strictly
  // higher, so a tie keeps the lower slot.
  auto tournament = [&](const float (&acc)[WM][WN][4], int u, bool first) {
#pragma unroll
    for (int mm = 0; mm < WM; ++mm) {
      if (mm == 1 && !two) break;
#pragma unroll
      for (int jj = 0; jj < WN; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool take = first | (acc[mm][jj][e] > fs[mm][jj][e]);
          fs[mm][jj][e] = take ? acc[mm][jj][e] : fs[mm][jj][e];
          fu[mm][jj][e] = take ? u : fu[mm][jj][e];
        }
      }
    }
  };

  int slot = 0;   // ring slot of step i
  int fslot = 0;  // fold slot of step i: segments start at a chunk

  // Step i of the walk has landed, for the group: the slot of step i-1 is
  // free for step i + stages - 1, and (int8) the landed codes are
  // converted into the group's bf16 tile.
  auto land = [&](int i) {
    cp_async_wait_dyn(stages - 2);  // step i has landed ...
    group_sync(1 + grp, gthreads);  // ... for the group; slot i-1 is free
    load(i + stages - 1, slot == 0 ? stages - 1 : slot - 1);
    if constexpr (kInt8) {
      // the bf16 tile is free: every warp of the group is past step i-1
      codes_to_bf16(sc + slot * stage, sconv, Ek, ld, gtid, gthreads);
      group_sync(1 + grp, gthreads);
    }
  };

  // Sub-tile u's sums, complete (its last slice with kSliced), from ring
  // slot `landed`: the kScaled epilogue, then the fold tournament or the
  // cascade.
  auto finish = [&](float (&acc)[WM][WN][4], int u, int landed) {
    if constexpr (kCat == Catalog::kScaled) scaled(acc, landed);
    if constexpr (kFold) {
      tournament(acc, u, fslot == 0);
      if (fslot == F - 1)
        cascade(fs, [&](int mm, int jj, int e) { return fu[mm][jj][e]; },
                std::false_type());
    } else if (u * L + bin0 + BN <= n_valid) {
      cascade(acc, [u](int, int, int) { return u; }, std::false_type());
    } else {
      cascade(acc, [u](int, int, int) { return u; }, std::true_type());
    }
  };

  if constexpr (kSliced) {
    // Step i sums slice s of sub-tile u into acc, which holds the sub-tile's
    // sums across its slices.
    float acc[WM][WN][4];
    for (int i = 0, s = 0, u = u0; i < steps * nsl; ++i) {
      land(i);
      if (active) {
        if (s == 0) {
#pragma unroll
          for (int mm = 0; mm < WM; ++mm)
#pragma unroll
            for (int jj = 0; jj < WN; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mm][jj][e] = 0.f;
        }
        const int at = slot * (stage / 2);  // the slot, in bf16
        // A: the slot's query slice, or slice s of the resident tile
        const __nv_bfloat16* pas[WM];
#pragma unroll
        for (int mm = 0; mm < WM; ++mm)
          pas[mm] = pa[mm] + (kReread ? at : s * Ek);
        const int w = min(Ek, E - s * Ek);  // the slice's columns
        if (w == Ek)
          slice_scores(pas, kInt8 ? pb : pb + at, two, acc);
        else
          tile_scores<0>(pas, kInt8 ? pb : pb + at, w, two, areg, acc);
        if (s == nsl - 1) finish(acc, u, slot);
      }
      slot = slot + 1 == stages ? 0 : slot + 1;
      if (++s == nsl) {
        s = 0;
        ++u;
        if constexpr (kFold) fslot = fslot + 1 == F ? 0 : fslot + 1;
      }
    }
  } else {
    for (int i = 0; i < steps; ++i) {
      land(i);
      if (active) {
        float acc[WM][WN][4];
#pragma unroll
        for (int mm = 0; mm < WM; ++mm)
#pragma unroll
          for (int jj = 0; jj < WN; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mm][jj][e] = 0.f;
        tile_scores<kSteps>(pa, kInt8 ? pb : pb + slot * BN * ld, Ek, two,
                            areg, acc);
        finish(acc, u0 + i, slot);  // sub-tile u0 + i
      }
      slot = slot + 1 == stages ? 0 : slot + 1;
      if constexpr (kFold) fslot = fslot + 1 == F ? 0 : fslot + 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every group is past its walk: the ring is free

  // Partial cells over the ring: slot k of group y, cell (row r of the
  // tile, bin b) at k * stride + y * cells + r * PS + b. The padded row
  // stride PS keeps the paired stores free of bank conflicts.
  const int part = tile_rows * PS;  // cells of one group's partial
  const int stride = groups * part;  // from one slot to the next
  float* ps = reinterpret_cast<float*>(ring);
  int* pi = reinterpret_cast<int*>(ps + kKeep * stride);
  // The catalog row of sub-tile number a at bin bin_t + off.
  auto row_of = [&](int a, int off) {
    return a == BIG_IDX ? BIG_IDX : a * L + bin_t + off;
  };
  if (active) {
#pragma unroll
    for (int mm = 0; mm < WM; ++mm) {
#pragma unroll
      for (int jj = 0; jj < WN; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8: e = 2h, 2h + 1
          const int o = grp * part + (wrow + mm * 16 + g + h * 8) * PS +
                        wbin + jj * 8 + 2 * t;
          const int e = 2 * h;
          *reinterpret_cast<float2*>(ps + o) =
              make_float2(m1[mm][jj][e], m1[mm][jj][e + 1]);
          *reinterpret_cast<int2*>(pi + o) =
              make_int2(row_of(a1[mm][jj][e], jj * 8),
                        row_of(a1[mm][jj][e + 1], jj * 8 + 1));
          if (kKeep == 2) {
            *reinterpret_cast<float2*>(ps + stride + o) =
                make_float2(m2[mm][jj][e], m2[mm][jj][e + 1]);
            *reinterpret_cast<int2*>(pi + stride + o) =
                make_int2(row_of(a2[mm][jj][e], jj * 8),
                          row_of(a2[mm][jj][e + 1], jj * 8 + 1));
          }
        }
      }
    }
  }
  __syncthreads();

  // The block's groups merge into group 0's partial.
  const int ncell = rows * BN;
  if (groups > 1) {
    const float* gps[MAX_WARPS];
    const int* gpi[MAX_WARPS];
#pragma unroll
    for (int y = 0; y < MAX_WARPS; ++y) {
      gps[y] = ps + y * part;
      gpi[y] = pi + y * part;
    }
#pragma unroll 2
    for (int cell = tid; cell < ncell; cell += nthreads) {
      const int o = cell / BN * PS + cell % BN;
      const Top<kKeep> top =
          merged<kKeep, MAX_WARPS>(gps, gpi, groups, o, stride);
      ps[o] = top.s1;
      pi[o] = top.i1;
      if (kKeep == 2) {
        ps[stride + o] = top.s2;
        pi[stride + o] = top.i2;
      }
    }
  }
  cluster.sync();  // every block's partial is complete

  // This block's share of the cells, merged over the cluster's blocks.
  const float* rps[MAX_CLUSTER];
  const int* rpi[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) {
    rps[r] = cluster.map_shared_rank(ps, r < csize ? r : 0);
    rpi[r] = cluster.map_shared_rank(pi, r < csize ? r : 0);
  }
  const int lo = static_cast<int>((long long)rank * ncell / csize);
  const int hi = static_cast<int>((long long)(rank + 1) * ncell / csize);
#pragma unroll 4
  for (int cell = lo + tid; cell < hi; cell += nthreads) {
    const Top<kKeep> top = merged<kKeep, MAX_CLUSTER>(
        rps, rpi, csize, cell / BN * PS + cell % BN, stride);
    const size_t o = (size_t)(row0 + cell / BN) * L + bin0 + cell % BN;
    m1_out[o] = top.s1;
    a1_out[o] = top.i1;
    if (kKeep == 2) {
      m2_out[o] = top.s2;
      a2_out[o] = top.i2;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

using KernelFn = void (*)(const __nv_bfloat16*, const void*, const float*,
                          const float*, const float*, const int*, float*,
                          int*, float*, int*, int, int, int, int, int, int,
                          int);

// The instantiation a pass runs at width E: a sliced walk's, else A
// fragments in registers at E = 16 * A_STEPS, from shared memory
// otherwise. All four sum in one k-order.
template <bool kThreshold, int kKeep, Catalog kCat, bool kFold = false>
KernelFn kernel_for(int E, Walk walk) {
  constexpr Walk kW = Walk::kWhole;
  return walk == Walk::kResident
             ? bin_max_kernel<kThreshold, kKeep, 0, kCat, kFold,
                              Walk::kResident>
         : walk == Walk::kReread
             ? bin_max_kernel<kThreshold, kKeep, 0, kCat, kFold, Walk::kReread>
         : E == 16 * A_STEPS
             ? bin_max_kernel<kThreshold, kKeep, A_STEPS, kCat, kFold, kW>
             : bin_max_kernel<kThreshold, kKeep, 0, kCat, kFold, kW>;
}

// The walk of a pass of kind `cat` at width E: the whole-E instances up to
// the kind's whole_e_max, then the resident walk up to the widest E at
// which 32 query rows fit a block (3,296 for every kind), then the re-read
// walk; or the walk the caller forces (force 1: resident, 2: re-read; the
// checks that hold the walks to the same bits).
Walk walk_for(int E, Catalog cat, int force) {
  if (force == 1) return Walk::kResident;
  if (force == 2) return Walk::kReread;
  if (E <= whole_e_max(cat)) return Walk::kWhole;
  return fits(shape_for(1, E, cat, Walk::kResident)) ? Walk::kResident
                                                     : Walk::kReread;
}

cudaError_t prepare(KernelFn kernel, int B, int E, Catalog cat, Walk walk,
                    Shape* s) {
  if (B <= 0 || E <= 0 || E % 16 != 0) return cudaErrorInvalidValue;
  *s = shape_for(B, E, cat, walk);
  if (!fits(*s)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s->smem);
}

// Grid (cluster, L / BN, ceil(B / rows)) in clusters of (cluster, 1, 1).
cudaLaunchConfig_t config(const Shape& s, int B, int L, int cluster,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, L / BN, (B + s.rows - 1) / s.rows);
  cfg.blockDim = dim3(32 * s.wpg, s.groups, 1);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `cluster` blocks of `kernel` at shape s that the current
// device holds at once (cudaOccupancyMaxActiveClusters), cached by kernel,
// device, block shape and cluster size: the query costs more than a launch.
cudaError_t resident_clusters(KernelFn kernel, const Shape& s, int cluster,
                              int* out) {
  struct Entry {
    KernelFn kernel;
    int device, wpg, groups, smem, cluster, clusters;
  };
  static std::mutex mu;
  static Entry cache[256];
  static int cached = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < cached; ++i) {
      const Entry& e = cache[i];
      if (e.kernel == kernel && e.device == device && e.wpg == s.wpg &&
          e.groups == s.groups && e.smem == s.smem && e.cluster == cluster) {
        *out = e.clusters;
        return cudaSuccess;
      }
    }
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(s, 1, BN, cluster, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (cached < 256)
    cache[cached++] = {kernel, device, s.wpg, s.groups, s.smem, cluster, *out};
  return cudaSuccess;
}

// The cluster size of a launch of `tiles` bin tiles x row groups: the
// largest power of two c <= MAX_CLUSTER for which the card holds all `tiles`
// clusters of c blocks at once, so the grid runs in one wave; 1 when no c
// > 1 does. A grid that needs a second wave lost to a smaller cluster in one
// wave on the H100 (PERF.md).
cudaError_t pick_cluster(KernelFn kernel, const Shape& s, int tiles,
                         int* cluster) {
  for (int c = MAX_CLUSTER; c > 1; c /= 2) {
    int resident = 0;
    const cudaError_t err = resident_clusters(kernel, s, c, &resident);
    if (err != cudaSuccess) return err;
    if (resident >= tiles) {
      *cluster = c;
      return cudaSuccess;
    }
  }
  *cluster = 1;
  return cudaSuccess;
}

// Clusters of a launch: bin tiles x row groups.
int tiles_of(int B, int L, const Shape& s) {
  return L / BN * ((B + s.rows - 1) / s.rows);
}

// The kernel of a pass: keep 1 or 2, thresholds or not, the catalog's
// kind, (fold > 1) the fold tournament, and the walk. A per-row single
// pass at fold 1 is the int8 first round's kernel; the raw pass has no
// thresholds.
KernelFn pass_kernel(int keep, int threshold, Catalog cat, int fold, int E,
                     Walk walk) {
  constexpr Catalog kB = Catalog::kBf16, kS = Catalog::kScaled,
                    kR = Catalog::kRaw;
  if (cat == kR)
    return fold > 1 ? kernel_for<false, 2, kR, true>(E, walk)
                    : kernel_for<false, 2, kR>(E, walk);
  if (cat == kS && fold > 1) return kernel_for<false, 2, kS, true>(E, walk);
  if (cat == kS)
    return threshold ? kernel_for<true, 2, kS>(E, walk)
                     : kernel_for<false, 2, kS>(E, walk);
  return keep == 1   ? kernel_for<true, 1, kB>(E, walk)
         : threshold ? kernel_for<true, 2, kB>(E, walk)
                     : kernel_for<false, 2, kB>(E, walk);
}

// A pass over n_pad rows in chunks of `fold` sub-tiles of L rows (fold = 1
// but for the fold passes), by the kernel pass_kernel picks; force (1
// resident, 2 re-read) runs that sliced walk at any E it fits.
int launch(int keep, int threshold, Catalog cat, const void* q, const void* c,
           const void* scales, const void* bias, const void* thr_s,
           const void* thr_i, void* m1, void* a1, void* m2, void* a2, int B,
           int E, int n_pad, int L, int n_valid, int fold, int force,
           void* stream) {
  if (L <= 0 || L % BN != 0 || fold <= 0 || n_pad <= 0 ||
      n_pad % ((long long)L * fold) != 0 || force < 0 || force > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Walk walk = walk_for(E, cat, force);
  const KernelFn kernel = pass_kernel(keep, threshold, cat, fold, E, walk);
  Shape s;
  cudaError_t err = prepare(kernel, B, E, cat, walk, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cluster = 1;
  err = pick_cluster(kernel, s, tiles_of(B, L, s), &cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(s, B, L, cluster, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q), c,
      static_cast<const float*>(scales), static_cast<const float*>(bias),
      static_cast<const float*>(thr_s), static_cast<const int*>(thr_i),
      static_cast<float*>(m1), static_cast<int*>(a1), static_cast<float*>(m2),
      static_cast<int*>(a2), B, E, L, n_pad / (L * fold), n_valid, fold,
      s.stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher returns cudaGetLastError() after the launch (0 = success);
// a refused launch (e.g. cudaErrorClusterOutOfResources) returns its error.
// walk 1 runs the resident walk, 2 the re-read walk, at any E where it fits
// (the checks that hold the walks to the same bits pass it); 0 lets E and
// the kind choose.
extern "C" int bin_max2_first_round(const void* q, const void* c, void* m1,
                                    void* a1, void* m2, void* a2, int B,
                                    int E, int n_pad, int L, int n_valid,
                                    int walk, void* stream) {
  return launch(2, 0, Catalog::kBf16, q, c, nullptr, nullptr, nullptr, nullptr,
                m1, a1, m2, a2, B, E, n_pad, L, n_valid, 1, walk,
                stream);
}

extern "C" int bin_max2_round(const void* q, const void* c, const void* thr_s,
                              const void* thr_i, void* m1, void* a1, void* m2,
                              void* a2, int B, int E, int n_pad, int L,
                              int n_valid, int walk, void* stream) {
  return launch(2, 1, Catalog::kBf16, q, c, nullptr, nullptr, thr_s, thr_i, m1,
                a1, m2, a2, B, E, n_pad, L, n_valid, 1, walk, stream);
}

extern "C" int bin_max_round(const void* q, const void* c, const void* thr_s,
                             const void* thr_i, void* m, void* a, int B, int E,
                             int n_pad, int L, int n_valid, int walk,
                             void* stream) {
  return launch(1, 1, Catalog::kBf16, q, c, nullptr, nullptr, thr_s, thr_i, m,
                a, nullptr, nullptr, B, E, n_pad, L, n_valid, 1, walk,
                stream);
}

extern "C" int bin_max2_scaled_first_round(const void* q, const void* codes,
                                           const void* scales,
                                           const void* bias, void* m1,
                                           void* a1, void* m2, void* a2,
                                           int B, int E, int n_pad, int L,
                                           int n_valid, int walk,
                                           void* stream) {
  return launch(2, 0, Catalog::kScaled, q, codes, scales, bias, nullptr,
                nullptr, m1, a1, m2, a2, B, E, n_pad, L, n_valid, 1,
                walk, stream);
}

extern "C" int bin_max2_scaled_round(const void* q, const void* codes,
                                     const void* scales, const void* bias,
                                     const void* thr_s, const void* thr_i,
                                     void* m1, void* a1, void* m2, void* a2,
                                     int B, int E, int n_pad, int L,
                                     int n_valid, int walk,
                                     void* stream) {
  return launch(2, 1, Catalog::kScaled, q, codes, scales, bias, thr_s, thr_i,
                m1, a1, m2, a2, B, E, n_pad, L, n_valid, 1, walk,
                stream);
}

// The int8 single passes: every row is streamed (n_valid = n_pad), a -inf
// bias marks the invalid and padded ones. The fold pass reduces each fold
// chunk of F sub-tiles per cell before the cascade.
extern "C" int bin_max2_scaled_single_pass(const void* q, const void* codes,
                                           const void* scales,
                                           const void* bias, void* m1,
                                           void* a1, void* m2, void* a2,
                                           int B, int E, int n_pad, int L,
                                           int walk, void* stream) {
  return launch(2, 0, Catalog::kScaled, q, codes, scales, bias, nullptr,
                nullptr, m1, a1, m2, a2, B, E, n_pad, L, n_pad, 1,
                walk, stream);
}

extern "C" int bin_max2_scaled_fold_pass(const void* q, const void* codes,
                                         const void* scales, const void* bias,
                                         void* m1, void* a1, void* m2,
                                         void* a2, int B, int E, int n_pad,
                                         int L, int F, int walk,
                                         void* stream) {
  return launch(2, 0, Catalog::kScaled, q, codes, scales, bias, nullptr,
                nullptr, m1, a1, m2, a2, B, E, n_pad, L, n_pad, F,
                walk, stream);
}

// The raw single pass of the global-scale index: the catalog is full chunks
// of F sub-tiles of real rows (n_full % (F * L) == 0), so every row is
// streamed (n_valid = n_full) with no mask, no scale and no bias.
extern "C" int bin_max2_raw_fold_pass(const void* q, const void* codes,
                                      void* m1, void* a1, void* m2, void* a2,
                                      int B, int E, int n_full, int L, int F,
                                      int walk, void* stream) {
  return launch(2, 0, Catalog::kRaw, q, codes, nullptr, nullptr, nullptr,
                nullptr, m1, a1, m2, a2, B, E, n_full, L, n_full, F,
                walk, stream);
}

// Launch shape of a pass (keep 1 or 2; threshold 0 or 1; catalog 0 = bf16,
// 1 = int8 scaled, 2 = int8 raw; fold 1, or F > 1 for an int8 fold pass)
// over B rows of width E and L bins, as launch() takes it unforced:
// out[0..13] = cluster size, warps per block, warp groups, ring stages,
// shared bytes, registers a thread, local (spilled) bytes a thread,
// clusters of the launch (bin tiles x row groups), clusters of 1, 2, 4 and
// 8 blocks resident at once, the walk (0 whole-E, 1 resident, 2 re-read)
// and the query rows a block holds. Returns a CUDA error code (0 =
// success).
extern "C" int bin_max_launch_info(int keep, int threshold, int catalog,
                                   int fold, int B, int E, int L, int* out) {
  if (catalog < 0 || catalog > 2 || L <= 0 || L % BN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Catalog cat = static_cast<Catalog>(catalog);
  const Walk w = walk_for(E, cat, 0);
  const KernelFn kernel = pass_kernel(keep, threshold, cat, fold, E, w);
  Shape s;
  cudaError_t err = prepare(kernel, B, E, cat, w, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = pick_cluster(kernel, s, tiles_of(B, L, s), &out[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = s.wpg * s.groups;
  out[2] = s.groups;
  out[3] = s.stages;
  out[4] = s.smem;
  out[5] = fa.numRegs;
  out[6] = static_cast<int>(fa.localSizeBytes);
  out[7] = tiles_of(B, L, s);
  for (int i = 0, c = 1; c <= MAX_CLUSTER; ++i, c *= 2) {
    err = resident_clusters(kernel, s, c, &out[8 + i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  out[12] = static_cast<int>(w);
  out[13] = s.rows;
  return 0;
}
