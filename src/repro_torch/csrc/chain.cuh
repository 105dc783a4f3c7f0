// The staged-chain kernel body shared by every table family (butterfly.cu:
// G pairs, shear.cu: T entries).  A family supplies its stage action `Op`, a
// struct of table pointers with
//   __device__ void operator()(float* row, long long e, int n) const
// that applies table entry e to one signal row held in shared memory (pads,
// with an index n, are skipped by the action).
//
// One CTA holds `rows` signal rows of width n at a row stride `ld` (n + 1
// rounded up to an odd count, so rows fall on distinct banks), reads x from
// device memory once and writes y once, also across both legs of an
// operator.  A stage is a loop over (entry, row) work items, row fastest, so
// a warp's 32 lanes read one table entry (a broadcast) and touch 32 rows at
// an odd stride (no bank conflicts).  Within a stage the packer makes the
// entries' touch sets disjoint, so every work item's reads and writes are
// its own; one __syncthreads() orders consecutive stages.
//
// The chain and operator kernels (run_leg, chain_tile, operator_tile) walk
// all P slots of a stage and read each work item's entry from device memory.
// The filter-bank kernels have a body of their own (walk_leg, bank_tile):
// a CTA owns r signal rows and F_g filters, runs the analysis leg on its r
// rows, scales them into F_g copies in the same tile and runs ONE synthesis
// walk over all F_g * r rows, so it crosses 2 S stage barriers whatever F_g
// (the earlier bank body crossed (1 + F) S); each leg walks a stage only up
// to its real extent (1 + its last real slot, from a (B, S) extent table),
// and reads its entries from a small ring of stages in shared memory that
// cp.async fills a few stages ahead, so no work item waits on device memory.
// The rows and filters per CTA (kernels/launcher.py::bank_geometry) keep the
// CTA's shared memory small enough for three resident CTAs per SM.
#pragma once

#include <cuda_runtime.h>

inline int odd_stride(int n) { return (n + 1) | 1; }

// One leg of a chain: stages [s0, s0 + ns) of (B, S, P) tables.
template <class Op>
struct Leg {
  Op op;              // the family's table pointers and stage action
  long long bstride;  // elements between consecutive matrices' tables (0: shared)
  int P;              // entries per stage
  int s0;             // first stage to run
  int ns;             // number of stages to run
};

template <class Op>
__device__ __forceinline__ void run_leg(float* tile, int ld, int rows, int n,
                                        int b, const Leg<Op>& leg) {
  const long long base = (long long)b * leg.bstride;
  const int items = rows * leg.P;
  for (int st = leg.s0; st < leg.s0 + leg.ns; ++st) {
    const long long off = base + (long long)st * leg.P;
    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int p = w / rows;
      const int r = w - p * rows;
      leg.op(tile + r * ld, off + p, n);
    }
    __syncthreads();
  }
}

// The CTA's tile: matrix blockIdx.y, rows [r0, r0 + rows) of its signal.
struct TileSpan {
  long long off;  // offset of the tile's first element in x and y
  int b;
  int rows;
};

__device__ __forceinline__ TileSpan tile_span(int R, int n,
                                              int rows_per_tile) {
  TileSpan t;
  t.b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_tile;
  t.rows = min(rows_per_tile, R - r0);
  t.off = ((long long)t.b * R + r0) * n;
  return t;
}

__device__ __forceinline__ void load_tile(float* tile, int ld, const float* x,
                                          int rows, int n) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n;
    const int col = e - r * n;
    tile[r * ld + col] = x[(long long)r * n + col];
  }
  __syncthreads();
}

__device__ __forceinline__ void store_tile(float* y, const float* tile, int ld,
                                           int rows, int n) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n;
    const int col = e - r * n;
    y[(long long)r * n + col] = tile[r * ld + col];
  }
}

// tile[r, col] *= d[col] for the (n + 1)-wide dummy-padded spectrum d.
__device__ __forceinline__ void scale_tile(float* tile, int ld, const float* d,
                                           int rows, int n) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n;
    const int col = e - r * n;
    tile[r * ld + col] *= d[col];
  }
  __syncthreads();
}

// y[b] = chain_b x[b] for this CTA's tile.
template <class Op>
__device__ __forceinline__ void chain_tile(int R, int n, int ld,
                                           int rows_per_tile, const float* x,
                                           float* y, const Leg<Op>& leg) {
  extern __shared__ float tile[];
  const TileSpan t = tile_span(R, n, rows_per_tile);
  load_tile(tile, ld, x + t.off, t.rows, n);
  run_leg(tile, ld, t.rows, n, t.b, leg);
  store_tile(y + t.off, tile, ld, t.rows, n);
}

// y[b] = second_b diag(d[b]) first_b x[b] for this CTA's tile; d is
// (B, n + 1) with 1.0 in the dummy column n.
template <class Op>
__device__ __forceinline__ void operator_tile(int R, int n, int ld,
                                              int rows_per_tile,
                                              const float* x, float* y,
                                              const float* d,
                                              const Leg<Op>& first,
                                              const Leg<Op>& second) {
  extern __shared__ float tile[];
  const TileSpan t = tile_span(R, n, rows_per_tile);
  load_tile(tile, ld, x + t.off, t.rows, n);
  run_leg(tile, ld, t.rows, n, t.b, first);
  scale_tile(tile, ld, d + (long long)t.b * (n + 1), t.rows, n);
  run_leg(tile, ld, t.rows, n, t.b, second);
  store_tile(y + t.off, tile, ld, t.rows, n);
}

// ---------------------------------------------------------------------------
// The filter bank (g_bank_kernel, t_bank_kernel)
// ---------------------------------------------------------------------------
// A bank leg walks each stage over its real extent only (the packers put a
// stage's real entries first, so 1 + its last real slot), reads the stage's
// entries from a ring of kRing stages in shared memory that cp.async fills
// kRing - 1 stages ahead, and crosses one __syncthreads() per stage: the
// barrier that orders the stages also publishes the ring slot that the next
// stage reads and frees the slot that the copy started after it overwrites.
// A family's action `Op` supplies, besides its table pointers,
//   kFields                    32-bit table fields per entry (indices first)
//   kWords                     ring words per entry (16-byte aligned)
//   field(k)                   field k's (B, S, P) table
//   apply(row, entry, n)       the entry (in the ring) on one signal row

constexpr int kRing = 4;  // stages of table entries in shared memory

template <class Op>
struct BankLeg {
  Op op;               // the family's table pointers
  const int* ext;      // (B, S) real extent of every stage
  long long bstride;   // table elements between matrices (0: shared)
  long long estride;   // extent elements between consecutive matrices
  int P;               // slots per stage
  int s0;              // first stage to run
  int ns;              // number of stages to run
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the e real entries of stage st into a ring slot (entry-major, kWords
// words per entry); asynchronous until this thread's cp_async_wait.
template <class Op>
__device__ __forceinline__ void copy_stage(const BankLeg<Op>& leg,
                                           long long base, int st, int e,
                                           float* slot) {
  const long long off = base + (long long)st * leg.P;
  for (int p = threadIdx.x; p < e; p += blockDim.x) {
#pragma unroll
    for (int k = 0; k < Op::kFields; ++k)
      cp_async4(slot + p * Op::kWords + k, leg.op.field(k) + off + p);
  }
}

// One bank leg on `rows` rows of the tile.  `ring` holds kRing slots of
// `slot_words` words, `ring_ext` their kRing extents.  Work items are
// (entry, row) pairs, rows fastest, so a warp's lanes read one ring entry
// (a broadcast) and touch rows at an odd stride (no bank conflicts); each
// thread steps through its items without a division.
template <class Op>
__device__ __forceinline__ void walk_leg(float* tile, int ld, int rows, int n,
                                         int b, const BankLeg<Op>& leg,
                                         float* ring, int slot_words,
                                         int* ring_ext) {
  const long long base = (long long)b * leg.bstride;
  const int* ext = leg.ext + (long long)b * leg.estride + leg.s0;
  for (int k = 0; k < kRing - 1; ++k) {
    if (k < leg.ns) {
      const int e = __ldg(ext + k);
      if (threadIdx.x == 0) ring_ext[k] = e;
      copy_stage(leg, base, leg.s0 + k, e, ring + k * slot_words);
    }
    cp_async_commit();
  }
  int e_next = kRing - 1 < leg.ns ? __ldg(ext + kRing - 1) : 0;
  const int q = blockDim.x / rows;
  const int rem = blockDim.x - q * rows;
  const int p0 = threadIdx.x / rows;
  const int r0 = threadIdx.x - p0 * rows;
  for (int t = 0; t < leg.ns; ++t) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage t landed
    __syncthreads();             // everyone's did; stage t - 1 is done
    const int ahead = t + kRing - 1;
    if (ahead < leg.ns) {
      const int slot = ahead % kRing;  // stage t - 1's slot, now free
      if (threadIdx.x == 0) ring_ext[slot] = e_next;
      copy_stage(leg, base, leg.s0 + ahead, e_next,
                 ring + slot * slot_words);
      e_next = ahead + 1 < leg.ns ? __ldg(ext + ahead + 1) : 0;
    }
    cp_async_commit();
    const float* stage = ring + (t % kRing) * slot_words;
    const int e = ring_ext[t % kRing];
    for (int p = p0, r = r0; p < e;) {
      Op::apply(tile + r * ld, stage + p * Op::kWords, n);
      p += q;
      r += rem;
      if (r >= rows) {
        r -= rows;
        ++p;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Shared memory of a bank CTA: the tile of `rows` rows (16-byte aligned),
// then the ring of kRing slots of slot_words words, then kRing extents.
inline size_t bank_smem(int rows, int ld, int slot_words) {
  return ((size_t)rows * ld + 3) / 4 * 16 +
         (size_t)kRing * (slot_words + 1) * sizeof(float);
}

// y[b, f] = second_b diag(gains[b, f]) first_b x[b] for the CTA's rows and
// filters; gains (B, F, n + 1) with 1.0 in the dummy column n, y
// (B, F, R, n).  CTA (blockIdx.x, b = blockIdx.y) owns row tile
// blockIdx.x % row_tiles (rows_per_cta rows) and filter group
// blockIdx.x / row_tiles (filters_per_cta filters).  It runs the first leg
// once on its rows, scales them into one copy per filter (copy f =
// coefficients * gains_f, copy 0 in place and last, since the others read
// it), and runs the second leg ONCE over all copies as one tile of
// fg * rows rows: 2 S stage barriers per CTA for any fg.  Each row's
// arithmetic is the plain version's (kernels/ref.py folds F into the row
// axis the same way).
template <class Op>
__device__ __forceinline__ void bank_tile(int R, int n, int ld,
                                          int rows_per_cta,
                                          int filters_per_cta, int row_tiles,
                                          int slot_words, const float* x,
                                          float* y, const float* gains, int F,
                                          const BankLeg<Op>& first,
                                          const BankLeg<Op>& second) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x % row_tiles) * rows_per_cta;
  const int f0 = (blockIdx.x / row_tiles) * filters_per_cta;
  const int rows = min(rows_per_cta, R - r0);
  const int fg = min(filters_per_cta, F - f0);
  float* tile = smem;
  float* ring =
      smem + ((size_t)rows_per_cta * filters_per_cta * ld + 3) / 4 * 4;
  int* ring_ext = reinterpret_cast<int*>(ring + kRing * slot_words);

  load_tile(tile, ld, x + ((long long)b * R + r0) * n, rows, n);
  walk_leg(tile, ld, rows, n, b, first, ring, slot_words, ring_ext);
  const float* g = gains + ((long long)b * F + f0) * (n + 1);
  const int span = rows * n;
  for (int e = threadIdx.x; e < (fg - 1) * span; e += blockDim.x) {
    const int f = 1 + e / span;
    const int q = e - (f - 1) * span;
    const int r = q / n;
    const int col = q - r * n;
    tile[(f * rows + r) * ld + col] =
        tile[r * ld + col] * g[(long long)f * (n + 1) + col];
  }
  __syncthreads();
  scale_tile(tile, ld, g, rows, n);
  walk_leg(tile, ld, fg * rows, n, b, second, ring, slot_words, ring_ext);
  for (int e = threadIdx.x; e < fg * span; e += blockDim.x) {
    const int row = e / n;
    const int col = e - row * n;
    const int f = row / rows;
    const int r = row - f * rows;
    y[(((long long)b * F + f0 + f) * R + r0 + r) * n + col] =
        tile[row * ld + col];
  }
}

// Launch a bank kernel on a grid of (row tiles x filter groups, matrices).
// Returns a cudaError_t code (0: launched).
template <class Op, class... Params>
inline int launch_bank(void (*kernel)(Params...), int B, int R, int n, int F,
                       int rows_per_cta, int filters_per_cta, int threads,
                       void* stream,
                       const float* x, float* y, const float* gains,
                       const BankLeg<Op>& first, const BankLeg<Op>& second) {
  if (B == 0 || R == 0) return 0;
  if (rows_per_cta < 1 || filters_per_cta < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  const int ld = odd_stride(n);
  const int slot_words = (first.P > second.P ? first.P : second.P) *
                         Op::kWords;
  const size_t smem = bank_smem(rows_per_cta * filters_per_cta, ld,
                                slot_words);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (R + rows_per_cta - 1) / rows_per_cta;
  const int groups = (F + filters_per_cta - 1) / filters_per_cta;
  const dim3 grid(row_tiles * groups, B);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      R, n, ld, rows_per_cta, filters_per_cta, row_tiles, slot_words, x, y,
      gains, F, first, second);
  return (int)cudaGetLastError();
}

// Resident CTAs per SM of `kernel` at `smem` bytes of dynamic shared memory
// and `threads` threads (the card's own occupancy reading), or a negative
// cudaError_t code.
inline int resident_ctas(const void* kernel, size_t smem, int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launch `kernel(R, n, ld, rows_per_tile, args...)` on a grid of (row
// tiles, matrices) with a tile of rows_per_tile rows in dynamic shared
// memory.  Returns a cudaError_t code (0: launched).
template <class... Params, class... Args>
inline int launch_tiled(void (*kernel)(int, int, int, int, Params...), int B,
                        int R, int n, int rows_per_tile, int threads,
                        void* stream, Args... args) {
  if (B == 0 || R == 0) return 0;
  const int ld = odd_stride(n);
  const size_t smem = (size_t)rows_per_tile * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + rows_per_tile - 1) / rows_per_tile, B);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(R, n, ld,
                                                         rows_per_tile,
                                                         args...);
  return (int)cudaGetLastError();
}
