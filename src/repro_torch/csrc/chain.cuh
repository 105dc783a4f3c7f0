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
// operator.  A filter bank holds two such tiles (the analysis leg's
// coefficients and a work tile) and writes one y per filter.  A stage is a
// loop over (entry, row) work items, row fastest, so a warp's 32 lanes read
// one table entry (a broadcast) and touch 32 rows at an odd stride (no bank
// conflicts).  Within a stage the packer makes the entries' touch sets
// disjoint, so every work item's reads and writes are its own; one
// __syncthreads() orders consecutive stages.
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

// y[b, f] = second_b diag(gains[b, f]) first_b x[b] for every filter
// f < F, for this CTA's tile; gains are (B, F, n + 1) with 1.0 in the dummy
// column n, y is (B, F, R, n).  The first leg runs once: its coefficients
// stay in the first shared tile while each filter scales a copy into the
// second tile and runs the second leg there.  F is a runtime count.
template <class Op>
__device__ __forceinline__ void bank_tile(int R, int n, int ld,
                                          int rows_per_tile, const float* x,
                                          float* y, const float* gains, int F,
                                          const Leg<Op>& first,
                                          const Leg<Op>& second) {
  extern __shared__ float tile[];
  float* coeff = tile;
  float* work = tile + (size_t)rows_per_tile * ld;
  const TileSpan t = tile_span(R, n, rows_per_tile);
  const int r0 = blockIdx.x * rows_per_tile;
  load_tile(coeff, ld, x + t.off, t.rows, n);
  run_leg(coeff, ld, t.rows, n, t.b, first);
  for (int f = 0; f < F; ++f) {
    const long long bf = (long long)t.b * F + f;
    const float* g = gains + bf * (n + 1);
    for (int e = threadIdx.x; e < t.rows * n; e += blockDim.x) {
      const int r = e / n;
      const int col = e - r * n;
      work[r * ld + col] = coeff[r * ld + col] * g[col];
    }
    __syncthreads();
    run_leg(work, ld, t.rows, n, t.b, second);
    store_tile(y + (bf * R + r0) * n, work, ld, t.rows, n);
    // filter f + 1 overwrites the work tile that filter f is storing
    __syncthreads();
  }
}

// Launch `kernel(R, n, ld, rows_per_tile, args...)` on a grid of (row
// tiles, matrices) with `tiles` tiles of rows_per_tile rows in dynamic
// shared memory.  Returns a cudaError_t code (0: launched).
template <class... Params, class... Args>
inline int launch_tiled(void (*kernel)(int, int, int, int, Params...), int B,
                        int R, int n, int rows_per_tile, int tiles,
                        int threads, void* stream, Args... args) {
  if (B == 0 || R == 0) return 0;
  const int ld = odd_stride(n);
  const size_t smem = (size_t)tiles * rows_per_tile * ld * sizeof(float);
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
