// Staged G-chain (butterfly) kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/butterfly.py:
//   g_chain_kernel     <- batched_butterfly_apply (_batched_butterfly_kernel)
//                         and butterfly_apply (_butterfly_kernel) as B = 1
//   g_operator_kernel  <- batched_sym_operator_apply (_batched_fused_sym_kernel)
//                         and sym_operator_apply (_fused_sym_kernel) as B = 1
//
// Semantics (the plain PyTorch versions in src/repro_torch/kernels/ref.py):
// a stage st holds P pairwise-disjoint pairs (i, j) with values (c, s, sigma);
// per signal row it computes y_i = c x_i + s x_j, y_j = sigma (-s x_i + c x_j).
// Pad entries carry the out-of-bounds index n and are exact no-ops, so they
// are skipped.  The operator runs the adjoint leg, scales by the (n+1)-wide
// dummy-padded spectrum, then runs the forward leg, in one launch.
//
// Design.  One CTA owns one (matrix b, tile of `rows` signal rows).  The tile
// (rows x ld floats, ld = n+1 rounded up to an odd count) sits in dynamic
// shared memory for the whole chain: x is read from device memory once and y
// written once, also across both legs of the operator.  A stage is a loop
// over (pair, row) work items, row fastest, so the 32 lanes of a warp read
// one table entry (a broadcast) and touch 32 rows at an odd stride (no bank
// conflicts).  A __syncthreads() separates consecutive stages.
//
// Bound on this card.  Stages are narrow (at n = 256, g = 4096 a batched fit
// packs S = 440 stages of P = 63 slots, of which only ~9 per stage are real
// pairs; the rest are pads, read and skipped): a stage is ~rows*P*8 flops
// between two barriers, so the kernel is bound by the stage barriers and the
// per-stage table reads, not by arithmetic or by the single HBM pass over x
// and y.  The design answers with
// many rows per CTA (so a stage has enough work items per barrier) and with
// several CTAs per SM (tiles small enough that the barrier stalls of one CTA
// overlap another's work).  The anytime cut is a runtime (first stage, stage
// count) per leg: no recompilation, and a count of 0 is a valid cut.
#include <cuda_runtime.h>

namespace {

struct Leg {
  const int* ii;
  const int* jj;
  const float* c;
  const float* s;
  const float* sg;
  long long bstride;  // elements between consecutive matrices' tables (0: shared)
  int P;              // pairs per stage
  int s0;             // first stage to run
  int ns;             // number of stages to run
};

__device__ __forceinline__ void run_leg(float* tile, int ld, int rows, int n,
                                        int b, const Leg& leg) {
  const long long base = (long long)b * leg.bstride;
  const int items = rows * leg.P;
  for (int st = leg.s0; st < leg.s0 + leg.ns; ++st) {
    const long long off = base + (long long)st * leg.P;
    for (int w = threadIdx.x; w < items; w += blockDim.x) {
      const int p = w / rows;
      const int r = w - p * rows;
      const int i = __ldg(leg.ii + off + p);
      const int j = __ldg(leg.jj + off + p);
      if (i < n && j < n) {
        const float c = __ldg(leg.c + off + p);
        const float s = __ldg(leg.s + off + p);
        const float g = __ldg(leg.sg + off + p);
        float* row = tile + r * ld;
        const float xi = row[i];
        const float xj = row[j];
        row[i] = c * xi + s * xj;
        row[j] = g * (-s * xi + c * xj);
      }
    }
    __syncthreads();
  }
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

__global__ void g_chain_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int R, int n, int ld,
                               int rows_per_tile, Leg leg) {
  extern __shared__ float tile[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_tile;
  const int rows = min(rows_per_tile, R - r0);
  const long long xoff = ((long long)b * R + r0) * n;
  load_tile(tile, ld, x + xoff, rows, n);
  run_leg(tile, ld, rows, n, b, leg);
  store_tile(y + xoff, tile, ld, rows, n);
}

__global__ void g_operator_kernel(const float* __restrict__ x,
                                  float* __restrict__ y,
                                  const float* __restrict__ d, int R, int n,
                                  int ld, int rows_per_tile, Leg adj,
                                  Leg fwd) {
  extern __shared__ float tile[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_tile;
  const int rows = min(rows_per_tile, R - r0);
  const long long xoff = ((long long)b * R + r0) * n;
  load_tile(tile, ld, x + xoff, rows, n);
  run_leg(tile, ld, rows, n, b, adj);
  const float* db = d + (long long)b * (n + 1);
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n;
    const int col = e - r * n;
    tile[r * ld + col] *= db[col];
  }
  __syncthreads();
  run_leg(tile, ld, rows, n, b, fwd);
  store_tile(y + xoff, tile, ld, rows, n);
}

inline int odd_stride(int n) { return (n + 1) | 1; }

inline Leg make_leg(const int* ii, const int* jj, const float* c,
                    const float* s, const float* sg, long long bstride, int P,
                    int s0, int ns) {
  Leg leg;
  leg.ii = ii;
  leg.jj = jj;
  leg.c = c;
  leg.s = s;
  leg.sg = sg;
  leg.bstride = bstride;
  leg.P = P;
  leg.s0 = s0;
  leg.ns = ns;
  return leg;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt into on the current device.
int repro_max_smem_optin(void) {
  int dev = 0;
  int v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y[b] = Ubar_b x[b] over stages [s0, s0 + ns) of tables (B, S, P) with
// matrix stride `bstride` (0 for one shared table set).  x, y: (B, R, n).
int g_chain_launch(const float* x, float* y, int B, int R, int n,
                   const int* ii, const int* jj, const float* c,
                   const float* s, const float* sg, long long bstride, int P,
                   int s0, int ns, int rows_per_tile, int threads,
                   void* stream) {
  if (B == 0 || R == 0) return 0;
  const int ld = odd_stride(n);
  const size_t smem = (size_t)rows_per_tile * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      g_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + rows_per_tile - 1) / rows_per_tile, B);
  g_chain_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, y, R, n, ld, rows_per_tile,
      make_leg(ii, jj, c, s, sg, bstride, P, s0, ns));
  return (int)cudaGetLastError();
}

// y[b] = Ubar_b diag(d[b]) Ubar_b^T x[b]: the adjoint leg runs stages
// [a0, a0 + na) of the adjoint tables, the forward leg [f0, f0 + nf) of the
// forward tables; d is (B, n + 1) with 1.0 in the dummy column n.
int g_operator_launch(const float* x, float* y, const float* d, int B, int R,
                      int n, const int* aii, const int* ajj, const float* ac,
                      const float* as, const float* asg, long long abstride,
                      int aP, int a0, int na, const int* fii, const int* fjj,
                      const float* fc, const float* fs, const float* fsg,
                      long long fbstride, int fP, int f0, int nf,
                      int rows_per_tile, int threads, void* stream) {
  if (B == 0 || R == 0) return 0;
  const int ld = odd_stride(n);
  const size_t smem = (size_t)rows_per_tile * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      g_operator_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + rows_per_tile - 1) / rows_per_tile, B);
  g_operator_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, y, d, R, n, ld, rows_per_tile,
      make_leg(aii, ajj, ac, as, asg, abstride, aP, a0, na),
      make_leg(fii, fjj, fc, fs, fsg, fbstride, fP, f0, nf));
  return (int)cudaGetLastError();
}

}  // extern "C"
