// Staged G-chain (butterfly) kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/butterfly.py:
//   g_chain_kernel     <- batched_butterfly_apply (_batched_butterfly_kernel)
//                         and butterfly_apply (_butterfly_kernel) as B = 1
//   g_operator_kernel  <- batched_sym_operator_apply (_batched_fused_sym_kernel)
//                         and sym_operator_apply (_fused_sym_kernel) as B = 1
// and in src/repro/kernels/spectral.py:
//   g_bank_kernel      <- batched_sym_filter_bank_apply
//                         (_batched_bank_sym_kernel) and sym_filter_bank_apply
//                         (_bank_sym_kernel) as B = 1
//
// Semantics (the plain PyTorch versions in src/repro_torch/kernels/ref.py):
// a stage st holds P pairwise-disjoint pairs (i, j) with values (c, s, sigma);
// per signal row it computes y_i = c x_i + s x_j, y_j = sigma (-s x_i + c x_j).
// Pad entries carry the out-of-bounds index n and are exact no-ops, so they
// are skipped.  The operator runs the adjoint leg, scales by the (n+1)-wide
// dummy-padded spectrum, then runs the forward leg, in one launch.  The bank
// runs the adjoint leg once, then for each of F filters scales a copy of the
// coefficients by that filter's gains and runs the forward leg on it.
//
// Design.  One CTA owns one (matrix b, tile of `rows` signal rows).  The tile
// sits in dynamic shared memory for the whole chain: x is read from device
// memory once and y written once, also across both legs of the operator.
// The body (chain.cuh) is shared with the T kernels; this file supplies the
// stage action GPair.  A __syncthreads() separates consecutive stages.
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
//
// The bank.  The function is F + 1 legs over one signal read and F output
// writes (at B = 64, F = 7, R = n = 256 about 3.2 GFLOP against 0.14 GB:
// operation-bound on paper), but the kernel runs (1 + F) * S stage barriers
// per tile and stays bound by them, as the operator does.  It keeps the
// analysis coefficients in a second shared tile, so x is read once and the
// adjoint leg runs once per tile, not once per filter; the two tiles halve
// the rows a CTA can hold (kernels/launcher.py::rows_per_tile).  F is a
// runtime count: a new bank needs no rebuild.
#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

// A G pair (i, j) with values (c, s, sigma), applied to one signal row.
struct GPair {
  const int* ii;
  const int* jj;
  const float* c;
  const float* s;
  const float* sg;

  __device__ __forceinline__ void operator()(float* row, long long e,
                                             int n) const {
    const int i = __ldg(ii + e);
    const int j = __ldg(jj + e);
    if (i < n && j < n) {
      const float ce = __ldg(c + e);
      const float se = __ldg(s + e);
      const float ge = __ldg(sg + e);
      const float xi = row[i];
      const float xj = row[j];
      row[i] = ce * xi + se * xj;
      row[j] = ge * (-se * xi + ce * xj);
    }
  }
};

using GLeg = Leg<GPair>;

__global__ void g_chain_kernel(int R, int n, int ld, int rows_per_tile,
                               const float* __restrict__ x,
                               float* __restrict__ y, GLeg leg) {
  chain_tile(R, n, ld, rows_per_tile, x, y, leg);
}

__global__ void g_operator_kernel(int R, int n, int ld, int rows_per_tile,
                                  const float* __restrict__ x,
                                  float* __restrict__ y,
                                  const float* __restrict__ d, GLeg adj,
                                  GLeg fwd) {
  operator_tile(R, n, ld, rows_per_tile, x, y, d, adj, fwd);
}

__global__ void g_bank_kernel(int R, int n, int ld, int rows_per_tile,
                              const float* __restrict__ x,
                              float* __restrict__ y,
                              const float* __restrict__ gains, int F,
                              GLeg adj, GLeg fwd) {
  bank_tile(R, n, ld, rows_per_tile, x, y, gains, F, adj, fwd);
}

inline GLeg g_leg(const int* ii, const int* jj, const float* c, const float* s,
                  const float* sg, long long bstride, int P, int s0, int ns) {
  return GLeg{GPair{ii, jj, c, s, sg}, bstride, P, s0, ns};
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
  return launch_tiled(g_chain_kernel, B, R, n, rows_per_tile, 1, threads,
                      stream, x, y, g_leg(ii, jj, c, s, sg, bstride, P, s0,
                                          ns));
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
  return launch_tiled(g_operator_kernel, B, R, n, rows_per_tile, 1, threads,
                      stream, x, y, d,
                      g_leg(aii, ajj, ac, as, asg, abstride, aP, a0, na),
                      g_leg(fii, fjj, fc, fs, fsg, fbstride, fP, f0, nf));
}

// y[b, f] = Ubar_b diag(gains[b, f]) Ubar_b^T x[b] for f < F, legs as in
// g_operator_launch; gains (B, F, n + 1) with 1.0 in the dummy column n,
// y (B, F, R, n).  Two shared tiles of rows_per_tile rows each.
int g_bank_launch(const float* x, float* y, const float* gains, int F, int B,
                  int R, int n, const int* aii, const int* ajj,
                  const float* ac, const float* as, const float* asg,
                  long long abstride, int aP, int a0, int na, const int* fii,
                  const int* fjj, const float* fc, const float* fs,
                  const float* fsg, long long fbstride, int fP, int f0,
                  int nf, int rows_per_tile, int threads, void* stream) {
  return launch_tiled(g_bank_kernel, B, R, n, rows_per_tile, 2, threads,
                      stream, x, y, gains, F,
                      g_leg(aii, ajj, ac, as, asg, abstride, aP, a0, na),
                      g_leg(fii, fjj, fc, fs, fsg, fbstride, fP, f0, nf));
}

}  // extern "C"
