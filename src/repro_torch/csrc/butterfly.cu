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
// are skipped.  The operator runs the adjoint leg, scales by the spectrum,
// then runs the forward leg, in one launch.  The bank runs the adjoint leg
// once, scales one copy of the coefficients per filter by that filter's
// gains, and runs the forward leg on all copies at once.
//
// Design: the chain and the operator (chain.cuh, the rows body:
// stream_leg in own_rows, chain_rows and operator_rows).  A warp owns
// its signal rows of one matrix for the whole launch: one lane per row
// where the rows fill the card (B = 64, R = 256: 4 warps of 32 rows per
// CTA), eight lanes splitting each stage's entries at B = 1
// (kernels/launcher.py::operator_geometry).  Each leg walks only the real
// pairs, compacted in stage order with per-stage offsets
// (kernels/launcher.py::entry_stream, built once per table set and shared
// by every chain and operator launch on it), so no pad is read and the
// anytime cut, head or tail, is a runtime entry range; a cut of 0 stages
// is valid.  The operator's spectrum is read as given, (B, n).  There is
// no CTA barrier: with one lane per row nothing synchronises, with
// several the row's lanes cross one __syncwarp() per stage.
//
// Bound on this card.  The chain's function is one pass over x and y plus
// its real pairs (B = 64, R = n = 256, 4096 pairs a matrix: ~0.012 ms of
// HBM traffic), the operator's twice the pairs; the kernels are bound
// instead by the latency of one warp's walk (a stage of ~9 pairs costs
// its chain of ring load, row load, arithmetic and store plus
// bookkeeping, with one warp per scheduler at the batched shapes), not
// by memory and not by arithmetic.  The body answers with groups of up
// to 8 pairs whose loads all precede their stores in pinned order,
// entries from a per-warp shared ring filled two chunks ahead, and no
// branch per pair.
//
// The bank.  The function is F + 1 legs over one signal read and F output
// writes (at B = 64, F = 7, R = n = 256 about 3.2 GFLOP against 0.14 GB:
// operation-bound on paper), and the kernel is bound by stage barriers,
// table-entry latency and shared-memory traffic.  Its body (chain.cuh,
// walk_leg and bank_tile) answers each: the filters are folded into the
// synthesis rows (a CTA's F_g copies of its r analysed rows form one tile,
// walked once: 2 S barriers, not (1 + F) S); each stage is walked only up to
// its real extent (~9 of the 63 slots at the batched shapes); the stage's
// entries come from a shared ring that cp.async fills three stages ahead,
// entry-major (i, j, c, s, sigma at a 32-byte stride: one 16-byte and one
// 4-byte broadcast read per work item); and the geometry
// (kernels/launcher.py::bank_geometry) keeps three CTAs resident per SM
// while giving every SM two CTAs where the work allows, splitting the
// filters over CTAs (and re-running the analysis per group) only then.
// F is a runtime count: a new bank needs no rebuild.
//
// bf16 forms (g_chain_bf16_kernel, g_operator_bf16_kernel,
// g_bank_bf16_kernel: the same entry points when the value tables c, s,
// sigma are stored as bf16, as the JAX package's precision="bf16" policy
// stores them; its Pallas kernels cast each entry to the f32 signal's
// dtype).  The rows body reads a 16-byte stream entry (i, j, c|s, sigma|0:
// two bf16 values a word, the first in the low half) instead of the f32
// form's 32 bytes, with one 16-byte shared load per entry; the bank body
// copies the indices with cp.async as before and reads each 2-byte value
// with a plain load, widened into the ring's f32 word.  The arithmetic is
// the f32 form's on the widened values, so a bf16 form equals its f32 form
// on tables.float(), and is held to the same plain versions.
//
// bf16-signal forms (g_chain_xbf16_kernel, g_operator_xbf16_kernel,
// g_bank_xbf16_kernel: the same entry points on a bf16 signal, which the
// Pallas kernels compute in bf16, casting every table value, spectrum
// entry and gain to x's dtype).  They take bf16 value tables (the
// launcher casts f32 tables once by RNE, launcher.cast_tables: the same
// rounding as the per-entry cast), read x as bf16 into the f32 tile and
// round every product and sum to bf16 in the plain version's order
// (g_rotate: y_i = r(r(c x_i) + r(s x_j)), y_j = r(sigma r(r(-s x_i) +
// r(c x_j)))), with __fmul_rn / __fadd_rn so that nothing contracts to an
// FMA; the spectrum and the gains are rounded as they are read (chain.cuh,
// Signal).  They are bitwise equal to their plain versions.
#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

// One G pair on a row's two coordinates at signal type T: y_i = c x_i +
// s x_j, y_j = sigma (-s x_i + c x_j).  f32 as the f32 kernels always
// computed it (nvcc contracts it to FMAs); bf16 rounds each product and
// sum on its own, in the plain version's order (kernels/ref.py::_walk).
template <class T>
__device__ __forceinline__ void g_rotate(float c, float s, float g, float xi,
                                         float xj, float& yi, float& yj) {
  if constexpr (Signal<T>::kRounds) {
    yi = radd<T>(rmul<T>(c, xi), rmul<T>(s, xj));
    yj = rmul<T>(g, radd<T>(rmul<T>(-s, xi), rmul<T>(c, xj)));
  } else {
    yi = c * xi + s * xj;
    yj = g * (-s * xi + c * xj);
  }
}

// A bank ring entry (i, j, c, s, sigma) on one signal row.
template <class T>
__device__ __forceinline__ void g_apply(float* row, const float* e, int n) {
  const int4 w = *reinterpret_cast<const int4*>(e);
  if (w.x < n && w.y < n) {
    float yi, yj;
    g_rotate<T>(__int_as_float(w.z), __int_as_float(w.w), e[4], row[w.x],
                row[w.y], yi, yj);
    row[w.x] = yi;
    row[w.y] = yj;
  }
}

// The rows body's entry in registers (chain.cuh, stream_leg).
struct GEntry {
  int i, j;
  float c, s, g;
};

// K entries of one stage on the row at shared address `row`: every
// coordinate read before any is written (chain.cuh, apply_group).
template <class T, int K>
__device__ __forceinline__ void g_apply_group(unsigned row, unsigned scratch,
                                              const GEntry (&en)[K],
                                              const bool (&ok)[K]) {
  unsigned ai[K], aj[K];
  float xi[K], xj[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ai[k] = ok[k] ? row + 4 * en[k].i : scratch;
    aj[k] = ok[k] ? row + 4 * en[k].j : scratch;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xi[k] = ld_shared(ai[k]);
    xj[k] = ld_shared(aj[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float yi, yj;
    g_rotate<T>(en[k].c, en[k].s, en[k].g, xi[k], xj[k], yi, yj);
    st_shared(ai[k], yi);
    st_shared(aj[k], yj);
  }
}

// A G pair (i, j) with values (c, s, sigma): the table pointers of a bank
// leg, and the stage action of every body on one f32 signal row.
struct GPair {
  using Signal = float;
  const int* ii;
  const int* jj;
  const float* c;
  const float* s;
  const float* sg;

  // The bank's ring form (chain.cuh): an entry is the words
  // (i, j, c, s, sigma) at a 32-byte stride.
  static constexpr int kFields = 5;
  static constexpr int kWords = 8;

  __device__ __forceinline__ const float* field(int k) const {
    switch (k) {
      case 0: return reinterpret_cast<const float*>(ii);
      case 1: return reinterpret_cast<const float*>(jj);
      case 2: return c;
      case 3: return s;
      default: return sg;
    }
  }

  static __device__ __forceinline__ void apply(float* row, const float* e,
                                               int n) {
    g_apply<float>(row, e, n);
  }

  // The rows body's form (chain.cuh, stream_leg): an entry in registers,
  // read from a warp's ring (the ring form) with one 16-byte and one
  // 4-byte broadcast load.
  using Entry = GEntry;

  static __device__ __forceinline__ Entry entry(unsigned a) {
    const int4 v = ld_shared4(a);
    return Entry{v.x, v.y, __int_as_float(v.z), __int_as_float(v.w),
                 ld_shared(a + 16)};
  }

  template <int K>
  static __device__ __forceinline__ void apply_group(unsigned row,
                                                     unsigned scratch,
                                                     const Entry (&en)[K],
                                                     const bool (&ok)[K]) {
    g_apply_group<float, K>(row, scratch, en, ok);
  }
};

// GPair's rows-body form for bf16 value tables at signal type T: the
// 4-word stream entry (i, j, c|s, sigma|0), widened in registers, then
// g_rotate<T>.
template <class T>
struct GPairBf16 {
  using Signal = T;
  static constexpr int kWords = 4;
  using Entry = GEntry;

  static __device__ __forceinline__ Entry entry(unsigned a) {
    const int4 v = ld_shared4(a);
    return Entry{v.x, v.y, bf16_lo((unsigned)v.z), bf16_hi((unsigned)v.z),
                 bf16_lo((unsigned)v.w)};
  }

  template <int K>
  static __device__ __forceinline__ void apply_group(unsigned row,
                                                     unsigned scratch,
                                                     const Entry (&en)[K],
                                                     const bool (&ok)[K]) {
    g_apply_group<T, K>(row, scratch, en, ok);
  }
};

// GPair's bank-body form for bf16 value tables at signal type T: the
// indices by cp.async, the three values widened into GPair's ring form
// (i, j, c, s, sigma).
template <class T>
struct GBankBf16 {
  using Signal = T;
  const int* ii;
  const int* jj;
  const unsigned short* c;  // bf16 bits
  const unsigned short* s;
  const unsigned short* sg;

  static constexpr int kFields = 2;
  static constexpr int kWords = GPair::kWords;

  __device__ __forceinline__ const float* field(int k) const {
    return reinterpret_cast<const float*>(k == 0 ? ii : jj);
  }

  __device__ __forceinline__ void widen(float* e, long long at) const {
    e[2] = bf16_lo(__ldg(c + at));
    e[3] = bf16_lo(__ldg(s + at));
    e[4] = bf16_lo(__ldg(sg + at));
  }

  static __device__ __forceinline__ void apply(float* row, const float* e,
                                               int n) {
    g_apply<T>(row, e, n);
  }
};

using GBankLeg = BankLeg<GPair>;
using GBankBf16Leg = BankLeg<GBankBf16<float>>;
using GBankXLeg = BankLeg<GBankBf16<__nv_bfloat16>>;

__global__ void __launch_bounds__(kMaxOperatorThreads)
    g_chain_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                   const float* __restrict__ x, float* __restrict__ y,
                   StreamLeg leg) {
  chain_lanes<GPair>(R, n, ld, lanes, rows_per_warp, x, y, leg);
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    g_operator_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                      const float* __restrict__ x, float* __restrict__ y,
                      const float* __restrict__ d, StreamLeg adj,
                      StreamLeg fwd) {
  operator_lanes<GPair>(R, n, ld, lanes, rows_per_warp, x, y, d, adj, fwd);
}

__global__ void g_bank_kernel(int R, int n, int ld, int rows_per_cta,
                              int filters_per_cta, int row_tiles,
                              int slot_words, const float* __restrict__ x,
                              float* __restrict__ y,
                              const float* __restrict__ gains, int F,
                              GBankLeg adj, GBankLeg fwd) {
  bank_tile(R, n, ld, rows_per_cta, filters_per_cta, row_tiles, slot_words,
            x, y, gains, F, adj, fwd);
}

inline GBankLeg g_bank_leg(const int* ii, const int* jj, const float* c,
                           const float* s, const float* sg, const int* ext,
                           long long bstride, int P, int s0, int ns) {
  return GBankLeg{GPair{ii, jj, c, s, sg}, ext, bstride,
                  P ? bstride / P : 0, P, s0, ns};
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    g_chain_bf16_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                        const float* __restrict__ x, float* __restrict__ y,
                        StreamLeg leg) {
  chain_lanes<GPairBf16<float>>(R, n, ld, lanes, rows_per_warp, x, y, leg);
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    g_operator_bf16_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                           const float* __restrict__ x, float* __restrict__ y,
                           const float* __restrict__ d, StreamLeg adj,
                           StreamLeg fwd) {
  operator_lanes<GPairBf16<float>>(R, n, ld, lanes, rows_per_warp, x, y, d,
                                   adj, fwd);
}

__global__ void g_bank_bf16_kernel(int R, int n, int ld, int rows_per_cta,
                                   int filters_per_cta, int row_tiles,
                                   int slot_words, const float* __restrict__ x,
                                   float* __restrict__ y,
                                   const float* __restrict__ gains, int F,
                                   GBankBf16Leg adj, GBankBf16Leg fwd) {
  bank_tile(R, n, ld, rows_per_cta, filters_per_cta, row_tiles, slot_words,
            x, y, gains, F, adj, fwd);
}

inline GBankBf16Leg g_bank_bf16_leg(const int* ii, const int* jj,
                                    const unsigned short* c,
                                    const unsigned short* s,
                                    const unsigned short* sg, const int* ext,
                                    long long bstride, int P, int s0,
                                    int ns) {
  return GBankBf16Leg{GBankBf16<float>{ii, jj, c, s, sg}, ext, bstride,
                      P ? bstride / P : 0, P, s0, ns};
}

// The bf16-signal forms (bf16 tables; the launcher casts f32 tables
// once, launcher.cast_tables): x and y bf16, every operation rounded to
// bf16 (chain.cuh, Signal).
using XSignal = __nv_bfloat16;

__global__ void __launch_bounds__(kMaxOperatorThreads)
    g_chain_xbf16_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                         const XSignal* __restrict__ x,
                         XSignal* __restrict__ y, StreamLeg leg) {
  chain_lanes<GPairBf16<XSignal>>(R, n, ld, lanes, rows_per_warp, x, y, leg);
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    g_operator_xbf16_kernel(int R, int n, int ld, int lanes,
                            int rows_per_warp, const XSignal* __restrict__ x,
                            XSignal* __restrict__ y,
                            const float* __restrict__ d, StreamLeg adj,
                            StreamLeg fwd) {
  operator_lanes<GPairBf16<XSignal>>(R, n, ld, lanes, rows_per_warp, x, y, d,
                                     adj, fwd);
}

__global__ void g_bank_xbf16_kernel(int R, int n, int ld, int rows_per_cta,
                                    int filters_per_cta, int row_tiles,
                                    int slot_words,
                                    const XSignal* __restrict__ x,
                                    XSignal* __restrict__ y,
                                    const float* __restrict__ gains, int F,
                                    GBankXLeg adj, GBankXLeg fwd) {
  bank_tile(R, n, ld, rows_per_cta, filters_per_cta, row_tiles, slot_words,
            x, y, gains, F, adj, fwd);
}

inline GBankXLeg g_bank_xbf16_leg(const int* ii, const int* jj,
                                  const unsigned short* c,
                                  const unsigned short* s,
                                  const unsigned short* sg, const int* ext,
                                  long long bstride, int P, int s0, int ns) {
  return GBankXLeg{GBankBf16<XSignal>{ii, jj, c, s, sg}, ext, bstride,
                   P ? bstride / P : 0, P, s0, ns};
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

// Shared memory of one SM on the current device (its resident blocks share
// it, each with a reserve of its own).
int repro_smem_per_sm(void) {
  int dev = 0;
  int v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y[b] = Ubar_b x[b] over stages [s0, s0 + ns) of the leg's stream (words,
// (B, S + 1) stage offsets); x, y: (B, R, n).  Each row of x is held by
// `lanes` lanes, a warp owns rows_per_warp rows, a CTA has `warps` warps.
int g_chain_launch(const float* x, float* y, int B, int R, int n,
                   const int* words, const int* off, int S, int s0, int ns,
                   int lanes, int rows_per_warp, int warps, void* stream) {
  return launch_rows<GPair>(g_chain_kernel, B, R, n, lanes, rows_per_warp,
                            warps, stream, x, y,
                            StreamLeg{words, off, S, s0, ns});
}

// y[b] = Ubar_b diag(d[b]) Ubar_b^T x[b], d (B, n): the adjoint leg runs
// stages [a0, a0 + na) of the adjoint stream (words, (B, aS + 1) stage
// offsets), the forward leg [f0, f0 + nf) of the forward stream; each row
// of x is held by `lanes` lanes, a warp owns rows_per_warp rows, a CTA has
// `warps` warps.
int g_operator_launch(const float* x, float* y, int B, int R, int n,
                      const float* d, const int* awords, const int* aoff,
                      int aS, int a0, int na, const int* fwords,
                      const int* foff, int fS, int f0, int nf, int lanes,
                      int rows_per_warp, int warps, void* stream) {
  return launch_rows<GPair>(g_operator_kernel, B, R, n, lanes, rows_per_warp,
                            warps, stream, x, y, d,
                            StreamLeg{awords, aoff, aS, a0, na},
                            StreamLeg{fwords, foff, fS, f0, nf});
}

// y[b, f] = Ubar_b diag(gains[b, f]) Ubar_b^T x[b] for f < F, legs as in
// g_operator_launch plus each leg's (B, S) stage extents; gains (B, F, n + 1)
// with 1.0 in the dummy column n, y (B, F, R, n).
int g_bank_launch(const float* x, float* y, int B, int R, int n,
                  const float* gains, int F, const int* aii, const int* ajj,
                  const float* ac, const float* as, const float* asg,
                  const int* aext, long long abstride, int aP, int a0, int na,
                  const int* fii, const int* fjj, const float* fc,
                  const float* fs, const float* fsg, const int* fext,
                  long long fbstride, int fP, int f0, int nf,
                  int rows_per_cta, int filters_per_cta, int threads,
                  void* stream) {
  return launch_bank(g_bank_kernel, B, R, n, F, rows_per_cta,
                     filters_per_cta, threads, stream, x, y, gains,
                     g_bank_leg(aii, ajj, ac, as, asg, aext, abstride, aP, a0,
                                na),
                     g_bank_leg(fii, fjj, fc, fs, fsg, fext, fbstride, fP, f0,
                                nf));
}

// Resident CTAs per SM of a G kernel (0 chain, 1 operator, 2 bank) with a
// tile of `rows` rows of width n (a chain or an operator: all its warps'
// rows, beside a ring per warp; a bank: all its filters' rows) and, for
// the bank, a ring of P-slot stages; negative: a cudaError_t code.
int g_occupancy(int kind, int rows, int n, int P, int threads) {
  const int ld = odd_stride(n);
  const size_t smem = operator_smem(rows, ld, threads / 32, GPair::kWords);
  switch (kind) {
    case 0:
      return resident_ctas((const void*)g_chain_kernel, smem, threads);
    case 1:
      return resident_ctas((const void*)g_operator_kernel, smem, threads);
    default:
      return resident_ctas((const void*)g_bank_kernel,
                           bank_smem(rows, ld, P * GPair::kWords), threads);
  }
}

// The bf16 forms: the same arguments, the value tables as bf16 bits.
int g_chain_bf16_launch(const float* x, float* y, int B, int R, int n,
                        const int* words, const int* off, int S, int s0,
                        int ns, int lanes, int rows_per_warp, int warps,
                        void* stream) {
  return launch_rows<GPairBf16<float>>(g_chain_bf16_kernel, B, R, n, lanes,
                                rows_per_warp, warps, stream, x, y,
                                StreamLeg{words, off, S, s0, ns});
}

int g_operator_bf16_launch(const float* x, float* y, int B, int R, int n,
                           const float* d, const int* awords, const int* aoff,
                           int aS, int a0, int na, const int* fwords,
                           const int* foff, int fS, int f0, int nf, int lanes,
                           int rows_per_warp, int warps, void* stream) {
  return launch_rows<GPairBf16<float>>(g_operator_bf16_kernel, B, R, n, lanes,
                                rows_per_warp, warps, stream, x, y, d,
                                StreamLeg{awords, aoff, aS, a0, na},
                                StreamLeg{fwords, foff, fS, f0, nf});
}

int g_bank_bf16_launch(const float* x, float* y, int B, int R, int n,
                       const float* gains, int F, const int* aii,
                       const int* ajj, const unsigned short* ac,
                       const unsigned short* as, const unsigned short* asg,
                       const int* aext, long long abstride, int aP, int a0,
                       int na, const int* fii, const int* fjj,
                       const unsigned short* fc, const unsigned short* fs,
                       const unsigned short* fsg, const int* fext,
                       long long fbstride, int fP, int f0, int nf,
                       int rows_per_cta, int filters_per_cta, int threads,
                       void* stream) {
  return launch_bank(g_bank_bf16_kernel, B, R, n, F, rows_per_cta,
                     filters_per_cta, threads, stream, x, y, gains,
                     g_bank_bf16_leg(aii, ajj, ac, as, asg, aext, abstride,
                                     aP, a0, na),
                     g_bank_bf16_leg(fii, fjj, fc, fs, fsg, fext, fbstride,
                                     fP, f0, nf));
}

// Resident CTAs per SM of a G bf16 form, as g_occupancy (its stream
// entries are half the f32 form's; its bank ring is the f32 form's).
int g_bf16_occupancy(int kind, int rows, int n, int P, int threads) {
  const int ld = odd_stride(n);
  const size_t smem =
      operator_smem(rows, ld, threads / 32, GPairBf16<float>::kWords);
  switch (kind) {
    case 0:
      return resident_ctas((const void*)g_chain_bf16_kernel, smem, threads);
    case 1:
      return resident_ctas((const void*)g_operator_bf16_kernel, smem,
                           threads);
    default:
      return resident_ctas((const void*)g_bank_bf16_kernel,
                           bank_smem(rows, ld, P * GBankBf16<float>::kWords),
                           threads);
  }
}

// The bf16-signal forms: x and y as bf16, the value tables as bf16 bits,
// the other arguments as the f32 forms'.
int g_chain_xbf16_launch(const XSignal* x, XSignal* y, int B, int R, int n,
                         const int* words, const int* off, int S, int s0,
                         int ns, int lanes, int rows_per_warp, int warps,
                         void* stream) {
  return launch_rows<GPairBf16<XSignal>>(g_chain_xbf16_kernel, B, R, n, lanes,
                                         rows_per_warp, warps, stream, x, y,
                                         StreamLeg{words, off, S, s0, ns});
}

int g_operator_xbf16_launch(const XSignal* x, XSignal* y, int B, int R,
                            int n, const float* d, const int* awords,
                            const int* aoff, int aS, int a0, int na,
                            const int* fwords, const int* foff, int fS,
                            int f0, int nf, int lanes, int rows_per_warp,
                            int warps, void* stream) {
  return launch_rows<GPairBf16<XSignal>>(
      g_operator_xbf16_kernel, B, R, n, lanes, rows_per_warp, warps, stream,
      x, y, d, StreamLeg{awords, aoff, aS, a0, na},
      StreamLeg{fwords, foff, fS, f0, nf});
}

int g_bank_xbf16_launch(const XSignal* x, XSignal* y, int B, int R, int n,
                        const float* gains, int F, const int* aii,
                        const int* ajj, const unsigned short* ac,
                        const unsigned short* as, const unsigned short* asg,
                        const int* aext, long long abstride, int aP, int a0,
                        int na, const int* fii, const int* fjj,
                        const unsigned short* fc, const unsigned short* fs,
                        const unsigned short* fsg, const int* fext,
                        long long fbstride, int fP, int f0, int nf,
                        int rows_per_cta, int filters_per_cta, int threads,
                        void* stream) {
  return launch_bank(g_bank_xbf16_kernel, B, R, n, F, rows_per_cta,
                     filters_per_cta, threads, stream, x, y, gains,
                     g_bank_xbf16_leg(aii, ajj, ac, as, asg, aext, abstride,
                                      aP, a0, na),
                     g_bank_xbf16_leg(fii, fjj, fc, fs, fsg, fext, fbstride,
                                      fP, f0, nf));
}

// Resident CTAs per SM of a G bf16-signal form, as g_bf16_occupancy.
int g_xbf16_occupancy(int kind, int rows, int n, int P, int threads) {
  const int ld = odd_stride(n);
  const size_t smem =
      operator_smem(rows, ld, threads / 32, GPairBf16<XSignal>::kWords);
  switch (kind) {
    case 0:
      return resident_ctas((const void*)g_chain_xbf16_kernel, smem, threads);
    case 1:
      return resident_ctas((const void*)g_operator_xbf16_kernel, smem,
                           threads);
    default:
      return resident_ctas((const void*)g_bank_xbf16_kernel,
                           bank_smem(rows, ld, P * GBankBf16<XSignal>::kWords),
                           threads);
  }
}

}  // extern "C"
