// Staged T-chain (scaling / shear) kernels for Hopper (sm_90a), plain C
// interface.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/shear.py:
//   t_chain_kernel     <- batched_shear_apply (_batched_shear_kernel)
//                         and shear_apply (_shear_kernel) as B = 1
//   t_operator_kernel  <- batched_gen_operator_apply
//                         (_batched_fused_gen_kernel) and gen_operator_apply
//                         (_fused_gen_kernel) as B = 1
// and in src/repro/kernels/spectral.py:
//   t_bank_kernel      <- batched_gen_filter_bank_apply
//                         (_batched_bank_gen_kernel) and gen_filter_bank_apply
//                         (_bank_gen_kernel) as B = 1
//
// Semantics (the plain PyTorch versions in src/repro_torch/kernels/ref.py):
// a stage st holds P entries (i, j, alpha, beta); per signal row it computes
// y_i = alpha x_i + beta x_j and writes only i (a scaling has j == i and
// beta = 0, a shear alpha = 1).  The packer puts j into a shear's touch set,
// so within a stage no entry writes a coordinate that another entry reads or
// writes: every work item's reads and its write are its own.  Pad entries
// carry the out-of-bounds index n and are skipped.  The operator runs the
// inverse leg, scales by the spectrum, then runs the forward leg, in one
// launch; the bank runs the inverse leg once, scales one copy of the
// coefficients per filter, and runs the forward leg on all copies at once.
// Each entry is computed as round(round(alpha x_i) + round(beta x_j)),
// without FMA contraction, so every kernel rounds exactly as the plain
// version does: T is not orthogonal, and rounding differences would
// otherwise grow with cond(Tbar) along the chain.
//
// Design: the chain and the operator have the G family's rows body
// (chain.cuh: stream_leg in own_rows, chain_rows and operator_rows; see
// butterfly.cu): warps own their rows for the whole
// launch, with no CTA barrier; each leg walks only its real entries,
// compacted in stage order (~14 a stage at the batched shapes, (i, j,
// alpha, beta) at a 16-byte stride), from a per-warp shared ring, and
// the anytime cut, head or tail, is a runtime entry range (a cut of 0
// stages is valid).  The chain's function is one pass over x and y plus
// its real entries (B = 64, R = n = 256: ~0.011 ms of HBM traffic); like
// the G kernels, both are bound instead by the latency of one warp's
// walk.  Each row's arithmetic is the plain version's in the same stage
// order (within a stage the entries touch disjoint coordinates, so their
// order does not matter), and the operator's scaling is one f32
// multiply: chain and operator are bitwise equal to their plain
// versions.
//
// The bank has the G bank's body (chain.cuh, walk_leg and bank_tile; see
// butterfly.cu): filters folded into the synthesis rows (2 S barriers per
// CTA), each stage walked only up to its real extent (~14 of the 72 slots at
// the batched shapes), entries from a shared ring filled by cp.async three
// stages ahead ((i, j, alpha, beta) at a 16-byte stride: one broadcast read
// per work item), and kernels/launcher.py::bank_geometry's rows and filters
// per CTA.  The copy of the coefficients for filter f is one f32 multiply,
// as in the plain version, so the bank stays bitwise equal to it.
//
// bf16 forms (t_chain_bf16_kernel, t_operator_bf16_kernel,
// t_bank_bf16_kernel: the same entry points when alpha and beta are stored
// as bf16, as the JAX package's precision="bf16" policy stores them).  The
// rows body reads the stream entry (i, j, alpha|beta, 0), still 16 bytes
// (ChunkRegs moves whole 16-byte pieces); the bank body copies the indices
// with cp.async and widens each 2-byte value with a plain load into the
// ring's f32 word.  The arithmetic is the f32 form's on the widened
// values, so the bf16 forms too are bitwise equal to their plain versions.
//
// bf16-signal forms (t_chain_xbf16_kernel, t_operator_xbf16_kernel,
// t_bank_xbf16_kernel: the entry points on a bf16 signal, computed in bf16
// as the Pallas kernels compute it).  They take bf16 value tables (the
// launcher casts f32 tables once by RNE), read x as bf16 into the f32 tile
// and round every product and sum to bf16 (t_combine: y_i = r(r(alpha
// x_i) + r(beta x_j))), the spectrum and the gains as they are read and
// the scales after them (chain.cuh, Signal); bitwise equal to their plain
// versions.
#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

// y_i = alpha x_i + beta x_j at signal type T: each product and the sum
// rounded on its own (unfused; at bf16 each rounded to bf16 as well).
template <class T>
__device__ __forceinline__ float t_combine(float a, float xi, float b,
                                           float xj) {
  return radd<T>(rmul<T>(a, xi), rmul<T>(b, xj));
}

// A bank ring entry (i, j, alpha, beta) on one signal row.
template <class T>
__device__ __forceinline__ void t_apply(float* row, const float* e, int n) {
  const int4 w = *reinterpret_cast<const int4*>(e);
  if (w.x < n && w.y < n) {
    row[w.x] = t_combine<T>(__int_as_float(w.z), row[w.x],
                            __int_as_float(w.w), row[w.y]);
  }
}

// The rows body's entry in registers (chain.cuh, stream_leg).
struct TRowEntry {
  int i, j;
  float a, b;
};

// K entries of one stage on the row at shared address `row`: every
// coordinate read before any is written (chain.cuh, apply_group).
template <class T, int K>
__device__ __forceinline__ void t_apply_group(unsigned row, unsigned scratch,
                                              const TRowEntry (&en)[K],
                                              const bool (&ok)[K]) {
  unsigned ai[K];
  float xi[K], xj[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ai[k] = ok[k] ? row + 4 * en[k].i : scratch;
    const unsigned aj = ok[k] ? row + 4 * en[k].j : scratch;
    xi[k] = ld_shared(ai[k]);
    xj[k] = ld_shared(aj);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    st_shared(ai[k], t_combine<T>(en[k].a, xi[k], en[k].b, xj[k]));
}

// A T entry (i, j, alpha, beta): the table pointers of a bank leg, and the
// stage action of every body on one f32 signal row (only i written).
struct TEntry {
  using Signal = float;
  const int* ii;
  const int* jj;
  const float* al;
  const float* be;

  // The bank's ring form (chain.cuh): an entry is the words
  // (i, j, alpha, beta) at a 16-byte stride.
  static constexpr int kFields = 4;
  static constexpr int kWords = 4;

  __device__ __forceinline__ const float* field(int k) const {
    switch (k) {
      case 0: return reinterpret_cast<const float*>(ii);
      case 1: return reinterpret_cast<const float*>(jj);
      case 2: return al;
      default: return be;
    }
  }

  static __device__ __forceinline__ void apply(float* row, const float* e,
                                               int n) {
    t_apply<float>(row, e, n);
  }

  // The rows body's form (chain.cuh, stream_leg): an entry in registers,
  // read from a warp's ring (the ring form) with one 16-byte broadcast
  // load.
  using Entry = TRowEntry;

  static __device__ __forceinline__ Entry entry(unsigned a) {
    const int4 v = ld_shared4(a);
    return Entry{v.x, v.y, __int_as_float(v.z), __int_as_float(v.w)};
  }

  template <int K>
  static __device__ __forceinline__ void apply_group(unsigned row,
                                                     unsigned scratch,
                                                     const Entry (&en)[K],
                                                     const bool (&ok)[K]) {
    t_apply_group<float, K>(row, scratch, en, ok);
  }
};

// TEntry for bf16 value tables at signal type T, in both bodies: the rows
// body's stream entry (i, j, alpha|beta, 0) widened in registers; the
// bank's ring entry in TEntry's f32 form (i, j, alpha, beta), the indices
// by cp.async and the values widened into it.  Then t_combine<T>.
template <class T>
struct TEntryBf16 {
  using Signal = T;
  const int* ii;
  const int* jj;
  const unsigned short* al;  // bf16 bits
  const unsigned short* be;

  static constexpr int kFields = 2;
  static constexpr int kWords = 4;

  __device__ __forceinline__ const float* field(int k) const {
    return reinterpret_cast<const float*>(k == 0 ? ii : jj);
  }

  __device__ __forceinline__ void widen(float* e, long long at) const {
    e[2] = bf16_lo(__ldg(al + at));
    e[3] = bf16_lo(__ldg(be + at));
  }

  static __device__ __forceinline__ void apply(float* row, const float* e,
                                               int n) {
    t_apply<T>(row, e, n);
  }

  using Entry = TRowEntry;

  static __device__ __forceinline__ Entry entry(unsigned a) {
    const int4 v = ld_shared4(a);
    return Entry{v.x, v.y, bf16_lo((unsigned)v.z), bf16_hi((unsigned)v.z)};
  }

  template <int K>
  static __device__ __forceinline__ void apply_group(unsigned row,
                                                     unsigned scratch,
                                                     const Entry (&en)[K],
                                                     const bool (&ok)[K]) {
    t_apply_group<T, K>(row, scratch, en, ok);
  }
};

using TBankLeg = BankLeg<TEntry>;
using TBankBf16Leg = BankLeg<TEntryBf16<float>>;
using TBankXLeg = BankLeg<TEntryBf16<__nv_bfloat16>>;

__global__ void __launch_bounds__(kMaxOperatorThreads)
    t_chain_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                   const float* __restrict__ x, float* __restrict__ y,
                   StreamLeg leg) {
  chain_lanes<TEntry>(R, n, ld, lanes, rows_per_warp, x, y, leg);
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    t_operator_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                      const float* __restrict__ x, float* __restrict__ y,
                      const float* __restrict__ d, StreamLeg inv,
                      StreamLeg fwd) {
  operator_lanes<TEntry>(R, n, ld, lanes, rows_per_warp, x, y, d, inv, fwd);
}

__global__ void t_bank_kernel(int R, int n, int ld, int rows_per_cta,
                              int filters_per_cta, int row_tiles,
                              int slot_words, const float* __restrict__ x,
                              float* __restrict__ y,
                              const float* __restrict__ gains, int F,
                              TBankLeg inv, TBankLeg fwd) {
  bank_tile(R, n, ld, rows_per_cta, filters_per_cta, row_tiles, slot_words,
            x, y, gains, F, inv, fwd);
}

inline TBankLeg t_bank_leg(const int* ii, const int* jj, const float* al,
                           const float* be, const int* ext, long long bstride,
                           int P, int s0, int ns) {
  return TBankLeg{TEntry{ii, jj, al, be}, ext, bstride, P ? bstride / P : 0,
                  P, s0, ns};
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    t_chain_bf16_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                        const float* __restrict__ x, float* __restrict__ y,
                        StreamLeg leg) {
  chain_lanes<TEntryBf16<float>>(R, n, ld, lanes, rows_per_warp, x, y, leg);
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    t_operator_bf16_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                           const float* __restrict__ x, float* __restrict__ y,
                           const float* __restrict__ d, StreamLeg inv,
                           StreamLeg fwd) {
  operator_lanes<TEntryBf16<float>>(R, n, ld, lanes, rows_per_warp, x, y, d,
                                    inv, fwd);
}

__global__ void t_bank_bf16_kernel(int R, int n, int ld, int rows_per_cta,
                                   int filters_per_cta, int row_tiles,
                                   int slot_words, const float* __restrict__ x,
                                   float* __restrict__ y,
                                   const float* __restrict__ gains, int F,
                                   TBankBf16Leg inv, TBankBf16Leg fwd) {
  bank_tile(R, n, ld, rows_per_cta, filters_per_cta, row_tiles, slot_words,
            x, y, gains, F, inv, fwd);
}

inline TBankBf16Leg t_bank_bf16_leg(const int* ii, const int* jj,
                                    const unsigned short* al,
                                    const unsigned short* be, const int* ext,
                                    long long bstride, int P, int s0,
                                    int ns) {
  return TBankBf16Leg{TEntryBf16<float>{ii, jj, al, be}, ext, bstride,
                      P ? bstride / P : 0, P, s0, ns};
}

// The bf16-signal forms (bf16 tables; the launcher casts f32 tables
// once, launcher.cast_tables): x and y bf16, every operation rounded to
// bf16 (chain.cuh, Signal).
using XSignal = __nv_bfloat16;

__global__ void __launch_bounds__(kMaxOperatorThreads)
    t_chain_xbf16_kernel(int R, int n, int ld, int lanes, int rows_per_warp,
                         const XSignal* __restrict__ x,
                         XSignal* __restrict__ y, StreamLeg leg) {
  chain_lanes<TEntryBf16<XSignal>>(R, n, ld, lanes, rows_per_warp, x, y,
                                   leg);
}

__global__ void __launch_bounds__(kMaxOperatorThreads)
    t_operator_xbf16_kernel(int R, int n, int ld, int lanes,
                            int rows_per_warp, const XSignal* __restrict__ x,
                            XSignal* __restrict__ y,
                            const float* __restrict__ d, StreamLeg inv,
                            StreamLeg fwd) {
  operator_lanes<TEntryBf16<XSignal>>(R, n, ld, lanes, rows_per_warp, x, y,
                                      d, inv, fwd);
}

__global__ void t_bank_xbf16_kernel(int R, int n, int ld, int rows_per_cta,
                                    int filters_per_cta, int row_tiles,
                                    int slot_words,
                                    const XSignal* __restrict__ x,
                                    XSignal* __restrict__ y,
                                    const float* __restrict__ gains, int F,
                                    TBankXLeg inv, TBankXLeg fwd) {
  bank_tile(R, n, ld, rows_per_cta, filters_per_cta, row_tiles, slot_words,
            x, y, gains, F, inv, fwd);
}

inline TBankXLeg t_bank_xbf16_leg(const int* ii, const int* jj,
                                  const unsigned short* al,
                                  const unsigned short* be, const int* ext,
                                  long long bstride, int P, int s0, int ns) {
  return TBankXLeg{TEntryBf16<XSignal>{ii, jj, al, be}, ext, bstride,
                   P ? bstride / P : 0, P, s0, ns};
}

}  // namespace

extern "C" {

// y[b] = Tbar_b x[b] (Tbar_b^{-1} x[b] on the inverse stream) over stages
// [s0, s0 + ns) of the leg's stream; arguments as g_chain_launch.
int t_chain_launch(const float* x, float* y, int B, int R, int n,
                   const int* words, const int* off, int S, int s0, int ns,
                   int lanes, int rows_per_warp, int warps, void* stream) {
  return launch_rows<TEntry>(t_chain_kernel, B, R, n, lanes, rows_per_warp,
                             warps, stream, x, y,
                             StreamLeg{words, off, S, s0, ns});
}

// y[b] = Tbar_b diag(d[b]) Tbar_b^{-1} x[b], d (B, n): the inverse leg runs
// stages [i0, i0 + ni) of the inverse stream (words, (B, iS + 1) stage
// offsets), the forward leg [f0, f0 + nf) of the forward stream; geometry as
// g_operator_launch.
int t_operator_launch(const float* x, float* y, int B, int R, int n,
                      const float* d, const int* iwords, const int* ioff,
                      int iS, int i0, int ni, const int* fwords,
                      const int* foff, int fS, int f0, int nf, int lanes,
                      int rows_per_warp, int warps, void* stream) {
  return launch_rows<TEntry>(t_operator_kernel, B, R, n, lanes, rows_per_warp,
                             warps, stream, x, y, d,
                             StreamLeg{iwords, ioff, iS, i0, ni},
                             StreamLeg{fwords, foff, fS, f0, nf});
}

// y[b, f] = Tbar_b diag(gains[b, f]) Tbar_b^{-1} x[b] for f < F, legs as in
// t_operator_launch plus each leg's (B, S) stage extents; gains
// (B, F, n + 1) with 1.0 in the dummy column n, y (B, F, R, n).
int t_bank_launch(const float* x, float* y, int B, int R, int n,
                  const float* gains, int F, const int* iii, const int* ijj,
                  const float* ial, const float* ibe, const int* iext,
                  long long ibstride, int iP, int i0, int ni, const int* fii,
                  const int* fjj, const float* fal, const float* fbe,
                  const int* fext, long long fbstride, int fP, int f0,
                  int nf, int rows_per_cta, int filters_per_cta, int threads,
                  void* stream) {
  return launch_bank(t_bank_kernel, B, R, n, F, rows_per_cta,
                     filters_per_cta, threads, stream, x, y, gains,
                     t_bank_leg(iii, ijj, ial, ibe, iext, ibstride, iP, i0,
                                ni),
                     t_bank_leg(fii, fjj, fal, fbe, fext, fbstride, fP, f0,
                                nf));
}

// Resident CTAs per SM of a T kernel, as g_occupancy.
int t_occupancy(int kind, int rows, int n, int P, int threads) {
  const int ld = odd_stride(n);
  const size_t smem = operator_smem(rows, ld, threads / 32, TEntry::kWords);
  switch (kind) {
    case 0:
      return resident_ctas((const void*)t_chain_kernel, smem, threads);
    case 1:
      return resident_ctas((const void*)t_operator_kernel, smem, threads);
    default:
      return resident_ctas((const void*)t_bank_kernel,
                           bank_smem(rows, ld, P * TEntry::kWords), threads);
  }
}

// The bf16 forms: the same arguments, the value tables as bf16 bits.
int t_chain_bf16_launch(const float* x, float* y, int B, int R, int n,
                        const int* words, const int* off, int S, int s0,
                        int ns, int lanes, int rows_per_warp, int warps,
                        void* stream) {
  return launch_rows<TEntryBf16<float>>(t_chain_bf16_kernel, B, R, n, lanes,
                                 rows_per_warp, warps, stream, x, y,
                                 StreamLeg{words, off, S, s0, ns});
}

int t_operator_bf16_launch(const float* x, float* y, int B, int R, int n,
                           const float* d, const int* iwords, const int* ioff,
                           int iS, int i0, int ni, const int* fwords,
                           const int* foff, int fS, int f0, int nf, int lanes,
                           int rows_per_warp, int warps, void* stream) {
  return launch_rows<TEntryBf16<float>>(t_operator_bf16_kernel, B, R, n, lanes,
                                 rows_per_warp, warps, stream, x, y, d,
                                 StreamLeg{iwords, ioff, iS, i0, ni},
                                 StreamLeg{fwords, foff, fS, f0, nf});
}

int t_bank_bf16_launch(const float* x, float* y, int B, int R, int n,
                       const float* gains, int F, const int* iii,
                       const int* ijj, const unsigned short* ial,
                       const unsigned short* ibe, const int* iext,
                       long long ibstride, int iP, int i0, int ni,
                       const int* fii, const int* fjj,
                       const unsigned short* fal, const unsigned short* fbe,
                       const int* fext, long long fbstride, int fP, int f0,
                       int nf, int rows_per_cta, int filters_per_cta,
                       int threads, void* stream) {
  return launch_bank(t_bank_bf16_kernel, B, R, n, F, rows_per_cta,
                     filters_per_cta, threads, stream, x, y, gains,
                     t_bank_bf16_leg(iii, ijj, ial, ibe, iext, ibstride, iP,
                                     i0, ni),
                     t_bank_bf16_leg(fii, fjj, fal, fbe, fext, fbstride, fP,
                                     f0, nf));
}

// Resident CTAs per SM of a T bf16 form, as g_occupancy.
int t_bf16_occupancy(int kind, int rows, int n, int P, int threads) {
  const int ld = odd_stride(n);
  const size_t smem =
      operator_smem(rows, ld, threads / 32, TEntryBf16<float>::kWords);
  switch (kind) {
    case 0:
      return resident_ctas((const void*)t_chain_bf16_kernel, smem, threads);
    case 1:
      return resident_ctas((const void*)t_operator_bf16_kernel, smem,
                           threads);
    default:
      return resident_ctas((const void*)t_bank_bf16_kernel,
                           bank_smem(rows, ld, P * TEntryBf16<float>::kWords),
                           threads);
  }
}

// The bf16-signal forms: x and y as bf16, the value tables as bf16 bits,
// the other arguments as the f32 forms'.
int t_chain_xbf16_launch(const XSignal* x, XSignal* y, int B, int R, int n,
                         const int* words, const int* off, int S, int s0,
                         int ns, int lanes, int rows_per_warp, int warps,
                         void* stream) {
  return launch_rows<TEntryBf16<XSignal>>(t_chain_xbf16_kernel, B, R, n,
                                          lanes, rows_per_warp, warps, stream,
                                          x, y,
                                          StreamLeg{words, off, S, s0, ns});
}

int t_operator_xbf16_launch(const XSignal* x, XSignal* y, int B, int R,
                            int n, const float* d, const int* iwords,
                            const int* ioff, int iS, int i0, int ni,
                            const int* fwords, const int* foff, int fS,
                            int f0, int nf, int lanes, int rows_per_warp,
                            int warps, void* stream) {
  return launch_rows<TEntryBf16<XSignal>>(
      t_operator_xbf16_kernel, B, R, n, lanes, rows_per_warp, warps, stream,
      x, y, d, StreamLeg{iwords, ioff, iS, i0, ni},
      StreamLeg{fwords, foff, fS, f0, nf});
}

int t_bank_xbf16_launch(const XSignal* x, XSignal* y, int B, int R, int n,
                        const float* gains, int F, const int* iii,
                        const int* ijj, const unsigned short* ial,
                        const unsigned short* ibe, const int* iext,
                        long long ibstride, int iP, int i0, int ni,
                        const int* fii, const int* fjj,
                        const unsigned short* fal, const unsigned short* fbe,
                        const int* fext, long long fbstride, int fP, int f0,
                        int nf, int rows_per_cta, int filters_per_cta,
                        int threads, void* stream) {
  return launch_bank(t_bank_xbf16_kernel, B, R, n, F, rows_per_cta,
                     filters_per_cta, threads, stream, x, y, gains,
                     t_bank_xbf16_leg(iii, ijj, ial, ibe, iext, ibstride, iP,
                                      i0, ni),
                     t_bank_xbf16_leg(fii, fjj, fal, fbe, fext, fbstride, fP,
                                      f0, nf));
}

// Resident CTAs per SM of a T bf16-signal form, as g_occupancy.
int t_xbf16_occupancy(int kind, int rows, int n, int P, int threads) {
  const int ld = odd_stride(n);
  const size_t smem =
      operator_smem(rows, ld, threads / 32, TEntryBf16<XSignal>::kWords);
  switch (kind) {
    case 0:
      return resident_ctas((const void*)t_chain_xbf16_kernel, smem, threads);
    case 1:
      return resident_ctas((const void*)t_operator_xbf16_kernel, smem,
                           threads);
    default:
      return resident_ctas(
          (const void*)t_bank_xbf16_kernel,
          bank_smem(rows, ld, P * TEntryBf16<XSignal>::kWords), threads);
  }
}

}  // extern "C"
