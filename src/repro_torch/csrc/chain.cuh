// The staged-chain kernel bodies shared by both table families
// (butterfly.cu: G pairs, shear.cu: T entries).  A family supplies its
// stage action `Op`.  Two bodies:
//
// The rows body (stream_leg, own_rows, chain_rows, operator_rows,
// launch_rows) carries the chain kernels (one leg) and the operator
// kernels (two legs and the spectrum between them).  A warp owns its
// signal rows of one matrix for the whole launch, so no stage ever waits
// for the whole CTA.  Each leg walks a compacted stream of its real
// entries in stage order (kernels/launcher.py::entry_stream) with
// per-stage offsets, so no pad is read and the anytime cut, head or tail,
// is a runtime entry range; with L lanes per row (kernels/launcher.py::
// operator_geometry) the lanes of a row split a stage's entries and cross
// one __syncwarp() per stage, and with L = 1 a lane walks every entry on
// its own row with no synchronisation at all.  The stream reaches each
// warp through a ring of its own in shared memory, filled with plain
// loads staged through registers two chunks ahead.
//
// What bounds the rows body: not memory (x, y and the stream are read or
// written once per warp) and not the shared-memory pipe, but the latency
// of one warp's walk.  At the batched shapes a scheduler holds one warp,
// so a stage costs its dependent chain (ring load, row load, arithmetic,
// store) plus the per-stage bookkeeping; the body keeps that chain short:
// a lane reads a group of up to 8 entries and all their coordinates
// before it writes any, the group's shared accesses are pinned in that
// order, idle slots of a group use the row's scratch column instead of a
// branch, and no stage waits on device memory (PERF.md §6).
//
// The bank body (walk_leg, bank_tile, launch_bank): a CTA owns r signal
// rows and F_g filters, runs the analysis leg on its r rows, scales them
// into F_g copies in the same tile and runs ONE synthesis walk over all
// F_g * r rows, so it crosses 2 S stage barriers whatever F_g; each leg
// walks a stage only up to its real extent (1 + its last real slot, from
// a (B, S) extent table), and reads its entries from a small ring of
// stages in shared memory that cp.async fills a few stages ahead.  The
// rows and filters per CTA (kernels/launcher.py::bank_geometry) keep the
// CTA's shared memory small enough for three resident CTAs per SM.
//
// Every launch helper takes its batch as grid y; the launcher splits a
// batch of more than 65535 matrices into launches on offset pointers.
//
// bf16 value tables.  Each family has a second Op per body for tables
// whose values are stored as bf16 (GPairBf16 and GBankBf16 in
// butterfly.cu, TEntryBf16 in shear.cu): it reads the 16-bit values from
// device memory and widens them to f32 in registers (the rows body: from
// the packed stream entry) or into the ring's f32 words (the bank body),
// and then runs its f32 Op's arithmetic.  A bf16 -> f32 widening is exact,
// so a bf16 form computes exactly what its f32 form computes on the
// widened tables.
//
// bf16 signals.  Both bodies take the signal's element type from their Op
// (Op::Signal, float or __nv_bfloat16) and its rounding from Signal<T>.
// The shared tile keeps f32 words either way: a bf16 signal is widened
// into it (exact), every product and sum of the walk, the operator's
// spectrum scale and the bank's gain scale is rounded to bf16 by RNE
// (Signal<T>::r, after an unfused __fmul_rn / __fadd_rn: never an FMA),
// so the tile holds bf16 values throughout and the store back to bf16 is
// exact.  That is the plain version's arithmetic on a bf16 signal
// (kernels/ref.py: each torch op rounds its f32 result to bf16), so the
// bf16-signal forms (the *_xbf16_kernel instantiations) are bitwise equal
// to it.  The spectrum and the gains come in as f32 and are rounded to
// bf16 as they are read, as the plain version casts them to x's dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

inline int odd_stride(int n) { return (n + 1) | 1; }

// The signal's element type T: how it widens into the f32 tile, how a tile
// value is stored back, and the rounding r of every product and sum (the
// identity for f32).
template <class T>
struct Signal;

template <>
struct Signal<float> {
  static constexpr bool kRounds = false;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
  static __device__ __forceinline__ float r(float v) { return v; }
};

template <>
struct Signal<__nv_bfloat16> {
  static constexpr bool kRounds = true;
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// r(a * b) and r(a + b) at signal type T, each rounded on its own.
template <class T>
__device__ __forceinline__ float rmul(float a, float b) {
  return Signal<T>::r(__fmul_rn(a, b));
}

template <class T>
__device__ __forceinline__ float radd(float a, float b) {
  return Signal<T>::r(__fadd_rn(a, b));
}

// The f32 value of the bf16 in the low or high half of a word (exact: a
// bf16 is the high half of the f32 it rounds).
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The bank's tile: `rows` rows of x into the shared tile at the stride ld.
template <class T>
__device__ __forceinline__ void load_tile(float* tile, int ld, const T* x,
                                          int rows, int n) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n;
    const int col = e - r * n;
    tile[r * ld + col] = Signal<T>::widen(x[(long long)r * n + col]);
  }
  __syncthreads();
}

// tile[r, col] *= d[col] for the (n + 1)-wide dummy-padded spectrum d.
template <class T>
__device__ __forceinline__ void scale_tile(float* tile, int ld, const float* d,
                                           int rows, int n) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n;
    const int col = e - r * n;
    tile[r * ld + col] =
        rmul<T>(tile[r * ld + col], Signal<T>::r(d[col]));
  }
  __syncthreads();
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
//   Signal                     the signal's element type (float or
//                              __nv_bfloat16; its rounding: Signal<T>)
//   kFields                    32-bit table fields per entry (indices first)
//                              that cp.async copies
//   kWords                     ring words per entry (16-byte aligned)
//   field(k)                   field k's (B, S, P) table
//   apply(row, entry, n)       the entry (in the ring) on one signal row
// and, where its value tables are bf16, a member
//   widen(entry, at)           the value words of a ring entry from table
//                              element `at`, read with plain loads and
//                              widened to f32 (a 2-byte value at an odd
//                              element cannot take a 4-byte cp.async), so
//                              its kFields are the index fields only.

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

template <class Op, class = void>
struct Widens : std::false_type {};
template <class Op>
struct Widens<Op, std::void_t<decltype(&Op::widen)>> : std::true_type {};

// Copy the e real entries of stage st into a ring slot (entry-major, kWords
// words per entry); the cp.async fields are asynchronous until this
// thread's cp_async_wait, a widened value is stored before it returns.
// Either way the stage's next __syncthreads() (walk_leg) publishes them.
template <class Op>
__device__ __forceinline__ void copy_stage(const BankLeg<Op>& leg,
                                           long long base, int st, int e,
                                           float* slot) {
  const long long off = base + (long long)st * leg.P;
  for (int p = threadIdx.x; p < e; p += blockDim.x) {
#pragma unroll
    for (int k = 0; k < Op::kFields; ++k)
      cp_async4(slot + p * Op::kWords + k, leg.op.field(k) + off + p);
    if constexpr (Widens<Op>::value)
      leg.op.widen(slot + p * Op::kWords, off + p);
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
template <class Op, class T = typename Op::Signal>
__device__ __forceinline__ void bank_tile(int R, int n, int ld,
                                          int rows_per_cta,
                                          int filters_per_cta, int row_tiles,
                                          int slot_words, const T* x, T* y,
                                          const float* gains, int F,
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
        rmul<T>(tile[r * ld + col],
                Signal<T>::r(g[(long long)f * (n + 1) + col]));
  }
  __syncthreads();
  scale_tile<T>(tile, ld, g, rows, n);
  walk_leg(tile, ld, fg * rows, n, b, second, ring, slot_words, ring_ext);
  for (int e = threadIdx.x; e < fg * span; e += blockDim.x) {
    const int row = e / n;
    const int col = e - row * n;
    const int f = row / rows;
    const int r = row - f * rows;
    y[(((long long)b * F + f0 + f) * R + r0 + r) * n + col] =
        Signal<T>::narrow(tile[row * ld + col]);
  }
}

// Launch a bank kernel on a grid of (row tiles x filter groups, matrices).
// Returns a cudaError_t code (0: launched).
template <class Op, class... Params>
inline int launch_bank(void (*kernel)(Params...), int B, int R, int n, int F,
                       int rows_per_cta, int filters_per_cta, int threads,
                       void* stream, const typename Op::Signal* x,
                       typename Op::Signal* y, const float* gains,
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

// ---------------------------------------------------------------------------
// The rows body: chains (g_chain_kernel, t_chain_kernel) and operators
// (g_operator_kernel, t_operator_kernel)
// ---------------------------------------------------------------------------
// A warp owns rows of one matrix for the whole launch, so nothing in it
// waits for the CTA.  A family's action `Op` supplies, besides kWords and
// Signal (as in the bank body),
//   Entry                      one table entry in registers, read from the
//                              ring form at a shared address (entry(a))
//   apply_group<K>(row, scratch, en, ok)
//                              the K entries en[k] of one stage on the row at
//                              shared address `row`, every coordinate read
//                              before any is written; an entry without ok[k]
//                              reads and writes the row's scratch column n
//                              (`scratch`) instead, which is never stored

// Shared-memory accesses at 32-bit shared addresses, kept in program order
// (a memory clobber each): a group's loads all issue before its stores,
// and the compiler does not sink a load below arithmetic it could overlap.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float ld_shared(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ int4 ld_shared4(unsigned a) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

constexpr int kMaxOperatorThreads = 256;  // 8 warps: registers up to 255
constexpr int kChunk = 32;        // stream entries per ring chunk
constexpr int kRingChunks = 8;    // chunks in a warp's ring (a power of two)
constexpr int kRingEntries = kChunk * kRingChunks;

// Entries a lane reads before it writes any: eight with one or two lanes
// per row, four with more (so that a stage's ~9-15 entries mostly take one
// pass of the row's lanes).
template <int L>
constexpr int kGroupOf = L <= 2 ? 8 : 4;

// One leg as a compacted stream: the real entries of all matrices in stage
// order, and per-stage offsets (matrix b's stage s holds stream entries
// [off[b * (S + 1) + s], off[b * (S + 1) + s + 1])).  The anytime cut is the
// entry range of stages [s0, s0 + ns): a runtime offset and count.
struct StreamLeg {
  const int* words;  // (E, kWords) entries
  const int* off;    // (B, S + 1) stage offsets into the stream
  int S;             // stages of the tables
  int s0;            // first stage to run
  int ns;            // number of stages to run
};

// One lane's share of a ring chunk in registers: 16-byte pieces lane,
// lane + 32, ... of the chunk's kChunk entries.
template <class Op>
struct ChunkRegs {
  static constexpr int kPieces = Op::kWords / 4;  // per entry and per lane
  int4 v[kPieces];

  // Load chunk c of the leg's entry range [e_lo, e_hi) (pieces past e_hi
  // are not read).
  __device__ __forceinline__ void load(const int* words, int e_lo, int e_hi,
                                       int c, int lane) {
    const int first = e_lo + c * kChunk;
    const int pieces = min(kChunk, e_hi - first) * kPieces;
    const int4* src =
        reinterpret_cast<const int4*>(words + (long long)first * Op::kWords);
#pragma unroll
    for (int q = 0; q < kPieces; ++q)
      if (lane + 32 * q < pieces) v[q] = __ldg(src + lane + 32 * q);
  }

  // Store them as chunk c of the warp's ring.
  __device__ __forceinline__ void store(int* ring, int c, int lane) const {
    int4* slot = reinterpret_cast<int4*>(
        ring + (c & (kRingChunks - 1)) * kChunk * Op::kWords);
#pragma unroll
    for (int q = 0; q < kPieces; ++q) slot[lane + 32 * q] = v[q];
  }
};

// One leg on one signal row that L lanes of the warp share (this lane is
// number `sub` of them; a lane whose row lies past the warp's rows walks
// along without touching any row: `active` false).  Each lane takes
// entries sub, sub + L, ... of a stage, kGroupOf<L> at a time, and reads
// all their coordinates before it writes any: a stage's entries touch
// disjoint coordinates.  With L > 1 the row's lanes cross one __syncwarp()
// per stage; with one lane per row nothing in the stage loop synchronises.
// All 32 lanes run the same trip counts.
//
// The entries come from the warp's own ring in shared memory, chunks
// [first - 1, first + kRingChunks - 2] around the chunk `first` the walk is
// in, filled with plain loads staged through registers: the two chunks
// after the ring's last are in flight in two register sets (by parity, so
// no register waits on a load it is not stored from), and the walk stores
// the older one into the ring when it enters a new chunk.  A stage longer
// than the ring is walked in pieces.  The stage offsets come from a window
// of 32 that lane k holds in a register (off[w0 + k]), read with a shuffle;
// the next window is loaded one window ahead.
template <class Op, int L>
__device__ __forceinline__ void stream_leg(float* row, int n, bool active,
                                           int* ring, int b,
                                           const StreamLeg& leg, int lane,
                                           int sub) {
  constexpr int K = kGroupOf<L>;
  if (leg.ns <= 0) return;
  const unsigned row_s = smem_addr(row);
  const unsigned ring_s = smem_addr(ring);
  const int* off = leg.off + (long long)b * (leg.S + 1) + leg.s0;
  const int e_lo = __ldg(off);
  const int e_hi = __ldg(off + leg.ns);
  ChunkRegs<Op> even, odd;  // chunks in flight, by parity
  for (int c = 0; c < kRingChunks - 2; c += 2) {
    even.load(leg.words, e_lo, e_hi, c, lane);
    odd.load(leg.words, e_lo, e_hi, c + 1, lane);
    even.store(ring, c, lane);
    odd.store(ring, c + 1, lane);
  }
  even.load(leg.words, e_lo, e_hi, kRingChunks - 2, lane);
  odd.load(leg.words, e_lo, e_hi, kRingChunks - 1, lane);
  int stored = kRingChunks - 3;  // the ring's last chunk
  __syncwarp();
  int w0 = 0;  // the window's first stage offset
  int win = __ldg(off + min(lane, leg.ns));
  int nxt = __ldg(off + min(32 + lane, leg.ns));
  int e0 = e_lo;
  for (int st = 0; st < leg.ns; ++st) {
    if (st + 1 - w0 == 32) {
      w0 += 32;
      win = nxt;
      nxt = __ldg(off + min(w0 + 32 + lane, leg.ns));
    }
    const int e1 = __shfl_sync(0xffffffffu, win, st + 1 - w0);
    while (e0 < e1) {
      const int first = (e0 - e_lo) / kChunk;
      if (stored < first + kRingChunks - 2) {
        __syncwarp();  // every lane is done with the slots being refilled
        do {
          ++stored;
          if (stored & 1) {
            odd.store(ring, stored, lane);
            odd.load(leg.words, e_lo, e_hi, stored + 2, lane);
          } else {
            even.store(ring, stored, lane);
            even.load(leg.words, e_lo, e_hi, stored + 2, lane);
          }
        } while (stored < first + kRingChunks - 2);
        __syncwarp();  // and every lane's stores are visible
      }
      const int hi = min(e1, e_lo + (stored + 1) * kChunk);
      for (int base = e0 - e_lo + sub; base < hi - e_lo; base += K * L) {
        typename Op::Entry en[K];
        bool ok[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          ok[k] = active && base + k * L < hi - e_lo;
          en[k] = Op::entry(ring_s + ((base + k * L) & (kRingEntries - 1)) *
                                         Op::kWords * 4);
        }
        Op::apply_group(row_s, row_s + 4 * n, en, ok);
      }
      e0 = hi;
    }
    if (L > 1) __syncwarp();
  }
  __syncwarp();  // the ring is free for the next leg
}

// Shared memory of a rows CTA: `rows` rows at the stride ld (16-byte
// aligned), then one ring per warp.
inline size_t operator_smem(int rows, int ld, int warps, int words) {
  return ((size_t)rows * ld + 3) / 4 * 16 +
         (size_t)warps * kChunk * kRingChunks * words * sizeof(int);
}

// The rows a warp owns in a rows CTA (blockIdx.x, b = blockIdx.y) of
// blockDim.x / 32 warps, shared by chain_rows and operator_rows: warp w
// owns rows [r0, r0 + rows) of matrix b, r0 = (blockIdx.x * warps + w) *
// rows_per_warp, in its own part of the shared tile (`wt`) at the odd
// stride ld (lanes on different rows hit different banks), beside a ring
// of table entries of its own.  The warp loads its rows from x
// (coalesced), runs `walk`, and stores its rows to y: x is read once and
// y written once, and no warp waits for another.  In the walk, lane
// `lane` is number `sub` of the L lanes of its row `mine`; a lane past
// the warp's rows walks on row 0's scratch column without touching any
// row (`active` false).  A partial last warp leaves the lanes of its
// missing rows idle.
template <class Op, int L, class Walk, class T = typename Op::Signal>
__device__ __forceinline__ void own_rows(int R, int n, int ld,
                                         int rows_per_warp, const T* x, T* y,
                                         Walk walk) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x * warps + warp) * rows_per_warp;
  if (r0 >= R) return;
  const int rows = min(rows_per_warp, R - r0);
  float* wt = smem + warp * rows_per_warp * ld;
  int* ring = reinterpret_cast<int*>(smem) +
              ((size_t)warps * rows_per_warp * ld + 3) / 4 * 4 +
              warp * kRingEntries * Op::kWords;
  const long long at = ((long long)b * R + r0) * n;
  for (int r = 0; r < rows; ++r)
    for (int c = lane; c < n; c += 32)
      wt[r * ld + c] =
          Signal<T>::widen(__ldg(x + at + (long long)r * n + c));
  __syncwarp();
  const int row = lane / L;
  const int sub = lane - row * L;
  float* mine = wt + (row < rows ? row : 0) * ld;
  walk(wt, rows, mine, row < rows, ring, b, lane, sub);
  __syncwarp();
  for (int r = 0; r < rows; ++r)
    for (int c = lane; c < n; c += 32)
      y[at + (long long)r * n + c] = Signal<T>::narrow(wt[r * ld + c]);
}

// y[b] = leg_b x[b]: the rows' lanes walk the one leg.
template <class Op, int L, class T = typename Op::Signal>
__device__ __forceinline__ void chain_rows(int R, int n, int ld,
                                           int rows_per_warp, const T* x,
                                           T* y, const StreamLeg& leg) {
  own_rows<Op, L>(R, n, ld, rows_per_warp, x, y,
                  [&](float*, int, float* mine, bool active, int* ring,
                      int b, int lane, int sub) {
                    stream_leg<Op, L>(mine, n, active, ring, b, leg, lane,
                                      sub);
                  });
}

// y[b] = second_b diag(d[b]) first_b x[b], d (B, n): the rows' lanes walk
// the first leg, the warp scales its rows' columns < n, the lanes walk
// the second leg.
template <class Op, int L, class T = typename Op::Signal>
__device__ __forceinline__ void operator_rows(int R, int n, int ld,
                                              int rows_per_warp, const T* x,
                                              T* y, const float* d,
                                              const StreamLeg& first,
                                              const StreamLeg& second) {
  own_rows<Op, L>(
      R, n, ld, rows_per_warp, x, y,
      [&](float* wt, int rows, float* mine, bool active, int* ring, int b,
          int lane, int sub) {
        stream_leg<Op, L>(mine, n, active, ring, b, first, lane, sub);
        __syncwarp();
        const float* db = d + (long long)b * n;
        for (int c = lane; c < n; c += 32) {
          const float dc = Signal<T>::r(__ldg(db + c));
          for (int r = 0; r < rows; ++r)
            wt[r * ld + c] = rmul<T>(wt[r * ld + c], dc);
        }
        __syncwarp();
        stream_leg<Op, L>(mine, n, active, ring, b, second, lane, sub);
      });
}

// A rows body at the launch's lanes per row (1, 2, 4 or 8).
template <class Op, class T = typename Op::Signal>
__device__ __forceinline__ void chain_lanes(int R, int n, int ld, int lanes,
                                            int rows_per_warp, const T* x,
                                            T* y, const StreamLeg& leg) {
  switch (lanes) {
    case 1: chain_rows<Op, 1>(R, n, ld, rows_per_warp, x, y, leg); break;
    case 2: chain_rows<Op, 2>(R, n, ld, rows_per_warp, x, y, leg); break;
    case 4: chain_rows<Op, 4>(R, n, ld, rows_per_warp, x, y, leg); break;
    default: chain_rows<Op, 8>(R, n, ld, rows_per_warp, x, y, leg);
  }
}

template <class Op, class T = typename Op::Signal>
__device__ __forceinline__ void operator_lanes(int R, int n, int ld,
                                               int lanes, int rows_per_warp,
                                               const T* x, T* y,
                                               const float* d,
                                               const StreamLeg& first,
                                               const StreamLeg& second) {
  switch (lanes) {
    case 1:
      operator_rows<Op, 1>(R, n, ld, rows_per_warp, x, y, d, first, second);
      break;
    case 2:
      operator_rows<Op, 2>(R, n, ld, rows_per_warp, x, y, d, first, second);
      break;
    case 4:
      operator_rows<Op, 4>(R, n, ld, rows_per_warp, x, y, d, first, second);
      break;
    default:
      operator_rows<Op, 8>(R, n, ld, rows_per_warp, x, y, d, first, second);
  }
}

// Launch `kernel(R, n, ld, lanes, rows_per_warp, args...)` on a grid of
// (row tiles of warps * rows_per_warp rows, matrices), `warps` warps per
// CTA, each warp's rows and ring in dynamic shared memory.  Returns a
// cudaError_t code (0: launched).
template <class Op, class... Params, class... Args>
inline int launch_rows(void (*kernel)(int, int, int, int, int, Params...),
                       int B, int R, int n, int lanes, int rows_per_warp,
                       int warps, void* stream, Args... args) {
  if (B == 0 || R == 0) return 0;
  if ((lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8) ||
      rows_per_warp < 1 || rows_per_warp * lanes > 32 || warps < 1 ||
      warps * 32 > kMaxOperatorThreads)
    return (int)cudaErrorInvalidValue;
  const int ld = odd_stride(n);
  const int rows = warps * rows_per_warp;
  const size_t smem = operator_smem(rows, ld, warps, Op::kWords);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + rows - 1) / rows, B);
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      R, n, ld, lanes, rows_per_warp, args...);
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
