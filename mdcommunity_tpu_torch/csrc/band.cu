// Band-operator kernels for Hopper (sm_90a), plain C ABI, loaded with ctypes
// by ops/band_kernels.py.
//
// K1  mdc_band_spmm : out = row ⊙ (A_band @ (col ⊙ h) + Gᵀ·sub)
// K2  mdc_band_sage : h' = l2n(relu(out_K1 @ A_w + h @ B_w))
// K3  mdc_band_spmm_halo : K1 on one shard of a gp mesh, its windows linear
//     over [left halo | local rows | right halo]
// and their bf16 modes mdc_band_spmm_bf16, mdc_band_sage_bf16 and
// mdc_band_spmm_halo_bf16.  Every mode is one kernel, band_mma_kernel.
//
// A_band is a DenseBandGraph's int8 base [nb, S+C, W2] (only its S band rows
// are read): row s of destination block b holds the edges from source rows
// (b·S − B + w) mod pad_n, w in [0, W2).  G is the mirror one-hot: row
// (b, s) owns mirror slot slot[b, s] (or none, -1), and `sub` [nb·C, D] is
// the mirror-space result computed by the wrapper (compaction gather +
// sorted-COO SpMM).  h, out: [pad_n, D] row-major, f32 (or, in the bf16
// modes, bf16 storage); row, col, sub: f32.
//
// What they replace.  Both replace the JAX package's Pallas TPU kernel
// ops/band_pallas.py::_make_kernel: K1 its sage=False, halo=False mode (the
// forward of spmm_band_packed), K2 its sage=True mode (sage_step_packed).
// mdc_band_spmm and mdc_band_sage are its precise (f32 operand) mode, which
// the default eval path uses.  K1 is also the backward of the operator (the
// VJP at band_pallas.py:811-829): the stored operator is symmetric, so
// ops/dense_band.BandSpmm launches K1 with row and col swapped for the
// training loss's gradient.  The *_bf16 entry points are its precise=False
// mode (band_pallas.py:535, 577-578, 609-620: bf16 band, bf16(col ⊙ h) and
// bf16(sub) operands, f32 accumulation, f32 epilogue), with h and out
// stored in f32 or, as its dtype=bf16 mode (:262-264, 743), in bf16.  The
// TPU kernel's node-pair lane packing and 128-lane scale planes exist for
// the TPU's vector tiles and have no counterpart here: h stays [pad_n, D]
// and the scales are read per row.
//
// The TPU kernel's remaining modes are template parameters:
//   NIB (nibble=True, band_pallas.py:584-602): the base rows hold two window
//     columns a byte, byte = a[w] + 16·a[w+1] for even w, each in [0, 7]
//     (the row pitch is W2/2 bytes, the mirror-lane rows included).  The A
//     fragments unpack them in registers into the int8 path's values, in
//     the same order, so a nibble launch gives the int8 launch's bits in
//     every mode (K1, K2, K3).
//   EPI (f32_epi=False, :653-668): K2's epilogue rounds its dot operands
//     (the pooled block after the row scale, the own rows' h, A_w and B_w)
//     to bf16 and sums in f32, in either precise mode; relu, Σz² and rsqrt
//     stay f32.
//   DIAG (diag=, :280-286, 480-498, 623-633), K1 only, timing variants
//     whose output is wrong by design: 1 noscale (no col scale in the
//     window staging, no row scale: out = A_band @ h + Gᵀ·sub), 2 nodot
//     (staging and scales, no multiply-adds: out[i] = row[i]·col[j]·h[j],
//     j = i − B mod pad_n, bf16(col[j]·h[j]) in the bf16 mode, re-read from
//     global memory in the epilogue), 3 noh (nodot without the h-window
//     staging: out = row ⊙ Gᵀ·sub), 4 hlin (a block stages only its own S
//     window rows, no B-row overlap and no wrap; the rest are zeros).
//   PREC: the precise mode (below), else the bf16 mode.
//
// K3 replaces the same kernel's halo=True mode (band_pallas.py:274-278,
// 394-478), the local engine of the gp-sharded band operator
// (parallel/band_partition.py:189-291).  It is the kernel with HALO set: a
// shard passes its own base blocks, h, scales, slots and mirror sub, and
// its ring neighbours' B-row strips lh, rh with their col scales lc, rc.
// Window row j = b·S − B + w of local block b reads lh[j + B] for j < 0,
// rh[j − local_n] for j >= local_n, and h[j] otherwise (B <= S keeps j in
// [−B, local_n + B)).  A launch covers the block range [b0, b1), so the
// caller can issue the interior blocks, whose windows never reach a halo,
// before the halos arrive, and the two boundary blocks after.  It stages
// the same values in the same order as K1, so a sharded operator gives K1's
// bits on the whole graph.
//
// What bounds them on an H100.  The function itself is bound by bytes: it
// must read the int8 band once (pad_n·W2 bytes, 0.54 GB at 2^20 nodes) and
// h, and write the output, while the band holds only ~6-12 nonzeros a row
// out of W2 = 512, so the multiply-adds the data needs are few.  A kernel
// that multiplies the band as a dense matrix instead does 2·pad_n·W2·D
// flops (6.9e10 at 2^20 nodes, D = 64): ~1 ms at the 67 TFLOP/s of FP32 FMA,
// over the bytes' 0.33 ms; on the bf16 tensor cores (989 TFLOP/s) ~0.07 ms,
// and three passes ~0.21 ms, under them.  So every mode runs the dense
// product on the tensor cores, and what bounds the kernel is moving the
// band and the window, and, in the precise mode, the three passes.
//
// The operands.  The bf16 modes: the int8 (or nibble) band widened exactly,
// the window as bf16(col ⊙ h) formed in f32 from the stored h and rounded to
// nearest even (XLA's astype(bfloat16)), bf16(sub) added in f32.  The
// precise mode cannot round col ⊙ h: one TF32 or bf16 pass keeps 10 or 8 of
// its 24 bits, the kind of rounding that cost the JAX package 0.035 AUDC.
// It splits each window value x = col·h (rounded once in f32, as an FP32
// multiply-add takes it) into three bf16 pieces, hi = bf16(x), mid =
// bf16(x − hi) and lo = bf16(x − hi − mid) (split3x2,
// ops/band_kernels.split_bf16x3).  x − hi has at most 16 significant bits
// and x − hi − mid at most 8, so each remainder is exact in f32 and hi +
// mid + lo = x exactly (2^-110 <= |x| < (2 − 2^-8)·2^127); a band value
// (8 bits) times a piece (8 bits) is exact in f32
// (tests/test_torch_band_split.py).  So three MMA passes of one band
// fragment against the three pieces add exactly the products that FP32
// FMAs of x add; only the accumulation differs.  The tensor core adds a
// pass's products to its accumulator input aligned to the largest, and
// truncates the sum to f32 (toward zero): a sum whose bits span more than
// f32's 24 drifts toward zero.  A band value times a piece has at most 15
// bits, and one k16 step of one row holds a few such products, so a pass
// into a zeroed register is mostly exact; the lo and mid products stay a
// 2^-8 of the hi ones, where a truncation is negligible.  So each k16 step
// sums its lo and mid products into one zeroed partial and its hi products
// into another, and adds both into the f32 accumulator, rounded to nearest.
// Measured against the plain version run in f64 (chip_smoke.py's
// yardstick, PERF.md), the kernel's error stays at the f32 plain
// version's.  The cheaper designs drifted: one partial for all three passes
// (lo, mid, hi) truncates the lo and mid sum's last bits where it meets the
// hi products, and the three passes straight into the accumulator truncate
// at the accumulator's magnitude; both biased the gate gradient of
// chip_smoke.py's fit check past its bound, and the second also broke the
// yardstick's 1e-6 on a two-column K2 of its edge graphs.  K2's f32
// epilogue (below) is an f32 dot on arbitrary f32 operands, which no split
// of one side makes exact: it stays on FP32 FMAs.
//
// The pipeline (every mode):
//   * A CTA (256 threads, a warp 32 rows) owns TR rows of a band block, all
//     S of them (TR = 256 at S = 256) unless the graph has too few blocks to
//     give every SM a CTA (ops/band_kernels.rows_per_cta then splits them,
//     down to 64 rows; the precise K2 takes 128 so that two CTAs share an
//     SM), and one column group of at most 64 columns (K2: all of them, in
//     turn).  So each window row is staged once or twice per band block.
//   * It walks the window in chunks of KB = 64 columns, only those its rows
//     can reach: on a ring of three or more blocks the symmetric band test
//     (ops/dense_band.band_slots) keeps rows r >= B out of window columns
//     [0, B) and rows r < S - B out of [S + B, W2)
//     (ops/band_kernels.window_reach; tests/test_torch_band_geometry.py).
//     A chunk whose base rows are all zero over the CTA skips its window
//     staging and its multiplies; a warp whose own rows are zero in it skips
//     its multiplies.  Skipping adds no term that was not an exact zero, and
//     every launch shape adds a row's chunks in ascending order with one k
//     order inside a chunk, so K1, K3 and every row split give the same bits.
//   * The base chunks come by cp.async 16-byte copies (8 or 4 where the row
//     pitch asks) into a ring of four stages (the precise K1 and K3, whose
//     window ring is three times the size, and K2: three).  The window rows
//     of chunk c + 1 load as 16-byte vectors (a float4 pair, or 8 bf16) into
//     registers before chunk c multiplies, unconditionally from valid
//     addresses with a mask for what is real, so that no instruction waits
//     on them until they are scaled (col[j] once a window row; K3's halo
//     choice once a window row), rounded or split, and stored as 16-byte
//     vectors after it, into a ring of two stages (one bf16 plane, or the
//     precise mode's three) whose rows are XOR-swizzled so that ldmatrix
//     reads them without bank conflicts.  The rows' slots and row scales come
//     by cp.async with the first chunk, so the epilogue waits on no load but
//     the rare mirror row.
//   * The band goes into the MMA (mma.sync m16n8k16, bf16, f32 accumulators)
//     from shared memory through registers: a thread reads 4 bytes of each
//     of its two rows a k16 step (2 with nibbles) and widens them exactly in
//     registers (byte_perm into an f32 2^23 + v + 128, one FADD, a bf16x2
//     pack), with no bf16 copy of the band in shared memory, once for the
//     three passes of the precise mode.  The chunk's k order is permuted so
//     that those bytes are contiguous: step s, fragment column 2t+e (+8)
//     takes window column 16t + 4s + e (+2); the window rows that ldmatrix
//     hands to the B fragments follow the same permutation.
//   * K2 stages A_w and B_w once a CTA.  Its f32 epilogue runs on FP32 FMAs
//     (the JAX package's f32_epi=True is an f32 dot) from 8 × 8 register
//     tiles over the pooled block in shared memory, transposed; the bf16
//     epilogue (f32_epi=False: bf16 operands by definition) runs [bf16(pool)
//     | bf16(h_own)] @ [A_w; B_w] on the tensor cores with f32 sums, whose
//     order within a k16 step is the tensor core's (within EPI_TOL of the
//     plain version, chip_smoke.py).  Shared memory stays under half an SM's
//     so two CTAs share an SM and one's epilogue overlaps the other's copies.
//   * K3's interior launches, whose windows never reach a halo, run K1's
//     instantiation (the same values in the same order) and so skip the
//     halo test; the boundary launches choose lh, h or rh once a window row.
// Nibble storage stages the same values in the same order (the int8 build's
// bits), sums run in a fixed order, and the output store rounds to nearest
// even with bf16 storage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;   // threads a CTA
constexpr int NW = NT / 32;
// DIAG values (band_pallas.py's diag names)
constexpr int FULL = 0, NOSCALE = 1, NODOT = 2, NOH = 3, HLIN = 4;

template <typename T>
struct BandArgs {
  const int8_t* base;
  const T* h;
  const float* row;
  const float* col;
  const float* sub;
  const int32_t* slot;
  const float* aw;   // K2 only: [D, D]
  const float* bw;   // K2 only: [D, D]
  T* out;
  int nb, S, B, C, D;
  int TR;            // destination rows a CTA (a multiple of 16)
  int DG;            // DP / 4, DP = D rounded up to 16
  const T* lh;       // K3 only: [B, D] left halo (the left shard's tail)
  const T* rh;       // K3 only: [B, D] right halo (the right shard's head)
  const float* lc;   // K3 only: [B] col scales of lh
  const float* rc;   // K3 only: [B] col scales of rh
  int b0;            // first block of the launch (grid y = blocks b0, b0+1, ...)
  int geo;           // the ring has >= 3 blocks (window_reach)
  int G;             // bytes a cp.async copy of the base (16, 8, 4)
  int vec;           // h rows load as 16-byte vectors
};

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------- the pipeline

constexpr int KB = 64;          // window columns a chunk of the contraction
// bf16 planes of a staged window: the bf16 modes' bf16(col ⊙ h), or the
// precise mode's three pieces hi, mid, lo of col ⊙ h (split3x2)
__host__ __device__ constexpr int planes(bool prec) { return prec ? 3 : 1; }
// base ring stages: the bf16 modes' K1 and K3 keep two chunks of copies in
// flight; the precise mode's K1 and K3 (whose window ring is three times
// the size) and K2 (whose epilogue needs the room) one
__host__ __device__ constexpr int ns_k1(bool prec) { return prec ? 3 : 4; }
constexpr int NS_K2 = 3;
constexpr int HP = 64;          // staged window row pitch (bf16): a column group
constexpr int MTM = 2;          // 16-row m-tiles a warp, at most
constexpr int NTM = HP / 8;     // 8-column n-tiles of a column group
constexpr int HS_STAGE = KB * HP;   // bf16 elements of a window stage
constexpr int SMEM_MAX = 232448;    // bytes of shared memory a block may use
constexpr int SMEM_HALF = 233472 / 2 - 1024;   // two blocks an SM (1 KB each reserved)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes of `src` ([0, G]; the rest of the G-byte copy is zero-filled)
__device__ __forceinline__ void cp_async(void* dst, const void* src, int G, int bytes) {
  const uint32_t d = smem_u32(dst);
  if (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  else if (G == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a · b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}
// The precise mode's split of a pair (x0, x1) of f32 window values: hi =
// bf16(x), mid = bf16(x − hi), lo = bf16(x − hi − mid), each rounded to
// nearest even (ops/band_kernels.split_bf16x3).  Each remainder is exact
// in f32 and hi + mid + lo = x exactly for 2^-110 <= |x| < (2 − 2^-8)·2^127;
// below, lo rounds to bf16's subnormal grid (an error under 2^-134).
__device__ __forceinline__ void split3x2(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                         uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = __fsub_rn(x0, __low2float(h)), r1 = __fsub_rn(x1, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bf2(__fsub_rn(r0, __low2float(m)), __fsub_rn(r1, __high2float(m)));
}
// byte k of x = word ^ 0x80808080 (v + 128) as an f32: 2^23 + v + 128 minus
// 2^23 + 128, exact for every int8 v
__device__ __forceinline__ float i8f(uint32_t x, int k) {
  return __int_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | k)) - 8388736.f;
}
// A fragment of one k16 step from the base words x (row g) and y (row g+8),
// four window columns a word: a0a1 = (g, cols 0-1), a2a3 = (g+8, 0-1),
// a4a5 = (g, 2-3), a6a7 = (g+8, 2-3)
__device__ __forceinline__ void a_frag(uint32_t x, uint32_t y, uint32_t (&a)[4]) {
  x ^= 0x80808080u;
  y ^= 0x80808080u;
  a[0] = bf2(i8f(x, 0), i8f(x, 1));
  a[1] = bf2(i8f(y, 0), i8f(y, 1));
  a[2] = bf2(i8f(x, 2), i8f(x, 3));
  a[3] = bf2(i8f(y, 2), i8f(y, 3));
}
// four nibbles (16 bits) -> four bytes
__device__ __forceinline__ uint32_t nib_word(uint32_t v) {
  return (v & 0xFu) | ((v & 0xF0u) << 4) | ((v & 0xF00u) << 8) | ((v & 0xF000u) << 12);
}
// the staged window's swizzle: row w's 16-byte chunk c sits at chunk
// c ^ key(w).  The rows one ldmatrix phase reads differ in bits 0, 4 and 5
// (the chunk's k permutation), so those make the key.
__device__ __forceinline__ int hkey(int w) { return (w & 1) | ((w >> 3) & 6); }

// window row w of block b: the row of h (or of a halo) it reads and the
// address of its scale; false where it stages zeros (past W2; DIAG hlin
// outside the block's own rows), and then row and scale stay valid
// addresses (h, col) that the caller may load and discard
template <bool HALO, int DIAG, typename T>
__device__ __forceinline__ bool window_src(const BandArgs<T>& a, int b, int w, int pad_n,
                                           const T*& row, const float*& scale) {
  row = a.h;
  scale = a.col;
  if (w >= a.S + 2 * a.B) return false;
  if constexpr (DIAG == HLIN) {
    if (w < a.B || w >= a.B + a.S) return false;
  }
  int j = b * a.S - a.B + w;
  if constexpr (HALO) {
    if (j < 0) {
      row = a.lh + (long long)(j + a.B) * a.D;
      scale = a.lc + j + a.B;
      return true;
    }
    if (j >= pad_n) {
      row = a.rh + (long long)(j - pad_n) * a.D;
      scale = a.rc + j - pad_n;
      return true;
    }
  } else {
    if (j < 0) j += pad_n;
    if (j >= pad_n) j -= pad_n;
  }
  row = a.h + (long long)j * a.D;
  scale = a.col + j;
  return true;
}

// 8 values of row p from column d0 into r, raw; returns which of them are
// real (bit k: values 4k..4k+3; past D they read as zeros).  The vector
// loads are unconditional, from p itself where the columns run past D, so
// that no instruction waits on them before the values are used.
__device__ __forceinline__ uint32_t load8(const float* p, int d0, int D, int vec,
                                          uint4 (&r)[2]) {
  if (vec) {
    const uint32_t m = (d0 + 4 <= D ? 1u : 0u) | (d0 + 8 <= D ? 2u : 0u);
    r[0] = __ldg(reinterpret_cast<const uint4*>(m & 1u ? p + d0 : p));
    r[1] = __ldg(reinterpret_cast<const uint4*>(m & 2u ? p + d0 + 4 : p));
    return m;
  }
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = d0 + k < D ? __float_as_uint(p[d0 + k]) : 0u;
  r[0] = make_uint4(v[0], v[1], v[2], v[3]);
  r[1] = make_uint4(v[4], v[5], v[6], v[7]);
  return 3u;
}
__device__ __forceinline__ uint32_t load8(const __nv_bfloat16* p, int d0, int D, int vec,
                                          uint4 (&r)[2]) {
  if (vec) {
    const uint32_t m = d0 + 8 <= D ? 3u : 0u;
    r[0] = __ldg(reinterpret_cast<const uint4*>(m ? p + d0 : p));
    return m;
  }
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = d0 + k < D ? (uint32_t)q[d0 + k] : 0u;
  r[0] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                    v[6] | v[7] << 16);
  return 3u;
}
// the 8 values of load8 as f32, zeros where its mask m says
__device__ __forceinline__ void unpack8(const uint4 (&r)[2], uint32_t m, float (&v)[8], float) {
  const uint32_t w[8] = {r[0].x, r[0].y, r[0].z, r[0].w, r[1].x, r[1].y, r[1].z, r[1].w};
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (m >> (k / 4)) & 1u ? __uint_as_float(w[k]) : 0.f;
}
__device__ __forceinline__ void unpack8(const uint4 (&r)[2], uint32_t m, float (&v)[8],
                                        __nv_bfloat16) {
  const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = m ? __uint_as_float(w[k] << 16) : 0.f;
    v[2 * k + 1] = m ? __uint_as_float(w[k] & 0xFFFF0000u) : 0.f;
  }
}

// A thread's window items of one chunk: 8 columns of a window row each, raw
// (f32 or bf16 bits), their masks and scales (64 rows × 8 items over NT
// threads)
struct HItems {
  uint4 raw[2][2];
  uint32_t ok[2];
  float scl[2];
};

// The rows of one CTA: TR rows from tile0, m-tiles a warp.
struct Tile {
  int b, tile0, m16, mt;
};

// acc[mi·NTM + j] (m-tile mi of the warp, n-tile j of column group cg) +=
// A_band @ (col ⊙ h) over the window chunks the CTA's rows reach: with
// bf16(col ⊙ h) in the bf16 modes, with its three pieces (PREC) in the
// precise mode.  Leaves the ring free for reuse (the caller synchronises
// before).
template <int NS, bool HALO, bool NIB, int DIAG, bool PREC, typename T>
__device__ __forceinline__ void contract(const BandArgs<T>& a, unsigned char* smem,
                                         const Tile& tl, int cg,
                                         float (&acc)[MTM * NTM][4]) {
  constexpr int NPL = planes(PREC);
  const int S = a.S, B = a.B, D = a.D, W2 = S + 2 * B, TR = a.TR, G = a.G;
  const int pad_n = a.nb * S, b = tl.b, tile0 = tl.tile0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int CB = NIB ? KB / 2 : KB;   // bytes of a base row in a chunk
  const int pitch = NIB ? W2 / 2 : W2;
  const int8_t* base_blk = a.base + (long long)b * (S + a.C) * pitch;
  unsigned char* ring = smem;   // [NS][TR][CB]
  // [2][NPL][KB][HP]
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + NS * TR * CB);
  const int dn = min(HP, 4 * a.DG - cg * HP);   // columns of the group (of 16)
  const int nn = dn / 8;
  const int m0 = warp * tl.mt;                       // the warp's first m-tile
  const int mtw = max(0, min(tl.mt, tl.m16 - m0));   // and its count
  // the window columns [lo, hi) that these rows can reach
  // (ops/band_kernels.window_reach)
  const int r_end = min(tile0 + TR, S);
  int lo = 0, hi = W2;
  if (a.geo) {
    if (tile0 >= B) lo = B;
    if (r_end <= S - B) hi = S + B;
  }
  const int c_lo = lo / KB, nch = (hi + KB - 1) / KB - c_lo;

#pragma unroll
  for (int i = 0; i < MTM * NTM; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  const int pieces = CB / G;   // copies a row of a chunk
  auto issue = [&](int c, int stage) {
    const int cofs = NIB ? c * KB / 2 : c * KB;   // the chunk's byte offset in a row
    unsigned char* dst = ring + stage * TR * CB;
    for (int e = tid; e < TR * pieces; e += NT) {
      const int r = e / pieces, q = e - r * pieces;
      const bool in = tile0 + r < S && cofs + q * G < pitch;
      const int8_t* src =
          in ? base_blk + (long long)(tile0 + r) * pitch + cofs + q * G : base_blk;
      cp_async(dst + r * CB + q * G, src, G, in ? G : 0);
    }
  };
  // does this thread's share of a landed stage hold a nonzero?
  auto own_nz = [&](int stage) {
    const unsigned char* src = ring + stage * TR * CB;
    uint32_t nz = 0;
    for (int e = tid; e < TR * pieces; e += NT) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(src + e * G);
      for (int k = 0; k < G / 4; ++k) nz |= p[k];
    }
    return (int)(nz != 0u);
  };
  // the window rows of chunk c: two 8-column items a thread (64 rows × 8),
  // loaded here and stored by h_store after the chunk before multiplies
  HItems hw;
  auto h_load = [&](int c) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + NT * it, rr = e >> 3, q = e & 7;
      const T* row;
      const float* scp;
      const bool in = window_src<HALO, DIAG>(a, b, c * KB + rr, pad_n, row, scp);
      hw.scl[it] = DIAG == NOSCALE ? 1.f : __ldg(scp);
      const uint32_t m = load8(row, in ? cg * HP + 8 * q : 0, D, a.vec, hw.raw[it]);
      hw.ok[it] = in ? m : 0u;
    }
  };
  auto h_store = [&](int stage) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + NT * it, rr = e >> 3, q = e & 7;
      if (8 * q >= dn) continue;
      float v[8];
      unpack8(hw.raw[it], hw.ok[it], v, T());
      const float sc = hw.scl[it];
      __nv_bfloat16* dst = hs + stage * NPL * HS_STAGE + rr * HP + 8 * (q ^ hkey(rr));
      if constexpr (PREC) {   // x = col·h rounded once in f32, then its pieces
        uint32_t w[3][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          split3x2(__fmul_rn(sc, v[2 * k]), __fmul_rn(sc, v[2 * k + 1]), w[0][k], w[1][k],
                   w[2][k]);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          *reinterpret_cast<uint4*>(dst + pl * HS_STAGE) =
              make_uint4(w[pl][0], w[pl][1], w[pl][2], w[pl][3]);
      } else {
        uint4 o;
        o.x = bf2(sc * v[0], sc * v[1]);
        o.y = bf2(sc * v[2], sc * v[3]);
        o.z = bf2(sc * v[4], sc * v[5]);
        o.w = bf2(sc * v[6], sc * v[7]);
        *reinterpret_cast<uint4*>(dst) = o;
      }
    }
  };
  // the ldmatrix row of this lane: matrix m = lane / 8 (n-tile pair half
  // m / 2, k half m % 2), row q = lane % 8, at k step s add 4s
  const int lm = lane >> 3, lq = lane & 7;
  const int lrow = 16 * (lq >> 1) + 2 * (lm & 1) + (lq & 1);
  auto mma_chunk = [&](const unsigned char* As, const __nv_bfloat16* Hs) {
    if (mtw <= 0) return;
    uint32_t wd[MTM][2][4];
    uint32_t nz = 0;
#pragma unroll
    for (int mi = 0; mi < MTM; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (mi < mtw) {
          const int r = (m0 + mi) * 16 + g + 8 * hh;
          if constexpr (NIB) {
            const uint2 u = *reinterpret_cast<const uint2*>(As + r * CB + 8 * t);
            v = make_uint4(u.x, u.y, 0u, 0u);
          } else {
            v = *reinterpret_cast<const uint4*>(As + r * CB + 16 * t);
          }
        }
        wd[mi][hh][0] = v.x; wd[mi][hh][1] = v.y;
        wd[mi][hh][2] = v.z; wd[mi][hh][3] = v.w;
        nz |= v.x | v.y | v.z | v.w;
      }
    }
    if (!__any_sync(0xffffffffu, nz != 0u)) return;   // the warp's rows are zero here
    const uint32_t hbase = smem_u32(Hs);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t af[MTM][4];
#pragma unroll
      for (int mi = 0; mi < MTM; ++mi) {
        uint32_t x, y;
        if constexpr (NIB) {
          const int sh = 16 * (s & 1);
          x = nib_word((wd[mi][0][s >> 1] >> sh) & 0xFFFFu);
          y = nib_word((wd[mi][1][s >> 1] >> sh) & 0xFFFFu);
        } else {
          x = wd[mi][0][s];
          y = wd[mi][1][s];
        }
        a_frag(x, y, af[mi]);
      }
      const int w = lrow + 4 * s;
#pragma unroll
      for (int p = 0; p < NTM / 2; ++p) {
        if (2 * p < nn) {
          uint32_t bf[NPL][4];   // planes hi (, mid, lo)
          const uint32_t adr = hbase + 2 * (w * HP + 8 * ((2 * p + (lm >> 1)) ^ lq));
#pragma unroll
          for (int pl = 0; pl < NPL; ++pl) ldsm_x4_t(adr + 2 * pl * HS_STAGE, bf[pl]);
#pragma unroll
          for (int mi = 0; mi < MTM; ++mi) {
            if (mi < mtw) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float* c = acc[mi * NTM + 2 * p + e];
                if constexpr (PREC) {
                  // the k16 step's lo and mid products (each exact) into one
                  // zeroed partial, its hi products into another, then
                  // their f32 sum, rounded to nearest, into the accumulator
                  float u[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f};
                  mma_bf16(u, af[mi], bf[2][2 * e], bf[2][2 * e + 1]);
                  mma_bf16(v, af[mi], bf[0][2 * e], bf[0][2 * e + 1]);
                  mma_bf16(u, af[mi], bf[1][2 * e], bf[1][2 * e + 1]);
#pragma unroll
                  for (int k = 0; k < 4; ++k) c[k] += v[k] + u[k];
                } else {
                  mma_bf16(c, af[mi], bf[0][2 * e], bf[0][2 * e + 1]);
                }
              }
            }
          }
        }
      }
    }
  };

  // chunk c_lo + i: its base in ring stage i % NS, its window in hs stage
  // i % 2.  Copy groups: one a chunk (empty past the last), committed in
  // order, so waiting for all but the newest lands the older chunk.
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (k < nch) issue(c_lo + k, k);
    cp_async_commit();
  }
  if (DIAG != NOH) h_load(c_lo);   // in flight beside the base copies
  cp_async_wait<NS - 2>();
  int any_cur = __syncthreads_or(own_nz(0));
  if (any_cur && DIAG != NOH) h_store(0);
  for (int i = 0; i < nch; ++i) {
    const int c = c_lo + i;
    cp_async_wait<NS - 3>();   // this thread's copies of chunk c + 1 have landed
    // the barrier also publishes chunk c + 1's base and chunk c's window, and
    // ends every warp's reads of the stages that the next lines refill
    const int any_next = __syncthreads_or(i + 1 < nch ? own_nz((i + 1) % NS) : 0);
    if (i + NS - 1 < nch) issue(c + NS - 1, (i + NS - 1) % NS);
    cp_async_commit();
    if (any_next && DIAG != NOH) h_load(c + 1);   // in flight while chunk c multiplies
    if (any_cur && DIAG != NOH && DIAG != NODOT)
      mma_chunk(ring + (i % NS) * TR * CB, hs + (i & 1) * NPL * HS_STAGE);
    if (any_next && DIAG != NOH) h_store((i + 1) & 1);
    any_cur = any_next;
  }
  cp_async_wait<0>();   // the (empty) trailing groups
}

// K1 / K3: the mirror add (sub, or bf16(sub) in the bf16 modes, in f32), the
// row scale and the store, from the accumulators (row g and g + 8 of each
// m-tile, columns 2t, 2t + 1 of each n-tile)
template <bool HALO, int DIAG, bool PREC, typename T>
__device__ __forceinline__ void store_rows(const BandArgs<T>& a, const Tile& tl, int cg,
                                           const float (&acc)[MTM * NTM][4],
                                           const unsigned char* info) {
  const int S = a.S, D = a.D, b = tl.b;
  const int pad_n = a.nb * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = warp * tl.mt, mtw = max(0, min(tl.mt, tl.m16 - m0));
  const int nn = min(HP, 4 * a.DG - cg * HP) / 8;
  const bool pair = (D & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MTM; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = (m0 + mi) * 16 + g + 8 * hh, r = tl.tile0 + rl;
      if (mi >= mtw || r >= S) continue;
      const long long node = (long long)b * S + r;
      const int sl = a.C > 0 ? reinterpret_cast<const int*>(info)[rl] : -1;
      const float rs = reinterpret_cast<const float*>(info)[a.TR + rl];
      const float* sub = a.sub + ((long long)b * a.C + sl) * D;
      const T* wrow = a.h;   // nodot: the window row of row r − B and its scale
      const float* wsc = a.col;
      if constexpr (DIAG == NODOT) window_src<HALO, FULL>(a, b, r, pad_n, wrow, wsc);
#pragma unroll
      for (int j = 0; j < NTM; ++j) {
        const int d = cg * HP + 8 * j + 2 * t;
        if (j >= nn || d >= D) continue;
        float v[2] = {acc[mi * NTM + j][2 * hh], acc[mi * NTM + j][2 * hh + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (d + e >= D) continue;
          if constexpr (DIAG == NODOT) {   // the window value of row r − B
            const float x = *wsc * wrow[d + e];
            v[e] = PREC ? x : round_bf16(x);
          } else if (sl >= 0) {
            v[e] += PREC ? sub[d + e] : round_bf16(sub[d + e]);
          }
          if (DIAG != NOSCALE) v[e] *= rs;
        }
        T* o = a.out + node * D + d;
        if (pair && d + 1 < D) {
          if constexpr (std::is_same<T, float>::value)
            *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          st(o, v[0]);
          if (d + 1 < D) st(o + 1, v[1]);
        }
      }
    }
  }
}

__host__ __device__ inline int align128(int x) { return (x + 127) / 128 * 128; }
// bytes of the base ring (ns stages) and the window ring (two stages)
__host__ __device__ inline int staging_bytes(int TR, bool nib, int ns, bool prec) {
  return align128(ns * TR * (nib ? KB / 2 : KB) + 2 * planes(prec) * HS_STAGE * 2);
}
// the row information (slot, row scale) of the CTA's rows, [2][TR] 32-bit
__host__ __device__ inline int info_bytes(int TR) { return align128(8 * TR); }

// The slot and row scale of the CTA's TR rows into shared memory info by
// cp.async, one group (zeros past S; the slots are read only when C > 0), so
// that the epilogue finds them there
template <typename T>
__device__ __forceinline__ void issue_info(const BandArgs<T>& a, const Tile& tl,
                                           unsigned char* info) {
  for (int rl = threadIdx.x; rl < a.TR; rl += NT) {
    const int r = tl.tile0 + rl;
    const bool in = r < a.S;
    const long long node = in ? (long long)tl.b * a.S + r : 0;
    cp_async(info + 4 * rl, a.slot + node, 4, in && a.C > 0 ? 4 : 0);
    cp_async(info + 4 * (a.TR + rl), a.row + node, 4, in ? 4 : 0);
  }
  cp_async_commit();
}

// K2's shared memory plan (bytes) for TR rows
struct SageSmem {
  int staging, pool, w, part, info, total;
};
template <bool NIB, bool EPI, bool PREC>
__host__ __device__ inline SageSmem sage_smem(int TR, int DP) {
  SageSmem m;
  m.staging = staging_bytes(TR, NIB, NS_K2, PREC);
  const int ncg = (DP + HP - 1) / HP;
  const int AP = (2 * DP + 63) / 64 * 64, WP = (DP + 63) / 64 * 64;
  const int pool = align128(EPI ? TR * AP * 2 : DP * (TR + 4) * 4);
  // one column group: the pooled block reuses the staging ring
  m.pool = ncg == 1 ? 0 : m.staging;
  const int region = ncg == 1 ? (m.staging > pool ? m.staging : pool) : m.staging + pool;
  m.w = region;
  const int wbytes = align128(EPI ? 2 * DP * WP * 2 : 2 * DP * DP * 4);
  // the f32 epilogue's row sums reuse the weights' space once the FMAs end
  const int pbytes = EPI ? 0 : TR * (DP / 8) * 4;
  m.part = region;
  m.info = region + (wbytes > pbytes ? wbytes : pbytes);
  m.total = m.info + info_bytes(TR);
  return m;
}

// K2 after the contraction of column group cg: the pooled block (mirror
// add as in store_rows, row scale) into shared memory, transposed f32
// [DP][TR + 4] for the f32 epilogue, bf16 [TR][AP] (swizzled) for the bf16
// one
template <bool EPI, bool PREC, typename T>
__device__ __forceinline__ void pool_rows(const BandArgs<T>& a, const Tile& tl, int cg,
                                          const float (&acc)[MTM * NTM][4],
                                          unsigned char* pool, const unsigned char* info) {
  const int S = a.S, D = a.D, DP = 4 * a.DG, TR = a.TR, b = tl.b;
  const int AP = (2 * DP + 63) / 64 * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = warp * tl.mt, mtw = max(0, min(tl.mt, tl.m16 - m0));
  const int nn = min(HP, DP - cg * HP) / 8;
#pragma unroll
  for (int mi = 0; mi < MTM; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = (m0 + mi) * 16 + g + 8 * hh, r = tl.tile0 + rl;
      if (mi >= mtw) continue;
      const bool rv = r < S;
      const long long node = (long long)b * S + r;
      const int sl = (rv && a.C > 0) ? reinterpret_cast<const int*>(info)[rl] : -1;
      const float rs = rv ? reinterpret_cast<const float*>(info)[TR + rl] : 0.f;
#pragma unroll
      for (int j = 0; j < NTM; ++j) {
        if (j >= nn) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = cg * HP + 8 * j + 2 * t + e;
          float v = 0.f;
          if (rv && d < D) {
            v = acc[mi * NTM + j][2 * hh + e];
            if (sl >= 0) {
              const float sv = a.sub[((long long)b * a.C + sl) * D + d];
              v += PREC ? sv : round_bf16(sv);
            }
            v *= rs;
          }
          if constexpr (EPI) {
            __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(pool);
            const int kc = d >> 3;
            A[rl * AP + 8 * ((kc & ~7) | ((kc ^ rl) & 7)) + (d & 7)] = __float2bfloat16_rn(v);
          } else {
            reinterpret_cast<float*>(pool)[d * (TR + 4) + rl] = v;
          }
        }
      }
    }
  }
}

// K2: the unscaled h of the CTA's rows, 8 columns an item, four items a
// thread in flight: put(rl, d, v) for every row rl < TR and column d < DP
// (zeros past S and D)
template <typename T, typename Put>
__device__ __forceinline__ void own_rows(const BandArgs<T>& a, const Tile& tl, Put put) {
  const int S = a.S, D = a.D, DP = 4 * a.DG, TR = a.TR, QN = DP / 8;
  for (int i0 = threadIdx.x; i0 < TR * QN; i0 += 4 * NT) {
    uint4 r[4][2];
    uint32_t m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int item = i0 + u * NT, rl = item / QN, q = item - rl * QN;
      const bool in = item < TR * QN && tl.tile0 + rl < S;
      m[u] = load8(in ? a.h + ((long long)tl.b * S + tl.tile0 + rl) * D : a.h, in ? 8 * q : 0,
                   D, a.vec, r[u]);
      if (!in) m[u] = 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int item = i0 + u * NT, rl = item / QN, q = item - rl * QN;
      if (item >= TR * QN) continue;
      float v[8];
      unpack8(r[u], m[u], v, T());
#pragma unroll
      for (int k = 0; k < 8; ++k) put(rl, 8 * q + k, v[k]);
    }
  }
}

// K2's f32 epilogue: z = relu(pool @ A_w + h_own @ B_w) on FP32 FMAs, a
// thread an 8-row × 8-column tile (pool terms k = 0..D-1, then h_own's),
// h' = z · rsqrt(Σz²) (part: the tiles' row sums, added in column order)
template <typename T>
__device__ __forceinline__ void sage_epi_f32(const BandArgs<T>& a, const Tile& tl,
                                             float* pool, const float* W, float* part) {
  const int S = a.S, D = a.D, DP = 4 * a.DG, TR = a.TR, LDT = TR + 4;
  const int tid = threadIdx.x, CGN = DP / 8, RGN = NT / CGN;
  const int cgi = tid % CGN, rgi = tid / CGN;
  const bool act = rgi < RGN && 8 * rgi < TR;
  float z[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) z[i][j] = 0.f;
  for (int half = 0; half < 2; ++half) {
    if (half == 1) {   // h_own over the pooled block, transposed
      __syncthreads();
      own_rows(a, tl, [&](int rl, int d, float v) { pool[d * LDT + rl] = v; });
      __syncthreads();
    }
    const float* Wh = W + half * DP * DP;
    if (act) {
#pragma unroll 2
      for (int k = 0; k < D; ++k) {
        const float4 p0 = *reinterpret_cast<const float4*>(pool + k * LDT + 8 * rgi);
        const float4 p1 = *reinterpret_cast<const float4*>(pool + k * LDT + 8 * rgi + 4);
        const float4 w0 = *reinterpret_cast<const float4*>(Wh + k * DP + 8 * cgi);
        const float4 w1 = *reinterpret_cast<const float4*>(Wh + k * DP + 8 * cgi + 4);
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) z[i][j] = fmaf(pv[i], wv[j], z[i][j]);
      }
    }
  }
  __syncthreads();   // part reuses W's space
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      z[i][j] = fmaxf(z[i][j], 0.f);
      sq = fmaf(z[i][j], z[i][j], sq);   // columns >= D hold exact zeros
    }
    if (act) part[(8 * rgi + i) * CGN + cgi] = sq;
  }
  __syncthreads();
  if (!act) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tl.tile0 + 8 * rgi + i;
    if (r >= S) continue;
    float tot = 0.f;
    for (int q = 0; q < CGN; ++q) tot += part[(8 * rgi + i) * CGN + q];
    const float scale = 1.f / sqrtf(fmaxf(tot, 1e-24f));
    T* o = a.out + ((long long)tl.b * S + r) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * cgi + j;
      if (d < D) st(o + d, z[i][j] * scale);
    }
  }
}

// K2's bf16 epilogue: z = [bf16(pool) | bf16(h_own)] @ [bf16(A_w); bf16(B_w)]
// on the tensor cores (f32 sums), a warp its m-tiles × NTD n-tiles; relu,
// Σz² over the row (the warp holds all of it) and the scale in f32
template <int NTD, typename T>
__device__ __forceinline__ void sage_epi_mma(const BandArgs<T>& a, const Tile& tl,
                                             const __nv_bfloat16* A, const __nv_bfloat16* W,
                                             float (&acc)[MTM * NTM][4]) {
  constexpr int MT = NTD > NTM ? 1 : MTM;   // m-tiles a warp at most
  const int S = a.S, D = a.D, DP = 4 * a.DG;
  const int AP = (2 * DP + 63) / 64 * 64, WP = (DP + 63) / 64 * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = warp * tl.mt, mtw = max(0, min(tl.mt, tl.m16 - m0));
  const int nt = DP / 8;
  if (mtw <= 0) return;
#pragma unroll
  for (int i = 0; i < MTM * NTM; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  const uint32_t abase = smem_u32(A), wbase = smem_u32(W);
  const int lm = lane >> 3, lq = lane & 7;
  for (int k0 = 0; k0 < 2 * DP; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (mi < mtw) {
        const int rl = (m0 + mi) * 16 + (lane & 15), kc = (k0 >> 3) + (lane >> 4);
        ldsm_x4(abase + 2 * (rl * AP + 8 * ((kc & ~7) | ((kc ^ rl) & 7))), af[mi]);
      }
    }
    const int kr = k0 + 8 * (lm & 1) + lq;
#pragma unroll
    for (int p = 0; p < NTD / 2; ++p) {
      if (2 * p < nt) {
        const int nc = 2 * p + (lm >> 1);
        uint32_t bf[4];
        ldsm_x4_t(wbase + 2 * (kr * WP + 8 * ((nc & ~7) | ((nc ^ kr) & 7))), bf);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (mi < mtw) {
            mma_bf16(acc[mi * NTD + 2 * p], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi * NTD + 2 * p + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < NTD; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = fmaxf(acc[mi * NTD + j][2 * hh + e], 0.f);
          acc[mi * NTD + j][2 * hh + e] = z;
          sq = fmaf(z, z, sq);   // columns >= D hold exact zeros
        }
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      const int r = tl.tile0 + (m0 + mi) * 16 + g + 8 * hh;
      if (mi >= mtw || r >= S) continue;
      const float scale = 1.f / sqrtf(fmaxf(sq, 1e-24f));
      T* o = a.out + ((long long)tl.b * S + r) * D;
#pragma unroll
      for (int j = 0; j < NTD; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * j + 2 * t + e;
          if (j < nt && d < D) st(o + d, acc[mi * NTD + j][2 * hh + e] * scale);
        }
      }
    }
  }
}

// K1, K2 and K3 in every mode.  T: storage of h and out (float or
// __nv_bfloat16); PREC: the precise (f32 operand) mode, else the bf16 mode.
// Grid (row tiles of TR, blocks, column groups of HP; K2 one group a CTA,
// all of them in turn).
template <bool SAGE, bool HALO, typename T, bool NIB, bool EPI, int DIAG, bool PREC>
__global__ void __launch_bounds__(NT, 2) band_mma_kernel(BandArgs<T> a) {
  static_assert(!PREC || std::is_same<T, float>::value, "the precise mode stores f32");
  static_assert(!(SAGE && HALO), "K2 has no halo mode");
  static_assert(SAGE || !EPI, "the bf16 epilogue is K2's");
  static_assert(DIAG == FULL || !(SAGE || HALO || NIB), "diag variants are K1's");
  extern __shared__ __align__(128) unsigned char smem[];
  Tile tl;
  tl.b = a.b0 + blockIdx.y;
  tl.tile0 = blockIdx.x * a.TR;
  tl.m16 = a.TR / 16;
  tl.mt = (tl.m16 + NW - 1) / NW;
  float acc[MTM * NTM][4];
  if constexpr (!SAGE) {
    unsigned char* info = smem + staging_bytes(a.TR, NIB, ns_k1(PREC), PREC);
    issue_info(a, tl, info);
    contract<ns_k1(PREC), HALO, NIB, DIAG, PREC>(a, smem, tl, blockIdx.z, acc);
    store_rows<HALO, DIAG, PREC>(a, tl, blockIdx.z, acc, info);
  } else {
    const int S = a.S, D = a.D, DP = 4 * a.DG, TR = a.TR, tid = threadIdx.x;
    const SageSmem m = sage_smem<NIB, EPI, PREC>(TR, DP);
    unsigned char* pool = smem + m.pool;
    // A_w and B_w once a CTA, [2·DP][DP] f32 (by cp.async, landing while
    // the first chunks' copies do) or [2·DP][WP] bf16, swizzled
    if constexpr (EPI) {
      const int WP = (DP + 63) / 64 * 64;
      __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem + m.w);
      for (int e0 = tid; e0 < 2 * DP * DP; e0 += 16 * NT) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int e = e0 + u * NT, k = e / DP, c = e - k * DP, kk = k < DP ? k : k - DP;
          v[u] = (e < 2 * DP * DP && kk < D && c < D) ? (k < DP ? a.aw : a.bw)[kk * D + c] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int e = e0 + u * NT, k = e / DP, c = e - k * DP, nc = c >> 3;
          if (e < 2 * DP * DP)
            W[k * WP + 8 * ((nc & ~7) | ((nc ^ k) & 7)) + (c & 7)] = __float2bfloat16_rn(v[u]);
        }
      }
    } else {
      float* W = reinterpret_cast<float*>(smem + m.w);
      const bool v4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(a.aw) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.bw) % 16 == 0;
      const int gw = v4 ? 4 : 1;   // floats a copy
      for (int e = tid; e < 2 * DP * DP / gw; e += NT) {
        const int k = e * gw / DP, c = e * gw - k * DP, kk = k < DP ? k : k - DP;
        const bool in = kk < D && c < D;
        const float* src = in ? (k < DP ? a.aw : a.bw) + kk * D + c : a.aw;
        cp_async(W + e * gw, src, 4 * gw, in ? 4 * gw : 0);
      }
      cp_async_commit();
    }
    issue_info(a, tl, smem + m.info);
    const int ncg = (DP + HP - 1) / HP;
    for (int cg = 0; cg < ncg; ++cg) {
      __syncthreads();   // the ring is free (the previous group's reads)
      contract<NS_K2, false, NIB, FULL, PREC>(a, smem, tl, cg, acc);
      __syncthreads();   // the pooled block may reuse the ring
      pool_rows<EPI, PREC>(a, tl, cg, acc, pool, smem + m.info);
    }
    if constexpr (EPI) {   // bf16(h_own) beside the pooled block
      const int AP = (2 * DP + 63) / 64 * 64;
      __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(pool);
      own_rows(a, tl, [&](int rl, int d, float v) {
        const int k = DP + d, kc = k >> 3;
        A[rl * AP + 8 * ((kc & ~7) | ((kc ^ rl) & 7)) + (k & 7)] = __float2bfloat16_rn(v);
      });
      __syncthreads();
      const __nv_bfloat16* W = reinterpret_cast<const __nv_bfloat16*>(smem + m.w);
      if (DP <= HP)
        sage_epi_mma<NTM>(a, tl, A, W, acc);
      else
        sage_epi_mma<2 * NTM>(a, tl, A, W, acc);
    } else {
      __syncthreads();
      sage_epi_f32(a, tl, reinterpret_cast<float*>(pool),
                   reinterpret_cast<const float*>(smem + m.w),
                   reinterpret_cast<float*>(smem + m.part));
    }
  }
}


// ---------------------------------------------------------------- launchers

__host__ inline bool shape_ok(int D, int nb, int b0, int b1, int S, int B, int C, bool nib) {
  return !(D < 1 || nb < 1 || b0 < 0 || b1 <= b0 || b1 > nb || b1 - b0 > 65535 ||
           S < 1 || B < 0 || B > S || C < 0 || (S + 2 * B) % (nib ? 8 : 4) != 0);
}

// Launches blocks [a.b0, b1) of a.nb at tr rows a CTA (a multiple of 16 up
// to 256: ops/band_kernels.rows_per_cta).  K2 lowers it until its shared
// memory fits, in the precise mode until two CTAs share an SM: its window
// ring of three planes takes a 256-row CTA to ~130 KB at D = 64, and two
// 128-row CTAs an SM timed faster than one of 256 rows
template <bool SAGE, bool HALO, typename T, bool NIB, bool EPI, int DIAG, bool PREC>
int launch(BandArgs<T> a, int b1, int tr, cudaStream_t stream) {
  if (!shape_ok(a.D, a.nb, a.b0, b1, a.S, a.B, a.C, NIB) || a.D > 256 || tr < 16 ||
      tr % 16 != 0 || tr > 256)
    return (int)cudaErrorInvalidValue;
  const int DP = (a.D + 15) / 16 * 16;
  a.DG = DP / 4;
  int TR = (a.S + 15) / 16 * 16;
  if (TR > tr) TR = tr;
  size_t shm;
  if constexpr (SAGE) {
    if (DP > 2 * HP) return (int)cudaErrorInvalidValue;
    // the f32 epilogue's 8-row tiles, the bf16 one's m-tiles a warp
    const int cap = EPI ? (DP > HP ? 16 * NW : 2 * 16 * NW) : 8 * (NT / (DP / 8));
    const int budget = PREC ? SMEM_HALF : SMEM_MAX;
    while (TR > 16 && (TR > cap || sage_smem<NIB, EPI, PREC>(TR, DP).total > budget))
      TR = (TR / 2 + 15) / 16 * 16;
    shm = sage_smem<NIB, EPI, PREC>(TR, DP).total;
  } else {
    shm = staging_bytes(TR, NIB, ns_k1(PREC), PREC) + info_bytes(TR);
  }
  if (shm > SMEM_MAX) return (int)cudaErrorInvalidValue;
  a.TR = TR;
  // base copies of 16 bytes where the row pitch and the pointer allow
  const int pitch = NIB ? (a.S + 2 * a.B) / 2 : a.S + 2 * a.B;
  a.G = 16;
  while (a.G > 4 && (pitch % a.G != 0 || reinterpret_cast<uintptr_t>(a.base) % a.G != 0))
    a.G /= 2;
  if (pitch % 4 != 0 || reinterpret_cast<uintptr_t>(a.base) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.vec = a.D % (int)(16 / sizeof(T)) == 0 && al16(a.h) && (a.lh == nullptr || al16(a.lh)) &&
          (a.rh == nullptr || al16(a.rh));
  void (*kern)(BandArgs<T>) = band_mma_kernel<SAGE, HALO, T, NIB, EPI, DIAG, PREC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + TR - 1) / TR, b1 - a.b0, SAGE ? 1 : (DP + HP - 1) / HP);
  kern<<<grid, NT, shm, stream>>>(a);
  return (int)cudaGetLastError();
}

// the runtime flags to the template parameters: nib (nibble storage) in
// every mode, epi (K2's bf16 epilogue) only with sage, diag (K1's timing
// variants, f32 storage) only for K1.  A K3 launch whose blocks never reach
// a halo (1 <= b0, b1 <= nb − 1) runs K1's instantiation: j stays in
// [0, local_n)
template <bool SAGE, bool HALO, typename T, bool PREC>
int dispatch(BandArgs<T> a, int b1, int nib, int epi, int diag, int tr, cudaStream_t stream) {
  if constexpr (SAGE) {
    if (diag) return (int)cudaErrorInvalidValue;
    if (nib)
      return epi ? launch<true, false, T, true, true, FULL, PREC>(a, b1, tr, stream)
                 : launch<true, false, T, true, false, FULL, PREC>(a, b1, tr, stream);
    return epi ? launch<true, false, T, false, true, FULL, PREC>(a, b1, tr, stream)
               : launch<true, false, T, false, false, FULL, PREC>(a, b1, tr, stream);
  } else {
    if (epi) return (int)cudaErrorInvalidValue;
    if (diag) {
      if constexpr (!HALO && std::is_same<T, float>::value) {
        if (nib) return (int)cudaErrorInvalidValue;
        switch (diag) {
          case NOSCALE: return launch<false, false, T, false, false, NOSCALE, PREC>(a, b1, tr, stream);
          case NODOT: return launch<false, false, T, false, false, NODOT, PREC>(a, b1, tr, stream);
          case NOH: return launch<false, false, T, false, false, NOH, PREC>(a, b1, tr, stream);
          case HLIN: return launch<false, false, T, false, false, HLIN, PREC>(a, b1, tr, stream);
        }
      }
      return (int)cudaErrorInvalidValue;
    }
    if (HALO && a.b0 >= 1 && b1 <= a.nb - 1)
      return nib ? launch<false, false, T, true, false, FULL, PREC>(a, b1, tr, stream)
                 : launch<false, false, T, false, false, FULL, PREC>(a, b1, tr, stream);
    return nib ? launch<false, HALO, T, true, false, FULL, PREC>(a, b1, tr, stream)
               : launch<false, HALO, T, false, false, FULL, PREC>(a, b1, tr, stream);
  }
}

// K1 (sage = false) or K2 over all nb blocks
template <typename T, bool PREC>
int run_band(bool sage, const int8_t* base, const void* h, const float* row,
             const float* col, const float* sub, const int32_t* slot, const float* aw,
             const float* bw, void* out, int nb, int S, int B, int C, int D, int nib,
             int epi, int diag, int tr, int geo, cudaStream_t stream) {
  BandArgs<T> a{base, static_cast<const T*>(h), row, col, sub, slot, aw, bw,
                static_cast<T*>(out), nb, S, B, C, D, 0, 0};
  a.geo = geo;
  return sage ? dispatch<true, false, T, PREC>(a, nb, nib, epi, diag, tr, stream)
              : dispatch<false, false, T, PREC>(a, nb, nib, epi, diag, tr, stream);
}

// K3 over blocks [b0, b1) of a shard
template <typename T, bool PREC>
int run_halo(const int8_t* base, const void* h, const void* lh, const void* rh,
             const float* row, const float* col, const float* lc, const float* rc,
             const float* sub, const int32_t* slot, void* out, int nb, int S, int B, int C,
             int D, int b0, int b1, int nib, int tr, int geo, cudaStream_t stream) {
  BandArgs<T> a{base, static_cast<const T*>(h), row, col, sub, slot, nullptr,
                nullptr, static_cast<T*>(out), nb, S, B, C, D, 0, 0,
                static_cast<const T*>(lh), static_cast<const T*>(rh), lc, rc, b0};
  a.geo = geo;
  return dispatch<false, true, T, PREC>(a, b1, nib, 0, 0, tr, stream);
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// Every entry point returns the cudaError_t of the launch (0 = launched).
// nib = 1: the base is nibble storage [nb, S+C, W2/2].  diag: 0 (the
// operator) or a K1 timing variant (1 noscale, 2 nodot, 3 noh, 4 hlin).
// epi_bf16 = 1: K2's bf16 epilogue (f32_epi=False).  tr: the rows a CTA (a
// multiple of 16, at most 256); geo = 1 when the graph's ring has three or
// more blocks (the window-reach skip).  D <= 256 (K2: 128).  The unsuffixed
// entry points are the precise mode (h, out f32); the _bf16 ones the bf16
// mode, h and out f32 (bf16_act = 0) or bf16 (1).

// K1.
int mdc_band_spmm(const int8_t* base, const float* h, const float* row,
                  const float* col, const float* sub, const int32_t* slot,
                  float* out, int nb, int S, int B, int C, int D, int nib,
                  int diag, int tr, int geo, void* stream) {
  return run_band<float, true>(false, base, h, row, col, sub, slot, nullptr, nullptr, out,
                               nb, S, B, C, D, nib, 0, diag, tr, geo, (cudaStream_t)stream);
}

// K2.  aw, bw: f32 [D, D].
int mdc_band_sage(const int8_t* base, const float* h, const float* row,
                  const float* col, const float* sub, const int32_t* slot,
                  const float* aw, const float* bw, float* out, int nb,
                  int S, int B, int C, int D, int nib, int epi_bf16, int tr, int geo,
                  void* stream) {
  return run_band<float, true>(true, base, h, row, col, sub, slot, aw, bw, out, nb, S, B,
                               C, D, nib, epi_bf16, 0, tr, geo, (cudaStream_t)stream);
}

int mdc_band_spmm_bf16(const int8_t* base, const void* h, const float* row,
                       const float* col, const float* sub, const int32_t* slot,
                       void* out, int nb, int S, int B, int C, int D,
                       int bf16_act, int nib, int diag, int tr, int geo, void* stream) {
  auto run = bf16_act ? &run_band<bf16, false> : &run_band<float, false>;
  return run(false, base, h, row, col, sub, slot, nullptr, nullptr, out, nb, S, B, C, D,
             nib, 0, diag, tr, geo, (cudaStream_t)stream);
}

int mdc_band_sage_bf16(const int8_t* base, const void* h, const float* row,
                       const float* col, const float* sub, const int32_t* slot,
                       const float* aw, const float* bw, void* out, int nb,
                       int S, int B, int C, int D, int bf16_act, int nib,
                       int epi_bf16, int tr, int geo, void* stream) {
  auto run = bf16_act ? &run_band<bf16, false> : &run_band<float, false>;
  return run(true, base, h, row, col, sub, slot, aw, bw, out, nb, S, B, C, D, nib,
             epi_bf16, 0, tr, geo, (cudaStream_t)stream);
}

// K3: blocks [b0, b1) of one shard of nb blocks.  h, out: [nb·S, D];
// lh, rh: [B, D] (null when no block of the range reads them: 1 <= b0,
// b1 <= nb − 1); lc, rc: [B] likewise; row, col, slot: [nb·S];
// sub: [nb·C, D].
int mdc_band_spmm_halo(const int8_t* base, const float* h, const float* lh,
                       const float* rh, const float* row, const float* col,
                       const float* lc, const float* rc, const float* sub,
                       const int32_t* slot, float* out, int nb, int S, int B,
                       int C, int D, int b0, int b1, int nib, int tr, int geo,
                       void* stream) {
  return run_halo<float, true>(base, h, lh, rh, row, col, lc, rc, sub, slot, out, nb, S, B,
                               C, D, b0, b1, nib, tr, geo, (cudaStream_t)stream);
}

int mdc_band_spmm_halo_bf16(const int8_t* base, const void* h, const void* lh,
                            const void* rh, const float* row, const float* col,
                            const float* lc, const float* rc, const float* sub,
                            const int32_t* slot, void* out, int nb, int S, int B,
                            int C, int D, int b0, int b1, int bf16_act, int nib,
                            int tr, int geo, void* stream) {
  auto run = bf16_act ? &run_halo<bf16, false> : &run_halo<float, false>;
  return run(base, h, lh, rh, row, col, lc, rc, sub, slot, out, nb, S, B, C, D, b0, b1, nib,
             tr, geo, (cudaStream_t)stream);
}

}  // extern "C"
