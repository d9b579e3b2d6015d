// Band-operator kernels for Hopper (sm_90a), plain C ABI, loaded with ctypes
// by ops/band_kernels.py.
//
// K1  mdc_band_spmm : out = row ⊙ (A_band @ (col ⊙ h) + Gᵀ·sub)
// K2  mdc_band_sage : h' = l2n(relu(out_K1 @ A_w + h @ B_w))
// K3  mdc_band_spmm_halo : K1 on one shard of a gp mesh, its windows linear
//     over [left halo | local rows | right halo]
// and their bf16 modes mdc_band_spmm_bf16, mdc_band_sage_bf16 and
// mdc_band_spmm_halo_bf16.
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
// K3 replaces the same kernel's halo=True mode (band_pallas.py:274-278,
// 394-478), the local engine of the gp-sharded band operator
// (parallel/band_partition.py:189-291).  It is band_kernel with HALO set: a
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
// flops (6.9e10 at 2^20 nodes, D=64): ~1 ms at the 67 TFLOP/s of FP32 FMA
// against ~0.17 ms for the bytes, so a dense kernel is bound by operations.
// Tensor cores are no way out for the precise eval: TF32 rounds h to ~10
// bits, the kind of rounding that cost the JAX package 0.035 AUDC.  The
// bf16 modes have accepted that rounding, and there the same dense product
// runs on the bf16 tensor cores (989 TFLOP/s: ~0.07 ms at 2^20), under the
// bytes.
//
// What the simple design does about it.  Precise mode: every multiply-add is
// an FP32 FFMA from registers: a thread owns a 4-row × 4-column register
// tile of the output, and each step of the window loop reads one float4 of
// the base tile and one float4 of the h tile from shared memory for 16
// FFMAs.  bf16 modes: the staged chunks are bf16 (the int8 band widened
// exactly; the window as col ⊙ h formed in f32 from the stored h and rounded
// to nearest even, as XLA's astype(bfloat16)), and each warp multiplies
// 16×16×16 bf16 fragments on the tensor cores (nvcuda::wmma, f32
// accumulators); at the end the accumulators go through shared memory into
// the same 4×4 register tiles, so both modes share the epilogue.  The int8
// base is widened once, while it is staged (KC=64 window columns at a time,
// four columns per 32-bit load), not once per FMA.  All NT threads stage,
// also when fewer own an output tile (D=2: 64 of 256), because staging, not
// the FMAs, is what a narrow D waits on.  A chunk whose staged base tile is
// all zero (most of them: a row's neighbours sit in one or two chunks of
// the window) skips its h staging and its multiplies, so the operations
// follow the band's fill rather than its dense size.  The window is staged
// col-scaled, so the row scale, the mirror add (bf16(sub) in the bf16
// modes, added in f32: the one-hot expansion is exact) and (K2) the dense
// layer and normalisation are f32 epilogues on the tile; a bf16 store
// rounds to nearest even.  Sums run in a fixed order (window position, then
// k of the epilogue dots), so results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KC = 64;    // window columns staged per step
constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;
constexpr int LDA = KC + 8;   // bf16 modes: staged band row pitch (elements)

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
  int TR;            // destination rows per block (multiple of 4; of 16 in
                     // the bf16 modes)
  int DG;            // column groups of 4: ceil(D / 4) (bf16 modes: of 16)
  const T* lh;       // K3 only: [B, D] left halo (the left shard's tail)
  const T* rh;       // K3 only: [B, D] right halo (the right shard's head)
  const float* lc;   // K3 only: [B] col scales of lh
  const float* rc;   // K3 only: [B] col scales of rh
  int b0;            // first block of the launch (grid y = blocks b0, b0+1, ...)
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// col ⊙ h at window row j = b·S − B + w of block b: K1 wraps it (mod
// pad_n; |j − wrap| < pad_n because B <= S), K3 reads it from the halos
// past either end of the shard
template <bool HALO, typename T>
__device__ __forceinline__ float window_val(const BandArgs<T>& a, int b, int w, int d,
                                            int pad_n) {
  int j = b * a.S - a.B + w;
  if constexpr (HALO) {
    if (j < 0) return a.lc[j + a.B] * ld(a.lh + (long long)(j + a.B) * a.D + d);
    if (j >= pad_n) return a.rc[j - pad_n] * ld(a.rh + (long long)(j - pad_n) * a.D + d);
  } else {
    if (j < 0) j += pad_n;
    if (j >= pad_n) j -= pad_n;
  }
  return a.col[j] * ld(a.h + (long long)j * a.D + d);
}

// bf16 modes: acc[i][j] (rows 4·rg+i, columns 4·dg+j of the tile) =
// bf16(A_band) @ bf16(col ⊙ h) on the tensor cores, f32 accumulation.
template <bool HALO, typename T>
__device__ __forceinline__ void contract_bf16(const BandArgs<T>& a,
                                              unsigned char* smem,
                                              float (&acc)[4][4]) {
  using namespace nvcuda;
  const int TR = a.TR, DP = 4 * a.DG, D = a.D, S = a.S, B = a.B;
  const int W2 = S + 2 * B, LDB = DP + 8;
  const int b = a.b0 + blockIdx.y, tile0 = blockIdx.x * TR;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid / 32;
  const int pad_n = a.nb * S;
  const int nfc = DP / 16, ntile = (TR / 16) * nfc;   // ntile <= 2·NW
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [TR][LDA]
  __nv_bfloat16* bs = as + TR * LDA;                            // [KC][LDB]
  const int8_t* base_blk = a.base + (long long)b * (S + a.C) * W2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[2];
  wmma::fill_fragment(fc[0], 0.f);
  wmma::fill_fragment(fc[1], 0.f);

  for (int w0 = 0; w0 < W2; w0 += KC) {
    int nz = 0;
    // 4 window columns per 32-bit load; 16 consecutive threads read one
    // row's 64 bytes.  int8 -> bf16 is exact.
    for (int e = tid; e < TR * (KC / 4); e += nthr) {
      const int q = e % (KC / 4), r = e / (KC / 4);
      const int w = w0 + 4 * q;
      uint32_t word = 0;
      if (w < W2 && tile0 + r < S)
        word = *reinterpret_cast<const uint32_t*>(
            base_blk + (long long)(tile0 + r) * W2 + w);
      nz |= word != 0u;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(as + r * LDA + 4 * q);
      dst[0] = __floats2bfloat162_rn((float)(int8_t)word, (float)(int8_t)(word >> 8));
      dst[1] = __floats2bfloat162_rn((float)(int8_t)(word >> 16),
                                     (float)(int8_t)(word >> 24));
    }
    // all-zero base chunk: nothing to add (the barrier also orders the
    // previous chunk's fragment loads before this chunk's writes)
    if (!__syncthreads_or(nz)) continue;
    for (int e = tid; e < KC * DP; e += nthr) {
      const int k = e / DP, d = e - k * DP;
      float v = 0.f;
      if (w0 + k < W2 && d < D) v = window_val<HALO>(a, b, w0 + k, d, pad_n);
      bs[k * LDB + d] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = warp + NW * t;
      if (tile < ntile) {
        const int rt = tile / nfc, ct = tile - rt * nfc;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, as + rt * 16 * LDA + kk, LDA);
          wmma::load_matrix_sync(fb, bs + kk * LDB + ct * 16, LDB);
          wmma::mma_sync(fc[t], fa, fb, fc[t]);
        }
      }
    }
    __syncthreads();
  }

  // accumulators -> shared [TR][DP] -> each owner's 4×4 register tile
  float* accs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int tile = warp + NW * t;
    if (tile < ntile) {
      const int rt = tile / nfc, ct = tile - rt * nfc;
      wmma::store_matrix_sync(accs + rt * 16 * DP + ct * 16, fc[t], DP,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  const int dg = tid % a.DG, rg = tid / a.DG;
  if (tid < a.DG * (TR / 4)) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = accs[(4 * rg + i) * DP + 4 * dg + j];
  }
}

// BF: bf16 operands (precise=False).  HALO: K3's linear windows over the
// halos.  T: storage of h and out (float, or __nv_bfloat16 with BF).
template <bool SAGE, bool BF, bool HALO, typename T>
__global__ void __launch_bounds__(NT) band_kernel(BandArgs<T> a) {
  static_assert(BF || std::is_same<T, float>::value, "bf16 storage needs BF");
  static_assert(!(SAGE && HALO), "K2 has no halo mode");
  extern __shared__ __align__(128) unsigned char smem[];
  const int TR = a.TR, DG = a.DG, DP = 4 * DG, D = a.D, S = a.S, B = a.B;
  const int W2 = S + 2 * B;
  const int b = a.b0 + blockIdx.y;
  const int tile0 = blockIdx.x * TR;   // first local row of this tile
  const int tid = threadIdx.x, nthr = blockDim.x;
  // threads tid < DG·TR/4 own a 4×4 output tile; all of them stage
  const bool owner = tid < DG * (TR / 4);
  const int dg = tid % DG, rg = tid / DG;
  const int pad_n = a.nb * S;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if constexpr (BF) {
    contract_bf16<HALO>(a, smem, acc);
  } else {
    float* bs = reinterpret_cast<float*>(smem);   // [KC][TR] base, transposed
    float* hs = bs + KC * TR;                     // [KC][DP] col ⊙ h window
    const int8_t* base_blk = a.base + (long long)b * (S + a.C) * W2;
    for (int w0 = 0; w0 < W2; w0 += KC) {
      int nz = 0;
      // 4 window columns per 32-bit load (W2 and w0 are multiples of 4);
      // consecutive threads take consecutive rows, so the shared stores of
      // a warp hit 32 banks
      for (int e = tid; e < TR * (KC / 4); e += nthr) {
        const int r = e % TR, q = e / TR;
        const int w = w0 + 4 * q;
        uint32_t word = 0;
        if (w < W2 && tile0 + r < S)
          word = *reinterpret_cast<const uint32_t*>(
              base_blk + (long long)(tile0 + r) * W2 + w);
        nz |= word != 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          bs[(4 * q + t) * TR + r] = (float)(int8_t)(word >> (8 * t));
      }
      // all-zero base chunk: nothing to add (the barrier also orders the
      // previous chunk's reads of hs before this chunk's writes)
      if (!__syncthreads_or(nz)) continue;
      for (int e = tid; e < KC * DP; e += nthr) {
        const int k = e / DP, d = e - k * DP;
        float v = 0.f;
        if (w0 + k < W2 && d < D) v = window_val<HALO>(a, b, w0 + k, d, pad_n);
        hs[k * DP + d] = v;
      }
      __syncthreads();
      if (owner) {
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(bs + k * TR + 4 * rg);
          const float4 hv = *reinterpret_cast<const float4*>(hs + k * DP + 4 * dg);
          const float bf[4] = {bv.x, bv.y, bv.z, bv.w};
          const float hf[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bf[i], hf[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // mirror expansion (+ sub[slot]) before the row scale, as the TPU kernel;
  // the bf16 modes add bf16(sub), as the TPU kernel's bf16 one-hot dot
  float* pool = reinterpret_cast<float*>(smem);  // K2: [TR][DP], reuses stage
#pragma unroll
  for (int i = 0; i < 4 && owner; ++i) {
    const int r = tile0 + 4 * rg + i;
    const bool rv = r < S;
    const long long node = (long long)b * S + r;
    const int sl = (rv && a.C > 0) ? a.slot[node] : -1;
    const float rs = rv ? a.row[node] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 4 * dg + j;
      float v = acc[i][j];
      if (rv && d < D) {
        if (sl >= 0) {
          const float s = a.sub[((long long)b * a.C + sl) * D + d];
          v += BF ? round_bf16(s) : s;
        }
        v *= rs;
        if (!SAGE) st(a.out + node * D + d, v);
      } else {
        v = 0.f;
      }
      if (SAGE) pool[(4 * rg + i) * DP + d] = v;
    }
  }
  if (!SAGE) return;

  // K2 epilogue: z = relu(pool @ A_w + h_own @ B_w); h' = z · rsqrt(Σz²)
  float* hown = pool + TR * DP;   // [TR][DP] unscaled h of the tile's rows
  float* as = hown + TR * DP;     // [D][DP]
  float* bws = as + D * DP;       // [D][DP]
  float* part = bws + D * DP;     // [TR][DG] row sums of squares
  for (int e = tid; e < TR * DP; e += nthr) {
    const int r = e / DP, d = e - r * DP;
    float v = 0.f;
    if (tile0 + r < S && d < D) v = ld(a.h + ((long long)b * S + tile0 + r) * D + d);
    hown[e] = v;
  }
  for (int e = tid; e < D * DP; e += nthr) {
    const int k = e / DP, c = e - k * DP;
    as[e] = c < D ? a.aw[k * D + c] : 0.f;
    bws[e] = c < D ? a.bw[k * D + c] : 0.f;
  }
  __syncthreads();

  float za[4][4], zb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) za[i][j] = zb[i][j] = 0.f;
  for (int k = 0; k < D && owner; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(as + k * DP + 4 * dg);
    const float4 bv = *reinterpret_cast<const float4*>(bws + k * DP + 4 * dg);
    const float af[4] = {av.x, av.y, av.z, av.w};
    const float bf[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = pool[(4 * rg + i) * DP + k];
      const float q = hown[(4 * rg + i) * DP + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        za[i][j] = fmaf(p, af[j], za[i][j]);
        zb[i][j] = fmaf(q, bf[j], zb[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float z = fmaxf(za[i][j] + zb[i][j], 0.f);
      za[i][j] = z;
      sq = fmaf(z, z, sq);   // columns >= D hold exact zeros
    }
    if (owner) part[(4 * rg + i) * DG + dg] = sq;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tile0 + 4 * rg + i;
    if (!owner || r >= S) continue;
    float tot = 0.f;
    for (int g = 0; g < DG; ++g) tot += part[(4 * rg + i) * DG + g];
    const float scale = 1.f / sqrtf(fmaxf(tot, 1e-24f));
    const long long node = (long long)b * S + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 4 * dg + j;
      if (d < D) st(a.out + node * D + d, za[i][j] * scale);
    }
  }
}

// launches blocks [a.b0, b1) of a.nb
template <bool BF, bool HALO, typename T>
int launch(bool sage, BandArgs<T> a, int b1, cudaStream_t stream) {
  // the bf16 modes pad D to whole 16-column fragments and take 16-row
  // fragments, with at most 2·NW fragments a block (TR·DP <= 16·NT)
  const int q = BF ? 16 : 4;
  if (a.D < 1 || a.nb < 1 || a.b0 < 0 || b1 <= a.b0 || b1 > a.nb ||
      b1 - a.b0 > 65535 || a.S < 1 || a.B < 0 || a.B > a.S || a.C < 0 ||
      (a.S + 2 * a.B) % 4 != 0 || (HALO && sage))
    return (int)cudaErrorInvalidValue;
  const int DP = (a.D + q - 1) / q * q;
  a.DG = DP / 4;
  if (a.DG > NT) return (int)cudaErrorInvalidValue;
  int TR = 4 * (NT / a.DG) / q * q;
  const int cap = (a.S + q - 1) / q * q;
  if (TR > cap) TR = cap;
  if (TR < q) return (int)cudaErrorInvalidValue;
  a.TR = TR;
  size_t shm = BF ? sizeof(__nv_bfloat16) * ((size_t)TR * LDA + (size_t)KC * (DP + 8))
                  : sizeof(float) * (size_t)KC * (TR + DP);
  if (BF && sizeof(float) * (size_t)TR * DP > shm) shm = sizeof(float) * (size_t)TR * DP;
  if (sage) {
    const size_t epi =
        sizeof(float) * ((size_t)2 * TR * DP + (size_t)2 * a.D * DP +
                         (size_t)TR * a.DG);
    if (epi > shm) shm = epi;
  }
  void (*kern)(BandArgs<T>);
  if constexpr (HALO)
    kern = band_kernel<false, BF, true, T>;
  else
    kern = sage ? band_kernel<true, BF, false, T> : band_kernel<false, BF, false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + TR - 1) / TR, b1 - a.b0);
  kern<<<grid, NT, shm, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bf16(bool sage, const int8_t* base, const void* h, const float* row,
                const float* col, const float* sub, const int32_t* slot,
                const float* aw, const float* bw, void* out, int nb, int S,
                int B, int C, int D, cudaStream_t stream) {
  BandArgs<T> a{base, static_cast<const T*>(h), row, col, sub, slot, aw, bw,
                static_cast<T*>(out), nb, S, B, C, D, 0, 0};
  return launch<true, false, T>(sage, a, nb, stream);
}

template <typename T>
int launch_halo_bf16(const int8_t* base, const void* h, const void* lh,
                     const void* rh, const float* row, const float* col,
                     const float* lc, const float* rc, const float* sub,
                     const int32_t* slot, void* out, int nb, int S, int B,
                     int C, int D, int b0, int b1, cudaStream_t stream) {
  BandArgs<T> a{base, static_cast<const T*>(h), row, col, sub, slot, nullptr,
                nullptr, static_cast<T*>(out), nb, S, B, C, D, 0, 0,
                static_cast<const T*>(lh), static_cast<const T*>(rh), lc, rc, b0};
  return launch<true, true, T>(false, a, b1, stream);
}

}  // namespace

extern "C" {

// K1.  Returns the cudaError_t of the launch (0 = launched).
int mdc_band_spmm(const int8_t* base, const float* h, const float* row,
                  const float* col, const float* sub, const int32_t* slot,
                  float* out, int nb, int S, int B, int C, int D,
                  void* stream) {
  BandArgs<float> a{base, h, row, col, sub, slot, nullptr, nullptr, out,
                    nb, S, B, C, D, 0, 0};
  return launch<false, false, float>(false, a, nb, (cudaStream_t)stream);
}

// K2.  aw, bw: f32 [D, D].  Returns the cudaError_t of the launch.
int mdc_band_sage(const int8_t* base, const float* h, const float* row,
                  const float* col, const float* sub, const int32_t* slot,
                  const float* aw, const float* bw, float* out, int nb,
                  int S, int B, int C, int D, void* stream) {
  BandArgs<float> a{base, h, row, col, sub, slot, aw, bw, out,
                    nb, S, B, C, D, 0, 0};
  return launch<false, false, float>(true, a, nb, (cudaStream_t)stream);
}

// K1, bf16 operands.  h and out are f32 (bf16_act = 0) or bf16 (1); D <= 256.
int mdc_band_spmm_bf16(const int8_t* base, const void* h, const float* row,
                       const float* col, const float* sub, const int32_t* slot,
                       void* out, int nb, int S, int B, int C, int D,
                       int bf16_act, void* stream) {
  return bf16_act
      ? launch_bf16<__nv_bfloat16>(false, base, h, row, col, sub, slot, nullptr,
                                   nullptr, out, nb, S, B, C, D, (cudaStream_t)stream)
      : launch_bf16<float>(false, base, h, row, col, sub, slot, nullptr, nullptr,
                           out, nb, S, B, C, D, (cudaStream_t)stream);
}

// K2, bf16 operands, f32 epilogue.  aw, bw: f32 [D, D].
int mdc_band_sage_bf16(const int8_t* base, const void* h, const float* row,
                       const float* col, const float* sub, const int32_t* slot,
                       const float* aw, const float* bw, void* out, int nb,
                       int S, int B, int C, int D, int bf16_act, void* stream) {
  return bf16_act
      ? launch_bf16<__nv_bfloat16>(true, base, h, row, col, sub, slot, aw, bw,
                                   out, nb, S, B, C, D, (cudaStream_t)stream)
      : launch_bf16<float>(true, base, h, row, col, sub, slot, aw, bw, out, nb,
                           S, B, C, D, (cudaStream_t)stream);
}

// K3: blocks [b0, b1) of one shard of nb blocks.  h, out: [nb·S, D];
// lh, rh: [B, D] (null when no block of the range reads them: 1 <= b0,
// b1 <= nb − 1); lc, rc: [B] likewise; row, col, slot: [nb·S];
// sub: [nb·C, D].  Returns the cudaError_t of the launch.
int mdc_band_spmm_halo(const int8_t* base, const float* h, const float* lh,
                       const float* rh, const float* row, const float* col,
                       const float* lc, const float* rc, const float* sub,
                       const int32_t* slot, float* out, int nb, int S, int B,
                       int C, int D, int b0, int b1, void* stream) {
  BandArgs<float> a{base, h, row, col, sub, slot, nullptr, nullptr, out,
                    nb, S, B, C, D, 0, 0, lh, rh, lc, rc, b0};
  return launch<false, true, float>(false, a, b1, (cudaStream_t)stream);
}

// K3, bf16 operands; h, lh, rh and out f32 (bf16_act = 0) or bf16 (1).
int mdc_band_spmm_halo_bf16(const int8_t* base, const void* h, const void* lh,
                            const void* rh, const float* row, const float* col,
                            const float* lc, const float* rc, const float* sub,
                            const int32_t* slot, void* out, int nb, int S, int B,
                            int C, int D, int b0, int b1, int bf16_act,
                            void* stream) {
  return bf16_act
      ? launch_halo_bf16<__nv_bfloat16>(base, h, lh, rh, row, col, lc, rc, sub,
                                        slot, out, nb, S, B, C, D, b0, b1,
                                        (cudaStream_t)stream)
      : launch_halo_bf16<float>(base, h, lh, rh, row, col, lc, rc, sub, slot,
                                out, nb, S, B, C, D, b0, b1, (cudaStream_t)stream);
}

}  // extern "C"
