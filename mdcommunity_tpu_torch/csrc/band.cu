// Band-operator kernels for Hopper (sm_90a), plain C ABI, loaded with ctypes
// by ops/band_kernels.py.
//
// K1  mdc_band_spmm : out = row ⊙ (A_band @ (col ⊙ h) + Gᵀ·sub)
// K2  mdc_band_sage : h' = l2n(relu(out_K1 @ A_w + h @ B_w))
//
// A_band is a DenseBandGraph's int8 base [nb, S+C, W2] (only its S band rows
// are read): row s of destination block b holds the edges from source rows
// (b·S − B + w) mod pad_n, w in [0, W2).  G is the mirror one-hot: row
// (b, s) owns mirror slot slot[b, s] (or none, -1), and `sub` [nb·C, D] is
// the mirror-space result computed by the wrapper (compaction gather +
// sorted-COO SpMM).  h, out: f32 [pad_n, D] row-major.
//
// What they replace.  Both replace the JAX package's Pallas TPU kernel
// ops/band_pallas.py::_make_kernel: K1 its sage=False, halo=False mode (the
// forward of spmm_band_packed), K2 its sage=True mode (sage_step_packed), in
// the precise (f32 operand) mode that the eval path uses.  K1 is also the
// backward of the operator (the VJP at band_pallas.py:811-829): the stored
// operator is symmetric, so ops/dense_band.BandSpmm launches K1 with row and
// col swapped for the training loss's gradient.  The TPU kernel's
// node-pair lane packing and 128-lane scale planes exist for the TPU's vector
// tiles and have no counterpart here: h stays [pad_n, D] and the scales are
// read per row.
//
// What bounds them on an H100.  The function itself is bound by bytes: it
// must read the int8 band once (pad_n·W2 bytes, 0.54 GB at 2^20 nodes) and
// h, and write the output, while the band holds only ~6-12 nonzeros a row
// out of W2 = 512, so the multiply-adds the data needs are few.  A kernel
// that multiplies the band as a dense matrix instead does 2·pad_n·W2·D
// flops (6.9e10 at 2^20 nodes, D=64): ~1 ms at the 67 TFLOP/s of FP32 FMA
// against ~0.17 ms for the bytes, so a dense kernel is bound by operations.
// Tensor cores are no way out for the precise eval: TF32 rounds h to ~10
// bits, the kind of rounding that cost the JAX package 0.035 AUDC.
//
// What the simple design does about it.  Every multiply-add is an FP32 FFMA
// from registers: a thread owns a 4-row × 4-column register tile of the
// output, and each step of the window loop reads one float4 of the base tile
// and one float4 of the h tile from shared memory for 16 FFMAs.  The int8
// base is widened to f32 once, while it is staged (KC=64 window columns at a
// time, four columns per 32-bit load), not once per FMA.  All NT threads
// stage, also when fewer own an output tile (D=2: 64 of 256), because
// staging, not the FMAs, is what a narrow D waits on.  A chunk whose staged
// base tile is all zero (most
// of them: a row's neighbours sit in one or two chunks of the window) skips
// its h staging and its FMAs, so the operations follow the band's fill
// rather than its dense size.  The window is staged col-scaled, so the row
// scale, the mirror add and (K2) the dense layer and normalisation are
// epilogues on the tile.  Sums run in a fixed order (window position, then
// k of the epilogue dots), so results are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 64;    // window columns staged per step
constexpr int NT = 256;   // threads per block

struct BandArgs {
  const int8_t* base;
  const float* h;
  const float* row;
  const float* col;
  const float* sub;
  const int32_t* slot;
  const float* aw;   // K2 only: [D, D]
  const float* bw;   // K2 only: [D, D]
  float* out;
  int nb, S, B, C, D;
  int TR;            // destination rows per block (multiple of 4)
  int DG;            // column groups of 4: ceil(D / 4)
};

template <bool SAGE>
__global__ void __launch_bounds__(NT) band_kernel(BandArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TR = a.TR, DG = a.DG, DP = 4 * DG, D = a.D, S = a.S, B = a.B;
  const int W2 = S + 2 * B;
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * TR;   // first local row of this tile
  const int tid = threadIdx.x, nthr = blockDim.x;
  // threads tid < DG·TR/4 own a 4×4 output tile; all of them stage
  const bool owner = tid < DG * (TR / 4);
  const int dg = tid % DG, rg = tid / DG;
  const int pad_n = a.nb * S;

  float* bs = reinterpret_cast<float*>(smem);   // [KC][TR] base, transposed
  float* hs = bs + KC * TR;                     // [KC][DP] col ⊙ h window
  const int8_t* base_blk = a.base + (long long)b * (S + a.C) * W2;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int w0 = 0; w0 < W2; w0 += KC) {
    int nz = 0;
    // 4 window columns per 32-bit load (W2 and w0 are multiples of 4);
    // consecutive threads take consecutive rows, so the shared stores of a
    // warp hit 32 banks
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
      if (w0 + k < W2 && d < D) {
        // window row (b·S − B + w) mod pad_n; |b·S − B + w − wrap| < pad_n
        // because B <= S
        int j = b * S - B + w0 + k;
        if (j < 0) j += pad_n;
        if (j >= pad_n) j -= pad_n;
        v = a.col[j] * a.h[(long long)j * D + d];
      }
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

  // mirror expansion (+ sub[slot]) before the row scale, as the TPU kernel
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
        if (sl >= 0) v += a.sub[((long long)b * a.C + sl) * D + d];
        v *= rs;
        if (!SAGE) a.out[node * D + d] = v;
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
    if (tile0 + r < S && d < D) v = a.h[((long long)b * S + tile0 + r) * D + d];
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
      if (d < D) a.out[node * D + d] = za[i][j] * scale;
    }
  }
}

int launch(bool sage, BandArgs a, cudaStream_t stream) {
  a.DG = (a.D + 3) / 4;
  if (a.D < 1 || a.DG > NT || a.nb < 1 || a.nb > 65535 || a.S < 1 ||
      a.B < 0 || a.B > a.S || a.C < 0 || (a.S + 2 * a.B) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int s4 = (a.S + 3) / 4 * 4;
  a.TR = 4 * (NT / a.DG);
  if (a.TR > s4) a.TR = s4;
  const int DP = 4 * a.DG;
  size_t shm = sizeof(float) * (size_t)KC * (a.TR + DP);
  if (sage) {
    const size_t epi =
        sizeof(float) * ((size_t)2 * a.TR * DP + (size_t)2 * a.D * DP +
                         (size_t)a.TR * a.DG);
    if (epi > shm) shm = epi;
  }
  void (*kern)(BandArgs) = sage ? band_kernel<true> : band_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + a.TR - 1) / a.TR, a.nb);
  kern<<<grid, NT, shm, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  Returns the cudaError_t of the launch (0 = launched).
int mdc_band_spmm(const int8_t* base, const float* h, const float* row,
                  const float* col, const float* sub, const int32_t* slot,
                  float* out, int nb, int S, int B, int C, int D,
                  void* stream) {
  BandArgs a{base, h, row, col, sub, slot, nullptr, nullptr, out,
             nb, S, B, C, D, 0, 0};
  return launch(false, a, (cudaStream_t)stream);
}

// K2.  aw, bw: f32 [D, D].  Returns the cudaError_t of the launch.
int mdc_band_sage(const int8_t* base, const float* h, const float* row,
                  const float* col, const float* sub, const int32_t* slot,
                  const float* aw, const float* bw, float* out, int nb,
                  int S, int B, int C, int D, void* stream) {
  BandArgs a{base, h, row, col, sub, slot, aw, bw, out,
             nb, S, B, C, D, 0, 0};
  return launch(true, a, (cudaStream_t)stream);
}

}  // extern "C"
