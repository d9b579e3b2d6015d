// Blocked-pair sparse kernels for Hopper (sm_90a), plain C ABI, loaded with
// ctypes by ops/blocked_kernels.py.
//
// K4  mdc_spmm_block  : out = A @ h over a pair-major blocked COO
// K5  mdc_sddmm_block : dw[p, t] = h[src_blk[p]·S + lsrc[p, t]] ·
//                                  g[dst_blk[p]·S + ldst[p, t]]
//
// The layout (ops/blocked_kernels.py::build_block_coo): nodes in blocks of
// S rows; edges grouped by (destination block, source block) pair into
// chunks of T slots; P pair chunks, padded to a multiple of 8.  Slot
// (p, t) of a real edge carries local rows lsrc/ldst and the weight
// w[p, t]; padding slots carry lsrc = ldst = 0 and w = 0.  h, g, out: f32
// [n_blocks·S, D] row-major, any D.
//
// What they replace.  K4 replaces the JAX package's Pallas TPU kernel
// ops/pallas_spmm.py::_spmm_kernel (via spmm_block), K5 its _sddmm_kernel
// (via sddmm_block); together they are the forward and the w-gradient of
// the blocked SpMM, whose h-gradient is K4 again (the adjacency is
// symmetric).  The TPU kernels gather rows with one-hot bf16x2 matmuls on
// the MXU, because the TPU's gather was slow; on an H100 a gather is a
// plain load, so both kernels here gather and compute in f32 FFMA.
//
// What bounds them on an H100.  Bytes: each slot is one multiply-add per
// column, a few flops per byte moved, so the index and weight arrays
// (12 B a slot) and the rows of h read once set the least time; at
// 18,432 rows the whole input is a few MB, and launch latency dominates.
//
// What the simple designs do about it.  K4: one warp per destination row,
// lanes over D (four columns a lane per pass, passes of 128 columns).  The
// row walks its list of real slots (row_ptr/row_slot, built once on the
// host from the static slot mask), so padding slots cost nothing and no
// float atomics are needed: each row sums its slots in list order, and the
// result is the same on every run.  The warp loads the slot metadata of 32
// slots at once, one per lane, and broadcasts each with a shuffle; a slot
// whose weight is 0 (a dead edge) skips its row load.  w is read in place
// through the slot index, in the slot order the graph's edge arrays keep.
// K5: one warp per slot, lanes over D, then a fixed-order butterfly
// reduction; padding slots and padded pairs are computed like the others
// (h[src_blk·S]·g[dst_blk·S], h[0]·g[0]), as the TPU kernel computes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block: 8 warps
constexpr unsigned FULL = 0xffffffffu;

__global__ void spmm_block_kernel(const int32_t* __restrict__ row_ptr,
                                  const int32_t* __restrict__ row_slot,
                                  const int32_t* __restrict__ src_blk,
                                  const int32_t* __restrict__ lsrc,
                                  const float* __restrict__ w,
                                  const float* __restrict__ h,
                                  float* __restrict__ out, int n_rows, int S,
                                  int T, int D) {
  const int lane = threadIdx.x & 31;
  const long long row = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  if (row >= n_rows) return;
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  for (int d0 = 0; d0 < D; d0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = beg; base < end; base += 32) {
      const int k = base + lane;
      long long src = 0;
      float wv = 0.f;
      if (k < end) {
        const int slot = row_slot[k];
        wv = w[slot];
        src = (long long)src_blk[slot / T] * S + lsrc[slot];
      }
      const int cnt = min(32, end - base);
      for (int j = 0; j < cnt; ++j) {
        const float wj = __shfl_sync(FULL, wv, j);
        const long long sj = __shfl_sync(FULL, src, j);
        if (wj == 0.f) continue;  // the same for every lane of the warp
        const float* hr = h + sj * D;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = d0 + lane + 32 * c;
          if (d < D) acc[c] = fmaf(wj, __ldg(hr + d), acc[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + lane + 32 * c;
      if (d < D) out[row * D + d] = acc[c];
    }
  }
}

__global__ void sddmm_block_kernel(const int32_t* __restrict__ src_blk,
                                   const int32_t* __restrict__ dst_blk,
                                   const int32_t* __restrict__ lsrc,
                                   const int32_t* __restrict__ ldst,
                                   const float* __restrict__ h,
                                   const float* __restrict__ g,
                                   float* __restrict__ out, long long n_slots,
                                   int S, int T, int D) {
  const int lane = threadIdx.x & 31;
  const long long slot = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  if (slot >= n_slots) return;
  const long long p = slot / T;
  const float* hr = h + ((long long)src_blk[p] * S + lsrc[slot]) * D;
  const float* gr = g + ((long long)dst_blk[p] * S + ldst[slot]) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(__ldg(hr + d), __ldg(gr + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) out[slot] = acc;
}

int blocks_for(long long warps) { return (int)((warps * 32 + NT - 1) / NT); }

}  // namespace

extern "C" {

// K4.  row_ptr int32 [n_rows + 1], row_slot int32 [row_ptr[n_rows]] (slot
// ids p·T + t of the real edges, grouped by destination row), src_blk
// int32 [P], lsrc int32 [P·T], w f32 [P·T], h f32 [n_rows, D], out f32
// [n_rows, D].  Returns the cudaError_t of the launch (0 = launched).
int mdc_spmm_block(const int32_t* row_ptr, const int32_t* row_slot,
                   const int32_t* src_blk, const int32_t* lsrc,
                   const float* w, const float* h, float* out, int n_rows,
                   int S, int T, int D, void* stream) {
  if (n_rows < 0 || S < 1 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  spmm_block_kernel<<<blocks_for(n_rows), NT, 0, (cudaStream_t)stream>>>(
      row_ptr, row_slot, src_blk, lsrc, w, h, out, n_rows, S, T, D);
  return (int)cudaGetLastError();
}

// K5.  src_blk, dst_blk int32 [P]; lsrc, ldst int32 [P·T]; h, g f32
// [n_blocks·S, D]; out f32 [P·T].  Returns the cudaError_t of the launch.
int mdc_sddmm_block(const int32_t* src_blk, const int32_t* dst_blk,
                    const int32_t* lsrc, const int32_t* ldst, const float* h,
                    const float* g, float* out, long long n_slots, int S,
                    int T, int D, void* stream) {
  if (n_slots < 0 || S < 1 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (n_slots == 0) return (int)cudaSuccess;
  sddmm_block_kernel<<<blocks_for(n_slots), NT, 0, (cudaStream_t)stream>>>(
      src_blk, dst_blk, lsrc, ldst, h, g, out, n_slots, S, T, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
