// The stream probe for Hopper (sm_90a), plain C ABI, loaded with ctypes by
// ops/probe_kernels.py.
//
// mdc_stream_sum: out[g] = Σ of the int8 array x [nb, rows, width] over the
// G blocks of group g (blocks g·G .. g·G + G − 1), as f32 [nb / G].  With
// extra = 1 it also adds, for each block, the parity-masked row reductions
// of the overlap probe: Σ_{i < min(rows, 256)} Σ_{k < 128} x[i, k] ·
// ([k == 2·(i mod 64)] + [k == 2·(i mod 64) + 1]), computed as the masked
// reduction it is (every lane tested), not as two gathers.
//
// What it replaces.  scripts/probe_pallas_stream.py::make_stream (a bare
// BlockSpec-pipelined Pallas stream over the packed base's shape: each grid
// step sums a G-block group) and, with extra, scripts/probe_overlap.py::
// make(extra_compute=True) (the same stream with scale-extraction-shaped
// VPU work, to see whether compute hides behind a saturated stream).  The
// TPU kernels write sum + s to one constant output block, so only the last
// group's value survives there; this kernel writes every group's sum, and
// its last entry plus s is the TPU kernel's output.
//
// What bounds it on an H100: bytes, by design (one read of x, nothing
// written but nb / G floats); it exists to measure the practical read rate
// against the data sheet's 3.35 TB/s.  Design: a group is cut into chunks
// of CH bytes, one block a chunk (grid = chunks × groups, so thousands of
// blocks keep every SM's loads in flight); each thread reads 16 bytes a
// load (int4, consecutive threads on consecutive addresses) and sums the
// signed bytes with __dp4a into an int; a block's int total goes into
// out[g] with one float atomicAdd.  The wrapper zeroes out first.  The sums
// are exact, and so independent of the order of the atomics, while each
// group's partial sums are integers below 2^24 (the probes' data: values in
// [0, 3), groups of at most 8 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int UNROLL = 16;       // 16-byte loads per thread
constexpr long long CH = (long long)NT * 16 * UNROLL;   // bytes a block (64 KB)

__device__ __forceinline__ int sum16(const int4 v) {
  int s = __dp4a(v.x, 0x01010101, 0);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

// the overlap probe's masked lane reductions over the 16 bytes at row r,
// columns [c, c + 16) of a block
__device__ __forceinline__ int masked16(const int4 v, int r, int c) {
  if (r >= 256 || c >= 128) return 0;
  const int want = 2 * (r & 63);
  const int w[4] = {v.x, v.y, v.z, v.w};
  int s = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int k = c + t;
    const int x = (int)(int8_t)(w[t >> 2] >> (8 * (t & 3)));
    s += (k == want ? x : 0) + (k == want + 1 ? x : 0);
  }
  return s;
}

template <bool EXTRA>
__global__ void __launch_bounds__(NT) stream_kernel(const int8_t* __restrict__ x,
                                                    float* __restrict__ out,
                                                    long long group_bytes, int rows,
                                                    int width) {
  const int g = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * CH;
  const int8_t* grp = x + (long long)g * group_bytes;
  const long long blk_bytes = (long long)rows * width;
  int acc = 0;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long o = c0 + 16LL * ((long long)u * NT + threadIdx.x);
    if (o < group_bytes) {
      const int4 v = *reinterpret_cast<const int4*>(grp + o);
      acc += sum16(v);
      if constexpr (EXTRA) {
        const long long ob = o % blk_bytes;
        acc += masked16(v, (int)(ob / width), (int)(ob % width));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ int warp_sum[NT / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < NT / 32; ++w) tot += warp_sum[w];
    atomicAdd(out + g, (float)tot);
  }
}

}  // namespace

extern "C" {

// x: int8 [nb, rows, width], contiguous and 16-byte aligned, width a
// multiple of 16; out: f32 [nb / G], zeroed.  Returns the cudaError_t of
// the launch (0 = launched).
int mdc_stream_sum(const int8_t* x, float* out, int nb, int rows, int width, int G,
                   int extra, void* stream) {
  if (nb < 1 || rows < 1 || width < 16 || width % 16 != 0 || G < 1 || nb % G != 0 ||
      ((uintptr_t)x & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long group_bytes = (long long)G * rows * width;
  const long long chunks = (group_bytes + CH - 1) / CH;
  if (chunks > 0x7fffffffLL || nb / G > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, nb / G);
  if (extra)
    stream_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(x, out, group_bytes, rows,
                                                              width);
  else
    stream_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(x, out, group_bytes, rows,
                                                               width);
  return (int)cudaGetLastError();
}

}  // extern "C"
