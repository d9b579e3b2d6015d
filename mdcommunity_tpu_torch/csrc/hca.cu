// HCA-Dismantler's community graph on Hopper (sm_90a), plain C ABI, loaded
// with ctypes by ops/hca_kernels.py; models/hca_banded.banded_hca_forward
// calls it once a layer.
//
// What it replaces.  The TPU code forms the community graph as the band
// operator applied to the one-hot membership, Mᵀ(A_live M)
// (mdcommunity_tpu/models/hca_banded.py:141-146, band_pallas.py's kernel at
// D = c_pad), and binarises it; the port ran the same product through K1 in
// chunks of 256 columns (models/hca_banded.community_graph, kept as the
// check).  The head uses only whether an entry is nonzero, so this pass
// writes that table directly:
//
//   out[c, c'] = 1  where some stored edge with a nonzero weight joins a
//                   live node of community c (destination) and a live node
//                   of community c' != c (source)
//   out[c, c]  = 1  for c < n_real (a real community's self loop), else 0
//   out        = 0  elsewhere
//
// The edges are read where K1 reads them and where severs zero them
// (ops/dense_band.sever_edges): the band cells of the base (int8 or two
// nibbles a byte; the mirror lanes below the band rows hold no edges), the
// overflow edges of the mirror COO (slots mapped to nodes by mirror_node)
// and the spill COO.  The stored operator is symmetric, so both directions
// of an edge are found.  Every store writes 1, so the table needs no atomics
// and does not depend on the order the threads run in; it is the K1 form's
// (counts > 0) table bit for bit.
//
// Kernels (the entry point returns the cudaError_t of its launches):
//   memset            the table to 0
//   hca_comm_diag     the diagonal
//   hca_comm_band     one warp a band row (a destination node): a dead
//                     destination skips its row unread; else the lanes read
//                     the row in 16- or 4-byte words (streaming loads)
//                     and each nonzero cell tests its source
//   hca_comm_coo      one thread an overflow or spill edge
//
// What bounds it on an H100: bytes.  At 2^20 nodes, S 256, B 128, int8, a
// layer's band rows are 537 MB (~0.16 ms at 3.35 TB/s; a nibble base half of
// that), the c_pad 4,096 f32 table 67 MB written once (~0.02 ms); comm_id
// (8 B) and live (1 B) of each edge's source are gathers that stay in L2,
// near-sequential in the band's order.  The stores scatter, one a live
// inter-community cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block, a multiple of 32

inline unsigned blocks(long long items) { return (unsigned)((items + NT - 1) / NT); }

__global__ void hca_comm_diag_kernel(float* __restrict__ out, int c_pad, int n_real) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c < c_pad) out[(long long)c * c_pad + c] = c < n_real ? 1.0f : 0.0f;
}

// the source node of window column lc of block blk's rows: (blk·S − B + lc)
// mod pad_n, one wrap at most (B <= S, lc < S + 2B)
__device__ __forceinline__ int window_src(int blk, int S, int B, int lc, int pad_n) {
  int s = blk * S - B + lc;
  if (s < 0) s += pad_n;
  else if (s >= pad_n) s -= pad_n;
  return s;
}

__device__ __forceinline__ void mark(float* __restrict__ out, const int64_t* __restrict__ cid,
                                     const uint8_t* __restrict__ live, int64_t cd, int src,
                                     int c_pad) {
  if (!live[src]) return;
  const int64_t cs = cid[src];
  if (cs != cd) out[cd * c_pad + cs] = 1.0f;
}

// V: the word a lane reads (uint4 or unsigned); NIB: two window
// columns a byte, column 2k in the low nibble of byte k
template <typename V, bool NIB>
__global__ void hca_comm_band_kernel(const uint8_t* __restrict__ base,
                                     const int64_t* __restrict__ cid,
                                     const uint8_t* __restrict__ live, float* __restrict__ out,
                                     int nb, int S, int B, int C, int pitch, int c_pad) {
  const int pad_n = nb * S;
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= pad_n || !live[row]) return;  // uniform over the warp
  const int blk = row / S, r = row - blk * S;
  const int64_t cd = cid[row];
  const V* words = reinterpret_cast<const V*>(base + ((long long)blk * (S + C) + r) * pitch);
  const int nw = pitch / (int)sizeof(V);
  for (int j = lane; j < nw; j += 32) {
    V w = __ldcs(words + j);
    const unsigned* part = reinterpret_cast<const unsigned*>(&w);
#pragma unroll
    for (int q = 0; q < (int)(sizeof(V) / 4); ++q) {
      unsigned x = part[q];
      while (x) {
        const int byte = (__ffs(x) - 1) >> 3;
        const unsigned v = (x >> (8 * byte)) & 0xffu;
        x &= ~(0xffu << (8 * byte));
        const int k = j * (int)sizeof(V) + 4 * q + byte;  // the byte's place in the row
        if (NIB) {
          if (v & 0xfu) mark(out, cid, live, cd, window_src(blk, S, B, 2 * k, pad_n), c_pad);
          if (v >> 4) mark(out, cid, live, cd, window_src(blk, S, B, 2 * k + 1, pad_n), c_pad);
        } else {
          mark(out, cid, live, cd, window_src(blk, S, B, k, pad_n), c_pad);
        }
      }
    }
  }
}

// one thread an edge src[i] -> dst[i] of weight w[i]; node maps mirror slots
// to nodes (null: src and dst are nodes)
__global__ void hca_comm_coo_kernel(const int64_t* __restrict__ src,
                                    const int64_t* __restrict__ dst,
                                    const float* __restrict__ w, long long m,
                                    const int64_t* __restrict__ node,
                                    const int64_t* __restrict__ cid,
                                    const uint8_t* __restrict__ live, float* __restrict__ out,
                                    int c_pad) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= m || w[i] == 0.0f) return;
  int64_t s = src[i], d = dst[i];
  if (node) {
    s = node[s];
    d = node[d];
    if (s < 0 || d < 0) return;
  }
  if (!live[d]) return;
  mark(out, cid, live, cid[d], (int)s, c_pad);
}

template <typename V>
void launch_band(const uint8_t* base, const int64_t* cid, const uint8_t* live, float* out,
                 int nb, int S, int B, int C, int pitch, int nib, int c_pad, cudaStream_t s) {
  const unsigned grid = (unsigned)(((long long)nb * S + NT / 32 - 1) / (NT / 32));
  if (nib)
    hca_comm_band_kernel<V, true><<<grid, NT, 0, s>>>(base, cid, live, out, nb, S, B, C,
                                                     pitch, c_pad);
  else
    hca_comm_band_kernel<V, false><<<grid, NT, 0, s>>>(base, cid, live, out, nb, S, B, C,
                                                      pitch, c_pad);
}

}  // namespace

extern "C" {

// One layer's community graph, written to out, f32 [c_pad, c_pad].  base:
// the layer's u8 [nb, S+C, pitch] (pitch W2, or W2/2 with nib = 1; the row
// pitch a multiple of 4 bytes); mirror_node: i64 [nb·C]; the mirror COO
// c_src, c_dst (i64 slots) and w_cov (f32), m_cov edges; the spill COO
// s_src, s_dst (i64 nodes) and w_spill, m_spill edges; cid: i64 [nb·S]
// (values in [0, c_pad)); live: u8 [nb·S].
int mdc_hca_comm_adj(const uint8_t* base, int nb, int S, int B, int C, int nib,
                     const int64_t* mirror_node, const int64_t* c_src, const int64_t* c_dst,
                     const float* w_cov, long long m_cov, const int64_t* s_src,
                     const int64_t* s_dst, const float* w_spill, long long m_spill,
                     const int64_t* cid, const uint8_t* live, float* out, int c_pad,
                     int n_real, void* stream) {
  if (nb < 1 || S < 1 || B < 0 || B > S || C < 0 || c_pad < 1 || m_cov < 0 || m_spill < 0
      || (S + 2 * B) % (nib ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int W2 = S + 2 * B;
  const int pitch = nib ? W2 / 2 : W2;
  cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)c_pad * c_pad, s);
  if (rc != cudaSuccess) return (int)rc;
  hca_comm_diag_kernel<<<blocks(c_pad), NT, 0, s>>>(out, c_pad, n_real);
  // 16-byte words where every row is 16-byte aligned (the cell's int8 base
  // at S 256, B 128: pitch 512, a word a lane), else 4-byte words
  if (pitch % 16 == 0 && (uintptr_t)base % 16 == 0)
    launch_band<uint4>(base, cid, live, out, nb, S, B, C, pitch, nib, c_pad, s);
  else
    launch_band<unsigned>(base, cid, live, out, nb, S, B, C, pitch, nib, c_pad, s);
  if (m_cov)
    hca_comm_coo_kernel<<<blocks(m_cov), NT, 0, s>>>(c_src, c_dst, w_cov, m_cov, mirror_node,
                                                     cid, live, out, c_pad);
  if (m_spill)
    hca_comm_coo_kernel<<<blocks(m_spill), NT, 0, s>>>(s_src, s_dst, w_spill, m_spill, nullptr,
                                                       cid, live, out, c_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
