// Blocked-pair sparse kernels for Hopper (sm_90a), plain C ABI, loaded with
// ctypes by ops/blocked_kernels.py.
//
// K4  mdc_spmm_block  : out = A @ h over the per-row lists of real slots
// K5  mdc_sddmm_block : dw[p, t] = h[src_blk[p]·S + lsrc[p, t]] ·
//                                  g[dst_blk[p]·S + ldst[p, t]]
//
// The layout (ops/blocked_kernels.py::build_block_coo): nodes in blocks of
// S rows; edges grouped by (destination block, source block) pair into
// chunks of T slots; P pair chunks, padded to a multiple of 8.  Slot
// (p, t) of a real edge carries local rows lsrc/ldst and the weight
// w[p, t]; padding slots carry lsrc = ldst = 0 and w = 0.  For K4 the
// layout also lists, per destination row, its real slots (row_ptr,
// row_slot) and their global source rows (row_src), built once on the
// host.  h, g, out: f32 [n_blocks·S, D] row-major, any D.
//
// What they replace.  K4 replaces the JAX package's Pallas TPU kernel
// ops/pallas_spmm.py::_spmm_kernel (via spmm_block), K5 its _sddmm_kernel
// (via sddmm_block); together they are the forward and the w-gradient of
// the blocked SpMM, whose h-gradient is K4 again (the adjacency is
// symmetric).  The TPU kernels gather rows with one-hot bf16x2 matmuls on
// the MXU, because the TPU's gather was slow; on an H100 a gather is a
// plain load, so both kernels gather and compute in f32 FFMA: one
// multiply-add per 4 to 8 bytes gathered, nothing for the tensor cores.
//
// What bounds them on an H100.  Bytes, and before that latency: each slot
// is a dependent chain of index loads ending in a 256-byte row gather
// (D = 64), served mostly by L2, since the RCM-ordered blocks reuse rows.
// A warp that walks one slot at a time waits on that chain with almost
// nothing in flight.  So the designs keep many independent row loads in
// flight, make each a 16-byte load a lane, and cut the index loads a slot
// costs.
//
// K4.  A team of L lanes (ceil(D/8) rounded up to a power of two, at most
// 32; four rows a warp at D = 64) takes one destination row, Q4 = 2
// float4 columns a lane, in passes of 8·L columns.  The team reads L
// entries of the row's list at a time, one a lane: row_slot and row_src
// coalesced, then w[row_slot] (w stays in slot order: it changes with every
// sever).  A ballot keeps the live slots (w != 0; a dead slot never loads
// its h row), and the team walks them in list order U4 at a time: it issues
// their row loads, then their multiply-adds, one fmaf a live slot and
// column in row_slot order, so each row's sum is the same on every run and
// for every team size.  The warp's loops run to its longest row (its lanes
// stay converged); hub rows take several list reads; a row with no live
// slot writes zeros.  Small teams and few slots in flight won the sweeps
// (tune_blocked.py): at D = 64 and 2^20 rows on an H100, U4 = 2 slots of
// two float4 a lane (46 registers) ran 1.5x faster than U4 = 8 slots of
// one float4 (64 registers), since more resident warps and less per-slot bookkeeping a
// row (shuffles, ballot bits) buy more than depth within a team.
//
// K5.  A warp takes 32 consecutive slots: lane k loads slot k's lsrc and
// ldst (coalesced) and its pair's src_blk/dst_blk through p = slot / T, so
// any T works (a group may straddle pairs).  Teams of L lanes
// (ceil(D/8) rounded up to a power of two; 8 at D = 64, Q5 = 2 float4 a
// row a lane) take one slot each per round; a round's four loads a lane
// are issued before its multiply-adds (R5 = 1: deeper rounds ran slower),
// and a fixed-order butterfly sums each team.  Lane k
// keeps slot k's result, and the warp writes its 32 results as one 128-byte
// store.  Padding slots and padded pairs are computed like the others
// (h[src_blk·S]·g[dst_blk·S], h[0]·g[0]), as the TPU kernel computes them.
//
// Both take 16-byte loads where D % 4 == 0 and the operands are 16-byte
// aligned (VEC); otherwise the same kernels load the same columns one
// float at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Launch constants, set by tune_blocked.py's sweeps on the H100 (PERF.md)
constexpr int NT4 = 64;            // K4: threads a block
constexpr int U4 = 2;              // K4: live slots whose rows a team loads at once
constexpr int Q4 = 2;              // K4: float4 columns a lane, per row
constexpr int NT5 = 256;           // K5: threads a block
constexpr int R5 = 1;              // K5: rounds whose rows a warp loads at once
constexpr int Q5 = 2;              // K5: float4 columns a lane, per row

// Columns c .. c+3 of row p: one float4 (VEC: D % 4 == 0, p aligned), else
// scalars masked at D; zeros past D.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int c, int D) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (VEC) {
    if (c < D) v = __ldg(reinterpret_cast<const float4*>(p + c));
  } else {
    if (c < D) v.x = __ldg(p + c);
    if (c + 1 < D) v.y = __ldg(p + c + 1);
    if (c + 2 < D) v.z = __ldg(p + c + 2);
    if (c + 3 < D) v.w = __ldg(p + c + 3);
  }
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, int c, int D, float4 v) {
  if constexpr (VEC) {
    if (c < D) *reinterpret_cast<float4*>(p + c) = v;
  } else {
    if (c < D) p[c] = v.x;
    if (c + 1 < D) p[c + 1] = v.y;
    if (c + 2 < D) p[c + 2] = v.z;
    if (c + 3 < D) p[c + 3] = v.w;
  }
}

template <int L, bool VEC>
__global__ void __launch_bounds__(NT4) spmm_rows_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ row_slot,
    const int32_t* __restrict__ row_src, const float* __restrict__ w,
    const float* __restrict__ h, float* __restrict__ out, int n_rows, int D) {
  constexpr int TEAMS = 32 / L;
  const int lane = threadIdx.x & 31, tl = lane % L, team = lane / L;
  const unsigned shift = team * L;
  const unsigned team_bits = L == 32 ? FULL : ((1u << L) - 1u) << shift;
  const long long first = (((long long)blockIdx.x * NT4 + threadIdx.x) >> 5) * TEAMS;
  if (first >= n_rows) return;  // the whole warp: its lanes share `first`
  const long long row = first + team;
  const bool own = row < n_rows;
  const int beg = own ? row_ptr[row] : 0, end = own ? row_ptr[row + 1] : 0;
  for (int d0 = 0; d0 < D; d0 += 4 * L * Q4) {
    float4 acc[Q4];
#pragma unroll
    for (int q = 0; q < Q4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = beg; __any_sync(FULL, base < end); base += L) {
      const int k = base + tl;
      int src = 0;
      float wk = 0.f;
      if (k < end) {
        src = row_src[k];
        wk = w[row_slot[k]];
      }
      unsigned live = (__ballot_sync(FULL, wk != 0.f) & team_bits) >> shift;
      while (__any_sync(FULL, live != 0u)) {
        float wu[U4];
        float4 v[U4][Q4];
#pragma unroll
        for (int u = 0; u < U4; ++u) {
          const int j = live ? __ffs((int)live) - 1 : 0;
          const float wj = __shfl_sync(FULL, wk, j, L);
          const int sj = __shfl_sync(FULL, src, j, L);
          wu[u] = live ? wj : 0.f;
          live &= live - 1u;
#pragma unroll
          for (int q = 0; q < Q4; ++q) {
            v[u][q] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (wu[u] != 0.f) v[u][q] = load4<VEC>(h + (long long)sj * D, d0 + 4 * (tl + L * q), D);
          }
        }
#pragma unroll
        for (int u = 0; u < U4; ++u) {
          if (wu[u] != 0.f) {
#pragma unroll
            for (int q = 0; q < Q4; ++q) {
              acc[q].x = fmaf(wu[u], v[u][q].x, acc[q].x);
              acc[q].y = fmaf(wu[u], v[u][q].y, acc[q].y);
              acc[q].z = fmaf(wu[u], v[u][q].z, acc[q].z);
              acc[q].w = fmaf(wu[u], v[u][q].w, acc[q].w);
            }
          }
        }
      }
    }
    if (own) {
#pragma unroll
      for (int q = 0; q < Q4; ++q) store4<VEC>(out + row * D, d0 + 4 * (tl + L * q), D, acc[q]);
    }
  }
}

template <int L, bool VEC>
__global__ void __launch_bounds__(NT5) sddmm_slots_kernel(
    const int32_t* __restrict__ src_blk, const int32_t* __restrict__ dst_blk,
    const int32_t* __restrict__ lsrc, const int32_t* __restrict__ ldst,
    const float* __restrict__ h, const float* __restrict__ g,
    float* __restrict__ out, long long n_slots, int S, int T, int D) {
  constexpr int TEAMS = 32 / L, ROUNDS = L;  // 32 slots = TEAMS × ROUNDS
  constexpr int R = ROUNDS < R5 ? ROUNDS : R5;
  const int lane = threadIdx.x & 31, tl = lane % L, team = lane / L;
  const long long base = (((long long)blockIdx.x * NT5 + threadIdx.x) >> 5) * 32;
  if (base >= n_slots) return;  // the whole warp
  const long long slot = base + lane;
  long long hrow = 0, grow = 0;  // past n_slots: row 0, computed, never stored
  if (slot < n_slots) {
    const long long p = slot / T;
    hrow = (long long)src_blk[p] * S + lsrc[slot];
    grow = (long long)dst_blk[p] * S + ldst[slot];
  }
  float mine = 0.f;
  for (int r0 = 0; r0 < ROUNDS; r0 += R) {
    long long hr[R], gr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = team + TEAMS * (r0 + r);  // the slot this team takes
      hr[r] = __shfl_sync(FULL, hrow, j) * D;
      gr[r] = __shfl_sync(FULL, grow, j) * D;
    }
    float part[R];
#pragma unroll
    for (int r = 0; r < R; ++r) part[r] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 4 * L * Q5) {
      float4 a[R][Q5], b[R][Q5];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < Q5; ++q) {
          const int c = d0 + 4 * (tl + L * q);
          a[r][q] = load4<VEC>(h + hr[r], c, D);
          b[r][q] = load4<VEC>(g + gr[r], c, D);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < Q5; ++q) {
          part[r] = fmaf(a[r][q].x, b[r][q].x, part[r]);
          part[r] = fmaf(a[r][q].y, b[r][q].y, part[r]);
          part[r] = fmaf(a[r][q].z, b[r][q].z, part[r]);
          part[r] = fmaf(a[r][q].w, b[r][q].w, part[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        part[r] += __shfl_xor_sync(FULL, part[r], off);
      // slot k was taken by team k % TEAMS in round k / TEAMS
      const float got = __shfl_sync(FULL, part[r], (lane % TEAMS) * L);
      if (lane / TEAMS == r0 + r) mine = got;
    }
  }
  if (slot < n_slots) out[slot] = mine;
}

int blocks_for(long long warps, int nt) { return (int)((warps * 32 + nt - 1) / nt); }

// The least power of two >= n, at most 32.
int team_lanes(int n) {
  int L = 1;
  while (L < n && L < 32) L *= 2;
  return L;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Calls f(lanes, vec) with both as compile-time constants
// (std::integral_constant), for L a power of two up to 32.
template <typename F>
void dispatch(int L, bool vec, F f) {
  auto with_vec = [&](auto lanes) {
    if (vec)
      f(lanes, std::true_type{});
    else
      f(lanes, std::false_type{});
  };
  switch (L) {
    case 1: with_vec(std::integral_constant<int, 1>{}); break;
    case 2: with_vec(std::integral_constant<int, 2>{}); break;
    case 4: with_vec(std::integral_constant<int, 4>{}); break;
    case 8: with_vec(std::integral_constant<int, 8>{}); break;
    case 16: with_vec(std::integral_constant<int, 16>{}); break;
    default: with_vec(std::integral_constant<int, 32>{});
  }
}

}  // namespace

extern "C" {

// K4.  row_ptr int32 [n_rows + 1], row_slot int32 [row_ptr[n_rows]] (slot
// ids p·T + t of the real edges, grouped by destination row), row_src
// int32 [row_ptr[n_rows]] (the global source row of each row_slot entry),
// w f32 [P·T], h f32 [n_rows, D], out f32 [n_rows, D].  Returns the
// cudaError_t of the launch (0 = launched).
int mdc_spmm_block(const int32_t* row_ptr, const int32_t* row_slot,
                   const int32_t* row_src, const float* w, const float* h,
                   float* out, int n_rows, int D, void* stream) {
  if (n_rows < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const bool vec = D % 4 == 0 && aligned16(h) && aligned16(out);
  dispatch(team_lanes((D + 4 * Q4 - 1) / (4 * Q4)), vec, [&](auto lanes, auto v) {
    constexpr int L = decltype(lanes)::value;
    const long long warps = ((long long)n_rows + 32 / L - 1) / (32 / L);
    spmm_rows_kernel<L, decltype(v)::value><<<blocks_for(warps, NT4), NT4, 0,
                                              (cudaStream_t)stream>>>(
        row_ptr, row_slot, row_src, w, h, out, n_rows, D);
  });
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
  const bool vec = D % 4 == 0 && aligned16(h) && aligned16(g);
  dispatch(team_lanes((D + 4 * Q5 - 1) / (4 * Q5)), vec, [&](auto lanes, auto v) {
    sddmm_slots_kernel<decltype(lanes)::value, decltype(v)::value>
        <<<blocks_for((n_slots + 31) / 32, NT5), NT5, 0, (cudaStream_t)stream>>>(
            src_blk, dst_blk, lsrc, ldst, h, g, out, n_slots, S, T, D);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
