// The LMCC cascade of the banded loops on Hopper (sm_90a), plain C ABI,
// loaded with ctypes by ops/cascade_kernels.py; env/device_cascade.py
// drives it.
//
// What it replaces.  No TPU kernel: the JAX package's cascade is host C++
// (native/src/mdc_native.cpp, copied into the port as the native engine).
// These kernels were added because that host cascade held the card idle: a
// component-record union-find that relabels a layer's whole giant component
// to move a handful of nodes, on one CPU thread, ~17 ns an edge.  Here a
// cascade is a from-scratch connected-components pass per layer and a sever
// test over the other layer, repeated until a round severs nothing; it
// reaches the same fixed point (the severs a set of removals forces do not
// depend on the order they are found in).
//
// Kernels (each entry point returns the cudaError_t of its launches):
//   mdc_cc_cover        covered[a] = 1 for each action a in [0, n)
//   mdc_cc_live_edges   alive[i] = !sever[i] & !covered[u[i]] & !covered[v[i]]
//                       over a layer's edges, and their count
//   mdc_cc_components   labels of the live edges' components: init, hook,
//                       compress (ECL-CC, Jaiganesh & Burtscher, HPDC 2018);
//                       label[x] = the least node id of x's component, and a
//                       node with no live edge keeps label[x] = x; touched[x]
//                       = x has a live edge
//   mdc_cc_sever_test   over the other layer's live edges: an end with no live
//                       edge in the labels' layer, or label[u] != label[v],
//                       sets sever, clears alive and appends the edge id to a
//                       buffer through a counter (the C++ rule that a node
//                       with no live edge shares a component with nothing,
//                       itself included: a self-loop on it is severed)
//   mdc_cc_rank         the largest count of uncovered nodes under one label
//   mdc_cc_alive_nodes  the live edges' endpoints as an n-byte mask
//
// What bounds them on an H100: bytes.  At 2^20 nodes and degree 6 a layer has
// ~3.1 M edges; the live pass reads u, v (8 B) and sever (1 B) and writes
// alive (1 B) an edge, the components pass reads u, v and alive (9 B an edge,
// ~28 MB, ~8.4 us at 3.35 TB/s) and writes and reads the 4 MB label array,
// which stays in the 50 MB L2, as do the covered bytes the live pass gathers.
// Design: one thread an edge or a node, 256 a block, consecutive threads on
// consecutive edges (the edges are sorted by their smaller end in the band's
// order, so label and covered gathers are near-sequential); hooks link a
// larger root under a smaller one with atomicCAS and compress paths on the
// way (intermediate pointer jumping), so a label never exceeds its node's id
// and a root is its tree's least id; the sever test and the rank aggregate
// their atomics over a warp (__ballot_sync, __match_any_sync), so the giant
// component's million nodes cost tens of thousands of atomics, not a million
// on one address.  The hook pass also marks the nodes that have a live edge
// (2 B an edge, n B to clear).  Labels are read with __ldcg (L2, not the
// non-coherent L1): a stale parent would still be an ancestor, but L2 reads
// see other blocks' hooks sooner.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block, a multiple of 32

inline unsigned blocks(long long items) { return (unsigned)((items + NT - 1) / NT); }

__global__ void cover_kernel(uint8_t* __restrict__ covered, const int64_t* __restrict__ acts,
                             int k, int n) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j < k) {
    const int64_t a = acts[j];
    if (a >= 0 && a < n) covered[a] = 1;
  }
}

__global__ void live_kernel(const int* __restrict__ u, const int* __restrict__ v,
                            const uint8_t* __restrict__ sever,
                            const uint8_t* __restrict__ covered, uint8_t* __restrict__ alive,
                            long long m, unsigned long long* __restrict__ count) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  int a = 0;
  if (i < m) {
    a = !sever[i] && !covered[u[i]] && !covered[v[i]];
    alive[i] = (uint8_t)a;
  }
  const int c = __syncthreads_count(a);
  if (threadIdx.x == 0 && c) atomicAdd(count, (unsigned long long)c);
}

__global__ void cc_init_kernel(int* __restrict__ label, uint8_t* __restrict__ touched,
                               int n) {
  const int x = blockIdx.x * NT + threadIdx.x;
  if (x < n) {
    label[x] = x;
    touched[x] = 0;
  }
}

// x's root, halving the path on the way: each node passed points to its
// grandparent (an ancestor, so label[y] <= y still holds)
__device__ __forceinline__ int representative(int x, int* label) {
  int cur = __ldcg(label + x);
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = __ldcg(label + cur))) {
      label[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

__global__ void cc_hook_kernel(const int* __restrict__ u, const int* __restrict__ v,
                               const uint8_t* __restrict__ alive, long long m, int* label,
                               uint8_t* __restrict__ touched) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= m || !alive[i]) return;
  const int ui = u[i], vi = v[i];
  touched[ui] = 1;
  touched[vi] = 1;
  int a = representative(ui, label);
  int b = representative(vi, label);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // hook the larger root a under b; if a is no longer a root, go on from
    // what it points to now
    const int old = atomicCAS(label + a, a, b);
    if (old == a) break;
    a = old;
  }
}

__global__ void cc_compress_kernel(int* label, int n) {
  const int x = blockIdx.x * NT + threadIdx.x;
  if (x >= n) return;
  int cur = __ldcg(label + x), next;
  const int first = cur;
  while (cur > (next = __ldcg(label + cur))) cur = next;
  if (cur != first) label[x] = cur;
}

__global__ void sever_kernel(const int* __restrict__ u, const int* __restrict__ v,
                             uint8_t* __restrict__ alive, uint8_t* __restrict__ sever,
                             long long m, const int* __restrict__ label,
                             const uint8_t* __restrict__ touched, int* __restrict__ new_ids,
                             unsigned long long* __restrict__ count) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  bool cut = false;
  if (i < m && alive[i]) {
    const int ui = u[i], vi = v[i];
    cut = !touched[ui] || __ldcg(label + ui) != __ldcg(label + vi);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, cut);
  if (!mask) return;
  const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
  unsigned long long base = 0;
  if (lane == leader) base = atomicAdd(count, (unsigned long long)__popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (cut) {
    sever[i] = 1;
    alive[i] = 0;
    new_ids[base + __popc(mask & ((1u << lane) - 1u))] = (int)i;
  }
}

__global__ void rank_count_kernel(const int* __restrict__ label,
                                  const uint8_t* __restrict__ covered, int n,
                                  int* __restrict__ cnt) {
  const int x = blockIdx.x * NT + threadIdx.x;
  const bool on = x < n && !covered[x];
  const int key = on ? __ldcg(label + x) : -1;
  const unsigned group = __match_any_sync(0xffffffffu, key);
  if (on && (threadIdx.x & 31) == __ffs(group) - 1) atomicAdd(cnt + key, __popc(group));
}

__global__ void rank_max_kernel(const int* __restrict__ cnt, int n,
                                unsigned long long* __restrict__ out) {
  unsigned best = 0;
  for (int x = blockIdx.x * NT + threadIdx.x; x < n; x += gridDim.x * NT)
    best = max(best, (unsigned)cnt[x]);
  best = __reduce_max_sync(0xffffffffu, best);
  __shared__ unsigned warp_best[NT / 32];
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NT / 32; ++w) best = max(best, warp_best[w]);
    if (best) atomicMax(out, (unsigned long long)best);
  }
}

__global__ void alive_nodes_kernel(const int* __restrict__ u, const int* __restrict__ v,
                                   const uint8_t* __restrict__ alive, long long m,
                                   uint8_t* __restrict__ mask) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i < m && alive[i]) {
    mask[u[i]] = 1;
    mask[v[i]] = 1;
  }
}

}  // namespace

extern "C" {

// covered: u8 [n]; acts: i64 [k] (entries outside [0, n) are skipped).
int mdc_cc_cover(uint8_t* covered, const int64_t* acts, int k, int n, void* stream) {
  if (k < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  cover_kernel<<<blocks(k), NT, 0, (cudaStream_t)stream>>>(covered, acts, k, n);
  return (int)cudaGetLastError();
}

// u, v: i32 [m]; sever, alive: u8 [m]; covered: u8 [n]; count: one u64,
// set to the number of live edges.
int mdc_cc_live_edges(const int* u, const int* v, const uint8_t* sever,
                      const uint8_t* covered, uint8_t* alive, long long m,
                      unsigned long long* count, void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(unsigned long long), (cudaStream_t)stream);
  if (rc != cudaSuccess || m == 0) return (int)rc;
  live_kernel<<<blocks(m), NT, 0, (cudaStream_t)stream>>>(u, v, sever, covered, alive, m,
                                                         count);
  return (int)cudaGetLastError();
}

// label: i32 [n], written: the least node id of each node's component over
// the live edges (alive: u8 [m]); touched: u8 [n], written: 1 where a node
// has a live edge.
int mdc_cc_components(const int* u, const int* v, const uint8_t* alive, long long m,
                      int* label, uint8_t* touched, int n, void* stream) {
  if (m < 0 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cc_init_kernel<<<blocks(n), NT, 0, s>>>(label, touched, n);
  if (m) cc_hook_kernel<<<blocks(m), NT, 0, s>>>(u, v, alive, m, label, touched);
  cc_compress_kernel<<<blocks(n), NT, 0, s>>>(label, n);
  return (int)cudaGetLastError();
}

// Over one layer's edges, with the other layer's labels and touched mask:
// each live edge whose ends carry two labels, or whose end has no live edge
// there, is severed; its id goes to new_ids[*count] and *count grows by one
// (new_ids holds m entries).
int mdc_cc_sever_test(const int* u, const int* v, uint8_t* alive, uint8_t* sever,
                      long long m, const int* label, const uint8_t* touched, int* new_ids,
                      unsigned long long* count, void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  sever_kernel<<<blocks(m), NT, 0, (cudaStream_t)stream>>>(u, v, alive, sever, m, label,
                                                          touched, new_ids, count);
  return (int)cudaGetLastError();
}

// out: one u64, set to the most uncovered nodes under one label (0 when
// every node is covered); cnt: i32 [n] scratch.
int mdc_cc_rank(const int* label, const uint8_t* covered, int n, int* cnt,
                unsigned long long* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)n, s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(out, 0, sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return (int)rc;
  rank_count_kernel<<<blocks(n), NT, 0, s>>>(label, covered, n, cnt);
  const unsigned grid = blocks(n) < 1024u ? blocks(n) : 1024u;
  rank_max_kernel<<<grid, NT, 0, s>>>(cnt, n, out);
  return (int)cudaGetLastError();
}

// mask: u8 [n], written: 1 where a node has a live edge.
int mdc_cc_alive_nodes(const int* u, const int* v, const uint8_t* alive, long long m,
                       uint8_t* mask, int n, void* stream) {
  if (m < 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaMemsetAsync(mask, 0, (size_t)n, (cudaStream_t)stream);
  if (rc != cudaSuccess || m == 0) return (int)rc;
  alive_nodes_kernel<<<blocks(m), NT, 0, (cudaStream_t)stream>>>(u, v, alive, m, mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
