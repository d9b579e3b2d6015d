// Louvain community detection, step for step as networkx 3.6.1 runs it
// (graphs/louvain.py is the same computation in Python; its docstring lists
// what fixes the result).  The caller drives the levels: it creates the
// engine from the edges, then alternates mdc_louvain_level (one pass of local
// moves over the level's nodes in an order it shuffles with Python's
// random.Random, one generator for all levels) and mdc_louvain_next (the
// modularity test and the next level's graph), and reads the labels of the
// last partition the level loop kept.
//
// What is kept from networkx:
//   * a level's graph as adjacency lists in insertion order: the first
//     level's in the order `G.edges()` meets the input graph's edges (each
//     node's neighbours in the order the edges first name them), every later
//     level's in the order `_gen_graph` adds its edges;
//   * the neighbour communities of a node in first-appearance order, then its
//     own community (the defaultdict's insertion), and the strict `>` on the
//     gain;
//   * the gains and modularities in double, with Python's operation order:
//     integer products (exact below 2^53), then the divisions; each
//     modularity summed over the communities in list order as Python 3.12's
//     sum() sums floats (Neumaier's compensated sum);
//   * the stop rule new_mod - mod <= threshold.
// Built with -ffp-contract=off (build.py): a fused multiply-add would round
// once where Python rounds twice.
//
// Adapted from networkx/algorithms/community/louvain.py and quality.py,
// networkx 3.6.1, Copyright (C) 2004-2025 NetworkX Developers (BSD 3-clause;
// the notice is in graphs/louvain.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <utility>
#include <vector>

namespace {

// Python 3.12's sum() over floats (after the int start 0).
struct PySum {
  double f = 0.0, c = 0.0;
  bool any = false;
  void add(double x) {
    if (!any) {
      f = x;
      any = true;
      return;
    }
    double t = f + x;
    if (std::fabs(f) >= std::fabs(x)) {
      c += (f - t) + x;
    } else {
      c += (x - t) + f;
    }
    f = t;
  }
  double value() const {
    double r = f;
    if (c != 0.0 && std::isfinite(c)) r += c;
    return r;
  }
};

// One level's graph: CSR adjacency with integer weights, each node's
// neighbours in insertion order (a self loop is its own neighbour, once).
struct Level {
  int64_t k = 0;
  std::vector<int64_t> off, nbr, w;
};

// The graph that adds the undirected weighted edges (a[t], b[t], wt[t]) in
// the order t, nx.Graph's add_edge: a repeated pair adds its weight in the
// pair's first place.
Level from_yields(int64_t k, const std::vector<int64_t>& a, const std::vector<int64_t>& b,
                  const std::vector<int64_t>& wt) {
  const int64_t Y = (int64_t)a.size();
  std::vector<std::pair<int64_t, int64_t>> key(Y);  // (pair key, t)
  for (int64_t t = 0; t < Y; ++t) {
    int64_t lo = std::min(a[t], b[t]), hi = std::max(a[t], b[t]);
    key[t] = {lo * k + hi, t};
  }
  std::sort(key.begin(), key.end());
  // each distinct pair: its first t and its summed weight, placed at t
  std::vector<int64_t> first_at(Y, -1), wsum(Y, 0);
  for (int64_t i = 0; i < Y;) {
    int64_t j = i, s = 0;
    while (j < Y && key[j].first == key[i].first) s += wt[key[j++].second];
    first_at[key[i].second] = key[i].second;
    wsum[key[i].second] = s;
    i = j;
  }
  Level g;
  g.k = k;
  g.off.assign(k + 1, 0);
  for (int64_t t = 0; t < Y; ++t) {
    if (first_at[t] < 0) continue;
    g.off[a[t] + 1]++;
    if (a[t] != b[t]) g.off[b[t] + 1]++;
  }
  for (int64_t i = 0; i < k; ++i) g.off[i + 1] += g.off[i];
  g.nbr.resize(g.off[k]);
  g.w.resize(g.off[k]);
  std::vector<int64_t> fill(g.off.begin(), g.off.end() - 1);
  for (int64_t t = 0; t < Y; ++t) {  // t ascending: each list in first-place order
    if (first_at[t] < 0) continue;
    int64_t p = fill[a[t]]++;
    g.nbr[p] = b[t];
    g.w[p] = wsum[t];
    if (a[t] != b[t]) {
      p = fill[b[t]]++;
      g.nbr[p] = a[t];
      g.w[p] = wsum[t];
    }
  }
  return g;
}

// networkx's weighted degree: a self loop counts twice.
std::vector<int64_t> degrees(const Level& g) {
  std::vector<int64_t> d(g.k, 0);
  for (int64_t u = 0; u < g.k; ++u)
    for (int64_t p = g.off[u]; p < g.off[u + 1]; ++p)
      d[u] += (g.nbr[p] == u) ? 2 * g.w[p] : g.w[p];
  return d;
}

// modularity(G, communities) for the level graph g and its nodes' community
// labels com (0..count-1, the list order).
double modularity(const Level& g, const std::vector<int64_t>& com, int64_t count,
                  double resolution) {
  std::vector<int64_t> deg = degrees(g);
  int64_t deg_sum = 0;
  for (int64_t d : deg) deg_sum += d;
  const double m = (double)deg_sum / 2.0;
  const double norm = 1.0 / (double)(deg_sum * deg_sum);
  std::vector<int64_t> twice(count, 0), loops(count, 0), ods(count, 0);
  for (int64_t u = 0; u < g.k; ++u) {
    int64_t c = com[u];
    ods[c] += deg[u];
    for (int64_t p = g.off[u]; p < g.off[u + 1]; ++p) {
      int64_t v = g.nbr[p];
      if (v == u)
        loops[c] += g.w[p];
      else if (com[v] == c)
        twice[c] += g.w[p];
    }
  }
  PySum s;
  for (int64_t c = 0; c < count; ++c) {
    double l_c = (double)(twice[c] / 2 + loops[c]);
    double q = resolution * (double)ods[c] * (double)ods[c] * norm;
    s.add(l_c / m - q);
  }
  return s.value();
}

struct Louvain {
  int64_t n = 0;
  double resolution = 1.0, m = 0.0, mod = 0.0;
  bool empty = true;
  Level g;                       // the current level's graph
  std::vector<int64_t> node_of;  // original node -> the current level's node
  std::vector<int64_t> com;      // the current level's node -> its community (list order)
  int64_t count = 0;             // communities of the last level pass
  std::vector<int64_t> last;     // labels of the partition the loop keeps
  int64_t last_count = 0;
  int64_t levels = 0, moves = 0;
};

// One pass of local moves (networkx's _one_level, undirected) over the
// level's nodes in `order`.  Leaves com (nonempty communities renumbered in
// index order) and count; returns whether any node moved.
bool one_level(Louvain& L, const int64_t* order) {
  const Level& g = L.g;
  const int64_t k = g.k;
  std::vector<int64_t> deg = degrees(g);
  // the level's lists as (neighbour, weight) int32 pairs without self
  // loops: one cache line holds a node's few entries
  std::vector<int64_t> off(k + 1, 0);
  std::vector<std::pair<int32_t, int32_t>> adj;
  adj.reserve(g.nbr.size());
  for (int64_t u = 0; u < k; ++u) {
    for (int64_t p = g.off[u]; p < g.off[u + 1]; ++p)
      if (g.nbr[p] != u) adj.push_back({(int32_t)g.nbr[p], (int32_t)g.w[p]});
    off[u + 1] = (int64_t)adj.size();
  }
  std::vector<int32_t> node2com(k), pos(k, -1);
  std::vector<int64_t> stot(deg);
  std::iota(node2com.begin(), node2com.end(), 0);
  // each community's nodes as a linked list, and whether a node must be
  // looked at again: a node whose last look moved nothing, and whose
  // neighbours' communities and candidate communities' Stot have not
  // changed since, would move nothing again (the same operands give the
  // same doubles), so it is skipped
  std::vector<int32_t> head(k), nxt(k, -1), prv(k, -1);
  std::iota(head.begin(), head.end(), 0);
  std::vector<uint8_t> dirty(k, 1);
  auto mark = [&](int32_t c) {  // a community's nodes and their neighbours
    for (int32_t y = head[c]; y >= 0; y = nxt[y]) {
      dirty[y] = 1;
      for (int64_t p = off[y]; p < off[y + 1]; ++p) dirty[adj[p].first] = 1;
    }
  };
  const double m = L.m, two_m2 = 2.0 * (m * m), res = L.resolution;
  std::vector<std::pair<int32_t, double>> w2c;
  constexpr int64_t AHEAD = 12;  // nodes of the order prefetched ahead
  bool improvement = false;
  int64_t nb_moves = 1;
  while (nb_moves > 0) {
    nb_moves = 0;
    for (int64_t i = 0; i < k; ++i) {
      if (i + 2 * AHEAD < k) __builtin_prefetch(&off[order[i + 2 * AHEAD]]);
      if (i + AHEAD < k && dirty[order[i + AHEAD]]) {
        const int64_t f = order[i + AHEAD];
        __builtin_prefetch(&adj[off[f]]);
        __builtin_prefetch(&node2com[f]);
      }
      const int64_t u = order[i];
      if (!dirty[u]) continue;
      dirty[u] = 0;
      const int32_t own = node2com[u];
      w2c.clear();
      for (int64_t p = off[u]; p < off[u + 1]; ++p) {
        const int32_t c = node2com[adj[p].first];
        if (pos[c] < 0) {
          pos[c] = (int32_t)w2c.size();
          w2c.push_back({c, 0.0});
        }
        w2c[pos[c]].second += (double)adj[p].second;
      }
      if (pos[own] < 0) {
        pos[own] = (int32_t)w2c.size();
        w2c.push_back({own, 0.0});
      }
      const int64_t d = deg[u];
      double best_mod = 0.0;
      int32_t best = own;
      stot[own] -= d;
      const double remove_cost =
          -w2c[pos[own]].second / m + res * (double)(stot[own] * d) / two_m2;
      for (const auto& cw : w2c) {
        double gain = remove_cost + cw.second / m - res * (double)(stot[cw.first] * d) / two_m2;
        if (gain > best_mod) {
          best_mod = gain;
          best = cw.first;
        }
      }
      stot[best] += d;
      for (const auto& cw : w2c) pos[cw.first] = -1;
      if (best != own) {
        node2com[u] = best;
        improvement = true;
        ++nb_moves;
        // unlink u from own, link it at best's head
        if (prv[u] >= 0) nxt[prv[u]] = nxt[u]; else head[own] = nxt[u];
        if (nxt[u] >= 0) prv[nxt[u]] = prv[u];
        prv[u] = -1;
        nxt[u] = head[best];
        if (head[best] >= 0) prv[head[best]] = (int32_t)u;
        head[best] = (int32_t)u;
        mark(own);
        mark(best);
      }
    }
    L.moves += nb_moves;
  }
  std::vector<int64_t> remap(k, -1);
  for (int64_t u = 0; u < k; ++u) remap[node2com[u]] = 0;
  int64_t cnt = 0;
  for (int64_t c = 0; c < k; ++c)
    if (remap[c] == 0) remap[c] = cnt++;
  L.com.resize(k);
  for (int64_t u = 0; u < k; ++u) L.com[u] = remap[node2com[u]];
  L.count = cnt;
  L.levels++;
  return improvement;
}

// networkx's _gen_graph: a node a community, in the order G.edges() meets
// the level's edges.
void gen_graph(Louvain& L) {
  const Level& g = L.g;
  std::vector<int64_t> a, b, wt;
  a.reserve(g.nbr.size() / 2 + 1);
  b.reserve(g.nbr.size() / 2 + 1);
  wt.reserve(g.nbr.size() / 2 + 1);
  for (int64_t u = 0; u < g.k; ++u)
    for (int64_t p = g.off[u]; p < g.off[u + 1]; ++p)
      if (g.nbr[p] >= u) {
        a.push_back(L.com[u]);
        b.push_back(L.com[g.nbr[p]]);
        wt.push_back(g.w[p]);
      }
  for (auto& x : L.node_of) x = L.com[x];
  L.g = from_yields(L.count, a, b, wt);
}

}  // namespace

extern "C" {

// The engine for the graph nx.Graph(); add_nodes_from(range(n));
// add_edges_from(edges): edges [m, 2] int64 in 0..n-1 (checked by the
// caller); null for n or m of 2^31 - 1 or more (a level's ids and weights
// are int32 in its passes).  Computes the singleton partition's modularity on it and the
// first level's graph.
void* mdc_louvain_create(int64_t n, const int64_t* edges, int64_t m_edges, double resolution) {
  if (n >= INT32_MAX || m_edges >= INT32_MAX) return nullptr;  // ids and weights as int32
  Louvain* L = new Louvain();
  L->n = n;
  L->resolution = resolution;
  L->node_of.resize(n);
  std::iota(L->node_of.begin(), L->node_of.end(), 0);
  L->last = L->node_of;
  L->last_count = n;
  L->empty = m_edges == 0;
  if (L->empty) return L;
  // the input graph: each distinct pair once, with the index of the edge
  // that first names it; G.edges() yields them by (smaller end, that index)
  std::vector<std::pair<int64_t, int64_t>> key(m_edges);
  for (int64_t i = 0; i < m_edges; ++i) {
    int64_t u = edges[2 * i], v = edges[2 * i + 1];
    key[i] = {std::min(u, v) * n + std::max(u, v), i};
  }
  std::sort(key.begin(), key.end());
  std::vector<std::pair<int64_t, int64_t>> yield;  // ((smaller end, first index), pair key)
  for (int64_t i = 0; i < m_edges;) {
    int64_t j = i;
    while (j < m_edges && key[j].first == key[i].first) ++j;
    yield.push_back({key[i].first / n, key[i].second});
    i = j;
  }
  std::vector<int64_t> order(yield.size());
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) { return yield[x] < yield[y]; });
  std::vector<int64_t> a(yield.size()), b(yield.size()), wt(yield.size(), 1);
  for (size_t t = 0; t < order.size(); ++t) {
    const int64_t i = yield[order[t]].second;
    a[t] = std::min(edges[2 * i], edges[2 * i + 1]);
    b[t] = std::max(edges[2 * i], edges[2 * i + 1]);
  }
  L->g = from_yields(n, a, b, wt);
  int64_t deg_sum = 0;
  for (int64_t d : degrees(L->g)) deg_sum += d;
  L->m = (double)deg_sum / 2.0;
  // the singleton partition's modularity, on the same edges
  std::vector<int64_t> single(n);
  std::iota(single.begin(), single.end(), 0);
  L->mod = modularity(L->g, single, n, resolution);
  return L;
}

void mdc_louvain_destroy(void* p) { delete (Louvain*)p; }

int32_t mdc_louvain_empty(void* p) { return ((Louvain*)p)->empty ? 1 : 0; }

// nodes of the current level's graph
int64_t mdc_louvain_size(void* p) { return ((Louvain*)p)->g.k; }

// one pass of local moves in `order` (a permutation of the level's nodes);
// returns 1 if a node moved
int32_t mdc_louvain_level(void* p, const int64_t* order) {
  return one_level(*(Louvain*)p, order) ? 1 : 0;
}

// the level loop's step after a pass: keep the partition, then stop (0) if
// the modularity gained no more than threshold, else build the next level's
// graph (1)
int32_t mdc_louvain_next(void* p, double threshold) {
  Louvain& L = *(Louvain*)p;
  L.last_count = L.count;
  for (int64_t x = 0; x < L.n; ++x) L.last[x] = L.com[L.node_of[x]];
  double new_mod = modularity(L.g, L.com, L.count, L.resolution);
  if (new_mod - L.mod <= threshold) return 0;
  L.mod = new_mod;
  gen_graph(L);
  return 1;
}

// the kept partition: each node's community (list order); returns the count
int64_t mdc_louvain_labels(void* p, int64_t* out) {
  Louvain& L = *(Louvain*)p;
  std::copy(L.last.begin(), L.last.end(), out);
  return L.last_count;
}

// [passes of local moves, node moves over all passes]
void mdc_louvain_stats(void* p, int64_t* out) {
  Louvain& L = *(Louvain*)p;
  out[0] = L.levels;
  out[1] = L.moves;
}

}  // extern "C"
