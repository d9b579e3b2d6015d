// mdc_native: host-side native engine for mdcommunity_tpu_torch (a copy of
// the JAX package's engine, built into the port's own build directory).
//
// Two components, both plain C ABI for ctypes:
//
// 1. Duplex-cascade dismantling environment — the host-side eval hot path.
//    Semantics mirror env/host_env.py (itself matching the
//    reference's MvcEnv + Mcc.MCC alternating sever loop, mvc_env.py:31-162 /
//    Mcc.py:30-38): covering a node kills its incident edges in both layers;
//    the cascade alternately severs layer-B edges that straddle distinct
//    layer-A components until the partitions agree; severed edges persist.
//
//    The engine is COMPONENT-LOCAL (round 5; the 10^6-node dismantling loop
//    is host-cascade-bound, RESULTS r04): each layer keeps its component
//    partition as explicit records (node list + edge list per component).
//    Edges only ever die, so partitions only refine — a component's labeling
//    can change only if IT lost an edge.  Every edge death (covering or
//    sever) marks its component "affected"; a cascade round relabels ONLY
//    the affected components (union-find over their nodes/edges) and
//    re-tests ONLY the other-layer edges incident to the relabeled nodes
//    (an edge can newly straddle the partition only if an endpoint's
//    component was just recomputed).  A batch that fragments one region of
//    a 10^6-node duplex therefore does work proportional to that region,
//    not to the whole live graph — previously every round re-merged every
//    live edge and re-scanned every live cross edge.
//
// 2. GMM pairwise connector — the O(N^2) inner loop of the geometric
//    multiplex generator (reference Hyperbolic.py:101-117): Fermi-Dirac
//    connection probability p = 1/(1 + (d/(mu*k*k'))^(1/T)) over all pairs.
//    Hidden-variable sampling (kappa/theta copulas) stays in numpy where
//    scipy's lambertw/erfinv live; only the pair loop is native.
//
// Build: g++ -O3 -shared -fPIC (see ../build.py). No external deps.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

using std::int32_t;
using std::int64_t;
using std::uint64_t;

// ---------------------------------------------------------------- union-find
// Epoch-stamped scratch union-find: begin() is O(1) (bumps an epoch instead
// of rewriting parent[]), find() lazily initializes a node the first time
// the current epoch touches it.  Used only inside relabel(), over the
// affected components' nodes — never O(N).
struct StampedUF {
  std::vector<int32_t> parent;
  std::vector<int32_t> size;
  std::vector<uint32_t> stamp;
  uint32_t epoch = 0;

  void init(int32_t n) {
    parent.resize(n);
    size.resize(n);
    stamp.assign(n, 0);
    epoch = 0;
  }
  // Returns true when the epoch wrapped: stamps kept beside this one (the
  // env's rr_stamp) must then be cleared too.
  bool begin() {
    if (++epoch == 0) {  // u32 wrap: invalidate all stamps once
      std::fill(stamp.begin(), stamp.end(), 0);
      epoch = 1;
      return true;
    }
    return false;
  }
  inline bool seen(int32_t x) const { return stamp[x] == epoch; }
  inline int32_t find(int32_t x) {
    if (stamp[x] != epoch) {
      stamp[x] = epoch;
      parent[x] = x;
      size[x] = 1;
      return x;
    }
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {  // path compression
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  inline void merge(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
  }
};

// ------------------------------------------------------------------ cascade
struct Layer {
  std::vector<int32_t> u, v;   // undirected edge endpoints
  std::vector<uint8_t> sever;  // persistent cascade-severed flag
  std::vector<uint8_t> alive;  // !sever && !covered[u] && !covered[v]
  int64_t alive_count = 0;
  std::vector<int64_t> new_sever;  // edge ids severed by the last cascade
  // CSR incidence: node -> incident edge ids (covering a node touches only
  // its own edges; the incremental sever test walks the other layer's
  // incidence of just-relabeled nodes)
  std::vector<int64_t> inc_ptr;
  std::vector<int64_t> inc_ids;

  int64_t m() const { return (int64_t)u.size(); }

  void build_incidence(int32_t n) {
    inc_ptr.assign(n + 1, 0);
    for (int64_t i = 0; i < m(); ++i) {
      ++inc_ptr[u[i] + 1];
      ++inc_ptr[v[i] + 1];
    }
    for (int32_t i = 0; i < n; ++i) inc_ptr[i + 1] += inc_ptr[i];
    inc_ids.resize(2 * m());
    std::vector<int64_t> cur(inc_ptr.begin(), inc_ptr.end() - 1);
    for (int64_t i = 0; i < m(); ++i) {
      inc_ids[cur[u[i]]++] = i;
      inc_ids[cur[v[i]]++] = i;
    }
  }
};

// Component records of one layer's partition.  comp_rec[x] == -1 means x is
// a singleton (no live edge in this layer): its implicit label is x itself,
// distinct from every other node — so two uncovered endpoints are in the
// same component iff their comp_rec ids are equal AND != -1.
//
// Stale-tolerant lists: nodes[r] may contain entries whose comp_rec moved
// on (covering sets comp_rec -1 without touching the list), and edges[r]
// may contain dead edge ids — both are filtered and compacted the next
// time r relabels.  rec_size[r] is the true member count (maintained
// eagerly), so the rank scan never touches the lists.
struct Recs {
  std::vector<int32_t> comp_rec;            // node -> record id | -1
  std::vector<std::vector<int32_t>> nodes;  // record -> member nodes (stale-
                                            //   tolerant; see above)
  std::vector<std::vector<int64_t>> edges;  // record -> edge ids (ditto)
  std::vector<int64_t> rec_size;            // record -> true member count
  std::vector<int32_t> free_ids;
  std::vector<int32_t> live;      // live record ids, unordered
  std::vector<int32_t> live_pos;  // record -> index into live | -1
  std::vector<uint8_t> aff_flag;  // record -> already in affected?
  std::vector<int32_t> affected;  // record ids with edge deaths pending

  void init(int32_t n) {
    comp_rec.assign(n, -1);
    nodes.clear();
    edges.clear();
    rec_size.clear();
    free_ids.clear();
    live.clear();
    live_pos.clear();
    aff_flag.clear();
    affected.clear();
  }
  int32_t alloc() {
    int32_t r;
    if (!free_ids.empty()) {
      r = free_ids.back();
      free_ids.pop_back();
      nodes[r].clear();
      edges[r].clear();
      rec_size[r] = 0;
    } else {
      r = (int32_t)nodes.size();
      nodes.emplace_back();
      edges.emplace_back();
      rec_size.push_back(0);
      live_pos.push_back(-1);
      aff_flag.push_back(0);
    }
    live_pos[r] = (int32_t)live.size();
    live.push_back(r);
    return r;
  }
  void destroy(int32_t r) {
    int32_t pos = live_pos[r];
    int32_t last = live.back();
    live[pos] = last;
    live_pos[last] = pos;
    live.pop_back();
    live_pos[r] = -1;
    aff_flag[r] = 0;
    free_ids.push_back(r);
  }
  inline void mark_affected(int32_t r) {
    if (r >= 0 && !aff_flag[r]) {
      aff_flag[r] = 1;
      affected.push_back(r);
    }
  }
};

struct DuplexEnv {
  int32_t n = 0;
  Layer layers[2];
  Recs recs[2];
  std::vector<uint8_t> covered;
  std::vector<double> weights;  // [2][n] node costs (degree-cost variant)
  double wsum[2] = {1.0, 1.0};
  int64_t rank = 0, max_rank = 0, t = 0;
  int64_t n_uncovered = 0;
  double score = 0.0;
  std::vector<double> curve;
  StampedUF uf;                    // relabel scratch (shared by both layers)
  std::vector<int32_t> root_rec;   // UF root -> new record id (same epoch)
  std::vector<int32_t> v_scratch;  // relabel node gather
  std::vector<int64_t> e_scratch;  // relabel edge gather

  void refresh_alive(int l) {
    Layer& L = layers[l];
    int64_t cnt = 0;
    for (int64_t i = 0; i < L.m(); ++i) {
      uint8_t a = !L.sever[i] && !covered[L.u[i]] && !covered[L.v[i]];
      L.alive[i] = a;
      if (a) ++cnt;
    }
    L.alive_count = cnt;
  }

  // root -> new record id, valid within the current uf epoch (a root is
  // always `seen`, so co-stamping with uf's epoch identifies a live
  // mapping).
  std::vector<uint32_t> rr_stamp;
  inline int32_t root_rec_for(Recs& R, int32_t root) {
    if (rr_stamp[root] != uf.epoch) {
      rr_stamp[root] = uf.epoch;
      root_rec[root] = R.alloc();
    }
    return root_rec[root];
  }

  // Recompute the partition of ONE affected record: union-find over its
  // still-alive edges, then keep the LARGEST child in place (same record
  // id, lists compacted in-place, no regroup) and extract only the smaller
  // children / newly-isolated nodes into fresh records.  Nodes whose
  // component assignment actually changed are appended to v_scratch — the
  // incident sever test only needs THOSE: a cross edge between two kept
  // nodes compares equal exactly as it did before the relabel (same record
  // id on both ends), and partitions only refine, so it cannot newly
  // straddle.  O(nodes + edges of the record), with no work proportional
  // to the unaffected rest of the graph.
  void relabel_record(int l, int32_t r) {
    Recs& R = recs[l];
    Layer& L = layers[l];
    // move the lists out: root_rec_for -> alloc() may grow R.nodes/R.edges
    // (invalidating references into them); moved-out locals stay stable
    std::vector<int32_t> rn = std::move(R.nodes[r]);
    std::vector<int64_t> re = std::move(R.edges[r]);
    // rr_stamp is co-stamped with uf's epoch, so a wrap clears it as well:
    // a stale stamp equal to the restarted epoch would map a root to a
    // record of an earlier relabel
    if (uf.begin()) std::fill(rr_stamp.begin(), rr_stamp.end(), 0);
    int32_t best_root = -1;
    int64_t best = 0;
    size_t we = 0;
    for (size_t k = 0; k < re.size(); ++k) {
      int64_t i = re[k];
      if (!L.alive[i]) continue;  // killed by covering or a sever
      uf.merge(L.u[i], L.v[i]);
      re[we++] = i;
      int32_t root = uf.find(L.u[i]);
      if (uf.size[root] > best) {
        best = uf.size[root];
        best_root = root;
      }
    }
    re.resize(we);
    size_t wn = 0;
    bool split = false;
    for (size_t k = 0; k < rn.size(); ++k) {
      int32_t x = rn[k];
      if (R.comp_rec[x] != r) continue;  // covered earlier: stale entry
      if (!uf.seen(x)) {                 // lost its last live edge here
        R.comp_rec[x] = -1;
        v_scratch.push_back(x);
        continue;
      }
      int32_t root = uf.find(x);
      if (root == best_root) {
        rn[wn++] = x;  // kept: same record id, no downstream retests
        continue;
      }
      int32_t nr = root_rec_for(R, root);
      R.comp_rec[x] = nr;
      R.nodes[nr].push_back(x);
      ++R.rec_size[nr];
      v_scratch.push_back(x);
      split = true;
    }
    rn.resize(wn);
    R.rec_size[r] = (int64_t)wn;
    if (split) {
      // split happened: move the smaller children's edges out
      size_t w2 = 0;
      for (size_t k = 0; k < re.size(); ++k) {
        int64_t i = re[k];
        int32_t root = uf.find(L.u[i]);
        if (root == best_root) {
          re[w2++] = i;
        } else {
          R.edges[root_rec[root]].push_back(i);
        }
      }
      re.resize(w2);
    }
    R.nodes[r] = std::move(rn);
    R.edges[r] = std::move(re);
    if (wn == 0) R.destroy(r);
  }

  // Relabel every affected record of layer l; v_scratch collects the nodes
  // whose component assignment changed (for the incident sever test).
  void relabel(int l) {
    Recs& R = recs[l];
    v_scratch.clear();
    // swap out: relabel_record may alloc records, but never re-marks l
    aff_scratch.assign(R.affected.begin(), R.affected.end());
    R.affected.clear();
    for (int32_t r : aff_scratch) {
      R.aff_flag[r] = 0;
      relabel_record(l, r);
    }
  }
  std::vector<int32_t> aff_scratch;

  // Alternating MCC sever loop over the affected sets; fills
  // layers[*].new_sever, sets rank.  Seeding: callers mark the components
  // of every node they covered (both layers) before calling.
  void cascade() {
    layers[0].new_sever.clear();
    layers[1].new_sever.clear();
    while (!recs[0].affected.empty() || !recs[1].affected.empty()) {
      for (int side = 0; side < 2; ++side) {
        if (recs[side].affected.empty()) continue;
        relabel(side);  // v_scratch := nodes whose side-component changed
        Recs& S = recs[side];
        Recs& O = recs[1 - side];
        Layer& other = layers[1 - side];
        // Only other-layer edges incident to just-changed nodes can have
        // newly straddled `side`'s partition (it only ever refines, and
        // kept nodes keep their record id, so their pairwise equality is
        // unchanged).
        for (int32_t x : v_scratch) {
          for (int64_t k = other.inc_ptr[x]; k < other.inc_ptr[x + 1]; ++k) {
            int64_t i = other.inc_ids[k];
            if (!other.alive[i]) continue;
            int32_t cu = S.comp_rec[other.u[i]];
            if (cu >= 0 && cu == S.comp_rec[other.v[i]]) continue;
            other.sever[i] = 1;
            other.alive[i] = 0;
            --other.alive_count;
            other.new_sever.push_back(i);
            // the dead edge's own-layer component must relabel next round
            O.mark_affected(O.comp_rec[other.u[i]]);
          }
        }
      }
    }
    // rank: largest layer-0 component over uncovered nodes.  Records hold
    // exactly the uncovered nodes of every component with >= 2 members;
    // isolated uncovered nodes are singletons of size 1.
    int64_t best = 0;
    for (int32_t r : recs[0].live) {
      int64_t s = recs[0].rec_size[r];
      if (s > best) best = s;
    }
    if (best == 0) best = n_uncovered > 0 ? 1 : 0;
    rank = best;
  }

  void reset() {
    std::fill(covered.begin(), covered.end(), 0);
    n_uncovered = n;
    for (int l = 0; l < 2; ++l) {
      std::fill(layers[l].sever.begin(), layers[l].sever.end(), 0);
      refresh_alive(l);
      // one seed record holding every node and edge; the first relabel
      // splits it into the true components and the full incident sever
      // scan it triggers reproduces the from-scratch alternating cascade
      Recs& R = recs[l];
      R.init(n);
      int32_t r0 = R.alloc();
      R.nodes[r0].resize(n);
      for (int32_t i = 0; i < n; ++i) R.nodes[r0][i] = i;
      R.edges[r0].resize(layers[l].m());
      for (int64_t i = 0; i < layers[l].m(); ++i) R.edges[r0][i] = i;
      std::fill(R.comp_rec.begin(), R.comp_rec.end(), r0);
      R.rec_size[r0] = n;
      R.mark_affected(r0);
    }
    cascade();
    score = 0.0;
    curve.assign(1, 1.0);
    t = 0;
  }

  // Cover node a: kill its incident edges (O(deg a)) and mark its two
  // components affected.
  inline void cover(int32_t a) {
    covered[a] = 1;
    --n_uncovered;
    for (int l = 0; l < 2; ++l) {
      Layer& L = layers[l];
      for (int64_t k = L.inc_ptr[a]; k < L.inc_ptr[a + 1]; ++k) {
        int64_t i = L.inc_ids[k];
        if (L.alive[i]) {
          L.alive[i] = 0;
          --L.alive_count;
        }
      }
      int32_t rc = recs[l].comp_rec[a];
      if (rc >= 0) {
        recs[l].mark_affected(rc);
        --recs[l].rec_size[rc];
        recs[l].comp_rec[a] = -1;
      }
    }
  }

  int64_t step(int32_t a, bool degree_cost) {
    cover(a);
    cascade();
    double norm = (double)rank / (double)std::max<int64_t>(max_rank, 1);
    if (degree_cost) {
      double cost = 0.5 * (weights[a] / wsum[0] + weights[n + a] / wsum[1]);
      score += norm * cost;
    } else {
      score += norm / (double)n;
    }
    curve.push_back(norm);
    ++t;
    return rank;
  }

  // Batched removal: cover up to k nodes, run ONE cascade, append the
  // post-batch norm once per removed node.  Already-covered / out-of-range
  // entries are skipped.  Returns the number of nodes actually removed.
  //
  // Approximation contract (the StepRatio amortization the 10^6-node path
  // needs — per-removal cascades make a full dismantling Θ(N²)): the FINAL
  // state (covered set, severed set, rank, terminal) is EXACTLY the
  // sequential result — the MCC fixed point after removing a set is
  // order-independent because components only ever split — but the k curve
  // entries all take the post-batch rank, so the score contribution of the
  // batch is underestimated by at most k·(rank_pre − rank_post)/(max_rank·n);
  // summed over a whole dismantling the bias is ≤ k/n (one part per
  // thousand at StepRatio 0.001).
  int64_t step_many(const int64_t* actions, int64_t k, bool degree_cost) {
    int64_t removed = 0;
    static thread_local std::vector<int32_t> done;
    done.clear();
    for (int64_t j = 0; j < k; ++j) {
      if (actions[j] < 0 || actions[j] >= n) continue;
      int32_t a = (int32_t)actions[j];
      if (covered[a]) continue;
      cover(a);
      done.push_back(a);
      ++removed;
    }
    if (!removed) return 0;
    cascade();
    double norm = (double)rank / (double)std::max<int64_t>(max_rank, 1);
    for (int32_t a : done) {
      if (degree_cost) {
        double cost =
            0.5 * (weights[a] / wsum[0] + weights[n + a] / wsum[1]);
        score += norm * cost;
      } else {
        score += norm / (double)n;
      }
      curve.push_back(norm);
    }
    t += removed;
    return removed;
  }

  bool terminal() const {
    return !(layers[0].alive_count > 0 && layers[1].alive_count > 0);
  }
};

// ---------------------------------------------------------------- GMM rng
// splitmix64 -> xoshiro256+ (public-domain constructions)
struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t result = s[0] + s[3];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline double uniform() {  // [0, 1)
    return (double)(next() >> 11) * 0x1.0p-53;
  }
};

}  // namespace

extern "C" {

// ---- duplex cascade env -----------------------------------------------

void* mdc_env_create(int64_t n, const int64_t* e0, int64_t m0,
                     const int64_t* e1, int64_t m1, const double* weights) {
  auto* env = new DuplexEnv();
  env->n = (int32_t)n;
  env->covered.assign(n, 0);
  env->uf.init((int32_t)n);
  env->root_rec.assign(n, -1);
  env->rr_stamp.assign(n, 0);
  const int64_t* es[2] = {e0, e1};
  int64_t ms[2] = {m0, m1};
  for (int l = 0; l < 2; ++l) {
    Layer& L = env->layers[l];
    L.u.resize(ms[l]);
    L.v.resize(ms[l]);
    for (int64_t i = 0; i < ms[l]; ++i) {
      L.u[i] = (int32_t)es[l][2 * i];
      L.v[i] = (int32_t)es[l][2 * i + 1];
    }
    L.sever.assign(ms[l], 0);
    L.alive.assign(ms[l], 0);
    L.build_incidence((int32_t)n);
  }
  if (weights) {
    env->weights.assign(weights, weights + 2 * n);
  } else {
    env->weights.assign(2 * n, 1.0);
  }
  for (int l = 0; l < 2; ++l) {
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) s += env->weights[l * n + i];
    env->wsum[l] = s;
  }
  env->reset();
  env->max_rank = env->rank;  // intact LMCC (reference graph.py ori_rank)
  return env;
}

void mdc_env_destroy(void* p) { delete (DuplexEnv*)p; }
void mdc_env_reset(void* p) { ((DuplexEnv*)p)->reset(); }

int64_t mdc_env_step(void* p, int64_t a, int32_t degree_cost) {
  return ((DuplexEnv*)p)->step((int32_t)a, degree_cost != 0);
}

// Batched removal (StepRatio amortization): ONE cascade for k removals.
// Returns the number of nodes actually removed (skips covered/oob).
int64_t mdc_env_step_many(void* p, const int64_t* actions, int64_t k,
                          int32_t degree_cost) {
  return ((DuplexEnv*)p)->step_many(actions, k, degree_cost != 0);
}

int64_t mdc_env_rank(void* p) { return ((DuplexEnv*)p)->rank; }
int64_t mdc_env_max_rank(void* p) { return ((DuplexEnv*)p)->max_rank; }
double mdc_env_score(void* p) { return ((DuplexEnv*)p)->score; }
int32_t mdc_env_terminal(void* p) { return ((DuplexEnv*)p)->terminal(); }
int64_t mdc_env_t(void* p) { return ((DuplexEnv*)p)->t; }

int64_t mdc_env_curve_len(void* p) {
  return (int64_t)((DuplexEnv*)p)->curve.size();
}
void mdc_env_curve(void* p, double* out) {
  auto& c = ((DuplexEnv*)p)->curve;
  std::memcpy(out, c.data(), c.size() * sizeof(double));
}

// Edge ids severed by the most recent reset/step cascade.
int64_t mdc_env_new_sever_count(void* p, int32_t layer) {
  return (int64_t)((DuplexEnv*)p)->layers[layer].new_sever.size();
}
void mdc_env_new_sever(void* p, int32_t layer, int64_t* out) {
  auto& env = *(DuplexEnv*)p;
  auto& ids = env.layers[layer].new_sever;
  auto& L = env.layers[layer];
  for (size_t i = 0; i < ids.size(); ++i) {
    out[2 * i] = L.u[ids[i]];
    out[2 * i + 1] = L.v[ids[i]];
  }
}

// Persistent severed-edge mask of a layer (uint8[m]).
void mdc_env_sever_mask(void* p, int32_t layer, uint8_t* out) {
  auto& L = ((DuplexEnv*)p)->layers[layer];
  std::memcpy(out, L.sever.data(), L.sever.size());
}

// Live-edge mask of a layer (for terminal/valid-action queries).
void mdc_env_alive_nodes(void* p, int32_t layer, uint8_t* out) {
  auto& env = *(DuplexEnv*)p;
  std::memset(out, 0, env.n);
  Layer& L = env.layers[layer];
  for (int64_t i = 0; i < L.m(); ++i) {
    if (L.alive[i]) {
      out[L.u[i]] = 1;
      out[L.v[i]] = 1;
    }
  }
}

// Set the relabel union-find's epoch counter (test hook for the u32 wrap).
void mdc_env_set_uf_epoch(void* p, uint32_t epoch) {
  ((DuplexEnv*)p)->uf.epoch = epoch;
}

// ---- GMM pairwise connector --------------------------------------------

// Fermi-Dirac pairwise connection over all i<j: dist = (n/2pi) * circular
// angular distance, chi = dist/(mu*k_i*k_j), p = 1/(1+chi^(1/T)).
// Returns the number of edges written, or -1 if cap was too small.
int64_t mdc_gmm_connect(int64_t n, const double* kappa, const double* theta,
                        double T, double mu, uint64_t seed, int32_t* out,
                        int64_t cap) {
  Xoshiro rng(seed);
  const double two_pi = 2.0 * M_PI;
  const double inv_T = 1.0 / T;
  const double scale = (double)n / two_pi;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double ki = kappa[i], ti = theta[i];
    for (int64_t j = i + 1; j < n; ++j) {
      double dt = std::fabs(ti - theta[j]);
      double dist = scale * std::fabs(M_PI - std::fabs(M_PI - dt));
      double chi = dist / (mu * ki * kappa[j]);
      double p = 1.0 / (1.0 + std::pow(chi, inv_T));
      if (rng.uniform() < p) {
        if (cnt >= cap) return -1;
        out[2 * cnt] = (int32_t)i;
        out[2 * cnt + 1] = (int32_t)j;
        ++cnt;
      }
    }
  }
  return cnt;
}

}  // extern "C"
