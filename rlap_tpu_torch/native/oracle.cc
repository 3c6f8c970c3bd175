// Sequential randomized-elimination oracle (CPU, C++17, no external deps).
//
// A from-scratch reimplementation of the *algorithm* of the reference's
// C++/Eigen elimination engine (rlap/csrc/preconditioner.cc) used as the
// ground truth for the TPU kernel's spectral-parity tests, and as a fast
// host-side fallback for small graphs. Design differs deliberately from the
// reference: instead of per-column doubly-linked `PriorityElement` lists with
// `reverse` cross-pointers, edges live once in a flat undirected pool
// {a, b, w, alive} and each node keeps a vector of pool ids; killing or
// merging a pool entry updates both endpoints at once, which removes the
// whole flip-index/reverse-pointer machinery.
//
// Semantics preserved (required for distributional parity):
//   * vertex orders: "random" (uniform shuffle), "degree" (min-degree with
//     the same update rule: -1 per duplicate merge / last-neighbor drop,
//     +1 per received clique edge), "coarsen" (min-degree + star contraction
//     with harmonic weights  w_j*w_k/(w_j+w_k)).
//   * neighbor orders o_n: asc/desc by weight, or shuffled.
//   * the clique sampler: f = w_j*colScale/wdeg; partner from the suffix
//     CDF  r = u*(csum-cum_j)+cum_j ;  new weight f*(1-f)*wdeg ;
//     colScale *= (1-f) ;  wdeg *= (1-f)^2 ; last neighbor dropped.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Edge {
  int64_t a, b;
  double w;
  bool alive;
};

struct Pool {
  std::vector<Edge> edges;
  std::vector<std::vector<int64_t>> incident;  // node -> pool ids (lazy)

  explicit Pool(int64_t n) : incident(n) {}

  int64_t add(int64_t a, int64_t b, double w) {
    int64_t id = (int64_t)edges.size();
    edges.push_back({a, b, w, true});
    incident[a].push_back(id);
    incident[b].push_back(id);
    return id;
  }

  int64_t other(int64_t id, int64_t v) const {
    const Edge& e = edges[id];
    return e.a == v ? e.b : e.a;
  }
};

// Collect node v's alive incident edges, merging duplicates (summing weights
// and killing the duplicates). Returns (neighbor, weight, pool id) triples.
// `deg` is updated like the reference's compressColumn does: the *neighbor*
// of a merged duplicate loses one incident entry.
struct Entry {
  int64_t nbr;
  double w;
  int64_t id;
};

std::vector<Entry> collect_merged(Pool& pool, int64_t v,
                                  std::vector<double>* deg) {
  auto& ids = pool.incident[v];
  std::vector<Entry> col;
  col.reserve(ids.size());
  size_t keep = 0;
  for (size_t i = 0; i < ids.size(); ++i) {
    int64_t id = ids[i];
    if (!pool.edges[id].alive) continue;
    ids[keep++] = id;  // compact the lazy list in place
    col.push_back({pool.other(id, v), pool.edges[id].w, id});
  }
  ids.resize(keep);
  if (col.empty()) return col;
  std::sort(col.begin(), col.end(),
            [](const Entry& x, const Entry& y) { return x.nbr < y.nbr; });
  std::vector<Entry> merged;
  merged.reserve(col.size());
  for (const Entry& e : col) {
    if (!merged.empty() && merged.back().nbr == e.nbr) {
      merged.back().w += e.w;
      pool.edges[merged.back().id].w = merged.back().w;
      pool.edges[e.id].alive = false;
      if (deg) {
        (*deg)[e.nbr] -= 1;  // neighbor's column lost an entry
        (*deg)[v] -= 1;
      }
    } else {
      merged.push_back(e);
    }
  }
  return merged;
}

void order_neighbors(std::vector<Entry>& col, int o_n, std::mt19937_64& gen) {
  switch (o_n) {
    case 0:  // asc
      std::sort(col.begin(), col.end(),
                [](const Entry& x, const Entry& y) { return x.w < y.w; });
      break;
    case 1:  // desc
      std::sort(col.begin(), col.end(),
                [](const Entry& x, const Entry& y) { return x.w > y.w; });
      break;
    default:  // random
      std::shuffle(col.begin(), col.end(), gen);
  }
}

// Lazy min-degree queue: entries re-validated against `deg` at pop time.
// Same pop semantics as the reference's bucket DegreePQ (ties broken
// arbitrarily), different structure.
struct LazyMinDegPQ {
  using Item = std::pair<double, int64_t>;  // (deg, node)
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> q;
  const std::vector<double>* deg;

  explicit LazyMinDegPQ(const std::vector<double>& d) : deg(&d) {
    for (int64_t i = 0; i < (int64_t)d.size(); ++i) q.push({d[i], i});
  }
  void touch(int64_t v) { q.push({(*deg)[v], v}); }
  int64_t pop(const std::vector<char>& done) {
    while (!q.empty()) {
      auto [d, v] = q.top();
      q.pop();
      if (done[v]) continue;
      if (d != (*deg)[v]) continue;  // stale key
      return v;
    }
    return -1;
  }
};

}  // namespace

#define RLAP_EXPORT __attribute__((visibility("default")))

extern "C" {

// edge_info: e rows of (u, v, w) doubles — both directions present
// (symmetric), like the reference op's input (rlap/ops.py:47).
// out: capacity out_cap rows of (row, col, val); *out_count set to rows
// written (both directions). Returns 0 on success, <0 on error.
RLAP_EXPORT int64_t rlap_approximate_cholesky(const double* edge_info, int64_t e,
                                  int64_t n, int64_t t, int o_v, int o_n,
                                  uint64_t seed, double* out, int64_t out_cap,
                                  int64_t* out_count) {
  if (n <= 0 || e < 0 || t < 0) return -1;
  Pool pool(n);
  std::vector<double> deg(n, 0.0);
  // keep each undirected edge once (u < v); drop zeros like the reference
  // reader (reader.cc:50-55). deg counts directed entries like Eigen nnz.
  for (int64_t i = 0; i < e; ++i) {
    int64_t u = (int64_t)edge_info[3 * i];
    int64_t v = (int64_t)edge_info[3 * i + 1];
    double w = edge_info[3 * i + 2];
    if (u < 0 || u >= n || v < 0 || v >= n) return -2;
    if (w == 0.0 || u == v) continue;
    if (u < v) pool.add(u, v, w);
    deg[u] += 1;
  }

  std::mt19937_64 gen(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  std::vector<char> done(n, 0);

  auto eliminate_clique = [&](int64_t i, std::vector<Entry>& col) {
    double csum = 0;
    std::vector<double> cum(col.size());
    for (size_t j = 0; j < col.size(); ++j) {
      csum += col[j].w;
      cum[j] = csum;
    }
    double wdeg = csum, colScale = 1.0;
    for (size_t j = 0; j + 1 < col.size(); ++j) {
      double w = col[j].w * colScale;
      double f = w / wdeg;
      double r = uni(gen) * (csum - cum[j]) + cum[j];
      size_t k = std::upper_bound(cum.begin(), cum.end(), r) - cum.begin();
      if (k >= col.size()) k = col.size() - 1;
      double wnew = f * (1 - f) * wdeg;
      pool.add(col[j].nbr, col[k].nbr, wnew);
      deg[col[k].nbr] += 1;  // DegreePQInc; col[j].nbr net unchanged
      colScale *= (1 - f);
      wdeg *= (1 - f) * (1 - f);
    }
    if (!col.empty()) deg[col.back().nbr] -= 1;  // last neighbor dropped
    for (const Entry& en : col) pool.edges[en.id].alive = false;
    deg[i] = 0;
  };

  auto eliminate_coarsen = [&](int64_t i, std::vector<Entry>& col) {
    double csum = 0;
    std::vector<double> cum(col.size());
    for (size_t j = 0; j < col.size(); ++j) {
      csum += col[j].w;
      cum[j] = csum;
    }
    double r = uni(gen) * csum;
    size_t k = std::upper_bound(cum.begin(), cum.end(), r) - cum.begin();
    if (k >= col.size()) k = col.size() - 1;
    double wk = col[k].w;
    deg[col[k].nbr] -= 1;  // edge (i,k) zeroed
    for (size_t j = 0; j < col.size(); ++j) {
      if (j == k) continue;
      double wnew = wk * col[j].w / (wk + col[j].w);
      pool.add(col[j].nbr, col[k].nbr, wnew);
      deg[col[k].nbr] += 1;
    }
    for (const Entry& en : col) pool.edges[en.id].alive = false;
    deg[i] = 0;
  };

  int64_t eliminated = 0;
  if (o_v == 0) {  // random order
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::shuffle(order.begin(), order.end(), gen);
    for (int64_t it = 0; it < t && it < n - 1; ++it) {
      int64_t i = order[it];
      auto col = collect_merged(pool, i, nullptr);
      order_neighbors(col, o_n, gen);
      eliminate_clique(i, col);
      done[i] = 1;
      ++eliminated;
    }
  } else {  // degree (1) or coarsen (2): min-degree order
    LazyMinDegPQ pq(deg);
    for (int64_t it = 0; it < t && it < n - 1; ++it) {
      int64_t i = pq.pop(done);
      if (i < 0) break;
      auto col = collect_merged(pool, i, &deg);
      // CoarseningPreconditioner forces o_n=random (preconditioner.cc:830-833)
      order_neighbors(col, o_v == 2 ? 2 : o_n, gen);
      if (o_v == 2) {
        if (!col.empty()) eliminate_coarsen(i, col);
      } else {
        eliminate_clique(i, col);
      }
      done[i] = 1;
      ++eliminated;
      for (const Entry& en : col) pq.touch(en.nbr);
    }
  }

  // harvest: merge surviving columns, emit both directions
  int64_t cnt = 0;
  for (int64_t v = 0; v < n; ++v) {
    if (done[v]) continue;
    auto col = collect_merged(pool, v, nullptr);
    for (const Entry& en : col) {
      if (en.w == 0.0) continue;
      if (cnt >= out_cap) return -3;
      out[3 * cnt] = (double)en.nbr;
      out[3 * cnt + 1] = (double)v;
      out[3 * cnt + 2] = en.w;
      ++cnt;
    }
  }
  *out_count = cnt;
  return eliminated;
}

// Marshalling check (parity with the reference `identity` op,
// rlap/csrc/py_api_binder.cc:71-76): copies in -> out.
RLAP_EXPORT void rlap_identity(const double* in, int64_t count, double* out) {
  std::memcpy(out, in, (size_t)count * sizeof(double));
}

// Whitespace-separated "(i, j, v)" text reader — the native equivalent of
// the reference TSVReader (rlap/csrc/reader.cc:14-34). 1-indexed input.
// Returns number of edges read, or <0 on error.
RLAP_EXPORT int64_t rlap_read_tsv(const char* path, double* out, int64_t cap) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int64_t cnt = 0;
  double i, j, v;
  while (fscanf(f, "%lf %lf %lf", &i, &j, &v) == 3) {
    if (cnt >= cap) {
      fclose(f);
      return -2;
    }
    out[3 * cnt] = i - 1;
    out[3 * cnt + 1] = j - 1;
    out[3 * cnt + 2] = v;
    ++cnt;
  }
  fclose(f);
  return cnt;
}

}  // extern "C"
