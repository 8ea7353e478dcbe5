// Native CPU HNSW — the competitor baseline for the bench harness.
//
// Role: the reference benchmarks RAFT against hnswlib on CPU
// (cpp/bench/ann/src/hnswlib/hnswlib_wrapper.h); this environment has
// no hnswlib, so the comparison baseline is this from-scratch C++17
// implementation of the HNSW algorithm (Malkov & Yashunin,
// arXiv:1603.09320): multi-layer proximity graph, greedy descent on
// upper layers, best-first ef-search on layer 0, heuristic neighbor
// selection with pruned-fill. Single-threaded by design — the bench
// host has one core, and a 1-thread baseline matches the reference's
// per-thread QPS accounting.
//
// C ABI only (loaded via ctypes from raft_tpu_torch/bench/hnsw_cpu.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

constexpr uint32_t kMagic = 0x72684e57;  // "rhNW"
constexpr int kMetricL2 = 0;
constexpr int kMetricIP = 1;

struct Hnsw {
  int64_t dim = 0;
  int64_t M = 16;         // links per node, upper layers
  int64_t M0 = 32;        // links per node, layer 0
  int64_t ef_construction = 200;
  int metric = kMetricL2;
  double mult = 0.0;      // level multiplier 1/ln(M)
  std::mt19937_64 rng;

  int64_t n = 0;
  std::vector<float> vecs;              // n * dim
  std::vector<int32_t> levels;          // per node
  // links[l][node] is a fixed-capacity row: [count, id0, id1, ...]
  // upper layers store rows only for nodes whose level >= l.
  // Layer rows are flat per level for cache friendliness.
  std::vector<std::vector<uint32_t>> links;  // per level, flat rows
  std::vector<int64_t> row_of;          // node -> row index per upper level? (see note)
  // Simpler: upper-level links are stored per node in a ragged table.
  std::vector<std::vector<std::vector<uint32_t>>> upper;  // [node][level-1] -> ids
  std::vector<std::vector<uint32_t>> level0;              // [node] -> ids
  int32_t max_level = -1;
  int64_t entry = -1;

  // visited-epoch tags (reused across searches)
  std::vector<uint32_t> visited;
  uint32_t epoch = 0;

  float dist(const float* a, const float* b) const {
    double acc = 0.0;
    if (metric == kMetricL2) {
      for (int64_t i = 0; i < dim; ++i) {
        const double d = double(a[i]) - double(b[i]);
        acc += d * d;
      }
      return float(acc);
    }
    for (int64_t i = 0; i < dim; ++i) acc += double(a[i]) * double(b[i]);
    return float(-acc);  // min-form inner product
  }

  const float* vec(int64_t id) const { return vecs.data() + id * dim; }

  uint32_t* touch_epoch() {
    if (++epoch == 0) {  // wrap: clear tags once every 2^32 searches
      std::fill(visited.begin(), visited.end(), 0u);
      epoch = 1;
    }
    visited.resize(size_t(n), 0u);
    return visited.data();
  }

  const std::vector<uint32_t>& neighbors(int64_t id, int level) const {
    if (level == 0) return level0[size_t(id)];
    return upper[size_t(id)][size_t(level - 1)];
  }
  std::vector<uint32_t>& neighbors_mut(int64_t id, int level) {
    if (level == 0) return level0[size_t(id)];
    return upper[size_t(id)][size_t(level - 1)];
  }

  // Greedy single-step descent used on layers above the target.
  int64_t greedy(const float* q, int64_t ep, int level) const {
    int64_t cur = ep;
    float curd = dist(q, vec(cur));
    bool improved = true;
    while (improved) {
      improved = false;
      for (uint32_t nb : neighbors(cur, level)) {
        const float d = dist(q, vec(nb));
        if (d < curd) {
          curd = d;
          cur = nb;
          improved = true;
        }
      }
    }
    return cur;
  }

  using HeapItem = std::pair<float, uint32_t>;

  // Best-first search on one layer; returns up to ef closest as a
  // max-heap (worst on top).
  std::priority_queue<HeapItem> search_layer(const float* q, int64_t ep,
                                             int level, size_t ef) {
    uint32_t* seen = touch_epoch();
    const uint32_t tag = epoch;
    std::priority_queue<HeapItem> best;                       // max-heap
    std::priority_queue<HeapItem, std::vector<HeapItem>,
                        std::greater<HeapItem>> cand;         // min-heap
    const float epd = dist(q, vec(ep));
    best.emplace(epd, uint32_t(ep));
    cand.emplace(epd, uint32_t(ep));
    seen[ep] = tag;
    while (!cand.empty()) {
      const auto [cd, c] = cand.top();
      if (cd > best.top().first && best.size() >= ef) break;
      cand.pop();
      for (uint32_t nb : neighbors(c, level)) {
        if (seen[nb] == tag) continue;
        seen[nb] = tag;
        const float d = dist(q, vec(nb));
        if (best.size() < ef || d < best.top().first) {
          cand.emplace(d, nb);
          best.emplace(d, nb);
          if (best.size() > ef) best.pop();
        }
      }
    }
    return best;
  }

  // Heuristic neighbor selection (algorithm 4 of the paper, with the
  // pruned-fill extension): keep a candidate only if it is closer to
  // the base point than to every already-kept neighbor — spreads the
  // links over the cluster structure; backfill from pruned if short.
  void select_neighbors(std::vector<HeapItem>& cand, size_t M,
                        std::vector<uint32_t>& out) const {
    std::sort(cand.begin(), cand.end());
    out.clear();
    std::vector<HeapItem> pruned;
    for (const auto& [d, id] : cand) {
      if (out.size() >= M) break;
      bool keep = true;
      for (uint32_t s : out) {
        if (dist(vec(id), vec(s)) < d) {
          keep = false;
          break;
        }
      }
      if (keep)
        out.push_back(id);
      else
        pruned.emplace_back(d, id);
    }
    for (const auto& [d, id] : pruned) {
      if (out.size() >= M) break;
      out.push_back(id);
    }
  }

  void shrink(int64_t id, int level) {
    auto& nbs = neighbors_mut(id, level);
    const size_t cap = size_t(level == 0 ? M0 : M);
    if (nbs.size() <= cap) return;
    std::vector<HeapItem> cand;
    cand.reserve(nbs.size());
    const float* base = vec(id);
    for (uint32_t nb : nbs) cand.emplace_back(dist(base, vec(nb)), nb);
    std::vector<uint32_t> kept;
    select_neighbors(cand, cap, kept);
    nbs = std::move(kept);
  }

  void add_one(const float* v) {
    const int64_t id = n++;
    vecs.insert(vecs.end(), v, v + dim);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    double u = uni(rng);
    if (u < 1e-12) u = 1e-12;
    const int32_t level = int32_t(-std::log(u) * mult);
    levels.push_back(level);
    level0.emplace_back();
    level0.back().reserve(size_t(M0));
    upper.emplace_back(size_t(std::max<int32_t>(level, 0)));
    if (entry < 0) {
      entry = id;
      max_level = level;
      return;
    }
    int64_t ep = entry;
    for (int l = max_level; l > level; --l) ep = greedy(v, ep, l);
    for (int l = std::min(level, max_level); l >= 0; --l) {
      auto found = search_layer(v, ep, l, size_t(ef_construction));
      std::vector<HeapItem> cand;
      cand.reserve(found.size());
      while (!found.empty()) {
        cand.push_back(found.top());
        found.pop();
      }
      std::vector<uint32_t> sel;
      select_neighbors(cand, size_t(M), sel);
      auto& mine = neighbors_mut(id, l);
      mine = sel;
      for (uint32_t nb : sel) {
        neighbors_mut(nb, l).push_back(uint32_t(id));
        shrink(nb, l);
      }
      if (!sel.empty()) ep = sel[0];  // closest kept neighbor
    }
    if (level > max_level) {
      max_level = level;
      entry = id;
    }
  }

  int search(const float* q, int64_t k, int64_t ef, float* out_d,
             int64_t* out_i) {
    if (n == 0) return -1;
    int64_t ep = entry;
    for (int l = max_level; l > 0; --l) ep = greedy(q, ep, l);
    auto best = search_layer(q, ep, 0, size_t(std::max(ef, k)));
    while (int64_t(best.size()) > k) best.pop();
    int64_t got = int64_t(best.size());
    for (int64_t i = got - 1; i >= 0; --i) {
      out_d[i] = best.top().first;
      out_i[i] = int64_t(best.top().second);
      best.pop();
    }
    for (int64_t i = got; i < k; ++i) {
      out_d[i] = INFINITY;
      out_i[i] = -1;
    }
    return 0;
  }
};

template <typename T>
bool wr(FILE* f, const T& v) {
  return std::fwrite(&v, sizeof(T), 1, f) == 1;
}
template <typename T>
bool wr_vec(FILE* f, const std::vector<T>& v) {
  const uint64_t sz = v.size();
  if (!wr(f, sz)) return false;
  return sz == 0 || std::fwrite(v.data(), sizeof(T), sz, f) == sz;
}
template <typename T>
bool rd(FILE* f, T& v) {
  return std::fread(&v, sizeof(T), 1, f) == 1;
}
template <typename T>
bool rd_vec(FILE* f, std::vector<T>& v) {
  uint64_t sz = 0;
  if (!rd(f, sz)) return false;
  v.resize(size_t(sz));
  return sz == 0 || std::fread(v.data(), sizeof(T), sz, f) == sz;
}

}  // namespace

extern "C" {

const char* hnsw_last_error() { return g_error.c_str(); }

void* hnsw_create(int64_t dim, int64_t M, int64_t ef_construction,
                  int metric, uint64_t seed) {
  if (dim <= 0 || M < 2 || ef_construction < 1 ||
      (metric != kMetricL2 && metric != kMetricIP)) {
    g_error = "hnsw_create: bad parameters";
    return nullptr;
  }
  auto* h = new Hnsw();
  h->dim = dim;
  h->M = M;
  h->M0 = 2 * M;
  h->ef_construction = ef_construction;
  h->metric = metric;
  h->mult = 1.0 / std::log(double(M));
  h->rng.seed(seed);
  return h;
}

int hnsw_add(void* ptr, const float* vecs, int64_t count) {
  if (!ptr || !vecs || count < 0) {
    g_error = "hnsw_add: bad arguments";
    return -1;
  }
  auto* h = static_cast<Hnsw*>(ptr);
  for (int64_t i = 0; i < count; ++i) h->add_one(vecs + i * h->dim);
  return 0;
}

int64_t hnsw_size(void* ptr) {
  return ptr ? static_cast<Hnsw*>(ptr)->n : -1;
}

// accessors so a loader can cross-check a cache file's recorded
// geometry/metric against what the caller expects — a mismatched file
// would otherwise stride queries by the WRONG dim at search time
int64_t hnsw_dim(void* ptr) {
  return ptr ? static_cast<Hnsw*>(ptr)->dim : -1;
}

int hnsw_metric(void* ptr) {
  return ptr ? static_cast<Hnsw*>(ptr)->metric : -1;
}

int hnsw_search(void* ptr, const float* queries, int64_t nq, int64_t k,
                int64_t ef, float* out_d, int64_t* out_i) {
  if (!ptr || !queries || nq < 0 || k < 1) {
    g_error = "hnsw_search: bad arguments";
    return -1;
  }
  auto* h = static_cast<Hnsw*>(ptr);
  for (int64_t i = 0; i < nq; ++i) {
    if (h->search(queries + i * h->dim, k, ef, out_d + i * k,
                  out_i + i * k) != 0) {
      g_error = "hnsw_search: empty index";
      return -1;
    }
  }
  return 0;
}

int hnsw_save(void* ptr, const char* path) {
  auto* h = static_cast<Hnsw*>(ptr);
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    g_error = std::string("hnsw_save: cannot open ") + path;
    return -1;
  }
  bool ok = wr(f, kMagic) && wr(f, h->dim) && wr(f, h->M) &&
            wr(f, h->ef_construction) && wr(f, h->metric) && wr(f, h->n) &&
            wr(f, h->max_level) && wr(f, h->entry) && wr_vec(f, h->vecs) &&
            wr_vec(f, h->levels);
  for (int64_t i = 0; ok && i < h->n; ++i) {
    ok = wr_vec(f, h->level0[size_t(i)]);
    for (const auto& row : h->upper[size_t(i)])
      ok = ok && wr_vec(f, row);
  }
  std::fclose(f);
  if (!ok) g_error = "hnsw_save: short write";
  return ok ? 0 : -1;
}

void* hnsw_load(const char* path) try {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    g_error = std::string("hnsw_load: cannot open ") + path;
    return nullptr;
  }
  auto* h = new Hnsw();
  uint32_t magic = 0;
  bool ok = rd(f, magic) && magic == kMagic && rd(f, h->dim) &&
            rd(f, h->M) && rd(f, h->ef_construction) && rd(f, h->metric) &&
            rd(f, h->n) && rd(f, h->max_level) && rd(f, h->entry);
  // validate scalar fields BEFORE any size-driven allocation: a corrupt
  // cache file must come back as an error the Python runner can recover
  // from (rebuild), never a std::bad_alloc escaping into ctypes
  ok = ok && h->dim > 0 && h->dim <= (1 << 20) && h->M >= 2 &&
       h->M <= (1 << 20) && h->n >= 0 && h->entry >= -1 &&
       h->entry < h->n;
  ok = ok && rd_vec(f, h->vecs) && rd_vec(f, h->levels) &&
       h->vecs.size() == size_t(h->n) * size_t(h->dim) &&
       h->levels.size() == size_t(h->n);
  // max_level must be consistent with levels[]: greedy()/neighbors()
  // index upper[entry][max_level-1], so a corrupt max_level above the
  // entry's actual level list is an out-of-bounds read at SEARCH time —
  // reject it here like every other corruption
  // an empty index is always saved with max_level == -1; for n > 0 the
  // levels[] cross-check below pins max_level (>= 0) exactly
  ok = ok && (h->n > 0 || h->max_level == -1);
  if (ok && h->n > 0) {
    ok = h->entry >= 0 && h->levels[size_t(h->entry)] == h->max_level;
    for (int64_t i = 0; ok && i < h->n; ++i)
      ok = h->levels[size_t(i)] >= 0 && h->levels[size_t(i)] <= h->max_level;
  }
  if (ok) {
    h->M0 = 2 * h->M;
    h->mult = 1.0 / std::log(double(h->M));
    h->level0.resize(size_t(h->n));
    h->upper.resize(size_t(h->n));
    for (int64_t i = 0; ok && i < h->n; ++i) {
      ok = rd_vec(f, h->level0[size_t(i)]);
      for (uint32_t nb : h->level0[size_t(i)])
        ok = ok && int64_t(nb) < h->n;  // stale ids read out of bounds
      h->upper[size_t(i)].resize(
          size_t(std::max<int32_t>(h->levels[size_t(i)], 0)));
      for (auto& row : h->upper[size_t(i)]) {
        ok = ok && rd_vec(f, row);
        for (uint32_t nb : row) ok = ok && int64_t(nb) < h->n;
      }
    }
  }
  std::fclose(f);
  if (!ok) {
    g_error = "hnsw_load: corrupt or truncated file";
    delete h;
    return nullptr;
  }
  return h;
} catch (const std::exception& e) {
  g_error = std::string("hnsw_load: ") + e.what();
  return nullptr;
}

void hnsw_free(void* ptr) { delete static_cast<Hnsw*>(ptr); }

}  // extern "C"
