// Rank-order face clustering core (Zhu et al.), native implementation.
//
// The reference implements this algorithm as nested Python object loops
// (facial_clustering.py:24-204: per-pair neighbour scans inside an iterative
// cluster-merge loop) — O(C² · N²) Python-interpreted work per iteration.
// This is the port's host-side native core for it (a copy of the JAX
// package's native/rankorder.cc): the distance matrix comes from the device
// (one matmul); the sequential merge logic, which does not vectorize, runs
// here in C++. Exposed via ctypes (rankorder.py).
//
// Semantics match pipelines/clustering.py::_rank_order_clusters exactly
// (top-N neighbour lists with self at rank 0, min-linkage cluster distance,
// normalized distance gate, symmetric rank-order penalty gate, union-find
// connected components, iterate until no merge).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int> parent;
  explicit UnionFind(int n) : parent(n) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int find(int a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  }
  void unite(int a, int b) {
    int ra = find(a), rb = find(b);
    if (ra != rb) parent[rb] = ra;
  }
};

// argsort (stable) of one row, ascending.
void stable_argsort_row(const float* row, int n, std::vector<int>* order) {
  order->resize(n);
  std::iota(order->begin(), order->end(), 0);
  std::stable_sort(order->begin(), order->end(),
                   [&](int a, int b) { return row[a] < row[b]; });
}

// Symmetric rank-order distance between two neighbour lists (indices into the
// *cluster* id space). Mirrors _rank_order_clusters.rank_order_between.
double rank_order_between(const std::vector<int>& nbrs_i,
                          const std::vector<int>& nbrs_j, int i, int j) {
  auto asym = [](const std::vector<int>& a_list, const std::vector<int>& b_list,
                 int /*b*/) {
    // position lookup in b_list
    double penalty = 0.0;
    int n_count = static_cast<int>(a_list.size());
    for (int rank = 0; rank < static_cast<int>(a_list.size()); ++rank) {
      int e = a_list[rank];
      auto it = std::find(b_list.begin(), b_list.end(), e);
      if (it != b_list.end()) {
        int r_b = static_cast<int>(it - b_list.begin());
        if (r_b == 0) return std::pair<double, int>(penalty, rank + 1);
        penalty += r_b;
      }
    }
    return std::pair<double, int>(penalty, n_count);
  };
  auto [d_ij, n_i] = asym(nbrs_i, nbrs_j, j);
  auto [d_ji, n_j] = asym(nbrs_j, nbrs_i, i);
  return (d_ij + d_ji) / std::max(1, std::min(n_i, n_j));
}

}  // namespace

extern "C" {

// dist: n*n row-major pairwise distances.
// labels_out: n ints; faces in the same cluster share a label. Singleton
// clusters keep their own label (caller filters by size).
// Returns the number of merge iterations executed.
int rank_order_cluster(const float* dist, int n, int n_neighbours, int k_norm,
                       float t, float norm_threshold, int* labels_out) {
  if (n <= 0) return 0;
  const int nn = std::min(n_neighbours, n);
  // reference divisor: min(len(neighbour_list), K) — the list holds
  // min(n, n_neighbours) entries (facial_clustering.py:85-86)
  const int k_eff = std::min(nn, k_norm);

  // Per-face top-k absolute-distance sums (self included at rank 0).
  std::vector<double> face_topk_sum(n, 0.0);
  {
    std::vector<int> order;
    for (int i = 0; i < n; ++i) {
      stable_argsort_row(dist + static_cast<int64_t>(i) * n, n, &order);
      int k = std::min(k_norm, n);
      for (int r = 0; r < k; ++r)
        face_topk_sum[i] += dist[static_cast<int64_t>(i) * n + order[r]];
    }
  }

  std::vector<std::vector<int>> clusters(n);
  for (int i = 0; i < n; ++i) clusters[i] = {i};

  int iterations = 0;
  bool first = true;
  bool merged = true;
  while (first || merged) {
    first = false;
    ++iterations;
    const int m = static_cast<int>(clusters.size());

    // cluster min-linkage distance matrix
    std::vector<float> cmat(static_cast<int64_t>(m) * m, 0.0f);
    for (int i = 0; i < m; ++i) {
      for (int j = i; j < m; ++j) {
        float best = std::numeric_limits<float>::max();
        for (int fi : clusters[i]) {
          const float* row = dist + static_cast<int64_t>(fi) * n;
          for (int fj : clusters[j]) {
            best = std::min(best, row[fj]);
            if (best == 0.0f) break;
          }
          if (best == 0.0f) break;
        }
        cmat[static_cast<int64_t>(i) * m + j] = best;
        cmat[static_cast<int64_t>(j) * m + i] = best;
      }
    }

    // top-nn neighbour cluster lists
    const int cn = std::min(n_neighbours, m);
    std::vector<std::vector<int>> nbrs(m);
    {
      std::vector<int> order;
      for (int i = 0; i < m; ++i) {
        stable_argsort_row(cmat.data() + static_cast<int64_t>(i) * m, m, &order);
        nbrs[i].assign(order.begin(), order.begin() + cn);
      }
    }

    UnionFind uf(m);
    merged = false;
    for (int i = 0; i < m; ++i) {
      for (int j : nbrs[i]) {
        if (i == j) continue;
        double norm_sum = 0.0;
        for (int f : clusters[i]) norm_sum += face_topk_sum[f];
        for (int f : clusters[j]) norm_sum += face_topk_sum[f];
        const double denom =
            (norm_sum / k_eff) /
            (clusters[i].size() + clusters[j].size());
        const double normalized =
            cmat[static_cast<int64_t>(i) * m + j] / std::max(denom, 1e-12);
        if (normalized >= norm_threshold) continue;
        if (rank_order_between(nbrs[i], nbrs[j], i, j) >= t) continue;
        uf.unite(i, j);
        merged = true;
      }
    }

    // rebuild clusters from components
    std::vector<std::vector<int>> next;
    std::vector<int> root_slot(m, -1);
    for (int i = 0; i < m; ++i) {
      int r = uf.find(i);
      if (root_slot[r] < 0) {
        root_slot[r] = static_cast<int>(next.size());
        next.emplace_back();
      }
      auto& dst = next[root_slot[r]];
      dst.insert(dst.end(), clusters[i].begin(), clusters[i].end());
    }
    if (next.size() == clusters.size()) merged = false;
    clusters = std::move(next);
  }

  for (int c = 0; c < static_cast<int>(clusters.size()); ++c)
    for (int f : clusters[c]) labels_out[f] = c;
  return iterations;
}

}  // extern "C"
