// Native max-clique solvers for PCM outlier rejection.
//
// The reference vendors the Pattabiraman et al. "fast max-clique" C++
// library (C++/PCM/fmc: exact branch-and-bound `maxClique`,
// findClique.h:46, and heuristic `maxCliqueHeu`, :50-52) behind the
// PCM::MaxCliqueSolver hierarchy (PCM/PCM.hpp:15-191). This is the native
// equivalent for the framework's host-side PCM stage (dpgo_tpu/pcm.py):
// a Tomita-style exact branch-and-bound with greedy-coloring bound over
// 64-bit-word bitset adjacency, plus the same greedy heuristic.
//
// C API (ctypes-friendly, see dpgo_tpu/io/native.py):
//   dpgo_max_clique(adj, n, exact, out) -> clique size
//     adj: n*n uint8 row-major symmetric adjacency (diagonal ignored)
//     out: n uint8 membership mask of a maximum clique

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct CliqueBB {
  int64_t n;
  int words;
  std::vector<uint64_t> adj;  // n rows of `words` 64-bit words
  std::vector<uint8_t> cur, best;
  int best_size = 0;

  const uint64_t* row(int v) const {
    return adj.data() + static_cast<size_t>(v) * words;
  }
  bool connected(int v, int u) const {
    return (row(v)[u >> 6] >> (u & 63)) & 1;
  }

  // Greedy coloring of P; emits vertices ordered by ascending color class,
  // colors[i] = class index + 1 (an upper bound on the clique size within
  // the first i+1 vertices) — the Tomita MCQ bound.
  void color_sort(const std::vector<int>& P, std::vector<int>& order,
                  std::vector<int>& colors) const {
    std::vector<std::vector<int>> classes;
    for (int v : P) {
      size_t k = 0;
      for (; k < classes.size(); ++k) {
        bool conflict = false;
        for (int u : classes[k])
          if (connected(v, u)) { conflict = true; break; }
        if (!conflict) break;
      }
      if (k == classes.size()) classes.emplace_back();
      classes[k].push_back(v);
    }
    order.clear();
    colors.clear();
    for (size_t k = 0; k < classes.size(); ++k)
      for (int v : classes[k]) {
        order.push_back(v);
        colors.push_back(static_cast<int>(k) + 1);
      }
  }

  void expand(const std::vector<int>& P, int cur_size) {
    std::vector<int> order, colors;
    color_sort(P, order, colors);
    for (int idx = static_cast<int>(order.size()) - 1; idx >= 0; --idx) {
      if (cur_size + colors[idx] <= best_size) return;
      int v = order[idx];
      cur[v] = 1;
      std::vector<int> P2;
      P2.reserve(idx);
      for (int i2 = 0; i2 < idx; ++i2)
        if (connected(v, order[i2])) P2.push_back(order[i2]);
      if (P2.empty()) {
        if (cur_size + 1 > best_size) {
          best_size = cur_size + 1;
          best = cur;
        }
      } else {
        expand(P2, cur_size + 1);
      }
      cur[v] = 0;
    }
  }
};

}  // namespace

extern "C" int64_t dpgo_max_clique(const uint8_t* adj_in, int64_t n,
                                   int exact, uint8_t* out) {
  for (int64_t v = 0; v < n; ++v) out[v] = 0;
  if (n <= 0) return 0;

  CliqueBB bb;
  bb.n = n;
  bb.words = static_cast<int>((n + 63) / 64);
  bb.adj.assign(static_cast<size_t>(n) * bb.words, 0);
  std::vector<int> deg(n, 0);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t u = 0; u < n; ++u)
      if (u != v && adj_in[v * n + u]) {
        bb.adj[static_cast<size_t>(v) * bb.words + (u >> 6)] |=
            1ull << (u & 63);
        ++deg[v];
      }

  if (!exact) {
    // Greedy heuristic (fmc maxCliqueHeu): repeatedly take the
    // highest-degree candidate compatible with the clique so far.
    std::vector<uint8_t> cand(n, 1);
    int size = 0;
    for (;;) {
      int v = -1, bestdeg = -1;
      for (int64_t u = 0; u < n; ++u)
        if (cand[u] && deg[u] > bestdeg) { bestdeg = deg[u]; v = (int)u; }
      if (v < 0) break;
      out[v] = 1;
      ++size;
      for (int64_t u = 0; u < n; ++u)
        if (cand[u] && (u == v || !bb.connected(v, (int)u))) cand[u] = 0;
    }
    return size;
  }

  bb.cur.assign(n, 0);
  bb.best.assign(n, 0);
  // Degeneracy-flavored initial order: descending degree.
  std::vector<int> P(n);
  for (int64_t v = 0; v < n; ++v) P[v] = static_cast<int>(v);
  std::sort(P.begin(), P.end(),
            [&](int a, int b) { return deg[a] > deg[b]; });
  bb.expand(P, 0);
  for (int64_t v = 0; v < n; ++v) out[v] = bb.best[v];
  return bb.best_size;
}
