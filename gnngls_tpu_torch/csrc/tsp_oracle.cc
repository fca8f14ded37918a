// Native TSP label oracle: exact Held-Karp DP + 2-opt/relocate local search.
//
// Replaces the role of the reference's external C solvers (Concorde for
// optimal tours, gnngls/__init__.py:47-52; LKH-3 for forced-edge tours,
// gnngls/__init__.py:63-74) in label generation, which is host-side work
// (one solve per edge per instance — the data-gen hot loop, SURVEY §3.1).
// Exposed as a C ABI for ctypes; calls release the GIL implicitly, so Python
// thread pools parallelize across instances.
//
// Host code, not a GPU kernel: the port's copy of the JAX package's native
// oracle, built by gnngls_tpu_torch/data/native_oracle.py (one g++ call at
// first use, into build/gnngls_tpu_torch/, without -march=native: the code
// it emits does not depend on the CPU that built it).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Exact Held-Karp over cities 1..n-1 (depot 0 fixed). O(2^(n-1) * n^2).
// D is row-major (n, n).  tour_out gets n+1 entries (closed at depot).
double held_karp_impl(int n, const double* D, int32_t* tour_out) {
  const int m = n - 1;
  const size_t full = size_t(1) << m;
  std::vector<double> dp(full * m, kInf);
  std::vector<int32_t> parent(full * m, -1);
  auto d = [&](int a, int b) { return D[size_t(a) * n + b]; };

  for (int j = 0; j < m; ++j) dp[(size_t(1) << j) * m + j] = d(0, j + 1);

  for (size_t mask = 1; mask < full; ++mask) {
    for (int j = 0; j < m; ++j) {
      const double base = dp[mask * m + j];
      if (base == kInf || !(mask & (size_t(1) << j))) continue;
      for (int k = 0; k < m; ++k) {
        if (mask & (size_t(1) << k)) continue;
        const size_t nmask = mask | (size_t(1) << k);
        const double cand = base + d(j + 1, k + 1);
        if (cand < dp[nmask * m + k]) {
          dp[nmask * m + k] = cand;
          parent[nmask * m + k] = j;
        }
      }
    }
  }

  const size_t fullmask = full - 1;
  double best = kInf;
  int bestj = -1;
  for (int j = 0; j < m; ++j) {
    const double tot = dp[fullmask * m + j] + d(j + 1, 0);
    if (tot < best) { best = tot; bestj = j; }
  }

  // reconstruct
  std::vector<int32_t> rev;
  size_t mask = fullmask;
  int cur = bestj;
  while (cur != -1) {
    rev.push_back(cur + 1);
    const int pj = parent[mask * m + cur];
    mask &= ~(size_t(1) << cur);
    cur = pj;
  }
  tour_out[0] = 0;
  for (size_t i = 0; i < rev.size(); ++i) tour_out[i + 1] = rev[rev.size() - 1 - i];
  tour_out[n] = 0;
  return best;
}

double tour_cost_impl(int n, const double* D, const int32_t* tour) {
  double c = 0;
  for (int i = 0; i < n; ++i) c += D[size_t(tour[i]) * n + tour[i + 1]];
  return c;
}

// Best-improvement 2-opt + relocate descent (reference local_search
// semantics, gnngls/algorithms.py:111-132, without the isclose threshold —
// this oracle is for labels, not trajectory parity).
double local_search_impl(int n, const double* D, int32_t* tour) {
  auto d = [&](int a, int b) { return D[size_t(a) * n + b]; };
  double cost = tour_cost_impl(n, D, tour);
  bool improved = true;
  while (improved) {
    improved = false;
    // 2-opt
    {
      double best = -1e-10;
      int bi = -1, bj = -1;
      for (int i = 1; i < n; ++i) {
        for (int j = i + 2; j < n; ++j) {
          const double delta = d(tour[i], tour[j]) + d(tour[i - 1], tour[j - 1])
                             - d(tour[i], tour[i - 1]) - d(tour[j], tour[j - 1]);
          if (delta < best) { best = delta; bi = i; bj = j; }
        }
      }
      if (bi >= 0) {
        std::reverse(tour + bi, tour + bj);
        cost += best;
        improved = true;
      }
    }
    // relocate
    {
      double best = -1e-10;
      int bi = -1, bj = -1;
      for (int i = 1; i < n; ++i) {
        for (int j = 1; j < n; ++j) {
          if (i == j || i - j == 1) continue;
          const int a = tour[i - 1], b = tour[i], c2 = tour[i + 1];
          int dd, e;
          if (i < j) { dd = tour[j]; e = tour[j + 1]; }
          else { dd = tour[j - 1]; e = tour[j]; }
          const double delta = -d(a, b) - d(b, c2) + d(a, c2)
                             - d(dd, e) + d(dd, b) + d(b, e);
          if (delta < best) { best = delta; bi = i; bj = j; }
        }
      }
      if (bi >= 0) {
        int32_t node = tour[bi];
        if (bi < bj) {
          std::memmove(tour + bi, tour + bi + 1, sizeof(int32_t) * (bj - bi));
          tour[bj] = node;
        } else {
          std::memmove(tour + bj + 1, tour + bj, sizeof(int32_t) * (bi - bj));
          tour[bj] = node;
        }
        cost += best;
        improved = true;
      }
    }
  }
  return cost;
}

}  // namespace

extern "C" {

// Exact optimal closed tour.  Returns cost; tour_out needs n+1 slots.
double tsp_held_karp(int n, const double* D, int32_t* tour_out) {
  return held_karp_impl(n, D, tour_out);
}

// Exact optimal tour forced through edge (u, v), via big-M reduction.
double tsp_held_karp_fixed_edge(int n, const double* D, int u, int v,
                                int32_t* tour_out) {
  std::vector<double> D2(D, D + size_t(n) * n);
  double sum = 0;
  for (size_t i = 0; i < size_t(n) * n; ++i) sum += D[i];
  const double M = sum + 1.0;
  D2[size_t(u) * n + v] -= M;
  D2[size_t(v) * n + u] -= M;
  const double c = held_karp_impl(n, D2.data(), tour_out);
  return c + M;
}

// Nearest-neighbor construction + 2-opt/relocate descent.  Returns cost.
double tsp_local_search(int n, const double* D, int32_t* tour_out) {
  std::vector<char> visited(n, 0);
  visited[0] = 1;
  tour_out[0] = 0;
  for (int s = 1; s < n; ++s) {
    const int cur = tour_out[s - 1];
    double best = kInf;
    int bestj = -1;
    for (int j = 0; j < n; ++j) {
      if (!visited[j] && D[size_t(cur) * n + j] < best) {
        best = D[size_t(cur) * n + j];
        bestj = j;
      }
    }
    tour_out[s] = bestj;
    visited[bestj] = 1;
  }
  tour_out[n] = 0;
  return local_search_impl(n, D, tour_out);
}

// All-edges regret labels for one instance: for each of the E = n(n-1)/2
// edges (lexicographic (u,v), u<v), the forced-edge optimal (or locally
// optimal) cost.  Exact for n <= max_exact_n, else big-M + local search.
// costs_out needs E slots.  Returns the optimal (or heuristic) base cost.
double tsp_regret_costs(int n, const double* D, int max_exact_n,
                        double* costs_out) {
  std::vector<int32_t> tour(n + 1);
  const bool exact = n <= max_exact_n;
  double base;
  if (exact) {
    base = held_karp_impl(n, D, tour.data());
  } else {
    base = tsp_local_search(n, D, tour.data());
  }
  std::vector<char> in_sol(size_t(n) * n, 0);
  for (int i = 0; i < n; ++i) {
    in_sol[size_t(tour[i]) * n + tour[i + 1]] = 1;
    in_sol[size_t(tour[i + 1]) * n + tour[i]] = 1;
  }
  size_t e = 0;
  double sum = 0;
  for (size_t i = 0; i < size_t(n) * n; ++i) sum += D[i];
  const double M = sum + 1.0;
  for (int u = 0; u < n; ++u) {
    for (int v = u + 1; v < n; ++v, ++e) {
      if (in_sol[size_t(u) * n + v]) {
        costs_out[e] = base;
        continue;
      }
      std::vector<double> D2(D, D + size_t(n) * n);
      D2[size_t(u) * n + v] -= M;
      D2[size_t(v) * n + u] -= M;
      double c;
      if (exact) {
        c = held_karp_impl(n, D2.data(), tour.data());
      } else {
        c = tsp_local_search(n, D2.data(), tour.data());
      }
      costs_out[e] = c + M;
    }
  }
  return base;
}

}  // extern "C"
