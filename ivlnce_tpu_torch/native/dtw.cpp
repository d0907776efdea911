// Windowed symmetric1 DTW over 3D position sequences — the tour-nDTW
// inner loop (reference habitat_extensions/tour_ndtw.py:114-124 via
// dtw-python). Tours reach thousands of positions; the O(N*M) DP in C++
// keeps split-level evaluation fast.
//
// Window encoding: a list of (row, col) alignment constraints; column col
// admits only row row (tour_ndtw.py:19-27). Pass n_align = 0 for
// unconstrained DTW.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// x: (n, 3) row-major, y: (m, 3); align: (n_align, 2) as int64 (row, col).
// returns the DTW distance (symmetric1, no normalization), or infinity if
// no valid path exists.
double dtw_windowed(const double* x, int64_t n, const double* y, int64_t m,
                    const int64_t* align, int64_t n_align) {
  if (n <= 0 || m <= 0) return std::numeric_limits<double>::infinity();

  // per-column allowed row (or -1 = all rows allowed)
  std::vector<int64_t> col_row(m, -1);
  for (int64_t a = 0; a < n_align; ++a) {
    col_row[align[a * 2 + 1]] = align[a * 2];
  }

  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> prev(m, INF), cur(m, INF);

  auto cost = [&](int64_t i, int64_t j) {
    const double dx = x[i * 3 + 0] - y[j * 3 + 0];
    const double dy = x[i * 3 + 1] - y[j * 3 + 1];
    const double dz = x[i * 3 + 2] - y[j * 3 + 2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };
  auto blocked = [&](int64_t i, int64_t j) {
    return col_row[j] >= 0 && col_row[j] != i;
  };

  // row 0
  double run = 0.0;
  bool dead = false;
  for (int64_t j = 0; j < m; ++j) {
    if (dead || blocked(0, j)) {
      dead = true;
      prev[j] = INF;
    } else {
      run += cost(0, j);
      prev[j] = run;
    }
  }

  for (int64_t i = 1; i < n; ++i) {
    for (int64_t j = 0; j < m; ++j) {
      if (blocked(i, j)) {
        cur[j] = INF;
        continue;
      }
      double best = prev[j];                       // down
      if (j > 0) {
        best = std::min(best, prev[j - 1]);        // diagonal
        best = std::min(best, cur[j - 1]);         // left
      }
      cur[j] = (best == INF) ? INF : best + cost(i, j);
    }
    std::swap(prev, cur);
  }
  return prev[m - 1];
}

}  // extern "C"
