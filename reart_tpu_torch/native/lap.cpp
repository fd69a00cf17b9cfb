// Dense linear assignment (Jonker-Volgenant / successive shortest paths).
//
// Host runtime component of reart_tpu_torch (the port's own copy of
// reart_tpu/native/lap.cpp): replaces the reference's
// scipy.linear_sum_assignment + multiprocessing.Pool fan-out
// (utils/model_utils.py:85-103) for the model-selection energy. Exact
// solver; the auction in reart_tpu_torch/ops/assignment.py is the
// epsilon-optimal path of the fit.
//
// Built on first use by reart_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -pthread lap.cpp -o _build/libreart_native_<hash>.so

#include <cstdint>
#include <limits>
#include <vector>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdlib>
#include <thread>

namespace {

// Successive-shortest-path assignment with dual potentials.
// RowFn: int -> const float* (the i-th cost row, length m). n <= m.
// v_init: optional initial column duals (length m) — e.g. negated prices
// from an auction presolve; the SSP invariant only requires matched
// edges to stay tight, so ANY starting v is exact FOR SQUARE problems
// (sum v[j] over the chosen columns is then matching-independent; JV's own
// column reduction is the classic non-zero example). For n < m the column
// SUBSET varies, so nonzero v biases the selection — callers must pass
// nullptr then (lap_points_batch enforces this).
// Writes row_to_col[n]. Returns 0 on success.
template <class RowFn>
int solve_one(int n, int m, RowFn row_of, const float* v_init,
              int32_t* row_to_col) {
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> u(n, 0.0), v(m + 1, 0.0), minv(m + 1);
    std::vector<int> p(m + 1, -1), way(m + 1, 0);
    std::vector<char> used(m + 1);
    if (v_init) {
        for (int j = 0; j < m; ++j) v[j] = static_cast<double>(v_init[j]);
    }

    for (int i = 0; i < n; ++i) {
        std::fill(minv.begin(), minv.end(), INF);
        std::fill(used.begin(), used.end(), 0);
        int j0 = m;  // virtual start column
        p[m] = i;
        do {
            used[j0] = 1;
            const int i0 = p[j0];
            const float* row = row_of(i0);
            double delta = INF;
            int j1 = -1;
            const double ui0 = u[i0];
            for (int j = 0; j < m; ++j) {
                if (used[j]) continue;
                const double cur = static_cast<double>(row[j]) - ui0 - v[j];
                if (cur < minv[j]) {
                    minv[j] = cur;
                    way[j] = j0;
                }
                if (minv[j] < delta) {
                    delta = minv[j];
                    j1 = j;
                }
            }
            if (j1 < 0) return -1;  // infeasible
            for (int j = 0; j <= m; ++j) {
                if (used[j]) {
                    u[p[j]] += delta;
                    v[j] -= delta;
                } else {
                    minv[j] -= delta;
                }
            }
            j0 = j1;
        } while (p[j0] != -1);
        // augment along the found path
        do {
            const int j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0 != m);
    }
    for (int j = 0; j < m; ++j) {
        if (p[j] >= 0 && p[j] < n) row_to_col[p[j]] = j;
    }
    return 0;
}

// Lazily materialized euclidean cost rows from two point clouds: the
// (n, m) matrix is never built up front (at 4096^2 x 9 frames that is
// 600 MB of host traffic for the energy metric); a row is computed once,
// the first time the shortest-path tree scans it.
struct PointRows {
    const float* src;  // (n, 3)
    const float* tgt;  // (m, 3)
    int m;
    std::vector<std::vector<float>> cache;

    PointRows(const float* s, const float* t, int n_, int m_)
        : src(s), tgt(t), m(m_), cache(n_) {}

    const float* operator()(int i) {
        std::vector<float>& row = cache[i];
        if (row.empty()) {
            row.resize(m);
            const float sx = src[3 * i], sy = src[3 * i + 1],
                        sz = src[3 * i + 2];
            for (int j = 0; j < m; ++j) {
                const float dx = sx - tgt[3 * j];
                const float dy = sy - tgt[3 * j + 1];
                const float dz = sz - tgt[3 * j + 2];
                row[j] = std::sqrt(dx * dx + dy * dy + dz * dz);
            }
        }
        return row.data();
    }
};

// Batch elements are independent LAPs: fan them across a thread pool
// (the native counterpart of the reference's multiprocessing.Pool in
// utils/model_utils.py:85-103). Sized by hardware_concurrency — override
// with REART_NATIVE_THREADS (any value <= 0 means sequential) — so a
// 1-core host degenerates to the plain sequential loop.
int batch_threads() {
    if (const char* env = std::getenv("REART_NATIVE_THREADS")) {
        return std::max(1, std::atoi(env));
    }
    const unsigned hw = std::thread::hardware_concurrency();
    return hw ? static_cast<int>(hw) : 1;
}

// Concurrent lap_points_batch solves each hold up to an (n, m) lazy row
// cache, so the pool multiplies peak host memory: bound it by a cache
// budget (default 1 GB, override REART_NATIVE_MEM_MB).
int points_threads(int n, int m) {
    long long budget_mb = 1024;
    if (const char* env = std::getenv("REART_NATIVE_MEM_MB")) {
        const long long v = std::atoll(env);
        if (v > 0) budget_mb = v;
    }
    const long long per_solve = static_cast<long long>(n) * m * 4;
    const long long cap =
        std::max(1LL, (budget_mb << 20) / std::max(per_solve, 1LL));
    return static_cast<int>(
        std::min<long long>(batch_threads(), cap));
}

// Exceptions (bad_alloc from the row caches / SSP vectors) must not escape
// a pool thread (std::terminate) or the extern "C" boundary (UB under
// ctypes): contained here as rc = -3, which the Python wrapper turns into
// the scipy fallback.
template <class SolveK>
int solve_guarded(SolveK& solve_k, int k) {
    try {
        return solve_k(k);
    } catch (...) {
        return -3;
    }
}

template <class SolveK>
int run_batch(int b, int max_threads, SolveK solve_k) {
    const int nthreads = std::min(b, max_threads);
    if (nthreads <= 1) {
        for (int k = 0; k < b; ++k) {
            const int rc = solve_guarded(solve_k, k);
            if (rc != 0) return rc;
        }
        return 0;
    }
    std::vector<int> rcs(b, 0);
    std::atomic<int> next{0};
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
        pool.emplace_back([&] {
            for (int k = next++; k < b; k = next++) {
                rcs[k] = solve_guarded(solve_k, k);
            }
        });
    }
    for (std::thread& th : pool) th.join();
    for (int k = 0; k < b; ++k) {
        if (rcs[k] != 0) return rcs[k];
    }
    return 0;
}

}  // namespace

extern "C" {

int lap_solve(int n, int m, const float* cost, int32_t* row_to_col) {
    if (n > m) return -2;
    auto row_of = [&](int i) { return cost + static_cast<size_t>(i) * m; };
    return solve_one(n, m, row_of, nullptr, row_to_col);
}

// Batched entry: cost (b, n, m) row-major, out (b, n).
int lap_solve_batch(int b, int n, int m, const float* cost, int32_t* out) {
    if (n > m) return -2;
    return run_batch(b, batch_threads(), [=](int k) {
        const float* ck = cost + static_cast<size_t>(k) * n * m;
        auto row_of = [=](int i) { return ck + static_cast<size_t>(i) * m; };
        return solve_one(n, m, row_of, nullptr,
                         out + static_cast<size_t>(k) * n);
    });
}

// Batched euclidean-cost entry: src (b, n, 3), tgt (b, m, 3), optional
// v_init (b, m) initial column duals (pass NULL for cold start), out (b, n).
int lap_points_batch(int b, int n, int m, const float* src, const float* tgt,
                     const float* v_init, int32_t* out) {
    if (n > m) return -2;
    return run_batch(b, points_threads(n, m), [=](int k) {
        PointRows rows(src + static_cast<size_t>(k) * n * 3,
                       tgt + static_cast<size_t>(k) * m * 3, n, m);
        // warm duals are only exactness-preserving when n == m (see above)
        const float* vk = (v_init && n == m)
            ? v_init + static_cast<size_t>(k) * m : nullptr;
        return solve_one(n, m, rows, vk,
                         out + static_cast<size_t>(k) * n);
    });
}

}  // extern "C"
