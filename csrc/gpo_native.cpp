// Native host-side engine for gaussian_process_optimization_tpu.
//
// The reference vendors native code for its hot loops (Cython/OpenMP in GPy).
// The numerics live in XLA on the device; what remains host-bound is the
// experiment-design generation — the maximin Latin-hypercube search loops
// (GPyOpt experiment_design/latin_mixed_design.py:9: candidate generation,
// min-pairwise-distance scoring, discrete stratification with representation
// checks, 10x retries) and Sobol sequence generation (sobol_design.py:8).
// Those are branchy O(iterations * n^2 * d) loops — native C++ here, with a
// pure-numpy fallback in bo/designs.py.
//
// Build: g++ -O3 -march=native -shared -fPIC gpo_native.cpp -o libgpo_native.so
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <random>

extern "C" {

// ----------------------------------------------------------------- utilities
static double min_pairwise_dist_impl(const double* X, int n, int d) {
    double best = 1e300;
    for (int i = 0; i < n; ++i) {
        for (int j = i + 1; j < n; ++j) {
            double s = 0.0;
            const double* a = X + (size_t)i * d;
            const double* b = X + (size_t)j * d;
            for (int k = 0; k < d; ++k) {
                double diff = a[k] - b[k];
                s += diff * diff;
            }
            if (s < best) best = s;
        }
    }
    return std::sqrt(best);
}

double min_pairwise_dist(const double* X, int n, int d) {
    return min_pairwise_dist_impl(X, n, d);
}

// ------------------------------------------------------- maximin LHS (unit box)
// pyDOE criterion='maximin' equivalent: `iterations` random LHS candidates
// (random point within each stratum, permuted per dim), keep the one whose
// minimum pairwise distance is largest. Output in [0,1]^d, row-major (n, d).
void maximin_lhs(int n, int d, int iterations, uint64_t seed, double* out) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    std::vector<double> cand((size_t)n * d), best((size_t)n * d);
    std::vector<int> perm(n);
    double best_score = -1.0;
    for (int it = 0; it < iterations; ++it) {
        for (int j = 0; j < d; ++j) {
            for (int i = 0; i < n; ++i) perm[i] = i;
            std::shuffle(perm.begin(), perm.end(), rng);
            for (int i = 0; i < n; ++i)
                cand[(size_t)i * d + j] = (perm[i] + unif(rng)) / n;
        }
        double score = min_pairwise_dist_impl(cand.data(), n, d);
        if (score > best_score) {
            best_score = score;
            best = cand;
        }
    }
    std::memcpy(out, best.data(), sizeof(double) * (size_t)n * d);
}

// --------------------------------------------- stratified discrete mixed LHS
// The reference author's algorithm (latin_mixed_design.py:25-91): candidates are
// permuted stratified interval-start values in [0,1); a candidate is accepted
// only if, per dim, every level appears at least floor(frac * n / levels) times
// (when n >= levels); among accepted candidates maximize min pairwise distance;
// up to `retries` outer rounds of `iterations` candidates. Returns unit-interval
// start values (caller maps to actual level values); 1 if a representation-valid
// design was found, else 0 (last candidate written anyway).
int discrete_lhs(int n, int d, int iterations, int retries, const int* levels,
                 double frac, uint64_t seed, double* out) {
    std::mt19937_64 rng(seed);
    std::vector<double> cand((size_t)n * d), best((size_t)n * d);
    std::vector<int> perm(n);
    std::vector<int> counts;
    bool found = false;

    auto representation_ok = [&](const double* H) {
        for (int j = 0; j < d; ++j) {
            int L = levels[j];
            if (n < L) continue;
            int minimum = (int)std::max(std::floor(frac * n / L), 1.0);
            counts.assign(L, 0);
            for (int i = 0; i < n; ++i) {
                int idx = (int)(H[(size_t)i * d + j] * L);
                if (idx >= L) idx = L - 1;
                counts[idx]++;
            }
            for (int c : counts)
                if (c < minimum) return false;
        }
        return true;
    };

    for (int retry = 0; retry < retries && !found; ++retry) {
        double maxdist = 0.0;
        for (int it = 0; it < iterations; ++it) {
            for (int j = 0; j < d; ++j) {
                for (int i = 0; i < n; ++i) perm[i] = i;
                std::shuffle(perm.begin(), perm.end(), rng);
                for (int i = 0; i < n; ++i)
                    cand[(size_t)i * d + j] = (double)perm[i] / n;
            }
            double dist = min_pairwise_dist_impl(cand.data(), n, d);
            if (dist > maxdist && representation_ok(cand.data())) {
                maxdist = dist;
                best = cand;
                found = true;
            }
        }
    }
    if (!found) best = cand;  // reference gives up after retries and keeps the last
    std::memcpy(out, best.data(), sizeof(double) * (size_t)n * d);
    return found ? 1 : 0;
}

// ----------------------------------------------------------------- Sobol
// Gray-code Sobol with Joe-Kuo-style direction numbers for the first dims
// (sobol_design.py:8 used sobol_seq.i4_sobol_generate). Supports d <= 16.
static const int SOBOL_MAXD = 16;
// primitive polynomial degrees, coefficients a, and initial m values per dim (>=2)
static const int s_deg[SOBOL_MAXD - 1] = {1, 2, 3, 3, 4, 4, 5, 5, 5, 5, 5, 5, 6, 6, 6};
static const int s_a[SOBOL_MAXD - 1] = {0, 1, 1, 2, 1, 4, 2, 4, 7, 11, 13, 14, 1, 13, 16};
static const int s_minit[SOBOL_MAXD - 1][6] = {
    {1, 0, 0, 0, 0, 0}, {1, 3, 0, 0, 0, 0}, {1, 3, 1, 0, 0, 0}, {1, 1, 1, 0, 0, 0},
    {1, 1, 3, 3, 0, 0}, {1, 3, 5, 13, 0, 0}, {1, 1, 5, 5, 17, 0}, {1, 1, 5, 5, 5, 0},
    {1, 1, 7, 11, 19, 0}, {1, 1, 5, 1, 1, 0}, {1, 1, 1, 3, 11, 0}, {1, 3, 5, 5, 31, 0},
    {1, 3, 3, 9, 7, 49}, {1, 1, 1, 15, 21, 21}, {1, 3, 1, 13, 27, 49},
};

int sobol_points(int n, int d, double* out) {
    if (d < 1 || d > SOBOL_MAXD) return 0;
    const int BITS = 31;
    std::vector<std::vector<uint32_t>> V(d, std::vector<uint32_t>(BITS + 1));
    // dim 0: van der Corput
    for (int i = 1; i <= BITS; ++i) V[0][i] = 1u << (32 - i);
    for (int j = 1; j < d; ++j) {
        int sdeg = s_deg[j - 1];
        int a = s_a[j - 1];
        std::vector<uint32_t> m(sdeg + 1);
        for (int i = 1; i <= sdeg; ++i) m[i] = s_minit[j - 1][i - 1];
        for (int i = 1; i <= BITS; ++i) {
            if (i <= sdeg) {
                V[j][i] = m[i] << (32 - i);
            } else {
                uint32_t v = V[j][i - sdeg] ^ (V[j][i - sdeg] >> sdeg);
                for (int k = 1; k <= sdeg - 1; ++k)
                    if ((a >> (sdeg - 1 - k)) & 1) v ^= V[j][i - k];
                V[j][i] = v;
            }
        }
    }
    std::vector<uint32_t> x(d, 0);
    for (int i = 0; i < n; ++i) {
        if (i > 0) {
            // index of lowest zero bit of (i-1)
            uint32_t c = 1, value = i - 1;
            while (value & 1) { value >>= 1; ++c; }
            for (int j = 0; j < d; ++j) x[j] ^= V[j][c];
        }
        for (int j = 0; j < d; ++j)
            out[(size_t)i * d + j] = (double)x[j] / 4294967296.0;
    }
    return 1;
}

}  // extern "C"
