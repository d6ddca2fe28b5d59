// Sequential TFD novelty filter (native form of ops/tfd.is_new_structure_lru,
// itself the replay of reference embeds.py:47-69): iterate poses in
// generation order; accept a pose when its torsion fingerprint differs from
// EVERY previously accepted one by at least `thresh` total wrapped-L1
// degrees. The loop is inherently sequential (each acceptance extends the
// cache), which makes it a host bottleneck at production ensemble sizes in
// interpreted code — here it runs as a tight scalar loop with early exit on
// the (monotone, nonnegative) partial sums.
//
// Contract: fps (B, Q) float32 row-major; accept (B,) uint8 pre-filter
// (e.g. the clash mask); out (B,) uint8. Returns the number accepted.

// Also here: the cyclical embed's greedy angular dedup (the host-side
// sequential replay of reference embeds.py:621-628 ordering), another
// inherently-ordered scan that is interpreter-bound at scale.

#include <cstdint>
#include <cmath>

extern "C" int64_t tfd_lru_filter(const float* fps, int64_t B, int64_t Q,
                                  const uint8_t* accept, double thresh,
                                  uint8_t* out) {
    // cache holds row indices of accepted fingerprints
    int64_t* cache = new int64_t[B];
    int64_t n_cache = 0;

    for (int64_t i = 0; i < B; ++i) {
        out[i] = 0;
        if (!accept[i]) continue;
        const float* fi = fps + i * Q;
        bool novel = true;
        for (int64_t c = 0; c < n_cache && novel; ++c) {
            const float* fc = fps + cache[c] * Q;
            double s = 0.0;
            for (int64_t q = 0; q < Q; ++q) {
                double d = std::fabs(double(fi[q]) - double(fc[q]));
                if (d > 180.0) d = std::fabs(d - 360.0);
                s += d;
                if (s >= thresh) break;     // terms are nonnegative
            }
            if (s < thresh) novel = false;
        }
        if (novel) {
            out[i] = 1;
            cache[n_cache++] = i;
        }
    }
    delete[] cache;
    return n_cache;
}

// Greedy angular dedup over a batch of blocks: for each block b, accept
// angle t when it passed the clash screen and is not similar to any
// previously accepted angle of the same block (generation order).
// clash_ok (B, A) uint8; similar (B, A, A) uint8; out (B, A) uint8.
extern "C" void greedy_angular_dedup(const uint8_t* clash_ok,
                                     const uint8_t* similar,
                                     int64_t B, int64_t A,
                                     uint8_t* out) {
    int64_t* kept = new int64_t[A];
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t* ok_b = clash_ok + b * A;
        const uint8_t* sim_b = similar + b * A * A;
        uint8_t* out_b = out + b * A;
        int64_t n_kept = 0;
        for (int64_t t = 0; t < A; ++t) {
            out_b[t] = 0;
            if (!ok_b[t]) continue;
            const uint8_t* sim_t = sim_b + t * A;
            bool dup = false;
            for (int64_t k = 0; k < n_kept && !dup; ++k)
                dup = sim_t[kept[k]];
            if (!dup) {
                out_b[t] = 1;
                kept[n_kept++] = t;
            }
        }
    }
    delete[] kept;
}
