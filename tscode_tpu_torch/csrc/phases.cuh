// Cycle counts by phase, for profiling builds only. Built with
// -DTT_PHASES (tools/kernel_phases.py builds such a copy of a library
// beside the real one), a kernel sums clock64() laps and counts into
// slots of its own and adds them to the record that set_prof points
// g_prof at. Without TT_PHASES every macro below is empty, its arguments
// are not evaluated, and TtLaps's members are empty inline functions, so
// the kernel compiles as if they were not there.
#pragma once

#ifdef TT_PHASES

#include <cuda_runtime.h>

__device__ long long* g_prof;

extern "C" int set_prof(void* p) {
  return (int)cudaMemcpyToSymbol(g_prof, &p, sizeof(p));
}

// n slots, zeroed, and the clock of the last lap
#define TT_START(n)         \
  long long tt_slot[n] = {}; \
  long long tt_t = clock64()
// a new lap starts here
#define TT_RESTART() (tt_t = clock64())
// the cycles since the last lap into slot i
#define TT_LAP(i)                          \
  do {                                     \
    const long long tt_now = clock64();    \
    tt_slot[i] += tt_now - tt_t;           \
    tt_t = tt_now;                         \
  } while (0)
// a count into slot i
#define TT_ADD(i, v) (tt_slot[i] += (v))
// where `who`, the n slots added to record `rec` of g_prof (n values)
#define TT_FLUSH(n, rec, who)                                   \
  do {                                                          \
    if (g_prof && (who)) {                                      \
      long long* tt_p = g_prof + (long long)(rec) * (n);        \
      for (int tt_i = 0; tt_i < (n); ++tt_i)                    \
        tt_p[tt_i] += tt_slot[tt_i];                            \
    }                                                           \
  } while (0)

// the same as an object that a kernel hands to its device functions:
// N slots, lap(i), add(i, v), flush(rec, who)
template <int N>
struct TtLaps {
  long long slot[N];
  long long t;
  // the clock, read in device code only (the host pass parses the body)
  __device__ __forceinline__ static long long clock() {
#ifdef __CUDA_ARCH__
    return clock64();
#else
    return 0;
#endif
  }
  __device__ __forceinline__ TtLaps() : t(clock()) {
    for (int i = 0; i < N; ++i) slot[i] = 0;
  }
  __device__ __forceinline__ void lap(int i) {
    const long long now = clock();
    slot[i] += now - t;
    t = now;
  }
  __device__ __forceinline__ void add(int i, long long v) { slot[i] += v; }
  __device__ __forceinline__ void flush(long long rec, bool who) const {
    if (g_prof && who)
      for (int i = 0; i < N; ++i) g_prof[rec * N + i] += slot[i];
  }
};

#else

template <int N>
struct TtLaps {
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void flush(long long, bool) const {}
};

#define TT_START(n)
#define TT_RESTART()
#define TT_LAP(i)
#define TT_ADD(i, v)
#define TT_FLUSH(n, rec, who)

#endif
