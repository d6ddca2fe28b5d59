// Cycle counts by phase, for profiling builds only. Built with
// -DTT_PHASES (tools/kernel_phases.py builds such a copy of a library
// beside the real one), a kernel sums clock64() laps and counts into
// slots of its own and adds them to the record that set_prof points
// g_prof at. Without TT_PHASES every macro below is empty, its arguments
// are not evaluated, and the kernel compiles as if they were not there.
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

#else

#define TT_START(n)
#define TT_RESTART()
#define TT_LAP(i)
#define TT_ADD(i, v)
#define TT_FLUSH(n, rec, who)

#endif
