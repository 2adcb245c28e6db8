#include "tracing.h"

namespace hvdtpu {

ClockEstimate EstimateClockOffset(const std::vector<ClockSample>& samples) {
  ClockEstimate best;
  int64_t best_rtt = 0;
  for (const ClockSample& s : samples) {
    const int64_t rtt = s.t3 - s.t1;
    if (rtt < 0) continue;  // clock went backwards / bogus sample
    if (!best.valid || rtt < best_rtt) {
      best_rtt = rtt;
      // The reply timestamp t2 was taken somewhere inside [t1, t3]; assuming
      // the midpoint symmetrizes the two legs, and the residual error is
      // bounded by half the round trip (+1 us granularity floor).
      best.offset_us = s.t2 - (s.t1 + s.t3) / 2;
      best.err_us = rtt / 2 + 1;
      best.valid = true;
    }
  }
  return best;
}

}  // namespace hvdtpu
