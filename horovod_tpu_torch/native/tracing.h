// Cross-rank distributed tracing support (docs/tracing.md).
//
// Two pure components shared by the core and the data plane:
//
//  * TraceSampler — "every Nth op" gate for the per-hop span firehose
//    (HVDTPU_TRACE_SAMPLE). Op-level phases (NEGOTIATE / QUEUE / the op
//    activity) always ride the timeline; the per-hop SEND/RECV/REDUCE/
//    QUANTIZE child spans are emitted only for sampled ops so the hot path
//    stays at the ≈0% overhead budget.
//
//  * Clock-offset estimation — per-pair offset between this rank's
//    steady clock and rank 0's, from ping-pong samples piggybacked on the
//    form-up handshake (CtrlMsg::CLOCK in core.cpp) and refreshed
//    periodically through the control plane. The classic NTP-style
//    estimator: for the sample with the smallest round trip,
//    offset = t2 - (t1 + t3) / 2, with |error| bounded by half the round
//    trip (the reply can sit anywhere inside it). The offset ± error is
//    recorded into each rank's trace metadata so scripts/trace_analyze.py
//    can merge per-rank traces onto one global time axis.
//
// No reference analog: horovod/common/timeline.cc is strictly per-rank and
// leaves cross-rank correlation to the reader's eyeballs.
#pragma once

#include <cstdint>
#include <vector>

#include "thread_roles.h"

namespace hvdtpu {

// One ping-pong: t1 = local steady us at send, t2 = peer steady us at its
// reply, t3 = local steady us at receipt. All absolute microseconds.
struct ClockSample {
  int64_t t1 = 0;
  int64_t t2 = 0;
  int64_t t3 = 0;
};

// offset_us: peer_steady - local_steady (add to local timestamps to land on
// the peer's axis). err_us: half the best sample's round trip + 1 us of
// clock granularity — the bound recorded into the trace metadata.
struct ClockEstimate {
  int64_t offset_us = 0;
  int64_t err_us = 0;
  bool valid = false;
};

// Min-RTT estimator over `samples` (invalid samples — t3 < t1 — are
// skipped). Returns valid=false when nothing usable was measured.
ClockEstimate EstimateClockOffset(const std::vector<ClockSample>& samples);

// Every-Nth-op sampling gate. every_n <= 0 disables (SampleOp always
// false); every_n == 1 samples every op. The FIRST op is always sampled
// when enabled, so short jobs still produce hop spans. Single-driver like
// the DataPlane that owns it.
class TraceSampler {
 public:
  HVDTPU_CALLED_ON(background)
  void set_every_n(int64_t n) { every_n_ = n; }
  HVDTPU_CALLED_ON(background)
  int64_t every_n() const { return every_n_; }
  HVDTPU_CALLED_ON(background)
  bool enabled() const { return every_n_ > 0; }

  HVDTPU_CALLED_ON(background)
  bool SampleOp() {
    if (every_n_ <= 0) return false;
    return ops_++ % every_n_ == 0;
  }

 private:
  int64_t every_n_ = 0;
  int64_t ops_ = 0;
};

}  // namespace hvdtpu
