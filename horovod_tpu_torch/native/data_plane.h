// Host data plane: per-pair transport lanes (TCP mesh / shared memory) +
// collective algorithms.
//
// Fills the role of the reference's Gloo/MPI CPU data plane
// (horovod/common/ops/gloo_operations.cc, mpi_operations.cc): ring allreduce
// (reduce-scatter + allgather, like MPI/NCCL ring), rotation-based allgatherv,
// direct-send broadcast, and pairwise alltoallv — over pluggable transports
// (transport.h): plain TCP between hosts, POSIX shared-memory rings
// (shm_transport.h) between ranks sharing one. fp16/bf16 are accumulated in
// float (reference: half.{h,cc}).
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "common.h"
#include "compressed.h"
#include "flightrec.h"
#include "metrics.h"
#include "shm_transport.h"
#include "tracing.h"
#include "transport.h"

namespace hvdtpu {
class Timeline;
}

namespace hvdtpu {

struct PeerAddr {
  std::string host;
  int port = 0;
};

// Allreduce algorithm menu (reference fork: the IST-DASLab layer's
// ring / scatter-allgather / parameter-server / tree reduction selection).
// AUTO picks the latency algorithm (recursive doubling) at or below the
// crossover size and a bandwidth algorithm above it — the pipelined ring, or
// scatter-allgather once the group reaches sa_min_group ranks (where the
// ring's 2(n-1) serialized hops lose to SA's one round-trip of depth); the
// crossover and the SA choice are owned by the autotune machinery
// (autotune.h ParameterManager). PARAMETER_SERVER is explicit-selection
// only: workers ship the whole vector to a root that reduces and
// broadcasts — the reference PS baseline, never a win AUTO should pick.
enum class AllreduceAlgo : int32_t {
  AUTO = 0,
  RING = 1,
  RECURSIVE_DOUBLING = 2,
  TREE = 3,
  SCATTER_ALLGATHER = 4,
  PARAMETER_SERVER = 5,
};

// Default ring/latency-algorithm crossover: messages at or below this ride
// recursive doubling (log2(n) full-size exchanges beat 2(n-1) chunk rounds
// when per-round latency dominates). Conservative — measured on loopback,
// recursive doubling loses to the ring well before 256 KB at larger worlds;
// the autotuner owns the workload-specific value (4 KB .. 4 MB range).
constexpr int64_t kDefaultAlgoCrossoverBytes = 32 * 1024;
// Default ring pipeline segment: each ring chunk is streamed in segments of
// this size so reduction of segment k overlaps the transfer of segment k+1.
constexpr int64_t kDefaultSegmentBytes = 1 << 20;
// Default group size at which AUTO prefers scatter-allgather over the ring
// above the crossover: SA's direct exchange finishes in ~2 rounds of depth
// vs the ring's 2(n-1) serialized hops, but posts n-1 concurrent lanes —
// oversubscribed small worlds do better on the ring's two-lane schedule.
// Override with HVDTPU_ALLREDUCE_SA_GROUP (0 = never auto-pick SA).
constexpr int kDefaultSaMinGroup = 16;
// Broadcast latency floor: payloads at or below this ride the flat schedule
// (root sends to every peer directly — one hop of depth per peer, no
// store-and-forward handoff), larger ones the binomial tree (⌈log2 n⌉
// serialized rounds, but each rank forwards at most ⌈log2 n⌉ copies instead
// of the root shipping n-1). Override with HVDTPU_BCAST_FLAT_MAX.
constexpr int64_t kDefaultBcastFlatMaxBytes = 4096;

// Hierarchical two-level allreduce (HVDTPU_ALLREDUCE_HIER / hvdrun --hier):
// intra-host ring reduce-scatter/allgather over the (shm) local lanes, one
// leader per host running the flat ring/recursive-doubling over TCP.
// AUTO leaves the on/off choice to the Bayesian autotuner.
enum class HierMode : int32_t {
  OFF = 0,
  ON = 1,
  AUTO = 2,
};

// Fault injection (chaos harness; docs/fault-tolerance.md): at most one
// action armed per process via HVDTPU_CHAOS -> hvdtpu_set_chaos. Fires once,
// at the op_index-th collective this rank starts (allreduce, adasum,
// reduce-scatter and allgather all count) or the hop_index-th pairwise
// exchange it runs (1-based; exchanges count across every phase — segmented
// ring hops, recursive-doubling rounds, tree edges, hier leader phases and
// compressed hops alike, so a randomized hop lands anywhere in the
// schedule). Python owns the spec grammar (horovod_tpu/chaos.py); the native
// side only sees resolved integers.
struct ChaosSpec {
  enum class Action : int32_t {
    NONE = 0,
    KILL = 1,     // raise(SIGKILL): abrupt rank death mid-schedule
    HANG = 2,     // wedge the collective thread forever (live but silent)
    DELAY = 3,    // one-shot sleep of delay_ms (must NOT trip detection)
    DROP = 4,     // blackhole one peer lane (partition: silent, no EOF)
    CORRUPT = 5,  // flip one byte of the op's reduced/gathered output —
                  // seeded silent data corruption the divergence probe
                  // (docs/numerics.md) must catch. op trigger only.
  };
  Action action = Action::NONE;
  int64_t op_index = 0;   // 0 = not op-gated
  int64_t hop_index = 0;  // 0 = not hop-gated
  int64_t delay_ms = 0;
  int peer = -1;  // DROP: lane to blackhole (-1 = the triggering hop's peer)
};

// Concurrency contract (checked indirectly by `make analyze`: this type
// holds no mutex on purpose): a DataPlane is driven by exactly ONE thread —
// the core's background loop (plus the Python host thread during
// Listen/Connect, strictly before that loop starts). Collectives, setters
// and per-op counters are therefore unsynchronized by design. The only
// cross-thread members are the metrics-registry counters
// (total_raw_bytes/total_wire_bytes, relaxed atomics readable from any
// thread) and the worker threads SendRecvSegmented spawns internally, which
// are joined before the collective returns. Adding a second driving thread
// requires adding a Mutex + GUARDED_BY annotations here first.
class DataPlane {
 public:
  DataPlane(int rank, int size);
  ~DataPlane();

  // Start listening; returns the bound (ephemeral) port to advertise.
  HVDTPU_CALLED_ON(background)
  Status Listen();
  HVDTPU_CALLED_ON(any)
  int port() const { return port_; }

  // Establish the mesh: connect to lower ranks, accept from higher ranks.
  HVDTPU_CALLED_ON(background)
  Status Connect(const std::vector<PeerAddr>& peers);

  // Close every lane. clean: every rank agreed on the exit (the
  // negotiated shutdown), so no peer still reads, and the shm segments
  // close without their abort flag; else a peer still inside an op is
  // released by it.
  HVDTPU_CALLED_ON(background)
  void Shutdown(bool clean = false);

  // Break every lane NOW: flips the shared IoControl abort flag (sliced
  // reads observe it within one detect slice), aborts the shm segments
  // (futex waiters wake), and half-closes every TCP lane so blocked peers
  // see EOF — which is how failure detection cascades rank-to-rank across
  // the world within ~one detect slice per hop. Idempotent. Must run on the
  // collective-driving thread (same single-driver rule as the collectives;
  // cross-thread callers have the IoControl flags).
  HVDTPU_CALLED_ON(background)
  void Abort();
  HVDTPU_CALLED_ON(any)
  bool aborted() const { return io_ctl_.is_aborted(); }
  // First peer a lane failure was pinned on (-1 when none): names the
  // suspect in logs and the coordinator's dead-ranks accounting.
  HVDTPU_CALLED_ON(background)
  int failed_peer() const { return failed_peer_; }

  // Fault-detection knobs (docs/fault-tolerance.md), set before Start's
  // Connect. detect_ms bounds abort-propagation latency (poll slice =
  // detect_ms/5, clamped to [5, 100] ms); read_deadline_secs > 0 declares a
  // silent-but-open lane dead after that long with zero progress (0 = off);
  // formup_timeout_ms bounds Connect's accept phase.
  HVDTPU_CALLED_ON(background)
  void set_failure_detect_ms(int64_t ms) {
    if (ms <= 0) return;
    int64_t slice = ms / 5;
    io_ctl_.detect_slice_ms = slice < 5 ? 5 : (slice > 100 ? 100 : slice);
  }
  HVDTPU_CALLED_ON(background)
  void set_read_deadline_secs(double s) {
    io_ctl_.read_deadline_secs = s > 0 ? s : 0;
  }
  HVDTPU_CALLED_ON(background)
  void set_formup_timeout_ms(int64_t ms) {
    if (ms > 0) formup_timeout_ms_ = ms;
  }
  HVDTPU_CALLED_ON(background)
  void set_chaos(const ChaosSpec& spec) { chaos_ = spec; }

  // In-place allreduce over `count` elements (SUM/MIN/MAX/PRODUCT; AVERAGE
  // is SUM + caller-side postscale, reference operations.cc:928). Dispatches
  // by the configured algorithm: pipelined ring (reduce-scatter + allgather
  // with segment-level reduce/transfer overlap), recursive doubling, or
  // binomial tree; AUTO selects by message size vs the crossover.
  HVDTPU_CALLED_ON(background)
  Status Allreduce(void* data, int64_t count, DataType dtype, ReduceOp op);

  // Algorithm-selection knobs (hvdtpu_allreduce_algo surface + autotuned
  // crossover). Call from the thread that runs the collectives (the core's
  // background loop) or before it starts; values <= 0 are ignored.
  HVDTPU_CALLED_ON(background)
  void set_allreduce_algo(AllreduceAlgo algo) { algo_ = algo; }
  HVDTPU_CALLED_ON(background)
  void set_crossover_bytes(int64_t b) { if (b > 0) crossover_bytes_ = b; }
  HVDTPU_CALLED_ON(background)
  void set_segment_bytes(int64_t b) { if (b > 0) segment_bytes_ = b; }
  // AUTO's scatter-allgather gate: groups of at least this many ranks take
  // SA above the crossover (0 = never). set_sa_auto is the autotuner's
  // per-cycle choice on top of the static gate, mirroring set_hier_auto.
  HVDTPU_CALLED_ON(background)
  void set_sa_min_group(int64_t n) { if (n >= 0) sa_min_group_ = static_cast<int>(n); }
  HVDTPU_CALLED_ON(background)
  void set_sa_auto(bool on) { sa_auto_ = on; }
  // Broadcast flat/tree crossover (HVDTPU_BCAST_FLAT_MAX; 0 = always tree).
  HVDTPU_CALLED_ON(background)
  void set_bcast_flat_max(int64_t b) { if (b >= 0) bcast_flat_max_ = b; }
  HVDTPU_CALLED_ON(background)
  int64_t bcast_flat_max() const { return bcast_flat_max_; }
  HVDTPU_CALLED_ON(background)
  AllreduceAlgo allreduce_algo() const { return algo_; }
  HVDTPU_CALLED_ON(background)
  int64_t crossover_bytes() const { return crossover_bytes_; }
  HVDTPU_CALLED_ON(background)
  int64_t segment_bytes() const { return segment_bytes_; }
  HVDTPU_CALLED_ON(background)
  int sa_min_group() const { return sa_min_group_; }
  HVDTPU_CALLED_ON(background)
  bool sa_auto() const { return sa_auto_; }

  // Transport / topology knobs. set_shm_enabled and set_shm_ring_bytes must
  // be called before Connect (the lanes are negotiated there); hier mode may
  // change any time from the collective-driving thread, and set_hier_auto is
  // the autotuner's choice under HierMode::AUTO.
  HVDTPU_CALLED_ON(background)
  void set_shm_enabled(bool on) { shm_enabled_ = on; }
  HVDTPU_CALLED_ON(background)
  void set_shm_ring_bytes(int64_t b) { if (b > 0) shm_ring_bytes_ = b; }
  HVDTPU_CALLED_ON(background)
  void set_hier_mode(HierMode m) { hier_mode_ = m; }
  HVDTPU_CALLED_ON(background)
  void set_hier_auto(bool on) { hier_auto_ = on; }
  // Zero-copy lane knobs (docs/collectives.md "Zero-copy TCP lane").
  // Must be set before Connect: the TCP lanes probe at construction, the
  // shm lanes take their doorbell/NUMA policy at negotiation.
  HVDTPU_CALLED_ON(background)
  void set_tcp_zerocopy(ZeroCopyMode m) { tcp_zerocopy_ = m; }
  HVDTPU_CALLED_ON(background)
  void set_shm_numa(ShmNumaMode m) { shm_numa_ = m; }
  HVDTPU_CALLED_ON(background)
  void set_doorbell_batch(int64_t b) { if (b > 0) doorbell_batch_ = b; }
  HVDTPU_CALLED_ON(background)
  ZeroCopyMode tcp_zerocopy() const { return tcp_zerocopy_; }
  HVDTPU_CALLED_ON(background)
  HierMode hier_mode() const { return hier_mode_; }
  // True when Allreduce will take the two-level path: hier requested (or
  // autotuned on) and at least one host holds 2+ ranks. The predicate must
  // be identical on EVERY rank (it's a world-level property — leaders_ and
  // size_ agree everywhere), or ranks would split between the flat and
  // hierarchical schedules and deadlock.
  HVDTPU_CALLED_ON(background)
  bool hier_active() const {
    if (size_ <= 1 || leaders_.size() >= static_cast<size_t>(size_)) {
      return false;  // every host single-rank: hier degenerates to flat
    }
    return hier_mode_ == HierMode::ON ||
           (hier_mode_ == HierMode::AUTO && hier_auto_);
  }
  // Per-peer shm-ring occupancy (peer rank, buffered bytes) for the
  // memory-occupancy telemetry gauges (docs/profiling.md). Background
  // thread only, like the other lane walks.
  HVDTPU_CALLED_ON(background)
  void ShmOccupancy(std::vector<std::pair<int, int64_t>>* out) const;
  // Lane summary for the timeline / introspection: "tcp", "tcp-zc", "shm",
  // "shm+tcp", "shm+tcp-zc" ("local" before Connect / at size 1). Rebuilt
  // per call because the zero-copy tag is LIVE: an AUTO lane that detects
  // kernel-copied completions downgrades itself mid-run and the per-op
  // metric/timeline labels must follow. Collective-driving thread only.
  HVDTPU_CALLED_ON(background)
  const std::string& transport_label();
  HVDTPU_CALLED_ON(background)
  int shm_lane_count() const;  // peers reached over shared memory
  // Any TCP lane currently riding the zero-copy engine? (introspection +
  // tests; background thread only, like the label.)
  HVDTPU_CALLED_ON(background)
  bool zerocopy_active() const;
  HVDTPU_CALLED_ON(background)
  int num_hosts() const { return static_cast<int>(leaders_.size()); }

  // Per-op wire compression (compressed.h). The core calls
  // BeginCompressedOp before each allreduce with the effective mode for
  // that (fused) tensor — resolved from HVDTPU_COMPRESSION, the min-bytes
  // bypass and the skip-regex, identically on every rank — and the
  // tensor's error-feedback residual buffer (nullable). Collective-driving
  // (background) thread only. Compression applies to fp32 SUM/AVERAGE on
  // the ring and recursive-doubling paths (tree and the hierarchical
  // intra-host/gather stages stay raw; hier compresses the leader phase —
  // the slow cross-host link, the reference fork's premise).
  // quality (nullable): per-op quantization-quality accumulator
  // (gradstats.h) threaded into every WireCompress call this op makes —
  // the core reads MSE/SNR/residual-norm out of it at op completion
  // (docs/numerics.md).
  HVDTPU_CALLED_ON(background)
  void BeginCompressedOp(WireCompression c, float* residual,
                         GradQuality* quality = nullptr) {
    op_comp_ = c == WireCompression::AUTO ? WireCompression::NONE : c;
    op_residual_ = residual;
    op_quality_ = quality;
    if (quality != nullptr) quality->Reset();
  }
  HVDTPU_CALLED_ON(background)
  void EndCompressedOp() {
    op_comp_ = WireCompression::NONE;
    op_residual_ = nullptr;
    op_quality_ = nullptr;
  }

  // Payload accounting for the timeline's per-op raw_bytes/wire_bytes args
  // and the cumulative hvdtpu_wire_stats counters: raw = bytes this rank
  // would have sent uncompressed, wire = bytes actually sent. Reset by
  // Allreduce/AdasumAllreduce at entry; cumulative totals live in the
  // metrics registry (hvdtpu_allreduce_{raw,wire}_bytes_total) — the single
  // source of truth behind both hvdtpu_wire_stats and /metrics — whose
  // lock-free counters user threads may read while the background thread
  // runs ops.
  HVDTPU_CALLED_ON(background)
  int64_t op_raw_bytes() const { return op_raw_bytes_; }
  HVDTPU_CALLED_ON(background)
  int64_t op_wire_bytes() const { return op_wire_bytes_; }
  HVDTPU_CALLED_ON(any)
  int64_t total_raw_bytes() const { return raw_bytes_total_->Get(); }
  HVDTPU_CALLED_ON(any)
  int64_t total_wire_bytes() const { return wire_bytes_total_->Get(); }

  // Metrics registry to account into. The DataPlane constructor wires up a
  // private registry so standalone instances (unit tests, bench harness)
  // always have live counters; the core injects its own registry before
  // Listen() so data-plane series land in the worker's /metrics dump.
  HVDTPU_CALLED_ON(background)
  void set_metrics(Metrics* m);

  // Distributed tracing (docs/tracing.md): per-hop SEND/RECV/SENDRECV/
  // REDUCE/QUANTIZE child spans on the timeline's "hops" track, emitted for
  // every `sample_every_n`-th op (TraceSampler) so the un-sampled hot path
  // pays one branch per hop. The tracer outlives the plane (core owns
  // both); both setters are collective-driving-thread-only like the other
  // knobs (the core's ApplyTimelineRequest runs there).
  HVDTPU_CALLED_ON(background)
  void set_tracer(Timeline* t) { tracer_ = t; }
  HVDTPU_CALLED_ON(background)
  void set_trace_sample(int64_t n) { trace_sampler_.set_every_n(n); }
  HVDTPU_CALLED_ON(background)
  int64_t trace_sample() const { return trace_sampler_.every_n(); }
  // Always-on flight recorder (flightrec.h): every hop/reduce/quantize and
  // failure-detect event lands in the ring UNSAMPLED — five relaxed atomic
  // stores per event, no JSON — alongside whatever the sampled tracer
  // emits. Set before Connect (core owns the recorder; nullptr disables).
  HVDTPU_CALLED_ON(background)
  void set_flightrec(FlightRecorder* fr) {
    flight_ = fr != nullptr && fr->enabled() ? fr : nullptr;
  }
  // True while the CURRENT op is being sampled (core gates its own
  // tensor-level FUSION-WAIT spans on the same decision).
  HVDTPU_CALLED_ON(background)
  bool trace_sampling_op() const { return trace_op_; }
  // Always-on perf attribution (perfstats.h): when enabled, TraceHop also
  // accumulates this op's wait/wire/reduce/codec phase buckets (and the
  // slowest hop peer) unsampled — the core feeds them into PerfStats at op
  // completion. Same timestamping gate the flight recorder already pays.
  HVDTPU_CALLED_ON(background)
  void set_perf_enabled(bool on) { perf_on_ = on; }
  HVDTPU_CALLED_ON(background)
  int64_t op_wait_us() const { return op_wait_us_; }
  HVDTPU_CALLED_ON(background)
  int64_t op_wire_us() const { return op_wire_us_; }
  HVDTPU_CALLED_ON(background)
  int64_t op_reduce_us() const { return op_reduce_us_; }
  HVDTPU_CALLED_ON(background)
  int64_t op_codec_us() const { return op_codec_us_; }
  // Hop peer this op spent the most wait time on (-1 none): the wire-slow
  // anomaly's named suspect. Background thread only, like the accumulators.
  HVDTPU_CALLED_ON(background)
  int op_slow_peer() const { return op_slow_peer_; }
  // Label of the algorithm the LAST Allreduce actually ran ("ring",
  // "recursive_doubling", "tree", "scatter_allgather", "parameter_server",
  // with AUTO resolved by size; "hier" phases report the top-level
  // "hierarchical"). Background thread only — set by Allreduce, read by the
  // core's per-op metric labels.
  HVDTPU_CALLED_ON(background)
  const char* last_algo_label() const { return last_algo_label_; }

  // First-class allgather: gather variable-length byte blocks from
  // every rank; out = concatenated in rank order. block_bytes[r] gives each
  // rank's contribution size (negotiated per-rank dim-0 in the RESPONSES
  // frame). Dispatches like Allreduce: at or below the crossover the direct
  // pairwise rotation ("direct", n-1 full-duplex lanes), above it the ring
  // store-and-forward rotation ("ring", neighbor lanes only — the
  // allreduce's allgather phase generalized to ragged blocks). When the
  // core armed wire compression for the op (BeginCompressedOp; fp32 blocks
  // only), the ring variant ships quantize-once owner codes: every rank —
  // the owner included, via self-decode — decodes identical codes, so the
  // gathered vectors are bitwise identical world-wide. Full op lifecycle
  // (chaos trigger, cumulative byte counters, perf phases) like Allreduce.
  HVDTPU_CALLED_ON(background)
  Status Allgatherv(const void* in, int64_t in_bytes,
                    const std::vector<int64_t>& block_bytes,
                    ByteBuf* out);

  // First-class broadcast: binomial tree from the root (MPICH
  // schedule — depth ⌈log2 n⌉ vs the flat root-fanout's n-1 serialized
  // sends) with a flat fallback at or below bcast_flat_max_ bytes. When the
  // core armed wire compression (BeginCompressedOp; fp32 payloads only), the
  // ROOT quantizes once with self-decode and every hop forwards the codes
  // verbatim — all ranks decode identical codes, so the broadcast values are
  // bitwise identical world-wide even under int4 (quantize-once
  // pattern; no error-feedback residual — a broadcast payload is a value,
  // not a gradient stream). Full op lifecycle like Allreduce: chaos trigger,
  // cumulative byte counters, perf phases, algo label ("bcast_tree" /
  // "bcast_flat").
  HVDTPU_CALLED_ON(background)
  Status Broadcast(void* data, int64_t bytes, int root);

  // First-class pairwise alltoallv: send_bytes[r] from my buffer to
  // rank r (contiguous, in rank order); recv_bytes[r] received from rank r
  // into out (rank order). Step k exchanges with ranks (rank±k) — n-1
  // full-duplex hops, every block travels exactly one hop, so uneven (MoE
  // capacity-skew) splits cost only the bytes actually routed. Under wire
  // compression each fp32 block is quantized once at its sender (the self
  // block self-decodes through the same codec) and decoded at its one
  // receiver — single-hop determinism needs no forwarding discipline. Full
  // op lifecycle like Allreduce; algo label "pairwise".
  HVDTPU_CALLED_ON(background)
  Status Alltoallv(const void* in, const std::vector<int64_t>& send_bytes,
                   const std::vector<int64_t>& recv_bytes,
                   ByteBuf* out);

  // First-class reduce-scatter: reduce `count` elements across the
  // world and keep this rank's contiguous dim-0 chunk — the ring allreduce's
  // reduce-scatter phase promoted to a public op, at half an allreduce's
  // wire bytes ((n-1)/n of the payload per rank). Runs the existing ring
  // machinery over the rotated group [1, 2, ..., n-1, 0]: rank r sits at
  // group index (r-1+n)%n, so the phase's owner rule (member gi owns chunk
  // (gi+1)%gs) lands chunk r on rank r while the physical ring neighbors —
  // and therefore the segmented/zero-copy lane schedule — are unchanged.
  // Compressed mode (BeginCompressedOp, fp32 SUM/AVERAGE) rides the same
  // quantized hops as the compressed ring allreduce's first half. The
  // public op requires count % size == 0 (validated by the coordinator);
  // standalone callers may pass ragged counts and get the ragged chunk.
  HVDTPU_CALLED_ON(background)
  Status ReduceScatter(const void* in, int64_t count, DataType dtype,
                       ReduceOp op, ByteBuf* out);

  // In-place Adasum reduction (float32/float64): hypercube pairwise exchange
  // with the adaptive combine a*(1 - dot/2|a|^2) + b*(1 - dot/2|b|^2)
  // (reference: horovod/common/ops/adasum/adasum.h:38). Non-power-of-two
  // worlds fold extra ranks in by addition first, like the Python/XLA path.
  HVDTPU_CALLED_ON(background)
  Status AdasumAllreduce(void* data, int64_t count, DataType dtype);

 private:
  // Send to one peer while receiving from another (possibly the same), with
  // optional segment callbacks on the receive side. The building block every
  // algorithm rides; routes through the per-peer transports.
  // view_align: element size the receive-side callback views are aligned
  // to (the shm lane consumes segments IN PLACE from its ring — see
  // SegmentFn in transport.h — and must never hand the reducer a torn
  // element).
  Status Exchange(int send_peer, const void* send_buf, int64_t send_bytes,
                  int recv_peer, void* recv_buf, int64_t recv_bytes,
                  int64_t segment_bytes = 0,
                  const SegmentFn& on_segment = nullptr,
                  size_t view_align = 1);

  // Record a lane failure against `peer`, abort the plane, and return the
  // coherent "peer failure" status every subsequent op also gets.
  Status FailLane(int peer, const char* what);
  // Tracing helpers (no-ops unless the current op is sampled). BeginOpTrace
  // rolls the sampler at op entry; TraceHop emits one child span on the
  // "hops" track carrying {send/recv peer, bytes, lane, algo, hier,
  // compression, seg index, wait_us split}. wait0_us is the IoControl
  // wait counter snapshot from the hop's start.
  void BeginOpTrace();
  void TraceHop(const char* name, int send_peer, int recv_peer,
                int64_t bytes, int64_t t0_us, int64_t wait0_us);
  // One-directional hops with the same fault machinery as Exchange (chaos
  // hop counting, abort fast-fail, blackhole, FailLane attribution): the
  // tree edges, recursive-doubling fold/unfold links, hier leader
  // gather/scatter and broadcast fan-out all ride these, so the abort path
  // threads through EVERY schedule shape, not just the ring.
  Status SendTo(int peer, const void* buf, int64_t bytes, const char* what);
  Status RecvFrom(int peer, void* buf, int64_t bytes, const char* what);
  // Chaos triggers: counted at allreduce entry / every Exchange. MaybeChaos*
  // fire the armed action when its index is reached (FireChaos may not
  // return: KILL/HANG). BlackholeWait parks an exchange against a dropped
  // lane until the plane aborts or the read deadline declares it dead.
  void MaybeChaosOp();
  void MaybeChaosHop(int send_peer, int recv_peer);
  void FireChaos(int peer_hint);
  Status BlackholeWait(int peer);

  // Negotiate the per-pair lane (shm for same-host peers when both sides
  // set it up, TCP otherwise) over the freshly established socket mesh.
  Status SetupTransports(const std::vector<PeerAddr>& peers);

  // All algorithms run over an arbitrary ordered rank group so the flat
  // path (group = the whole world) and the hierarchical leader/local phases
  // share one implementation.
  Status AllreduceGroup(void* data, int64_t count, DataType dtype,
                        ReduceOp op, const std::vector<int>& group);
  // Bandwidth path: ring reduce-scatter + allgather; each reduce-scatter
  // step streams the incoming chunk in segments so ReduceBuffer of segment
  // k overlaps the transfer of segment k+1.
  Status RingAllreduceGroup(void* data, int64_t count, DataType dtype,
                            ReduceOp op, const std::vector<int>& group);
  // Latency path: log2(p) full-message pairwise exchanges; non-power-of-two
  // groups fold the extra ranks in by reduction first (like Adasum).
  Status RecursiveDoublingGroup(void* data, int64_t count, DataType dtype,
                                ReduceOp op, const std::vector<int>& group);
  // Binomial reduce-to-0 + binomial broadcast (reference fork's tree menu
  // entry; half the exchange volume of recursive doubling, twice the depth).
  Status TreeAllreduceGroup(void* data, int64_t count, DataType dtype,
                            ReduceOp op, const std::vector<int>& group);
  // Direct-exchange two-phase reduce (reference fork's scatter-allgather
  // menu entry): phase 1 rotates gs-1 pairwise exchanges so each rank
  // receives its owned chunk's slice from EVERY peer and reduces locally in
  // ascending source-rank order — the same accumulation order the ring's
  // reduce-scatter produces, so the result is bitwise identical to the
  // ring's; phase 2 is the rotation allgather. Same chunk ownership as the
  // ring: member gi owns chunk (gi+1) % gs.
  Status ScatterAllgatherGroup(void* data, int64_t count, DataType dtype,
                               ReduceOp op, const std::vector<int>& group);
  // Parameter-server baseline (reference PS mode): every worker ships the
  // whole vector to group[0], which reduces in rank order and broadcasts
  // the result — 2 hops of depth, n x the root's wire volume. The single
  // reduced buffer makes cross-rank bitwise equality trivial.
  Status ParameterServerGroup(void* data, int64_t count, DataType dtype,
                              ReduceOp op, const std::vector<int>& group);

  // Compressed-hop variants of the ring phases (fp32 SUM only; gated by
  // CompressionActive). Reduce-scatter: each hop quantizes the outgoing
  // chunk (error-feedback residual applied at the compressing rank),
  // ships the wire form, and the receiver dequantizes + reduces in fp32.
  // Allgather: the chunk owner quantizes its fully reduced chunk ONCE,
  // replaces its own copy with the dequantized values, and every hop
  // forwards the owner's wire bytes verbatim — all ranks decode identical
  // codes, so the final vectors are bitwise identical everywhere.
  Status CompressedRingReduceScatter(float* buf,
                                     const std::vector<int64_t>& starts,
                                     const std::vector<int>& group, int gi);
  Status CompressedRingAllgather(float* buf,
                                 const std::vector<int64_t>& starts,
                                 const std::vector<int>& group, int gi);
  // Recursive doubling with compressed exchanges: each round both peers
  // quantize their partial sum (self-decoding their own copy), so both
  // compute deQ(a) + deQ(b) and stay bitwise identical. Non-power-of-two
  // folds compress the uplink; the unfold ships the final vector raw so
  // folded ranks match the main group exactly.
  Status CompressedRecursiveDoubling(float* data, int64_t count,
                                     const std::vector<int>& group);
  // Compressed scatter-allgather: phase 1 quantizes every outgoing slice
  // (error feedback applied at its buffer region — each region is
  // compressed exactly once per op: gs-1 peer slices here, the owned chunk
  // in phase 2) and the receiver dequantize-adds into its owned chunk;
  // phase 2 is the quantize-once-at-owner rotation the ring allgather uses,
  // so every rank decodes identical codes and the vectors stay bitwise
  // identical world-wide.
  Status CompressedScatterAllgather(float* buf,
                                    const std::vector<int64_t>& starts,
                                    const std::vector<int>& group, int gi);
  // Compressed parameter-server: workers quantize the uplink (error
  // feedback at the worker), the root dequantize-adds in rank order, then
  // quantizes the result ONCE (self-decoding its own copy) and ships the
  // same wire bytes to every worker — bitwise identity by construction.
  Status CompressedParameterServer(float* buf, int64_t count,
                                   const std::vector<int>& group, int gi);

  bool CompressionActive(DataType dtype, ReduceOp op) const {
    return op_comp_ != WireCompression::NONE &&
           dtype == DataType::FLOAT32 &&
           (op == ReduceOp::SUM || op == ReduceOp::AVERAGE);
  }
  void AddOpBytes(int64_t raw, int64_t wire) {
    op_raw_bytes_ += raw;
    op_wire_bytes_ += wire;
  }

  // Ring phases over a group (shared by RingAllreduceGroup and the
  // hierarchical intra-host stages). After the reduce-scatter, group member
  // gi owns chunk (gi+1) % group_size fully reduced.
  Status RingReduceScatterPhase(uint8_t* buf, const std::vector<int64_t>& starts,
                                size_t elem, DataType dtype, ReduceOp op,
                                const std::vector<int>& group, int gi);
  Status RingAllgatherPhase(uint8_t* buf, const std::vector<int64_t>& starts,
                            size_t elem, const std::vector<int>& group,
                            int gi);

  // First-class allgather internals, both over the natural world
  // ring (rank r owns block r; offsets[r] = byte start of block r in out).
  // RingAllgathervPhase: store-and-forward rotation of ragged blocks — at
  // step s ship block (rank-s), receive block (rank-s-1) from the left
  // neighbor, n-1 hops over neighbor lanes only. CompressedRingAllgatherv:
  // same rotation, but each block travels as its owner's quantize-once wire
  // codes (fp32 blocks; the owner self-decodes), forwarded verbatim so all
  // ranks decode identical codes and the result is bitwise identical
  // world-wide.
  Status RingAllgathervPhase(const std::vector<int64_t>& offsets,
                             const std::vector<int64_t>& block_bytes,
                             uint8_t* out);
  Status CompressedRingAllgatherv(const std::vector<int64_t>& offsets,
                                  const std::vector<int64_t>& block_bytes,
                                  uint8_t* out);

  // Broadcast internals. Both schedules ship `wire_bytes` of `buf`
  // from `root` to every rank; raw_per_send is the uncompressed-equivalent
  // byte count each send accounts (== wire_bytes for raw payloads, the fp32
  // size for forwarded codes). Binomial: MPICH vrank schedule — receive from
  // parent (vrank minus its lowest set bit), forward to children on
  // descending masks. Flat: root sends to each peer directly.
  Status BinomialBroadcastSchedule(void* buf, int64_t wire_bytes,
                                   int64_t raw_per_send, int root);
  Status FlatBroadcastSchedule(void* buf, int64_t wire_bytes,
                               int64_t raw_per_send, int root);
  // Quantize-once-at-root broadcast: the root compresses `count` fp32
  // elements ONCE (self-decoding its own copy), the chosen schedule forwards
  // the codes verbatim, and every non-root rank decodes after its forwards
  // complete — bitwise identity world-wide by construction.
  Status CompressedBroadcast(float* data, int64_t count, int root, bool flat);
  // Compressed pairwise alltoallv: each outgoing fp32 block is quantized
  // once for its single receiver (the self block through the same
  // quantize/self-decode roundtrip so every block in `out` is uniformly
  // lossy), shipped as codes, and decoded on arrival.
  Status CompressedAlltoallv(const float* in,
                             const std::vector<int64_t>& send_off,
                             const std::vector<int64_t>& recv_off,
                             uint8_t* out);

  // Two-level path: intra-host ring reduce-scatter -> chunks gathered to the
  // host leader -> leaders run the flat algorithm over TCP -> chunks
  // scattered back -> intra-host ring allgather.
  Status HierarchicalAllreduce(void* data, int64_t count, DataType dtype,
                               ReduceOp op);

  int rank_;
  int size_;
  int listen_fd_ = -1;
  int port_ = 0;
  std::vector<int> fds_;  // per-peer socket; -1 for self (owned here)
  std::vector<std::unique_ptr<Transport>> transports_;  // per-peer lane

  // Host topology, derived from the peer table in Connect().
  std::vector<int> world_group_;  // 0..size-1
  std::vector<int> local_group_;  // ranks sharing my host (sorted)
  std::vector<int> leaders_;      // lowest rank per host (sorted)

  AllreduceAlgo algo_ = AllreduceAlgo::AUTO;
  int64_t crossover_bytes_ = kDefaultAlgoCrossoverBytes;
  int64_t segment_bytes_ = kDefaultSegmentBytes;
  int sa_min_group_ = kDefaultSaMinGroup;
  bool sa_auto_ = true;  // autotuner's SA-vs-ring pick under AUTO
  int64_t bcast_flat_max_ = kDefaultBcastFlatMaxBytes;
  bool shm_enabled_ = true;
  int64_t shm_ring_bytes_ = 0;  // 0 = shm_transport.h kDefaultShmRingBytes
  std::string transport_label_ = "local";
  HierMode hier_mode_ = HierMode::AUTO;
  bool hier_auto_ = false;
  // Zero-copy lane configuration: TCP MSG_ZEROCOPY/io_uring mode,
  // shm NUMA placement, futex-doorbell coalescing window (0 = lane
  // default). Applied at Connect/SetupTransports.
  ZeroCopyMode tcp_zerocopy_ = ZeroCopyMode::AUTO;
  ShmNumaMode shm_numa_ = ShmNumaMode::AUTO;
  int64_t doorbell_batch_ = 0;
  // TCP lanes (downcast cache) for zero-copy counter publication.
  std::vector<TcpTransport*> tcp_lanes_;
  int64_t zc_sends_published_ = 0;
  int64_t zc_fallbacks_published_ = 0;
  // Largest payload a TCP lane may send inline (blocking send, then recv)
  // without a deadlock risk; measured against the mesh's socket buffer
  // sizes in Connect(). 0 (pre-Connect) = always use the concurrent path.
  int64_t inline_max_bytes_ = 0;

  // Fault detection + injection state. io_ctl_ is shared with every lane
  // (its atomics are the only cross-thread members here); the rest is
  // driven by the collective thread only, like the members above.
  IoControl io_ctl_;
  int64_t formup_timeout_ms_ = 60000;
  int failed_peer_ = -1;
  ChaosSpec chaos_;
  int64_t chaos_ops_ = 0;
  int64_t chaos_hops_ = 0;
  int blackholed_peer_ = -1;
  // CORRUPT fired at this op's entry: flip one output byte AFTER the
  // reduction completes (the corruption must be in the post-allreduce
  // buffer the divergence probe fingerprints, not in an input a correct
  // reduction would overwrite).
  bool corrupt_pending_ = false;

  // Distributed-tracing state (background thread only, like the chaos
  // counters): the core's timeline as span sink, the every-Nth-op sampler,
  // and the current op's sampled flag + hop sequence. rec_hops_ is the
  // combined "timestamp this hop at all" gate: sampled-trace JSON OR the
  // always-on flight ring (flight_) wants it.
  Timeline* tracer_ = nullptr;
  TraceSampler trace_sampler_;
  bool trace_op_ = false;
  bool rec_hops_ = false;
  int64_t trace_hop_seq_ = 0;
  FlightRecorder* flight_ = nullptr;
  // Zero the per-op phase accumulators. Called by BeginOpTrace and by the
  // early returns that skip it (size_==1 / empty ops still reach
  // ObserveOp, which reads the accumulators unconditionally).
  void ResetOpPhaseAccum();
  // Per-op phase accumulation for the perf-attribution subsystem
  // (perfstats.h): reset by BeginOpTrace, fed by TraceHop and the
  // segmented-ring reduce callback, read by the core after each op.
  bool perf_on_ = false;
  int64_t op_wait_us_ = 0;
  int64_t op_wire_us_ = 0;
  int64_t op_reduce_us_ = 0;
  int64_t op_codec_us_ = 0;
  int op_slow_peer_ = -1;
  int64_t op_slow_peer_wait_us_ = 0;

  // Per-op wire compression state (background thread only) + payload
  // accounting (cumulative totals live in the metrics registry, readable
  // cross-thread).
  WireCompression op_comp_ = WireCompression::NONE;
  float* op_residual_ = nullptr;
  GradQuality* op_quality_ = nullptr;
  int64_t op_raw_bytes_ = 0;
  int64_t op_wire_bytes_ = 0;
  const char* last_algo_label_ = "none";
  // Registry state last and behind a pointer: embedding the fallback
  // registry inline shifted the hot members across cache lines and cost a
  // measurable ~3% on the 64 MB shm ring bench (layout, not work — the
  // counter adds themselves are two relaxed atomics per op).
  std::unique_ptr<Metrics> own_metrics_;  // fallback for standalone use
  Metrics* metrics_ = nullptr;
  Counter* raw_bytes_total_ = nullptr;
  Counter* wire_bytes_total_ = nullptr;
  Counter* zc_sends_total_ = nullptr;
  Counter* zc_fallbacks_total_ = nullptr;

  // Publish the TCP lanes' zero-copy send/fallback totals into the metrics
  // registry (delta-based; called at op boundaries on the driving thread).
  void PublishZeroCopyCounters();
};

// dst[i] = dst[i] OP src[i], accumulating fp16/bf16 in float.
void ReduceBuffer(void* dst, const void* src, int64_t count, DataType dtype,
                  ReduceOp op);

// Half-precision conversions (reference: horovod/common/half.{h,cc}).
float HalfToFloatPublic(uint16_t h);
uint16_t FloatToHalfPublic(float f);
float Bf16ToFloatPublic(uint16_t h);
uint16_t FloatToBf16Public(float f);

}  // namespace hvdtpu
