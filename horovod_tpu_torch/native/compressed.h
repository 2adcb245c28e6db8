// Wire compression for the process-mode data plane.
//
// Reference: the IST-DASLab fork's horovod/common/ops/compressed/ subsystem —
// CPUMaxMinQuantizer (compressor.h:168): bucket-wise uniform max-min
// quantization of fp32 payloads to b bits with per-bucket (min, unit)
// headers, plus error-feedback residuals accumulated at the compressing rank
// (compressor.cc ApplyErrorFeedback). This rebuild keeps the reference wire
// semantics byte-compatible with the JAX-level quantizer
// (horovod_tpu/compression/quantize.py MaxMinQuantizer, bucket 512): same
// bucket size, same (min, unit) encoding, same round-to-nearest-even codes —
// tests/test_wire_compression.py pins the two implementations to each other.
//
// The data plane (data_plane.cpp) uses these kernels for "compressed hops":
// each ring / recursive-doubling exchange ships the quantized form, the
// receiver dequantizes and reduces in fp32, and the next hop re-quantizes
// (with the residual applied wherever data is quantized).
//
// Wire layout for a block of `count` fp32 elements:
//   FP16: count x uint16 IEEE half codes (round-to-nearest-even, the 
//         F16C/RNE kernels).
//   INT8 / INT4: ceil(count/512) per-bucket headers (fp32 min, fp32 unit,
//         8 bytes each), then the codes — 1 byte per element (int8) or two
//         elements per byte, low nibble first (int4, matching
//         quantize.py pack_bits bit order). A short tail bucket is treated
//         as zero-padded to 512 for the min/max scan (quantize.py
//         _bucketize parity), but padding codes are never stored.
#pragma once

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

#include "gradstats.h"  // GradQuality (quantization-quality accumulation)

namespace hvdtpu {

// Matches the Python surface (envvars.WIRE_COMPRESSION_MODES) and the
// hvdtpu_set_compression C API. AUTO is a config-only value: the Bayesian
// autotuner owns the effective choice (none/fp16/int8) and broadcasts it via
// PARAMS; the data plane only ever sees a concrete mode.
enum class WireCompression : int32_t {
  NONE = 0,
  FP16 = 1,
  INT8 = 2,
  INT4 = 3,
  AUTO = 4,
};

// Matches compression/quantize.py DEFAULT_BUCKET_SIZE (reference:
// compressor.h:11).
constexpr int64_t kWireBucketSize = 512;

const char* WireCompressionName(WireCompression c);

// Bytes on the wire for `count` fp32 elements under mode `c` (NONE/AUTO:
// the raw 4 * count).
int64_t WireBytes(WireCompression c, int64_t count);

// Compress `count` fp32 elements into `dst` (WireBytes(c, count) bytes).
//
// residual (optional, `count` floats): error feedback — each element is
// quantized as x = src[i] + residual[i] and the new residual is x minus its
// dequantized value (reference: error feedback accumulated at the
// compressing rank).
//
// self_decode (optional, `count` floats, MAY alias src): receives the
// dequantized values, so a rank can replace its own copy with exactly what
// peers will decode — cross-rank bitwise consistency for the compressed
// collectives.
//
// quality (optional): accumulates sum (x - dequantized)^2 and sum x^2 over
// every quantized element (docs/numerics.md) — the kernels already compute
// the dequantized value for error feedback, so the accumulation costs two
// FMAs per lane, not an extra pass.
//
// c must be a concrete mode (not NONE/AUTO).
void WireCompress(WireCompression c, const float* src, int64_t count,
                  uint8_t* dst, float* residual, float* self_decode,
                  GradQuality* quality = nullptr);

// dst[i] = decoded[i].
void WireDecompress(WireCompression c, const uint8_t* src, int64_t count,
                    float* dst);

// dst[i] += decoded[i] (the fused decompress-and-reduce used by the
// compressed reduce-scatter hops; fp32 accumulation).
void WireDecompressAdd(WireCompression c, const uint8_t* src, int64_t count,
                       float* dst);

// Per-tensor error-feedback residual buffers, keyed by the (fused) op's
// name signature. Local to the compressing rank; nothing is negotiated.
// Concurrency contract: background-loop-owned (error feedback is applied
// inside the serialized collective path), so it carries no lock — the same
// single-driver rule as DataPlane, enforced socially and by `make analyze`
// finding any new mutex-free cross-thread state it would take to break it.
class ResidualStore {
 public:
  // The residual buffer for `key`, zero-initialized when new or when the
  // element count changed (a refused fusion or reshape drops the residual —
  // best-effort, like the reference's per-entry feedback buffers).
  // Bounded: fusion composition is timing-dependent (and the autotuner
  // varies the threshold), so distinct keys can proliferate — past
  // kMaxEntries the store resets rather than leak a full-size fp32 buffer
  // per stale signature (EF restarts from zero; it is best-effort state).
  // *reset (optional) is set true when EXISTING feedback state was dropped
  // — a live key resized (refused fusion / reshape) or the whole store
  // cleared at the cap — so the caller can count and WARN
  // (hvdtpu_residual_resets_total; docs/numerics.md): silently restarting
  // error feedback mid-run is a quality event, not bookkeeping.
  float* Get(const std::string& key, int64_t count, bool* reset = nullptr);
  size_t size() const { return buf_.size(); }
  // Total bytes held across every residual buffer — the memory-occupancy
  // telemetry's hvdtpu_residual_store_bytes gauge (refreshed at 1 Hz by
  // the background loop; docs/metrics.md documents the staleness window).
  // O(entries), entries are capped at kMaxEntries; background thread only,
  // like Get.
  int64_t TotalBytes() const {
    int64_t total = 0;
    for (const auto& kv : buf_) {
      total += static_cast<int64_t>(kv.second.size() * sizeof(float));
    }
    return total;
  }

  static constexpr size_t kMaxEntries = 256;

 private:
  std::unordered_map<std::string, std::vector<float>> buf_;
};

}  // namespace hvdtpu
