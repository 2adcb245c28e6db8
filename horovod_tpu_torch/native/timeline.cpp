#include "timeline.h"

namespace hvdtpu {

Timeline::~Timeline() { Shutdown(); }

void Timeline::Initialize(const std::string& path, int rank) {
  MutexLock st(state_mu_);
  if (initialized_ || path.empty()) return;
  file_ = fopen(path.c_str(), "w");
  if (file_ == nullptr) return;
  rank_ = rank;
  start_ = std::chrono::steady_clock::now();
  fputs("[\n", file_);
  first_ = true;
  {
    // Drop events raced in after a previous Shutdown drained the writer,
    // and clear the previous run's stop flag.
    MutexLock lk(mu_);
    while (!queue_.empty()) queue_.pop();
    stop_ = false;
  }
  initialized_ = true;
  writer_ = std::thread([this] { WriterLoop(); });
}

void Timeline::Shutdown() {
  {
    // Flip the flag under state_mu_: Emit holds state_mu_ for its whole
    // body, so after this block no emitter can be touching timeline state.
    MutexLock st(state_mu_);
    if (!initialized_) return;
    initialized_ = false;
  }
  {
    MutexLock lk(mu_);
    stop_ = true;
  }
  cv_.NotifyAll();
  if (writer_.joinable()) writer_.join();
  MutexLock st(state_mu_);
  fputs("\n]\n", file_);
  fclose(file_);
  file_ = nullptr;
}

int64_t Timeline::NowUs() const {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - start_)
      .count();
}

namespace {

std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    if (c == '"' || c == '\\') {
      out += '\\';
      out += c;
    } else if (static_cast<unsigned char>(c) < 0x20) {
      out += ' ';
    } else {
      out += c;
    }
  }
  return out;
}

}  // namespace

void Timeline::Push(std::string json) {
  MutexLock lk(mu_);
  queue_.push(Event{std::move(json)});
}

int64_t Timeline::init_steady_us() {
  MutexLock st(state_mu_);
  if (!initialized_) return 0;
  return std::chrono::duration_cast<std::chrono::microseconds>(
             start_.time_since_epoch())
      .count();
}

void Timeline::Span(const std::string& track, const std::string& name,
                    int64_t start_abs_us, int64_t end_abs_us,
                    const std::string& args_json) {
  int64_t origin_us;
  int rank;
  {
    MutexLock st(state_mu_);
    if (!initialized_) return;
    origin_us = std::chrono::duration_cast<std::chrono::microseconds>(
                    start_.time_since_epoch())
                    .count();
    rank = rank_;
  }
  // A span whose start predates the timeline (runtime start mid-op, or a
  // FUSION-WAIT whose tensor was enqueued before tracing began) is clamped
  // to the origin rather than dropped or emitted at a negative ts — and
  // the duration shrinks with it, so the rendered span still ENDS at its
  // true end instead of spilling past it.
  int64_t ts = start_abs_us - origin_us;
  if (ts < 0) ts = 0;
  int64_t end_ts = end_abs_us - origin_us;
  int64_t dur = end_ts - ts;
  if (dur < 0) dur = 0;
  std::string e = "{\"name\": \"" + JsonEscape(name) + "\", \"ph\": \"X\"";
  e += ", \"ts\": " + std::to_string(ts);
  e += ", \"dur\": " + std::to_string(dur);
  e += ", \"pid\": \"" + JsonEscape(track) + "\", \"tid\": " +
       std::to_string(rank);
  if (!args_json.empty()) e += ", \"args\": " + args_json;
  e += "}";
  Push(std::move(e));
}

void Timeline::Metadata(const std::string& args_json) {
  int64_t ts;
  int rank;
  {
    MutexLock st(state_mu_);
    if (!initialized_) return;
    ts = NowUs();
    rank = rank_;
  }
  std::string e = "{\"name\": \"trace_meta\", \"ph\": \"i\", \"s\": \"g\"";
  e += ", \"ts\": " + std::to_string(ts);
  e += ", \"pid\": \"" + std::string(kTraceMetaTrack) + "\", \"tid\": " +
       std::to_string(rank);
  if (!args_json.empty()) e += ", \"args\": " + args_json;
  e += "}";
  Push(std::move(e));
}

void Timeline::Emit(const std::string& name, char ph,
                    const std::string& args_json, const std::string& cat) {
  // Snapshot under state_mu_ (so a concurrent runtime Shutdown/Initialize
  // can't mutate start_/rank_ mid-read), then build the JSON outside it —
  // emitters shouldn't serialize on heap work.
  int64_t ts;
  int rank;
  {
    MutexLock st(state_mu_);
    if (!initialized_) return;
    ts = NowUs();
    rank = rank_;
  }
  // One row ("pid") per tensor name, one thread row per rank — mirrors the
  // reference's tensor-as-process layout (timeline.cc:254-276). Built with
  // std::string so long tensor names can't truncate into invalid JSON.
  std::string e = "{\"name\": \"";
  e += JsonEscape(cat.empty() ? name : cat);
  e += "\", \"ph\": \"";
  e += ph;
  e += "\", \"ts\": " + std::to_string(ts);
  e += ", \"pid\": \"" + JsonEscape(name) + "\", \"tid\": " +
       std::to_string(rank);
  if (!args_json.empty()) e += ", \"args\": " + args_json;
  if (!cat.empty()) e += ", \"cat\": \"" + JsonEscape(cat) + "\"";
  e += "}";
  Push(std::move(e));
}

void Timeline::WriterLoop() {
  MutexLock lk(mu_);
  while (true) {
    // Batched drain: per-event wakes preempt the collective thread on
    // small hosts, and a short free-running timer fires mid-op — so the
    // writer is nudged only at OP BOUNDARIES (OpDone/Shutdown), where the
    // emitting thread is about to idle on the control plane anyway. The
    // 1 s timed wait is a backstop for op-less stretches (metadata-only
    // traces, mark-cycles while idle).
    while (!stop_ && queue_.empty()) cv_.WaitForMs(lk, 1000);
    while (!queue_.empty()) {
      Event e = std::move(queue_.front());
      queue_.pop();
      lk.Unlock();
      if (!first_) fputs(",\n", file_);
      first_ = false;
      fputs(e.json.c_str(), file_);
      lk.Lock();
    }
    if (stop_ && queue_.empty()) break;
  }
  fflush(file_);
}

void Timeline::NegotiateStart(const std::string& name) {
  Emit(name, 'B', "", "NEGOTIATE");
}

void Timeline::NegotiateEnd(const std::string& name) { Emit(name, 'E', ""); }

void Timeline::QueueStart(const std::string& name) {
  Emit(name, 'B', "", "QUEUE");
}

void Timeline::ActivityStart(const std::string& name,
                             const std::string& activity,
                             const std::string& transport,
                             const std::string& compression) {
  std::string args;
  if (!transport.empty()) {
    args = "\"transport\": \"" + JsonEscape(transport) + "\"";
  }
  if (!compression.empty()) {
    if (!args.empty()) args += ", ";
    args += "\"compression\": \"" + JsonEscape(compression) + "\"";
  }
  Emit(name, 'B', args.empty() ? std::string() : "{" + args + "}", activity);
}

void Timeline::ActivityEnd(const std::string& name) { Emit(name, 'E', ""); }

void Timeline::OpDone(const std::string& name, const std::string& result,
                      int64_t raw_bytes, int64_t wire_bytes) {
  // Escape like every other arg: failure reasons embed tensor names, and a
  // quote/backslash there would corrupt the whole trace file.
  std::string args = "{\"result\": \"" + JsonEscape(result) + "\"";
  if (raw_bytes >= 0 && wire_bytes >= 0) {
    args += ", \"raw_bytes\": " + std::to_string(raw_bytes) +
            ", \"wire_bytes\": " + std::to_string(wire_bytes);
  }
  Emit(name, 'E', args + "}");
  // Op boundary: the only wake the hot path pays. The background thread
  // is about to return to the control-plane pump, so the writer's drain
  // (this op's phases + any sampled hop spans) runs in the gap between
  // ops instead of preempting a pipelined exchange.
  cv_.NotifyOne();
}

void Timeline::MarkCycle() {
  MutexLock st(state_mu_);
  if (!initialized_) return;
  char buf[160];
  snprintf(buf, sizeof(buf),
           "{\"name\": \"CYCLE %d\", \"ph\": \"i\", \"ts\": %lld, "
           "\"pid\": \"cycle\", \"tid\": %d, \"s\": \"g\"}",
           cycle_++, static_cast<long long>(NowUs()), rank_);
  MutexLock lk(mu_);
  queue_.push(Event{std::string(buf)});
}

}  // namespace hvdtpu
