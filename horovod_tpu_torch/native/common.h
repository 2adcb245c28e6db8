// Core types for the native runtime.
//
// TPU-native rebuild of the reference's horovod/common/common.h (Status,
// DataType enum, TensorTableEntry) — redesigned around a TCP control/data plane
// instead of MPI/NCCL. No external dependencies beyond POSIX + libstdc++.
#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Clang Thread Safety Analysis annotations (docs/static-analysis.md).
//
// Compiled with `clang++ -Wthread-safety -Werror=thread-safety` (the
// `make analyze` target) these attributes turn the locking discipline into a
// compile-time contract: every GUARDED_BY field must be touched under its
// mutex, every REQUIRES function must be called with it held. Under gcc (the
// default build) they expand to nothing. Pattern follows the canonical
// mutex.h from the Clang TSA documentation / Abseil.
// ---------------------------------------------------------------------------
#if defined(__clang__)
#define HVDTPU_TSA(x) __attribute__((x))
#else
#define HVDTPU_TSA(x)  // no-op under gcc
#endif

#define CAPABILITY(x) HVDTPU_TSA(capability(x))
#define SCOPED_CAPABILITY HVDTPU_TSA(scoped_lockable)
#define GUARDED_BY(x) HVDTPU_TSA(guarded_by(x))
#define PT_GUARDED_BY(x) HVDTPU_TSA(pt_guarded_by(x))
#define ACQUIRE(...) HVDTPU_TSA(acquire_capability(__VA_ARGS__))
#define RELEASE(...) HVDTPU_TSA(release_capability(__VA_ARGS__))
#define TRY_ACQUIRE(...) HVDTPU_TSA(try_acquire_capability(__VA_ARGS__))
#define REQUIRES(...) HVDTPU_TSA(requires_capability(__VA_ARGS__))
#define EXCLUDES(...) HVDTPU_TSA(locks_excluded(__VA_ARGS__))
#define ACQUIRED_BEFORE(...) HVDTPU_TSA(acquired_before(__VA_ARGS__))
#define ACQUIRED_AFTER(...) HVDTPU_TSA(acquired_after(__VA_ARGS__))
#define RETURN_CAPABILITY(x) HVDTPU_TSA(lock_returned(x))
#define NO_THREAD_SAFETY_ANALYSIS HVDTPU_TSA(no_thread_safety_analysis)

// Thread-role annotations (HVDTPU_CALLED_ON / HVDTPU_ROLE): the lock-free
// complement to the TSA layer above, in their own dependency-light header.
#include "thread_roles.h"

namespace hvdtpu {

// std::mutex carries no capability attribute under libstdc++, so the analysis
// cannot see through it; this annotated wrapper is what every lock in the
// native core uses. Same storage, same cost — the attributes are metadata.
class CAPABILITY("mutex") Mutex {
 public:
  void Lock() ACQUIRE() { mu_.lock(); }
  void Unlock() RELEASE() { mu_.unlock(); }
  // For CondVar: the analysis models waits as "lock stays held", which is
  // the contract the surrounding code relies on anyway.
  std::mutex& native_handle() { return mu_; }

 private:
  std::mutex mu_;
};

// RAII lock (std::lock_guard/std::unique_lock replacement). Supports the
// unlock-work-relock pattern (Timeline::WriterLoop): the analysis tracks the
// Unlock()/Lock() pair on the scoped object.
class SCOPED_CAPABILITY MutexLock {
 public:
  explicit MutexLock(Mutex& mu) ACQUIRE(mu) : lk_(mu.native_handle()) {}
  ~MutexLock() RELEASE() {}
  void Unlock() RELEASE() { lk_.unlock(); }
  void Lock() ACQUIRE() { lk_.lock(); }
  std::unique_lock<std::mutex>& native_handle() { return lk_; }

 private:
  std::unique_lock<std::mutex> lk_;
};

// Condition variable over an annotated Mutex. Predicates are spelled as
// explicit while-loops at the call sites (not wait(lk, pred) lambdas): the
// analysis cannot see that a lambda body runs with the lock held, a loop in
// the REQUIRES-checked scope it can.
class CondVar {
 public:
  void Wait(MutexLock& lk) { cv_.wait(lk.native_handle()); }
  // Timed wait (spurious wakeups allowed, like Wait): for consumers that
  // drain on a period instead of being notified per item — the timeline
  // writer batches its queue this way so emitters never pay a wakeup.
  // wait_until on system_clock (not wait_for): libstdc++'s steady-clock
  // wait_for lowers to pthread_cond_clockwait, which this toolchain's TSan
  // does not intercept — it then loses the unlock inside the wait and
  // reports phantom double-locks/races. pthread_cond_timedwait (the
  // system_clock path) is intercepted; a realtime jump at worst stretches
  // one backstop period.
  void WaitForMs(MutexLock& lk, int ms) {
    cv_.wait_until(lk.native_handle(),
                   std::chrono::system_clock::now() +
                       std::chrono::milliseconds(ms));
  }
  void NotifyOne() { cv_.notify_one(); }
  void NotifyAll() { cv_.notify_all(); }

 private:
  std::condition_variable cv_;
};

// Mirrors the reference DataType enum (horovod/common/message.h:28-39).
enum class DataType : int32_t {
  UINT8 = 0,
  INT8 = 1,
  INT32 = 4,
  INT64 = 5,
  FLOAT16 = 6,
  FLOAT32 = 7,
  FLOAT64 = 8,
  BOOL = 9,
  BFLOAT16 = 10,
};

inline size_t DataTypeSize(DataType dt) {
  switch (dt) {
    case DataType::UINT8:
    case DataType::INT8:
    case DataType::BOOL:
      return 1;
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      return 2;
    case DataType::INT32:
    case DataType::FLOAT32:
      return 4;
    case DataType::INT64:
    case DataType::FLOAT64:
      return 8;
  }
  return 0;
}

inline const char* DataTypeName(DataType dt) {
  switch (dt) {
    case DataType::UINT8: return "uint8";
    case DataType::INT8: return "int8";
    case DataType::INT32: return "int32";
    case DataType::INT64: return "int64";
    case DataType::FLOAT16: return "float16";
    case DataType::FLOAT32: return "float32";
    case DataType::FLOAT64: return "float64";
    case DataType::BOOL: return "bool";
    case DataType::BFLOAT16: return "bfloat16";
  }
  return "unknown";
}

// Collective op kinds (reference RequestType, message.h:50-52).
enum class OpType : int32_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  ALLTOALL = 3,
  REDUCESCATTER = 4,
  JOIN = 5,
};

// Reduction ops (matches horovod_tpu.ops.collectives.ReduceOp).
enum class ReduceOp : int32_t {
  AVERAGE = 0,
  SUM = 1,
  ADASUM = 2,
  MIN = 3,
  MAX = 4,
  PRODUCT = 5,
};

enum class StatusCode : int32_t {
  OK = 0,
  IN_PROGRESS = 1,
  INVALID_ARGUMENT = 2,
  ABORTED = 3,
  DUPLICATE_NAME = 4,
};

struct Status {
  StatusCode code = StatusCode::OK;
  std::string reason;
  static Status OK() { return Status{}; }
  static Status Error(StatusCode c, std::string r) { return Status{c, std::move(r)}; }
  bool ok() const { return code == StatusCode::OK; }
};

// Allocator whose construct() default-initializes (a no-op for trivial
// types) instead of value-initializing: resize() on a ByteBuf is "malloc
// only", no zero-fill pass. Working buffers about to be fully overwritten
// — the unfused allreduce output, the fusion buffer — must not pay a
// 16-64 MB memset per op; note that bulk copies into a ByteBuf should go
// through memcpy (or a fused kernel like CopyMomentsF32), not range
// insert: libstdc++ only lowers uninitialized range copies to the
// (non-temporal, large-copy-optimized) memmove for std::allocator.
template <typename T>
struct DefaultInitAllocator : std::allocator<T> {
  template <typename U>
  struct rebind {
    using other = DefaultInitAllocator<U>;
  };
  template <typename U>
  void construct(U* p) {
    ::new (static_cast<void*>(p)) U;
  }
  template <typename U, typename... Args>
  void construct(U* p, Args&&... args) {
    ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
};

// Collective working/output buffer (TensorEntry::output and the data
// plane's gather outputs): byte vector with uninitialized growth.
using ByteBuf = std::vector<uint8_t, DefaultInitAllocator<uint8_t>>;

// A pending collective on this rank (reference: TensorTableEntry, common.h:183).
struct TensorEntry {
  std::string name;
  OpType op_type = OpType::ALLREDUCE;
  ReduceOp reduce_op = ReduceOp::SUM;
  DataType dtype = DataType::FLOAT32;
  std::vector<int64_t> shape;
  double prescale = 1.0;
  double postscale = 1.0;
  int32_t root_rank = 0;            // broadcast
  std::vector<int32_t> splits;      // alltoall (may be empty = even)
  const void* input = nullptr;      // caller-owned until completion
  // Output buffer: owned by the core, copied out by the caller after wait.
  // ByteBuf (uninitialized growth): every fill path overwrites the full
  // range it sizes, so the old value-init zero pass was pure waste.
  ByteBuf output;
  int32_t handle = -1;
  // Absolute steady-clock us at Enqueue (Timeline::SteadyAbsUs): the start
  // of the tensor's FUSION-WAIT trace span — how long it sat queued/fusing
  // before its batch executed (docs/tracing.md). 0 on zombie stand-ins.
  int64_t enqueued_at_us = 0;

  int64_t num_elements() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
  int64_t byte_size() const {
    return num_elements() * static_cast<int64_t>(DataTypeSize(dtype));
  }
};

inline int64_t NumElements(const std::vector<int64_t>& shape) {
  int64_t n = 1;
  for (auto d : shape) n *= d;
  return n;
}

inline std::string ShapeStr(const std::vector<int64_t>& shape) {
  std::string s = "[";
  for (size_t i = 0; i < shape.size(); ++i) {
    if (i) s += ", ";
    s += std::to_string(shape[i]);
  }
  return s + "]";
}

}  // namespace hvdtpu
