// Control-plane wire format: Request / Response (+ serialization).
//
// Fills the role of the reference's flatbuffers wire format
// (horovod/common/wire/message.fbs, horovod/common/message.{h,cc}) with a
// hand-rolled little-endian binary encoding — the only consumers are this
// runtime's own ranks, so schema evolution machinery is unnecessary.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtpu {

// A rank's announcement that a named tensor is ready
// (reference: Request, message.h:48).
struct Request {
  int32_t rank = 0;
  OpType op_type = OpType::ALLREDUCE;
  ReduceOp reduce_op = ReduceOp::SUM;
  DataType dtype = DataType::FLOAT32;
  std::string name;
  std::vector<int64_t> shape;
  double prescale = 1.0;
  double postscale = 1.0;
  int32_t root_rank = 0;
  std::vector<int32_t> splits;  // alltoall send splits (empty = even)
};

enum class ResponseType : int32_t {
  OK = 0,
  ERROR = 1,
  JOIN_DONE = 2,
  SHUTDOWN = 3,
  // A rank asked to shut down: every rank leaves after the ops before it
  // (core.cpp, the negotiated shutdown).
  CLEAN_SHUTDOWN = 4,
};

// Coordinator's instruction to execute (possibly fused) collectives
// (reference: Response, message.h:145; fusion in controller.cc:686).
struct Response {
  ResponseType type = ResponseType::OK;
  OpType op_type = OpType::ALLREDUCE;
  ReduceOp reduce_op = ReduceOp::SUM;
  DataType dtype = DataType::FLOAT32;
  std::string error_message;
  // One entry per fused tensor. Shapes are the *coordinator-agreed* shapes so
  // joined ranks can materialize zero tensors (reference: tensor_queue.cc
  // GetTensorEntriesFromResponse).
  std::vector<std::string> names;
  std::vector<std::vector<int64_t>> shapes;
  std::vector<double> prescales;
  std::vector<double> postscales;
  int32_t root_rank = 0;
  // Alltoall: per-rank send splits for every rank (size * size entries,
  // [sender * size + receiver]), negotiated by the coordinator
  // (reference: controller AlltoallGetRecvSplits).
  std::vector<int32_t> all_splits;
  // Allgather: per-rank first-dimension sizes (reference: controller.cc:812).
  std::vector<int64_t> first_dims;
  int32_t last_joined_rank = -1;  // JOIN_DONE
};

// ---- serialization -------------------------------------------------------

class Writer {
 public:
  void I32(int32_t v) { Raw(&v, sizeof(v)); }
  void I64(int64_t v) { Raw(&v, sizeof(v)); }
  void F64(double v) { Raw(&v, sizeof(v)); }
  void Str(const std::string& s) {
    I64(static_cast<int64_t>(s.size()));
    Raw(s.data(), s.size());
  }
  void VecI64(const std::vector<int64_t>& v) {
    I64(static_cast<int64_t>(v.size()));
    Raw(v.data(), v.size() * sizeof(int64_t));
  }
  void VecI32(const std::vector<int32_t>& v) {
    I64(static_cast<int64_t>(v.size()));
    Raw(v.data(), v.size() * sizeof(int32_t));
  }
  void VecF64(const std::vector<double>& v) {
    I64(static_cast<int64_t>(v.size()));
    Raw(v.data(), v.size() * sizeof(double));
  }
  const std::vector<uint8_t>& buffer() const { return buf_; }
  std::vector<uint8_t> Take() { return std::move(buf_); }

 private:
  void Raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf_.insert(buf_.end(), b, b + n);
  }
  std::vector<uint8_t> buf_;
};

class Reader {
 public:
  explicit Reader(const std::vector<uint8_t>& buf) : buf_(buf) {}
  int32_t I32() { int32_t v = 0; Raw(&v, sizeof(v)); return v; }
  int64_t I64() { int64_t v = 0; Raw(&v, sizeof(v)); return v; }
  double F64() { double v = 0; Raw(&v, sizeof(v)); return v; }
  std::string Str() {
    int64_t n = Len(1);
    std::string s(static_cast<size_t>(n), '\0');
    Raw(s.data(), static_cast<size_t>(n));
    return s;
  }
  std::vector<int64_t> VecI64() {
    int64_t n = Len(sizeof(int64_t));
    std::vector<int64_t> v(static_cast<size_t>(n));
    Raw(v.data(), v.size() * sizeof(int64_t));
    return v;
  }
  std::vector<int32_t> VecI32() {
    int64_t n = Len(sizeof(int32_t));
    std::vector<int32_t> v(static_cast<size_t>(n));
    Raw(v.data(), v.size() * sizeof(int32_t));
    return v;
  }
  std::vector<double> VecF64() {
    int64_t n = Len(sizeof(double));
    std::vector<double> v(static_cast<size_t>(n));
    Raw(v.data(), v.size() * sizeof(double));
    return v;
  }
  bool ok() const { return ok_; }
  size_t pos() const { return pos_; }
  size_t size() const { return buf_.size(); }

 private:
  // A length prefix can never exceed the bytes remaining in the frame; a
  // bigger value means the frame is corrupt — flag it instead of letting a
  // garbage allocation size throw std::length_error.
  int64_t Len(size_t elem_size) {
    int64_t n = I64();
    if (n < 0 ||
        static_cast<size_t>(n) > (buf_.size() - pos_) / elem_size) {
      ok_ = false;
      return 0;
    }
    return n;
  }
  void Raw(void* p, size_t n) {
    if (pos_ + n > buf_.size()) { ok_ = false; return; }
    if (n > 0)  // memcpy with null dst is UB even for n == 0
      memcpy(p, buf_.data() + pos_, n);
    pos_ += n;
  }
  const std::vector<uint8_t>& buf_;
  size_t pos_ = 0;
  bool ok_ = true;
};

void SerializeRequest(const Request& r, Writer* w);
Request DeserializeRequest(Reader* r);
void SerializeResponse(const Response& r, Writer* w);
Response DeserializeResponse(Reader* r);

}  // namespace hvdtpu
