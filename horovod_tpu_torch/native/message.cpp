#include "message.h"

namespace hvdtpu {

void SerializeRequest(const Request& r, Writer* w) {
  w->I32(r.rank);
  w->I32(static_cast<int32_t>(r.op_type));
  w->I32(static_cast<int32_t>(r.reduce_op));
  w->I32(static_cast<int32_t>(r.dtype));
  w->Str(r.name);
  w->VecI64(r.shape);
  w->F64(r.prescale);
  w->F64(r.postscale);
  w->I32(r.root_rank);
  w->VecI32(r.splits);
}

Request DeserializeRequest(Reader* r) {
  Request q;
  q.rank = r->I32();
  q.op_type = static_cast<OpType>(r->I32());
  q.reduce_op = static_cast<ReduceOp>(r->I32());
  q.dtype = static_cast<DataType>(r->I32());
  q.name = r->Str();
  q.shape = r->VecI64();
  q.prescale = r->F64();
  q.postscale = r->F64();
  q.root_rank = r->I32();
  q.splits = r->VecI32();
  return q;
}

void SerializeResponse(const Response& r, Writer* w) {
  w->I32(static_cast<int32_t>(r.type));
  w->I32(static_cast<int32_t>(r.op_type));
  w->I32(static_cast<int32_t>(r.reduce_op));
  w->I32(static_cast<int32_t>(r.dtype));
  w->Str(r.error_message);
  w->I64(static_cast<int64_t>(r.names.size()));
  for (size_t i = 0; i < r.names.size(); ++i) {
    w->Str(r.names[i]);
    w->VecI64(r.shapes[i]);
    w->F64(r.prescales[i]);
    w->F64(r.postscales[i]);
  }
  w->I32(r.root_rank);
  w->VecI32(r.all_splits);
  w->VecI64(r.first_dims);
  w->I32(r.last_joined_rank);
}

Response DeserializeResponse(Reader* r) {
  Response p;
  p.type = static_cast<ResponseType>(r->I32());
  p.op_type = static_cast<OpType>(r->I32());
  p.reduce_op = static_cast<ReduceOp>(r->I32());
  p.dtype = static_cast<DataType>(r->I32());
  p.error_message = r->Str();
  int64_t n = r->I64();
  for (int64_t i = 0; i < n; ++i) {
    p.names.push_back(r->Str());
    p.shapes.push_back(r->VecI64());
    p.prescales.push_back(r->F64());
    p.postscales.push_back(r->F64());
  }
  p.root_rank = r->I32();
  p.all_splits = r->VecI32();
  p.first_dims = r->VecI64();
  p.last_joined_rank = r->I32();
  return p;
}

}  // namespace hvdtpu
