// The port's copy of cpp/collectives.cc, built in its place into the port's
// libhvdcore (horovod_tpu_torch/core/__init__.py). One departure: F32ToF16
// rounds to nearest with ties to even; cpp/'s rounds ties away from zero,
// so an fp16 sum could differ by one ulp from the sum that numpy, torch
// and the torch.distributed plane give.
#include "collectives.h"

#include <algorithm>
#include <cmath>
#include <cstring>

namespace hvd {

namespace {

// -- elementwise accumulate ------------------------------------------------

inline float Bf16ToF32(uint16_t h) {
  uint32_t u = ((uint32_t)h) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline uint16_t F32ToBf16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  // round-to-nearest-even like the reference's fp16 path rounds properly
  uint32_t rounding = 0x7fff + ((u >> 16) & 1);
  return (uint16_t)((u + rounding) >> 16);
}

inline float F16ToF32(uint16_t h) {
  uint32_t sign = (h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t u;
  if (exp == 0) {
    if (man == 0) {
      u = sign;
    } else {
      exp = 127 - 15 + 1;
      while ((man & 0x400) == 0) {
        man <<= 1;
        exp--;
      }
      man &= 0x3ff;
      u = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    u = sign | 0x7f800000 | (man << 13);
  } else {
    u = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline uint16_t F32ToF16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  uint32_t sign = (u >> 16) & 0x8000;
  int32_t bexp = (u >> 23) & 0xff;
  uint32_t man = u & 0x7fffff;
  if (bexp == 0xff)  // preserve NaN (quiet) vs Inf
    return (uint16_t)(sign | 0x7c00 | (man ? 0x200 : 0));
  int32_t e = bexp - 127 + 15;
  if (e >= 0x1f) return (uint16_t)(sign | 0x7c00);  // overflow -> inf
  if (e <= 0) {
    if (e < -10) return (uint16_t)sign;  // underflow -> signed zero
    man |= 0x800000;                     // implicit leading 1
    uint32_t shift = 14 - e;
    uint16_t val = (uint16_t)(man >> shift);
    uint32_t rest = man & ((1u << shift) - 1);  // the bits dropped
    uint32_t half = 1u << (shift - 1);
    if (rest > half || (rest == half && (val & 1))) val++;  // ties to even
    return (uint16_t)(sign | val);
  }
  uint16_t h = (uint16_t)(sign | (e << 10) | (man >> 13));
  uint32_t rest = man & 0x1fff;  // the 13 bits dropped
  // to nearest, ties to even (IEEE 754's default, as numpy, torch and
  // gloo round); a mantissa carry bumps the exponent
  if (rest > 0x1000 || (rest == 0x1000 && (h & 1))) h++;
  return h;
}

template <typename T>
void AccumTyped(T* dst, const T* src, int64_t n, ReduceOp op) {
  switch (op) {
    case ReduceOp::kSum:
    case ReduceOp::kAverage:
    case ReduceOp::kAdasum:
      for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
      break;
    case ReduceOp::kMin:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::min(dst[i], src[i]);
      break;
    case ReduceOp::kMax:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::max(dst[i], src[i]);
      break;
    case ReduceOp::kProduct:
      for (int64_t i = 0; i < n; ++i) dst[i] *= src[i];
      break;
  }
}

template <typename T, typename CvtIn, typename CvtOut>
void Accum16(uint16_t* dst, const uint16_t* src, int64_t n, ReduceOp op,
             CvtIn in, CvtOut out) {
  for (int64_t i = 0; i < n; ++i) {
    float a = in(dst[i]), b = in(src[i]), r;
    switch (op) {
      case ReduceOp::kMin: r = std::min(a, b); break;
      case ReduceOp::kMax: r = std::max(a, b); break;
      case ReduceOp::kProduct: r = a * b; break;
      default: r = a + b; break;
    }
    dst[i] = out(r);
  }
}

void Accumulate(void* dst, const void* src, int64_t n, DataType dt,
                ReduceOp op) {
  switch (dt) {
    case DataType::kFloat32:
      AccumTyped((float*)dst, (const float*)src, n, op);
      break;
    case DataType::kFloat64:
      AccumTyped((double*)dst, (const double*)src, n, op);
      break;
    case DataType::kInt32:
      AccumTyped((int32_t*)dst, (const int32_t*)src, n, op);
      break;
    case DataType::kInt64:
      AccumTyped((int64_t*)dst, (const int64_t*)src, n, op);
      break;
    case DataType::kUint8:
      AccumTyped((uint8_t*)dst, (const uint8_t*)src, n, op);
      break;
    case DataType::kInt8:
      AccumTyped((int8_t*)dst, (const int8_t*)src, n, op);
      break;
    case DataType::kBFloat16:
      Accum16<uint16_t>((uint16_t*)dst, (const uint16_t*)src, n, op,
                        Bf16ToF32, F32ToBf16);
      break;
    case DataType::kFloat16:
      Accum16<uint16_t>((uint16_t*)dst, (const uint16_t*)src, n, op,
                        F16ToF32, F32ToF16);
      break;
    case DataType::kBool:
      AccumTyped((uint8_t*)dst, (const uint8_t*)src, n, op);
      break;
  }
}

void ScaleBuffer(void* data, int64_t n, DataType dt, double factor) {
  if (factor == 1.0) return;
  switch (dt) {
    case DataType::kFloat32: {
      auto* p = (float*)data;
      for (int64_t i = 0; i < n; ++i) p[i] = (float)(p[i] * factor);
      break;
    }
    case DataType::kFloat64: {
      auto* p = (double*)data;
      for (int64_t i = 0; i < n; ++i) p[i] *= factor;
      break;
    }
    case DataType::kBFloat16: {
      auto* p = (uint16_t*)data;
      for (int64_t i = 0; i < n; ++i)
        p[i] = F32ToBf16((float)(Bf16ToF32(p[i]) * factor));
      break;
    }
    case DataType::kFloat16: {
      auto* p = (uint16_t*)data;
      for (int64_t i = 0; i < n; ++i)
        p[i] = F32ToF16((float)(F16ToF32(p[i]) * factor));
      break;
    }
    case DataType::kInt32: {
      auto* p = (int32_t*)data;
      for (int64_t i = 0; i < n; ++i) p[i] = (int32_t)(p[i] * factor);
      break;
    }
    case DataType::kInt64: {
      auto* p = (int64_t*)data;
      for (int64_t i = 0; i < n; ++i) p[i] = (int64_t)(p[i] * factor);
      break;
    }
    default:
      break;
  }
}

}  // namespace

void ScaleBufferOp(void* data, int64_t n, DataType dt, double factor) {
  ScaleBuffer(data, n, dt, factor);
}

Status RingAllreduce(Transport& t, const Group& g, int32_t tag, void* data,
                     int64_t nelem, DataType dtype, ReduceOp op,
                     double prescale, double postscale) {
  int size = g.size();
  int me = g.my_index;
  ScaleBuffer(data, nelem, dtype, prescale);
  if (size > 1 && nelem > 0) {
    size_t esz = DataTypeSize(dtype);
    // chunk boundaries
    std::vector<int64_t> starts(size + 1);
    for (int i = 0; i <= size; ++i) starts[i] = nelem * i / size;
    auto chunk_ptr = [&](int c) {
      return (uint8_t*)data + starts[c] * esz;
    };
    auto chunk_n = [&](int c) { return starts[c + 1] - starts[c]; };
    int right = g.global((me + 1) % size);
    int left = g.global((me - 1 + size) % size);
    std::vector<uint8_t> recvbuf;
    // phase 1: reduce-scatter (size-1 steps)
    for (int step = 0; step < size - 1; ++step) {
      int send_c = (me - step + size) % size;
      int recv_c = (me - step - 1 + size) % size;
      auto st = t.Send(right, tag, chunk_ptr(send_c), chunk_n(send_c) * esz);
      if (!st.ok()) return st;
      st = t.Recv(left, tag, &recvbuf);
      if (!st.ok()) return st;
      Accumulate(chunk_ptr(recv_c), recvbuf.data(), chunk_n(recv_c), dtype,
                 op);
    }
    // phase 2: allgather (size-1 steps)
    for (int step = 0; step < size - 1; ++step) {
      int send_c = (me + 1 - step + size) % size;
      int recv_c = (me - step + size) % size;
      auto st = t.Send(right, tag, chunk_ptr(send_c), chunk_n(send_c) * esz);
      if (!st.ok()) return st;
      st = t.Recv(left, tag, &recvbuf);
      if (!st.ok()) return st;
      memcpy(chunk_ptr(recv_c), recvbuf.data(), chunk_n(recv_c) * esz);
    }
  }
  if (op == ReduceOp::kAverage)
    ScaleBuffer(data, nelem, dtype, 1.0 / size);
  ScaleBuffer(data, nelem, dtype, postscale);
  return Status::OK();
}

Status HierarchicalAllreduce(Transport& t, const Group& local,
                             const Group& cross, bool is_leader, int32_t tag,
                             void* data, int64_t nelem, DataType dtype,
                             ReduceOp op, double prescale, double postscale) {
  ScaleBuffer(data, nelem, dtype, prescale);
  size_t esz = DataTypeSize(dtype);
  // 1) intra-host reduce to the local leader (local index 0)
  if (local.size() > 1) {
    if (local.my_index == 0) {
      std::vector<uint8_t> buf;
      for (int i = 1; i < local.size(); ++i) {
        auto st = t.Recv(local.global(i), tag, &buf);
        if (!st.ok()) return st;
        Accumulate(data, buf.data(), nelem, dtype, op);
      }
    } else {
      auto st = t.Send(local.global(0), tag, data, nelem * esz);
      if (!st.ok()) return st;
    }
  }
  // 2) cross-host ring among leaders
  if (is_leader && cross.size() > 1) {
    auto st = RingAllreduce(t, cross, tag + 1, data, nelem, dtype,
                            op == ReduceOp::kAverage ? ReduceOp::kSum : op,
                            1.0, 1.0);
    if (!st.ok()) return st;
  }
  // 3) intra-host broadcast of the result
  if (local.size() > 1) {
    auto st = Broadcast(t, local, tag + 2, data, nelem * esz, 0);
    if (!st.ok()) return st;
  }
  if (op == ReduceOp::kAverage) {
    int total = local.size() * std::max(cross.size(), 1);
    ScaleBuffer(data, nelem, dtype, 1.0 / total);
  }
  ScaleBuffer(data, nelem, dtype, postscale);
  return Status::OK();
}

Status HierarchicalAllgatherV(Transport& t, const Group& local,
                              const Group& cross, bool is_leader,
                              int32_t tag, const void* send,
                              int64_t send_bytes,
                              std::vector<int64_t>* per_rank_bytes,
                              std::vector<uint8_t>* out) {
  int lsz = local.size(), csz = cross.size();
  int n_global = lsz * csz;
  if (!is_leader) {
    // 1) hand our block to the node leader (size prefix + data)...
    std::vector<uint8_t> pkt(sizeof(int64_t) + (size_t)send_bytes);
    memcpy(pkt.data(), &send_bytes, sizeof(int64_t));
    if (send_bytes > 0)
      memcpy(pkt.data() + sizeof(int64_t), send, send_bytes);
    auto st = t.Send(local.global(0), tag, pkt.data(), pkt.size());
    if (!st.ok()) return st;
    // ...then wait for the leader's fan-out: [n_global sizes][all data]
    std::vector<uint8_t> sizes_buf((size_t)n_global * sizeof(int64_t));
    st = Broadcast(t, local, tag + 3, sizes_buf.data(),
                   (int64_t)sizes_buf.size(), 0);
    if (!st.ok()) return st;
    per_rank_bytes->assign(n_global, 0);
    memcpy(per_rank_bytes->data(), sizes_buf.data(), sizes_buf.size());
    int64_t total = 0;
    for (auto b : *per_rank_bytes) total += b;
    out->resize((size_t)total);
    return Broadcast(t, local, tag + 4, out->data(), total, 0);
  }
  // leader: 1) gather local blocks in local-rank order
  std::vector<int64_t> local_sizes(lsz, 0);
  std::vector<std::vector<uint8_t>> local_blocks(lsz);
  local_sizes[0] = send_bytes;
  int64_t host_total = send_bytes;
  for (int i = 1; i < lsz; ++i) {
    std::vector<uint8_t> pkt;
    auto st = t.Recv(local.global(i), tag, &pkt);
    if (!st.ok()) return st;
    memcpy(&local_sizes[i], pkt.data(), sizeof(int64_t));
    local_blocks[i].assign(pkt.begin() + sizeof(int64_t), pkt.end());
    host_total += local_sizes[i];
  }
  // host concat: [sizes of my lsz ranks][their data in local-rank order]
  std::vector<uint8_t> host((size_t)lsz * sizeof(int64_t) +
                            (size_t)host_total);
  memcpy(host.data(), local_sizes.data(), (size_t)lsz * sizeof(int64_t));
  int64_t off = (int64_t)lsz * sizeof(int64_t);
  if (send_bytes > 0) memcpy(host.data() + off, send, send_bytes);
  off += send_bytes;
  for (int i = 1; i < lsz; ++i) {
    memcpy(host.data() + off, local_blocks[i].data(), local_sizes[i]);
    off += local_sizes[i];
  }
  // 2) leaders exchange host blocks; [cross][local] order IS global rank
  // order under the launcher's homogeneous topology contract
  std::vector<int64_t> per_host;
  std::vector<uint8_t> gathered;
  auto st = AllgatherV(t, cross, tag + 1, host.data(), (int64_t)host.size(),
                       &per_host, &gathered);
  if (!st.ok()) return st;
  per_rank_bytes->assign(n_global, 0);
  int64_t total = 0;
  {
    int64_t goff = 0;
    for (int c = 0; c < csz; ++c) {
      memcpy(per_rank_bytes->data() + (size_t)c * lsz,
             gathered.data() + goff, (size_t)lsz * sizeof(int64_t));
      goff += per_host[c];
    }
    for (auto b : *per_rank_bytes) total += b;
  }
  out->clear();
  out->reserve((size_t)total);
  {
    int64_t goff = 0;
    for (int c = 0; c < csz; ++c) {
      const uint8_t* data0 = gathered.data() + goff +
                             (int64_t)lsz * sizeof(int64_t);
      int64_t data_bytes = per_host[c] - (int64_t)lsz * sizeof(int64_t);
      out->insert(out->end(), data0, data0 + data_bytes);
      goff += per_host[c];
    }
  }
  // 3) fan the result out to local members
  if (lsz > 1) {
    std::vector<uint8_t> sizes_buf((size_t)n_global * sizeof(int64_t));
    memcpy(sizes_buf.data(), per_rank_bytes->data(), sizes_buf.size());
    st = Broadcast(t, local, tag + 3, sizes_buf.data(),
                   (int64_t)sizes_buf.size(), 0);
    if (!st.ok()) return st;
    st = Broadcast(t, local, tag + 4, out->data(), total, 0);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

Status AllgatherV(Transport& t, const Group& g, int32_t tag,
                  const void* send, int64_t send_bytes,
                  std::vector<int64_t>* per_rank_bytes,
                  std::vector<uint8_t>* out) {
  int size = g.size();
  int me = g.my_index;
  per_rank_bytes->assign(size, 0);
  (*per_rank_bytes)[me] = send_bytes;
  // exchange sizes (pairwise)
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    auto st = t.Send(g.global(i), tag, &send_bytes, sizeof(int64_t));
    if (!st.ok()) return st;
  }
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    std::vector<uint8_t> buf;
    auto st = t.Recv(g.global(i), tag, &buf);
    if (!st.ok()) return st;
    memcpy(&(*per_rank_bytes)[i], buf.data(), sizeof(int64_t));
  }
  int64_t total = 0;
  std::vector<int64_t> offs(size);
  for (int i = 0; i < size; ++i) {
    offs[i] = total;
    total += (*per_rank_bytes)[i];
  }
  out->resize(total);
  memcpy(out->data() + offs[me], send, send_bytes);
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    auto st = t.Send(g.global(i), tag + 1, send, send_bytes);
    if (!st.ok()) return st;
  }
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    std::vector<uint8_t> buf;
    auto st = t.Recv(g.global(i), tag + 1, &buf);
    if (!st.ok()) return st;
    memcpy(out->data() + offs[i], buf.data(), buf.size());
  }
  return Status::OK();
}

Status Broadcast(Transport& t, const Group& g, int32_t tag, void* data,
                 int64_t nbytes, int root_index) {
  int size = g.size();
  int me = g.my_index;
  // binomial tree rooted at root_index (rotate indices)
  int vrank = (me - root_index + size) % size;
  int mask = 1;
  while (mask < size) {
    if (vrank < mask) {
      int vpeer = vrank + mask;
      if (vpeer < size) {
        int peer = g.global((vpeer + root_index) % size);
        auto st = t.Send(peer, tag, data, nbytes);
        if (!st.ok()) return st;
      }
    } else if (vrank < 2 * mask) {
      int vpeer = vrank - mask;
      int peer = g.global((vpeer + root_index) % size);
      std::vector<uint8_t> buf;
      auto st = t.Recv(peer, tag, &buf);
      if (!st.ok()) return st;
      memcpy(data, buf.data(), std::min((int64_t)buf.size(), nbytes));
    }
    mask <<= 1;
  }
  return Status::OK();
}

Status AlltoallV(Transport& t, const Group& g, int32_t tag, const void* send,
                 const std::vector<int64_t>& splits, int64_t row_bytes,
                 std::vector<int64_t>* recv_splits,
                 std::vector<uint8_t>* out) {
  int size = g.size();
  int me = g.my_index;
  if ((int)splits.size() != size)
    return Status::Error("alltoall splits must have one entry per rank");
  recv_splits->assign(size, 0);
  (*recv_splits)[me] = splits[me];
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    auto st = t.Send(g.global(i), tag, &splits[i], sizeof(int64_t));
    if (!st.ok()) return st;
  }
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    std::vector<uint8_t> buf;
    auto st = t.Recv(g.global(i), tag, &buf);
    if (!st.ok()) return st;
    memcpy(&(*recv_splits)[i], buf.data(), sizeof(int64_t));
  }
  std::vector<int64_t> send_offs(size), recv_offs(size);
  int64_t so = 0, ro = 0;
  for (int i = 0; i < size; ++i) {
    send_offs[i] = so;
    so += splits[i] * row_bytes;
    recv_offs[i] = ro;
    ro += (*recv_splits)[i] * row_bytes;
  }
  out->resize(ro);
  memcpy(out->data() + recv_offs[me], (const uint8_t*)send + send_offs[me],
         splits[me] * row_bytes);
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    auto st = t.Send(g.global(i), tag + 1,
                     (const uint8_t*)send + send_offs[i],
                     splits[i] * row_bytes);
    if (!st.ok()) return st;
  }
  for (int i = 0; i < size; ++i) {
    if (i == me) continue;
    std::vector<uint8_t> buf;
    auto st = t.Recv(g.global(i), tag + 1, &buf);
    if (!st.ok()) return st;
    memcpy(out->data() + recv_offs[i], buf.data(), buf.size());
  }
  return Status::OK();
}

Status Barrier(Transport& t, const Group& g, int32_t tag) {
  uint8_t b = 1;
  std::vector<uint8_t> bits(1, 1);
  return BitvectorAnd(t, g, tag, &bits);
  (void)b;
}

static Status BitvectorOp(Transport& t, const Group& g, int32_t tag,
                          std::vector<uint8_t>* bits, bool is_and) {
  // gather to group root (index 0), combine, broadcast back
  int me = g.my_index;
  if (me == 0) {
    for (int i = 1; i < g.size(); ++i) {
      std::vector<uint8_t> buf;
      auto st = t.Recv(g.global(i), tag, &buf);
      if (!st.ok()) return st;
      for (size_t j = 0; j < bits->size() && j < buf.size(); ++j) {
        if (is_and)
          (*bits)[j] &= buf[j];
        else
          (*bits)[j] |= buf[j];
      }
    }
    for (int i = 1; i < g.size(); ++i) {
      auto st = t.Send(g.global(i), tag + 1, bits->data(), bits->size());
      if (!st.ok()) return st;
    }
  } else {
    auto st = t.Send(g.global(0), tag, bits->data(), bits->size());
    if (!st.ok()) return st;
    std::vector<uint8_t> buf;
    st = t.Recv(g.global(0), tag + 1, &buf);
    if (!st.ok()) return st;
    *bits = std::move(buf);
  }
  return Status::OK();
}

Status BitvectorAnd(Transport& t, const Group& g, int32_t tag,
                    std::vector<uint8_t>* bits) {
  return BitvectorOp(t, g, tag, bits, true);
}

Status BitvectorOr(Transport& t, const Group& g, int32_t tag,
                   std::vector<uint8_t>* bits) {
  return BitvectorOp(t, g, tag, bits, false);
}

}  // namespace hvd
