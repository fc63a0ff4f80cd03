// The port's copy of cpp/transport.cc, built in its place into the port's
// libhvdcore (horovod_tpu_torch/core/__init__.py). One departure: a send to
// a peer whose reader has recorded an integrity failure (peer_error_) and
// shut the socket fails with that recorded message, as a receive waiting on
// the peer does, not with "socket send failed". In cpp/ which of the two a
// collective names after a corrupted frame depends on whether its thread
// was sending or receiving when the reader shut the socket.
#include "transport.h"
#include "logging.h"
#include "wire.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace hvd {

namespace {

// Parse the HVD_TPU_CHAOS_TRANSPORT spec (see TransportChaos in
// transport.h).  Malformed entries are skipped with a log line — a typo
// in a chaos spec must degrade to "fault not armed", never crash the job
// it was meant to test.
std::unique_ptr<TransportChaos> ParseChaosEnv(int size) {
  const char* env = getenv("HVD_TPU_CHAOS_TRANSPORT");
  if (env == nullptr || env[0] == '\0') return nullptr;
  auto chaos = std::unique_ptr<TransportChaos>(new TransportChaos(size));
  std::string spec(env);
  size_t pos = 0;
  while (pos <= spec.size()) {
    size_t end = spec.find(';', pos);
    if (end == std::string::npos) end = spec.size();
    std::string entry = spec.substr(pos, end - pos);
    pos = end + 1;
    if (entry.empty()) continue;
    TransportChaosRule rule;
    bool ok = !entry.empty(), have_dir = false, have_kind = false;
    size_t fpos = 0;
    while (fpos <= entry.size()) {
      size_t fend = entry.find(':', fpos);
      if (fend == std::string::npos) fend = entry.size();
      std::string field = entry.substr(fpos, fend - fpos);
      fpos = fend + 1;
      size_t eq = field.find('=');
      if (eq == std::string::npos) { ok = false; break; }
      std::string k = field.substr(0, eq), v = field.substr(eq + 1);
      if (k == "dir") {
        have_dir = true;
        if (v == "recv") rule.recv = true;
        else if (v == "send") rule.recv = false;
        else ok = false;
      } else if (k == "kind") {
        have_kind = true;
        if (v == "delay") rule.kind = 0;
        else if (v == "drop") rule.kind = 1;
        else if (v == "close") rule.kind = 2;
        else if (v == "bit_flip") rule.kind = 3;
        else ok = false;
      } else if (k == "peer") {
        rule.peer = (v == "*") ? -1 : atoi(v.c_str());
      } else if (k == "after") {
        rule.after = strtoull(v.c_str(), nullptr, 10);
      } else if (k == "count") {
        rule.count = strtoull(v.c_str(), nullptr, 10);
      } else if (k == "ms") {
        rule.ms = atof(v.c_str());
      } else if (k == "minb") {
        rule.min_bytes = strtoull(v.c_str(), nullptr, 10);
      } else if (k == "fires") {
        rule.fires = strtoull(v.c_str(), nullptr, 10);
      } else {
        ok = false;
      }
    }
    if (ok && have_dir && have_kind) {
      chaos->rules.push_back(rule);
    } else {
      HVD_LOG(Warning) << "chaos: ignoring malformed transport rule '"
                       << entry << "'";
    }
  }
  if (chaos->rules.empty()) return nullptr;
  chaos->rule_fired.reset(new std::atomic<uint64_t>[chaos->rules.size()]);
  for (size_t i = 0; i < chaos->rules.size(); ++i) {
    chaos->rule_fired[i] = 0;
    if (chaos->rules[i].kind == 3) chaos->has_bit_flip = true;
  }
  HVD_LOG(Warning) << "chaos: transport faults armed ("
                   << chaos->rules.size() << " rule(s): " << spec << ")";
  return chaos;
}

Status WriteAll(int fd, const void* data, size_t len) {
  const uint8_t* p = (const uint8_t*)data;
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      return Status::Error("socket send failed: " +
                           std::string(strerror(errno)));
    }
    p += n;
    len -= n;
  }
  return Status::OK();
}

int64_t NowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// `activity` (optional) is stamped after every successful chunk, so a
// peer slowly streaming one large frame keeps registering as alive for
// the recv inactivity deadline.
Status ReadAll(int fd, void* data, size_t len,
               std::atomic<int64_t>* activity = nullptr) {
  uint8_t* p = (uint8_t*)data;
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return Status::Error("socket recv failed/closed");
    }
    if (activity) activity->store(NowNs());
    p += n;
    len -= n;
  }
  return Status::OK();
}

int MakeListenSocket(int port, int* actual_port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  if (listen(fd, 128) != 0) {
    close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &alen);
  if (actual_port) *actual_port = ntohs(addr.sin_port);
  return fd;
}

void SetNoDelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

}  // namespace

Transport::Transport(int rank, int size, const std::string& coord_addr,
                     int coord_port, double connect_timeout_secs,
                     double recv_timeout_secs, bool wire_checksum)
    : rank_(rank), size_(size), coord_addr_(coord_addr),
      coord_port_(coord_port),
      connect_timeout_secs_(connect_timeout_secs),
      recv_timeout_secs_(recv_timeout_secs),
      checksum_enabled_(wire_checksum),
      chaos_(ParseChaosEnv(size)), last_rx_ns_(size) {
  for (int i = 0; i < size; ++i) last_rx_ns_[i] = 0;
  peer_fds_.assign(size, -1);
  inbox_.resize(size);
  dead_.assign(size, false);
  peer_error_.assign(size, std::string());
  for (int i = 0; i < size; ++i)
    send_mu_.emplace_back(new std::mutex());
}

bool Transport::ChaosOnFrame(bool recv, int peer, uint8_t* payload,
                             size_t len) {
  // chaos_ checked by the caller; frame indices count per peer per
  // direction so `after` means "the Nth frame exchanged with THAT peer"
  uint64_t seq = recv ? chaos_->recv_seen[peer].fetch_add(1)
                      : chaos_->send_seen[peer].fetch_add(1);
  bool drop = false;
  for (size_t ri = 0; ri < chaos_->rules.size(); ++ri) {
    const auto& r = chaos_->rules[ri];
    if (r.recv != recv) continue;
    if (r.peer != -1 && r.peer != peer) continue;
    if (seq < r.after) continue;
    if (r.count != 0 && seq >= r.after + r.count) continue;
    if (r.min_bytes != 0 && len < r.min_bytes) continue;
    if (r.fires != 0 &&
        chaos_->rule_fired[ri].fetch_add(1) >= r.fires) {
      continue;  // fire budget spent (fetch_add keeps it spent)
    }
    chaos_->injected.fetch_add(1);
    if (r.kind == 0) {  // delay
      HVD_LOG(Warning) << "chaos: delaying " << (recv ? "recv" : "send")
                       << " frame " << seq << " from/to peer " << peer
                       << " by " << r.ms << "ms";
      usleep((useconds_t)(r.ms * 1000.0));
    } else if (r.kind == 1) {  // drop
      HVD_LOG(Warning) << "chaos: dropping " << (recv ? "recv" : "send")
                       << " frame " << seq << " (peer " << peer << ")";
      drop = true;
    } else if (r.kind == 3) {  // bit_flip: corrupt one payload byte.
      // On the send side this runs AFTER the frame's CRC was computed
      // — the flip models corruption ON THE WIRE, which is exactly
      // what the checksum must catch (docs/CHAOS.md "Wire integrity").
      if (payload != nullptr && len > 0) {
        // bit 7 of the middle byte, not bit 0: for little-endian f32
        // payloads the lowest mantissa bit of a flipped addend can
        // ROUND AWAY in the reduction (1.0 + (1.0+2^-23) == 2.0f
        // exactly), which would make the undetected-corruption half of
        // the acceptance flaky — a higher-order bit always survives
        payload[len / 2] ^= 0x80;
        HVD_LOG(Warning) << "chaos: bit-flipping "
                         << (recv ? "recv" : "send") << " frame " << seq
                         << " (peer " << peer << ", " << len
                         << " bytes, offset " << (len / 2) << ")";
      }
    } else {  // close: reset the peer's socket mid-stream
      HVD_LOG(Warning) << "chaos: closing socket to peer " << peer
                       << " at frame " << seq;
      int fd = peer_fds_[peer];
      if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
      drop = true;
    }
  }
  return drop;
}

Transport::~Transport() { Shutdown(); }

Status Transport::ConnectTo(const std::string& host, int port, int* fd_out) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  bool is_literal = inet_pton(AF_INET, host.c_str(), &addr.sin_addr) == 1;
  // retry loop: peers may not be listening yet — and at fleet startup a
  // hostname may not RESOLVE yet either (records published as VMs come
  // up), so name resolution retries under the same deadline. Deadline =
  // the HOROVOD_GLOO_TIMEOUT_SECONDS-equivalent knob.
  std::string last_err = "unresolved";
  int attempts = std::max(1, (int)(connect_timeout_secs_ * 10));
  for (int attempt = 0; attempt < attempts; ++attempt) {
    if (attempt > 0) usleep(100 * 1000);
    if (!is_literal) {
      // TPU-VM fleets (and the Ray/Spark integrations) hand out
      // hostnames; the reference resolves through Gloo's rendezvous
      addrinfo hints{};
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      addrinfo* res = nullptr;
      int rc = getaddrinfo(host.c_str(), nullptr, &hints, &res);
      if (rc != 0 || res == nullptr) {
        last_err = std::string("bad address: ") + gai_strerror(rc);
        if (res) freeaddrinfo(res);
        continue;
      }
      addr.sin_addr = ((sockaddr_in*)res->ai_addr)->sin_addr;
      freeaddrinfo(res);
    }
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return Status::Error("socket() failed");
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0) {
      SetNoDelay(fd);
      *fd_out = fd;
      return Status::OK();
    }
    last_err = strerror(errno);
    close(fd);
  }
  return Status::Error("could not connect to " + host + ":" +
                       std::to_string(port) + " within " +
                       std::to_string((int)connect_timeout_secs_) +
                       "s (" + last_err + ")");
}

Status Transport::Init() {
  if (size_ == 1) return Status::OK();
  // Every rank opens its own listen socket on an ephemeral port.
  int my_port = 0;
  listen_fd_ = MakeListenSocket(rank_ == 0 ? coord_port_ : 0, &my_port);
  if (listen_fd_ < 0) return Status::Error("listen socket failed");

  // Rendezvous: rank 0 accepts size-1 registrations (rank, port), replies
  // with the full table; like the reference's KV-store rendezvous
  // (gloo_context.cc:67-94) with rank 0 as the store.
  std::vector<std::string> hosts(size_);
  std::vector<int> ports(size_, 0);
  hosts[0] = coord_addr_;
  ports[0] = my_port;

  if (rank_ == 0) {
    std::vector<int> reg_fds(size_, -1);
    for (int i = 1; i < size_; ++i) {
      sockaddr_in peer{};
      socklen_t plen = sizeof(peer);
      int fd = accept(listen_fd_, (sockaddr*)&peer, &plen);
      if (fd < 0) return Status::Error("accept failed in rendezvous");
      SetNoDelay(fd);
      int32_t hdr[2];
      auto st = ReadAll(fd, hdr, sizeof(hdr));
      if (!st.ok()) return st;
      int r = hdr[0];
      char ip[64];
      inet_ntop(AF_INET, &peer.sin_addr, ip, sizeof(ip));
      hosts[r] = ip;
      ports[r] = hdr[1];
      reg_fds[r] = fd;
    }
    // broadcast table
    wire::Writer w;
    for (int i = 0; i < size_; ++i) {
      w.str(hosts[i]);
      w.i32(ports[i]);
    }
    for (int i = 1; i < size_; ++i) {
      int32_t len = (int32_t)w.buf.size();
      auto st = WriteAll(reg_fds[i], &len, 4);
      if (st.ok()) st = WriteAll(reg_fds[i], w.buf.data(), w.buf.size());
      if (!st.ok()) return st;
      close(reg_fds[i]);
    }
  } else {
    int fd;
    auto st = ConnectTo(coord_addr_, coord_port_, &fd);
    if (!st.ok()) return st;
    int32_t hdr[2] = {rank_, my_port};
    st = WriteAll(fd, hdr, sizeof(hdr));
    if (!st.ok()) return st;
    int32_t len;
    st = ReadAll(fd, &len, 4);
    if (!st.ok()) return st;
    std::vector<uint8_t> buf(len);
    st = ReadAll(fd, buf.data(), len);
    if (!st.ok()) return st;
    close(fd);
    wire::Reader rd(buf.data(), buf.size());
    for (int i = 0; i < size_; ++i) {
      hosts[i] = rd.str();
      ports[i] = rd.i32();
    }
  }

  // Full mesh: connect to lower ranks; accept from higher ranks.
  for (int peer = 0; peer < rank_; ++peer) {
    int fd;
    auto st = ConnectTo(hosts[peer], ports[peer], &fd);
    if (!st.ok()) return st;
    int32_t me = rank_;
    st = WriteAll(fd, &me, 4);
    if (!st.ok()) return st;
    peer_fds_[peer] = fd;
  }
  for (int i = rank_ + 1; i < size_; ++i) {
    int fd = accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return Status::Error("accept failed in mesh setup");
    SetNoDelay(fd);
    int32_t who;
    auto st = ReadAll(fd, &who, 4);
    if (!st.ok()) return st;
    peer_fds_[who] = fd;
  }

  for (int peer = 0; peer < size_; ++peer) {
    if (peer == rank_) continue;
    readers_.emplace_back([this, peer] { ReaderLoop(peer); });
  }
  return Status::OK();
}

std::shared_ptr<Transport::TagQueue> Transport::GetQueue(int peer,
                                                         int32_t tag) {
  std::lock_guard<std::mutex> lk(inbox_mu_);
  auto& m = inbox_[peer];
  auto it = m.find(tag);
  if (it == m.end()) {
    auto q = std::make_shared<TagQueue>();
    if (dead_[peer]) q->closed = true;  // peer already gone
    m[tag] = q;
    return q;
  }
  return it->second;
}

void Transport::ReaderLoop(int peer) {
  int fd = peer_fds_[peer];
  for (;;) {
    // tag, len [, frame crc32c, header crc32c with the checksum on]
    int32_t hdr[4];
    size_t hdr_len = checksum_enabled_ ? sizeof(hdr) : 8;
    int64_t before = last_rx_ns_[peer].load();
    if (!ReadAll(fd, hdr, hdr_len, &last_rx_ns_[peer]).ok()) break;
    bool bad_header = hdr[1] < 0;  // a negative length is never real,
    // and would drive a garbage allocation below (the pre-checksum
    // hazard too, so it is checked in both modes)
    if (checksum_enabled_ && !bad_header) {
      // validate the HEADER'S OWN crc before trusting the length: a
      // flipped bit in the len field would otherwise block the reader
      // (or blow the allocation) before the frame CRC could fail —
      // exactly the corruption this layer must catch, not hang on
      uint32_t want_h;
      memcpy(&want_h, &hdr[3], 4);
      bad_header = wire::Crc32c(hdr, 8) != want_h;
    }
    if (bad_header) {
      if (checksum_enabled_) checksum_failures_.fetch_add(1);
      char buf[128];
      snprintf(buf, sizeof(buf),
               "wire corruption from peer %d: frame header failed "
               "verification (tag=%d, len=%d)", peer, hdr[0], hdr[1]);
      HVD_LOG(Error) << buf;
      {
        std::lock_guard<std::mutex> lk(inbox_mu_);
        peer_error_[peer] = buf;
      }
      ::shutdown(fd, SHUT_RDWR);
      break;
    }
    std::vector<uint8_t> payload(hdr[1]);
    if (hdr[1] > 0 &&
        !ReadAll(fd, payload.data(), hdr[1], &last_rx_ns_[peer]).ok())
      break;
    // chaos seam: zero-cost when off (one null test per frame)
    if (chaos_ && ChaosOnFrame(/*recv=*/true, peer, payload.data(),
                               payload.size())) {
      // an injected drop/close must look like SILENCE to the recv
      // deadline — that is the wedged-peer scenario it simulates
      last_rx_ns_[peer].store(before);
      continue;
    }
    if (checksum_enabled_) {
      // verify AFTER the chaos seam: a recv-side bit_flip models the
      // same on-the-wire corruption a send-side one does
      uint32_t want;
      memcpy(&want, &hdr[2], 4);
      uint32_t got = wire::Crc32c(hdr, 8);
      got = wire::Crc32c(payload.data(), payload.size(), got);
      if (got != want) {
        checksum_failures_.fetch_add(1);
        char buf[160];
        snprintf(buf, sizeof(buf),
                 "wire checksum mismatch on frame from peer %d (tag=%d,"
                 " len=%d, crc 0x%08x != expected 0x%08x): corrupted"
                 " data on the eager wire; closing the connection",
                 peer, hdr[0], hdr[1], got, want);
        HVD_LOG(Error) << buf
                       << " (HVD_TPU_WIRE_CHECKSUM; "
                       << "transport_checksum_failures counts these)";
        {
          std::lock_guard<std::mutex> lk(inbox_mu_);
          peer_error_[peer] = buf;
        }
        // a corrupt stream is unrecoverable (the length field itself
        // may be lying): reset the socket so the PEER also observes
        // the failure and both sides enter elastic recovery
        ::shutdown(fd, SHUT_RDWR);
        break;
      }
    }
    auto q = GetQueue(peer, hdr[0]);
    {
      std::lock_guard<std::mutex> lk(q->mu);
      q->q.push(std::move(payload));
    }
    q->cv.notify_all();
  }
  // close all queues for this peer so blocked recvs fail fast; mark the
  // peer dead so queues created later are born closed
  std::lock_guard<std::mutex> lk(inbox_mu_);
  dead_[peer] = true;
  for (auto& kv : inbox_[peer]) {
    std::lock_guard<std::mutex> qk(kv.second->mu);
    kv.second->closed = true;
    kv.second->cv.notify_all();
  }
}

Status Transport::Send(int peer, int32_t tag, const void* data, size_t len) {
  if (peer == rank_) {
    auto q = GetQueue(peer, tag);
    std::vector<uint8_t> payload((const uint8_t*)data,
                                 (const uint8_t*)data + len);
    {
      std::lock_guard<std::mutex> lk(q->mu);
      q->q.push(std::move(payload));
    }
    q->cv.notify_all();
    return Status::OK();
  }
  std::lock_guard<std::mutex> lk(*send_mu_[peer]);
  // header: {tag, len, frame_crc, hdr_crc}; the last two only when the
  // wire checksum is on.  hdr_crc covers (tag, len) ALONE so the
  // receiver can validate the length BEFORE allocating/reading the
  // payload — a flipped bit in the length field must be detected
  // immediately, not hang the reader waiting for bytes that never come
  int32_t hdr[4] = {tag, (int32_t)len, 0, 0};
  if (checksum_enabled_) {
    // frame CRC over header (tag+len) then payload, computed BEFORE
    // the chaos seam below may corrupt the bytes: a send-side bit_flip
    // models corruption on the wire, after checksumming — the case the
    // recv-side verification exists to catch
    uint32_t crc = wire::Crc32c(hdr, 8);
    crc = wire::Crc32c(data, len, crc);
    memcpy(&hdr[2], &crc, 4);
    uint32_t hcrc = wire::Crc32c(hdr, 8);
    memcpy(&hdr[3], &hcrc, 4);
  }
  // chaos seam: a dropped send is written NOWHERE — the peer starves,
  // which is exactly the wedged-peer scenario the recv deadline
  // catches; a bit_flip corrupts a COPY of the payload (the caller's
  // tensor bytes must stay intact — the fault is on the wire, not in
  // host memory)
  std::vector<uint8_t> corrupted;
  const void* out_data = data;
  if (chaos_) {
    uint8_t* mut = nullptr;
    if (chaos_->has_bit_flip && len > 0) {
      corrupted.assign((const uint8_t*)data, (const uint8_t*)data + len);
      mut = corrupted.data();
      out_data = mut;
    }
    if (ChaosOnFrame(/*recv=*/false, peer, mut, len))
      return Status::OK();
  }
  int fd = peer_fds_[peer];
  if (fd < 0) return Status::Error("no connection to peer");
  size_t hdr_len = checksum_enabled_ ? sizeof(hdr) : 8;
  auto st = WriteAll(fd, hdr, hdr_len);
  if (st.ok()) st = WriteAll(fd, out_data, len);
  if (!st.ok()) {
    // the reader records an integrity failure before it shuts the socket
    // down, so a send that the shutdown broke always finds the record
    std::lock_guard<std::mutex> ik(inbox_mu_);
    if (!peer_error_[peer].empty()) return Status::Error(peer_error_[peer]);
  }
  return st;
}

Status Transport::Recv(int peer, int32_t tag, std::vector<uint8_t>* out) {
  auto q = GetQueue(peer, tag);
  std::unique_lock<std::mutex> lk(q->mu);
  if (recv_timeout_secs_ > 0) {
    // inactivity deadline: the engine's lockstep cycle keeps frames
    // flowing every few ms while peers are healthy, so a silent gap of
    // this length means a dead-but-connected peer (SIGSTOP, wedged
    // host, half-open TCP) — surface it instead of blocking forever.
    // The clock is per-peer DELIVERED-byte activity (stamped chunk-wise
    // by ReaderLoop), not this tag queue's emptiness: a healthy peer
    // slowly streaming one large fused frame keeps resetting it.
    const int64_t timeout_ns = (int64_t)(recv_timeout_secs_ * 1e9);
    const int64_t waited_from = NowNs();
    while (q->q.empty() && !q->closed) {
      q->cv.wait_for(lk, std::chrono::milliseconds(200));
      if (!q->q.empty() || q->closed) break;
      int64_t base = waited_from;
      if (peer != rank_) base = std::max(base, last_rx_ns_[peer].load());
      if (NowNs() - base > timeout_ns) {
        return Status::Error(
            "transport timeout: no data from peer " +
            std::to_string(peer) + " for " +
            std::to_string(recv_timeout_secs_) +
            "s (HVD_TPU_TRANSPORT_TIMEOUT_S); peer is wedged or "
            "unreachable");
      }
    }
  } else {
    q->cv.wait(lk, [&] { return !q->q.empty() || q->closed; });
  }
  if (q->q.empty()) {
    // integrity failures carry their own cause: the waiter's error must
    // NAME the corrupting peer, not read as a generic peer loss.
    // Release the queue lock first — the reader's close-out path locks
    // inbox_mu_ then each queue, so taking inbox_mu_ while holding
    // q->mu would invert the order and risk a deadlock.
    lk.unlock();
    {
      std::lock_guard<std::mutex> ik(inbox_mu_);
      if (peer >= 0 && peer < (int)peer_error_.size() &&
          !peer_error_[peer].empty())
        return Status::Error(peer_error_[peer]);
    }
    return Status::Aborted("connection closed");
  }
  *out = std::move(q->q.front());
  q->q.pop();
  return Status::OK();
}

void Transport::Shutdown() {
  if (shutting_down_.exchange(true)) return;
  {
    // unblock every pending and future Recv
    std::lock_guard<std::mutex> lk(inbox_mu_);
    for (size_t p = 0; p < inbox_.size(); ++p) {
      dead_[p] = true;
      for (auto& kv : inbox_[p]) {
        std::lock_guard<std::mutex> qk(kv.second->mu);
        kv.second->closed = true;
        kv.second->cv.notify_all();
      }
    }
  }
  for (auto& fd : peer_fds_) {
    if (fd >= 0) {
      ::shutdown(fd, SHUT_RDWR);
    }
  }
  if (listen_fd_ >= 0) close(listen_fd_);
  for (auto& t : readers_)
    if (t.joinable()) t.join();
  for (auto& fd : peer_fds_) {
    if (fd >= 0) close(fd);
    fd = -1;
  }
  listen_fd_ = -1;
}

}  // namespace hvd
