// pt_native — native host runtime of paddle_tpu_torch (a copy of the
// repository's csrc/pt_native.cc, the same C ABI).
//
// Host-side pieces of the reference's C++ runtime:
//   * TCPStore   — rendezvous KV store for multi-host bootstrap
//                  (reference: paddle/phi/core/distributed/store/tcp_store.h:121)
//   * ShmRing    — process-shared-memory ring buffer moving serialized batches
//                  from dataloader worker processes to the trainer process
//                  (reference: paddle/fluid/memory/allocation/mmap_allocator.*
//                   feeding dataloader_iter.py's multi-process path)
//   * host ops   — parallel batch-assembly hot loops (image normalize,
//                  ragged-sequence padding, row gather) on the input
//                  pipeline's path to the card
//                  (reference: paddle/fluid/framework/data_feed.cc)
//   * HostPool   — stats-tracking host staging allocator
//                  (reference: paddle/fluid/memory/allocation/allocator_facade.h:45,
//                   paddle/fluid/memory/stats.h)
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (paddle_tpu_torch/native/__init__.py), built with g++ (no nvcc). No
// Python.h dependency: the library is GIL-free by construction and usable
// from any worker process.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// small socket helpers
// ---------------------------------------------------------------------------

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// ---------------------------------------------------------------------------
// TCPStore
//
// Wire protocol (little-endian):
//   request:  u8 cmd | u32 key_len | key | u64 val_len | val
//   response: u8 status (0=ok, 1=not_found/timeout) | u64 len | payload
// Commands: SET=1 GET=2(blocking) ADD=3(val = i64 delta, returns i64)
//           WAIT=4 DELETE=5 TRYGET=6(non-blocking) NUMKEYS=7
// ---------------------------------------------------------------------------

enum StoreCmd : uint8_t {
  kSet = 1,
  kGet = 2,
  kAdd = 3,
  kWait = 4,
  kDelete = 5,
  kTryGet = 6,
  kNumKeys = 7,
};

class StoreServer {
 public:
  explicit StoreServer(int port) : port_(port) {}

  bool Start() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
        0) {
      ::close(listen_fd_);
      return false;
    }
    if (port_ == 0) {  // ephemeral: report the bound port
      socklen_t len = sizeof(addr);
      ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
      port_ = ntohs(addr.sin_port);
    }
    if (::listen(listen_fd_, 128) != 0) {
      ::close(listen_fd_);
      return false;
    }
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    return true;
  }

  void Stop() {
    stop_.store(true);
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    cv_.notify_all();
    {
      // kick Serve threads blocked in recv on live client sockets — without
      // this, Stop() would hang until every remote client disconnects
      std::lock_guard<std::mutex> g(workers_mu_);
      for (int fd : client_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    std::vector<std::thread> workers;
    {
      std::lock_guard<std::mutex> g(workers_mu_);
      workers.swap(workers_);
    }
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }

  int port() const { return port_; }

  ~StoreServer() { Stop(); }

 private:
  void AcceptLoop() {
    while (!stop_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (stop_.load()) break;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(workers_mu_);
      client_fds_.push_back(fd);
      workers_.emplace_back([this, fd] { Serve(fd); });
    }
  }

  void Reply(int fd, uint8_t status, const std::string& payload) {
    uint64_t len = payload.size();
    std::string out;
    out.reserve(9 + payload.size());
    out.push_back(static_cast<char>(status));
    out.append(reinterpret_cast<char*>(&len), 8);
    out.append(payload);
    send_all(fd, out.data(), out.size());
  }

  void Serve(int fd) {
    for (;;) {
      uint8_t cmd;
      uint32_t key_len;
      uint64_t val_len;
      if (!recv_all(fd, &cmd, 1)) break;
      if (!recv_all(fd, &key_len, 4)) break;
      std::string key(key_len, '\0');
      if (key_len && !recv_all(fd, &key[0], key_len)) break;
      if (!recv_all(fd, &val_len, 8)) break;
      std::string val(val_len, '\0');
      if (val_len && !recv_all(fd, &val[0], val_len)) break;

      switch (cmd) {
        case kSet: {
          {
            std::lock_guard<std::mutex> g(mu_);
            data_[key] = val;
          }
          cv_.notify_all();
          Reply(fd, 0, "");
          break;
        }
        case kAdd: {
          int64_t delta = 0;
          if (val.size() == 8) memcpy(&delta, val.data(), 8);
          int64_t now;
          {
            std::lock_guard<std::mutex> g(mu_);
            int64_t cur = 0;
            auto it = data_.find(key);
            if (it != data_.end() && it->second.size() == 8)
              memcpy(&cur, it->second.data(), 8);
            now = cur + delta;
            std::string stored(8, '\0');
            memcpy(&stored[0], &now, 8);
            data_[key] = stored;
          }
          cv_.notify_all();
          std::string payload(8, '\0');
          memcpy(&payload[0], &now, 8);
          Reply(fd, 0, payload);
          break;
        }
        case kGet:
        case kWait: {
          // val carries an optional u64 timeout in ms (0 = forever)
          uint64_t timeout_ms = 0;
          if (val.size() == 8) memcpy(&timeout_ms, val.data(), 8);
          std::unique_lock<std::mutex> g(mu_);
          auto ready = [&] { return stop_.load() || data_.count(key) > 0; };
          bool ok;
          if (timeout_ms == 0) {
            cv_.wait(g, ready);
            ok = data_.count(key) > 0;
          } else {
            ok = cv_.wait_for(g, std::chrono::milliseconds(timeout_ms), ready) &&
                 data_.count(key) > 0;
          }
          if (!ok) {
            g.unlock();
            Reply(fd, 1, "");
          } else {
            std::string payload = (cmd == kGet) ? data_[key] : "";
            g.unlock();
            Reply(fd, 0, payload);
          }
          break;
        }
        case kTryGet: {
          std::unique_lock<std::mutex> g(mu_);
          auto it = data_.find(key);
          if (it == data_.end()) {
            g.unlock();
            Reply(fd, 1, "");
          } else {
            std::string payload = it->second;
            g.unlock();
            Reply(fd, 0, payload);
          }
          break;
        }
        case kDelete: {
          size_t n;
          {
            std::lock_guard<std::mutex> g(mu_);
            n = data_.erase(key);
          }
          Reply(fd, n ? 0 : 1, "");
          break;
        }
        case kNumKeys: {
          int64_t n;
          {
            std::lock_guard<std::mutex> g(mu_);
            n = static_cast<int64_t>(data_.size());
          }
          std::string payload(8, '\0');
          memcpy(&payload[0], &n, 8);
          Reply(fd, 0, payload);
          break;
        }
        default:
          Reply(fd, 1, "");
          break;
      }
    }
    {
      // unregister before close: the fd number may be reused by a new
      // connection the instant it's closed
      std::lock_guard<std::mutex> g(workers_mu_);
      client_fds_.erase(std::remove(client_fds_.begin(), client_fds_.end(), fd),
                        client_fds_.end());
    }
    ::close(fd);
  }

  int port_;
  int listen_fd_ = -1;
  std::atomic<bool> stop_{false};
  std::thread accept_thread_;
  std::mutex workers_mu_;
  std::vector<std::thread> workers_;
  std::vector<int> client_fds_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, std::string> data_;
};

class StoreClient {
 public:
  bool Connect(const char* host, int port, int timeout_ms) {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    char port_s[16];
    snprintf(port_s, sizeof(port_s), "%d", port);
    if (::getaddrinfo(host, port_s, &hints, &res) != 0 || !res) return false;
    // retry until the server comes up or the deadline passes (rendezvous:
    // workers may dial before the master binds)
    timespec start;
    clock_gettime(CLOCK_MONOTONIC, &start);
    for (;;) {
      fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd_ >= 0 &&
          ::connect(fd_, res->ai_addr, res->ai_addrlen) == 0) {
        int one = 1;
        ::setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        ::freeaddrinfo(res);
        return true;
      }
      if (fd_ >= 0) ::close(fd_);
      fd_ = -1;
      timespec now;
      clock_gettime(CLOCK_MONOTONIC, &now);
      long elapsed_ms = (now.tv_sec - start.tv_sec) * 1000 +
                        (now.tv_nsec - start.tv_nsec) / 1000000;
      if (timeout_ms >= 0 && elapsed_ms > timeout_ms) {
        ::freeaddrinfo(res);
        return false;
      }
      ::usleep(50 * 1000);
    }
  }

  // returns status (0 ok, 1 miss, -1 io error); payload out
  int Request(uint8_t cmd, const std::string& key, const std::string& val,
              std::string* payload) {
    std::lock_guard<std::mutex> g(mu_);
    uint32_t key_len = static_cast<uint32_t>(key.size());
    uint64_t val_len = val.size();
    std::string msg;
    msg.reserve(13 + key.size() + val.size());
    msg.push_back(static_cast<char>(cmd));
    msg.append(reinterpret_cast<char*>(&key_len), 4);
    msg.append(key);
    msg.append(reinterpret_cast<char*>(&val_len), 8);
    msg.append(val);
    if (!send_all(fd_, msg.data(), msg.size())) return -1;
    uint8_t status;
    uint64_t len;
    if (!recv_all(fd_, &status, 1)) return -1;
    if (!recv_all(fd_, &len, 8)) return -1;
    payload->assign(len, '\0');
    if (len && !recv_all(fd_, &(*payload)[0], len)) return -1;
    return status;
  }

  ~StoreClient() {
    if (fd_ >= 0) ::close(fd_);
  }

 private:
  int fd_ = -1;
  std::mutex mu_;
};

// ---------------------------------------------------------------------------
// ShmRing — POSIX shared-memory SPSC/MPMC byte-message ring.
//
// Layout: [Header | data bytes]. head/tail are free-running byte offsets
// (mod capacity on access). Each message is u32 length + payload, both
// copied with wraparound. Synchronisation: process-shared pthread mutex +
// two condition variables living inside the mapping.
// ---------------------------------------------------------------------------

struct ShmHeader {
  uint64_t magic;
  uint64_t capacity;  // data bytes
  uint64_t head;      // next write offset (free-running)
  uint64_t tail;      // next read offset (free-running)
  uint32_t closed;
  uint32_t _pad;
  pthread_mutex_t mu;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
};

constexpr uint64_t kShmMagic = 0x70745f73686d7231ull;  // "pt_shmr1"

class ShmRing {
 public:
  static ShmRing* Create(const char* name, uint64_t capacity) {
    ::shm_unlink(name);  // stale segment from a crashed run
    int fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return nullptr;
    uint64_t total = sizeof(ShmHeader) + capacity;
    if (::ftruncate(fd, static_cast<off_t>(total)) != 0) {
      ::close(fd);
      ::shm_unlink(name);
      return nullptr;
    }
    void* mem = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    ::close(fd);
    if (mem == MAP_FAILED) {
      ::shm_unlink(name);
      return nullptr;
    }
    auto* h = static_cast<ShmHeader*>(mem);
    memset(h, 0, sizeof(ShmHeader));
    h->capacity = capacity;
    pthread_mutexattr_t ma;
    pthread_mutexattr_init(&ma);
    pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mu, &ma);
    pthread_condattr_t ca;
    pthread_condattr_init(&ca);
    pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
    pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
    pthread_cond_init(&h->not_full, &ca);
    pthread_cond_init(&h->not_empty, &ca);
    h->magic = kShmMagic;  // publish last
    return new ShmRing(h, total, name, /*owner=*/true);
  }

  static ShmRing* Open(const char* name) {
    int fd = ::shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st;
    if (::fstat(fd, &st) != 0) {
      ::close(fd);
      return nullptr;
    }
    void* mem = ::mmap(nullptr, static_cast<size_t>(st.st_size),
                       PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    ::close(fd);
    if (mem == MAP_FAILED) return nullptr;
    auto* h = static_cast<ShmHeader*>(mem);
    if (h->magic != kShmMagic) {
      ::munmap(mem, static_cast<size_t>(st.st_size));
      return nullptr;
    }
    return new ShmRing(h, static_cast<uint64_t>(st.st_size), name,
                       /*owner=*/false);
  }

  // 0 ok, 1 timeout, 2 closed, 3 too large
  int Push(const void* data, uint64_t len, int timeout_ms) {
    uint64_t need = 4 + len;
    if (need > h_->capacity) return 3;
    timespec deadline;
    MakeDeadline(timeout_ms, &deadline);
    Lock();
    while (h_->capacity - (h_->head - h_->tail) < need) {
      if (h_->closed) {
        Unlock();
        return 2;
      }
      if (TimedWait(&h_->not_full, timeout_ms, &deadline)) {
        Unlock();
        return 1;
      }
    }
    uint32_t len32 = static_cast<uint32_t>(len);
    CopyIn(h_->head, &len32, 4);
    CopyIn(h_->head + 4, data, len);
    h_->head += need;
    pthread_cond_signal(&h_->not_empty);
    Unlock();
    return 0;
  }

  // returns message length, or -1 timeout, -2 closed+empty, -3 buffer small
  int64_t Pop(void* out, uint64_t cap, int timeout_ms) {
    timespec deadline;
    MakeDeadline(timeout_ms, &deadline);
    Lock();
    while (h_->head == h_->tail) {
      if (h_->closed) {
        Unlock();
        return -2;
      }
      if (TimedWait(&h_->not_empty, timeout_ms, &deadline)) {
        Unlock();
        return -1;
      }
    }
    uint32_t len32;
    CopyOut(h_->tail, &len32, 4);
    if (len32 > cap) {
      Unlock();
      return -3;
    }
    CopyOut(h_->tail + 4, out, len32);
    h_->tail += 4 + len32;
    pthread_cond_signal(&h_->not_full);
    Unlock();
    return static_cast<int64_t>(len32);
  }

  // peek the length of the next message without consuming (-1 empty)
  int64_t NextLen() {
    Lock();
    int64_t r = -1;
    if (h_->head != h_->tail) {
      uint32_t len32;
      CopyOut(h_->tail, &len32, 4);
      r = static_cast<int64_t>(len32);
    }
    Unlock();
    return r;
  }

  void Close() {
    Lock();
    h_->closed = 1;
    pthread_cond_broadcast(&h_->not_empty);
    pthread_cond_broadcast(&h_->not_full);
    Unlock();
  }

  uint64_t Size() {
    Lock();
    uint64_t n = h_->head - h_->tail;
    Unlock();
    return n;
  }

  ~ShmRing() {
    ::munmap(h_, total_);
    if (owner_) ::shm_unlink(name_.c_str());
  }

 private:
  ShmRing(ShmHeader* h, uint64_t total, std::string name, bool owner)
      : h_(h), total_(total), name_(std::move(name)), owner_(owner) {}

  void Lock() {
    int r = pthread_mutex_lock(&h_->mu);
    if (r == EOWNERDEAD) pthread_mutex_consistent(&h_->mu);
  }
  void Unlock() { pthread_mutex_unlock(&h_->mu); }

  static void MakeDeadline(int timeout_ms, timespec* ts) {
    clock_gettime(CLOCK_MONOTONIC, ts);
    ts->tv_sec += timeout_ms / 1000;
    ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts->tv_nsec >= 1000000000L) {
      ts->tv_sec += 1;
      ts->tv_nsec -= 1000000000L;
    }
  }

  // true on timeout
  bool TimedWait(pthread_cond_t* cv, int timeout_ms, const timespec* deadline) {
    if (timeout_ms < 0) {
      pthread_cond_wait(cv, &h_->mu);
      return false;
    }
    return pthread_cond_timedwait(cv, &h_->mu, deadline) == ETIMEDOUT;
  }

  char* data() { return reinterpret_cast<char*>(h_ + 1); }

  void CopyIn(uint64_t pos, const void* src, uint64_t n) {
    uint64_t off = pos % h_->capacity;
    uint64_t first = std::min(n, h_->capacity - off);
    memcpy(data() + off, src, first);
    if (n > first)
      memcpy(data(), static_cast<const char*>(src) + first, n - first);
  }

  void CopyOut(uint64_t pos, void* dst, uint64_t n) {
    uint64_t off = pos % h_->capacity;
    uint64_t first = std::min(n, h_->capacity - off);
    memcpy(dst, data() + off, first);
    if (n > first)
      memcpy(static_cast<char*>(dst) + first, data(), n - first);
  }

  ShmHeader* h_;
  uint64_t total_;
  std::string name_;
  bool owner_;
};

// ---------------------------------------------------------------------------
// parallel host ops
// ---------------------------------------------------------------------------

void parallel_for(int64_t n, int nthreads, const std::function<void(int64_t, int64_t)>& fn) {
  if (nthreads <= 1 || n < (1 << 16)) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// HostPool — size-bucketed free-list staging allocator with stats
// ---------------------------------------------------------------------------

class HostPool {
 public:
  void* Alloc(uint64_t size) {
    uint64_t bucket = Bucket(size);
    {
      std::lock_guard<std::mutex> g(mu_);
      auto it = free_.find(bucket);
      if (it != free_.end() && !it->second.empty()) {
        void* p = it->second.back();
        it->second.pop_back();
        live_[p] = bucket;
        current_ += bucket;
        peak_ = std::max(peak_, current_);
        ++alloc_count_;
        return p;
      }
    }
    void* p = ::aligned_alloc(64, bucket);
    if (!p) return nullptr;
    std::lock_guard<std::mutex> g(mu_);
    live_[p] = bucket;
    current_ += bucket;
    reserved_ += bucket;
    peak_ = std::max(peak_, current_);
    ++alloc_count_;
    return p;
  }

  int Free(void* p) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = live_.find(p);
    if (it == live_.end()) return -1;
    uint64_t bucket = it->second;
    live_.erase(it);
    current_ -= bucket;
    free_[bucket].push_back(p);
    return 0;
  }

  void Trim() {
    std::lock_guard<std::mutex> g(mu_);
    for (auto& kv : free_)
      for (void* p : kv.second) {
        ::free(p);
        reserved_ -= kv.first;
      }
    free_.clear();
  }

  void Stats(uint64_t* current, uint64_t* peak, uint64_t* reserved,
             uint64_t* allocs) {
    std::lock_guard<std::mutex> g(mu_);
    *current = current_;
    *peak = peak_;
    *reserved = reserved_;
    *allocs = alloc_count_;
  }

  ~HostPool() {
    Trim();
    for (auto& kv : live_) ::free(kv.first);
  }

 private:
  static uint64_t Bucket(uint64_t size) {
    // next power of two, min 256 bytes — bounded internal fragmentation,
    // high free-list hit rate for steady-state batch shapes
    uint64_t b = 256;
    while (b < size) b <<= 1;
    return b;
  }

  std::mutex mu_;
  std::map<uint64_t, std::vector<void*>> free_;
  std::map<void*, uint64_t> live_;
  uint64_t current_ = 0, peak_ = 0, reserved_ = 0, alloc_count_ = 0;
};

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

PT_EXPORT void* pt_store_server_start(int port) {
  auto* s = new StoreServer(port);
  if (!s->Start()) {
    delete s;
    return nullptr;
  }
  return s;
}

PT_EXPORT int pt_store_server_port(void* h) {
  return static_cast<StoreServer*>(h)->port();
}

PT_EXPORT void pt_store_server_stop(void* h) {
  delete static_cast<StoreServer*>(h);
}

PT_EXPORT void* pt_store_client_connect(const char* host, int port,
                                        int timeout_ms) {
  auto* c = new StoreClient();
  if (!c->Connect(host, port, timeout_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}

PT_EXPORT void pt_store_client_close(void* h) {
  delete static_cast<StoreClient*>(h);
}

PT_EXPORT int pt_store_set(void* h, const char* key, const void* val,
                           uint64_t len) {
  std::string payload;
  return static_cast<StoreClient*>(h)->Request(
      kSet, key, std::string(static_cast<const char*>(val), len), &payload);
}

// blocking get; returns length (>=0), -1 miss/timeout, -2 io error,
// -3 caller buffer too small (length still returned via *full_len)
PT_EXPORT int64_t pt_store_get(void* h, const char* key, void* out,
                               uint64_t cap, uint64_t timeout_ms,
                               uint64_t* full_len) {
  std::string payload;
  std::string t(8, '\0');
  memcpy(&t[0], &timeout_ms, 8);
  int st = static_cast<StoreClient*>(h)->Request(kGet, key, t, &payload);
  if (st < 0) return -2;
  if (st != 0) return -1;
  if (full_len) *full_len = payload.size();
  if (payload.size() > cap) return -3;
  memcpy(out, payload.data(), payload.size());
  return static_cast<int64_t>(payload.size());
}

PT_EXPORT int64_t pt_store_try_get(void* h, const char* key, void* out,
                                   uint64_t cap, uint64_t* full_len) {
  std::string payload;
  int st = static_cast<StoreClient*>(h)->Request(kTryGet, key, "", &payload);
  if (st < 0) return -2;
  if (st != 0) return -1;
  if (full_len) *full_len = payload.size();
  if (payload.size() > cap) return -3;
  memcpy(out, payload.data(), payload.size());
  return static_cast<int64_t>(payload.size());
}

PT_EXPORT int64_t pt_store_add(void* h, const char* key, int64_t delta) {
  std::string payload;
  std::string v(8, '\0');
  memcpy(&v[0], &delta, 8);
  int st = static_cast<StoreClient*>(h)->Request(kAdd, key, v, &payload);
  if (st != 0 || payload.size() != 8) return INT64_MIN;
  int64_t out;
  memcpy(&out, payload.data(), 8);
  return out;
}

PT_EXPORT int pt_store_wait(void* h, const char* key, uint64_t timeout_ms) {
  std::string payload;
  std::string t(8, '\0');
  memcpy(&t[0], &timeout_ms, 8);
  return static_cast<StoreClient*>(h)->Request(kWait, key, t, &payload);
}

PT_EXPORT int pt_store_delete(void* h, const char* key) {
  std::string payload;
  return static_cast<StoreClient*>(h)->Request(kDelete, key, "", &payload);
}

PT_EXPORT int64_t pt_store_num_keys(void* h) {
  std::string payload;
  int st = static_cast<StoreClient*>(h)->Request(kNumKeys, "", "", &payload);
  if (st != 0 || payload.size() != 8) return -1;
  int64_t out;
  memcpy(&out, payload.data(), 8);
  return out;
}

// --- shm ring ---

PT_EXPORT void* pt_shmring_create(const char* name, uint64_t capacity) {
  return ShmRing::Create(name, capacity);
}

PT_EXPORT void* pt_shmring_open(const char* name) { return ShmRing::Open(name); }

PT_EXPORT int pt_shmring_push(void* h, const void* data, uint64_t len,
                              int timeout_ms) {
  return static_cast<ShmRing*>(h)->Push(data, len, timeout_ms);
}

PT_EXPORT int64_t pt_shmring_pop(void* h, void* out, uint64_t cap,
                                 int timeout_ms) {
  return static_cast<ShmRing*>(h)->Pop(out, cap, timeout_ms);
}

PT_EXPORT int64_t pt_shmring_next_len(void* h) {
  return static_cast<ShmRing*>(h)->NextLen();
}

PT_EXPORT uint64_t pt_shmring_size(void* h) {
  return static_cast<ShmRing*>(h)->Size();
}

PT_EXPORT void pt_shmring_close(void* h) { static_cast<ShmRing*>(h)->Close(); }

PT_EXPORT void pt_shmring_destroy(void* h) { delete static_cast<ShmRing*>(h); }

// --- host ops ---

// (src u8[n, c] interleaved) -> dst f32, dst[i] = (src[i]/255 - mean[ch])/std[ch]
PT_EXPORT void pt_normalize_u8_f32(const uint8_t* src, float* dst,
                                   int64_t n_pixels, int channels,
                                   const float* mean, const float* stddev,
                                   int nthreads) {
  std::vector<float> inv_std(channels), m(channels);
  for (int i = 0; i < channels; ++i) {
    inv_std[i] = 1.0f / stddev[i];
    m[i] = mean[i];
  }
  const float k = 1.0f / 255.0f;
  parallel_for(n_pixels, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; ++p) {
      const uint8_t* s = src + p * channels;
      float* d = dst + p * channels;
      for (int ch = 0; ch < channels; ++ch)
        d[ch] = (s[ch] * k - m[ch]) * inv_std[ch];
    }
  });
}

// pad ragged int32 sequences into [n, max_len]
PT_EXPORT void pt_pad_i32(const int32_t* const* seqs, const int64_t* lens,
                          int64_t n, int64_t max_len, int32_t pad,
                          int32_t* out, int nthreads) {
  parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t l = std::min(lens[i], max_len);
      int32_t* row = out + i * max_len;
      memcpy(row, seqs[i], static_cast<size_t>(l) * 4);
      for (int64_t j = l; j < max_len; ++j) row[j] = pad;
    }
  });
}

// gather rows: out[i, :] = table[idx[i], :] (embedding-style host gather)
PT_EXPORT void pt_gather_rows_f32(const float* table, const int64_t* idx,
                                  int64_t n, int64_t row_elems, float* out,
                                  int nthreads) {
  parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      memcpy(out + i * row_elems, table + idx[i] * row_elems,
             static_cast<size_t>(row_elems) * 4);
  });
}

// --- host pool ---

PT_EXPORT void* pt_hostpool_create() { return new HostPool(); }
PT_EXPORT void pt_hostpool_destroy(void* h) { delete static_cast<HostPool*>(h); }
PT_EXPORT void* pt_hostpool_alloc(void* h, uint64_t size) {
  return static_cast<HostPool*>(h)->Alloc(size);
}
PT_EXPORT int pt_hostpool_free(void* h, void* p) {
  return static_cast<HostPool*>(h)->Free(p);
}
PT_EXPORT void pt_hostpool_trim(void* h) { static_cast<HostPool*>(h)->Trim(); }
PT_EXPORT void pt_hostpool_stats(void* h, uint64_t* current, uint64_t* peak,
                                 uint64_t* reserved, uint64_t* allocs) {
  static_cast<HostPool*>(h)->Stats(current, peak, reserved, allocs);
}

PT_EXPORT const char* pt_native_version() { return "pt_native 0.1"; }
