// TCPStore: key/value rendezvous server and client.
//
// The paddle_tpu_torch copy of the JAX package's store (a re-design of the
// reference's paddle/fluid/distributed/store/tcp_store.{h,cc}:91 TCPStore /
// MasterDaemon): the master rank listens, peers connect over TCP and issue
// SET/GET/ADD/WAIT.  Plain C interface, loaded through ctypes by
// paddle_tpu_torch/core/native.py.
//
// Wire format (little-endian), the same as the JAX package's and as the
// pure-Python pair in paddle_tpu_torch/distributed/store.py:
//   u8 op  | u32 keylen | key bytes | (SET/ADD: u32 vallen | val bytes)
// ops: 1=SET 2=GET 3=ADD 4=WAIT 5=DELETE 6=NUMKEYS
// replies: GET/WAIT -> u32 len | bytes (len==0xFFFFFFFF => missing)
//          ADD -> i64 new value; SET/DELETE -> u8 ack; NUMKEYS -> u32
//
// The client differs from the JAX package's in four ways, so that the
// Python layer's retry policy works on it as on the Python client:
//  * a failed op closes the connection, and tells why
//    (tcp_store_client_last_error: 1 the request never reached the wire
//    whole, 2 it did and the reply was lost);
//  * tcp_store_client_reconnect dials again;
//  * every connect attempt takes a fresh socket;
//  * tcp_store_client_shutdown wakes an op blocked on the connection.
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Op : uint8_t { SET = 1, GET = 2, ADD = 3, WAIT = 4, DEL = 5, NUM = 6 };

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd, p + got, n - got, 0);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = ::send(fd, p + sent, n - sent, 0);
    if (r <= 0) return false;
    sent += static_cast<size_t>(r);
  }
  return true;
}

class StoreServer {
 public:
  explicit StoreServer(int port) : port_(port), stop_(false) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
        ::listen(listen_fd_, 128) != 0) {
      ::close(listen_fd_);
      listen_fd_ = -1;
      return;
    }
    if (port == 0) {
      socklen_t len = sizeof(addr);
      ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
      port_ = ntohs(addr.sin_port);
    }
    accept_thread_ = std::thread([this] { AcceptLoop(); });
  }

  ~StoreServer() { Stop(); }

  bool ok() const { return listen_fd_ >= 0; }
  int port() const { return port_; }

  void Stop() {
    bool expected = false;
    if (!stop_.compare_exchange_strong(expected, true)) return;
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR), ::close(listen_fd_);
    if (accept_thread_.joinable()) accept_thread_.join();
    // Wake WAIT-blocked threads (their predicate checks stop_) and unblock
    // recv-blocked threads by shutting down every live connection; only then
    // is join guaranteed to complete even with clients still attached.
    {
      // mu_ orders the stop_ store with a waiter between its predicate
      // check and blocking — notify without it can be lost.
      std::lock_guard<std::mutex> lk(mu_);
    }
    cv_.notify_all();
    std::vector<std::thread> threads;
    {
      std::lock_guard<std::mutex> lk(conn_mu_);
      for (int fd : conn_fds_)
        if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
      threads.swap(conn_threads_);
    }
    // join with conn_mu_ released: Serve()'s fd cleanup takes conn_mu_.
    for (auto& t : threads)
      if (t.joinable()) t.join();
  }

 private:
  void AcceptLoop() {
    while (!stop_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(conn_mu_);
      // reap threads whose connections already closed (their fd slot was
      // tombstoned in Serve) so long-lived servers don't accumulate one
      // dead std::thread + fd slot per connection ever accepted
      for (size_t i = 0; i < conn_fds_.size();) {
        if (conn_fds_[i] < 0) {
          if (conn_threads_[i].joinable()) conn_threads_[i].join();
          conn_fds_[i] = conn_fds_.back();
          conn_fds_.pop_back();
          std::swap(conn_threads_[i], conn_threads_.back());
          conn_threads_.pop_back();
        } else {
          ++i;
        }
      }
      conn_fds_.push_back(fd);
      conn_threads_.emplace_back([this, fd] { Serve(fd); });
    }
  }

  void Serve(int fd) {
    while (!stop_) {
      uint8_t op;
      if (!read_full(fd, &op, 1)) break;
      uint32_t klen;
      if (!read_full(fd, &klen, 4)) break;
      std::string key(klen, '\0');
      if (klen && !read_full(fd, key.data(), klen)) break;
      if (op == SET) {
        uint32_t vlen;
        if (!read_full(fd, &vlen, 4)) break;
        std::string val(vlen, '\0');
        if (vlen && !read_full(fd, val.data(), vlen)) break;
        {
          std::lock_guard<std::mutex> lk(mu_);
          data_[key] = std::move(val);
        }
        cv_.notify_all();
        uint8_t ack = 1;
        if (!write_full(fd, &ack, 1)) break;
      } else if (op == GET) {
        std::string val;
        bool found;
        {
          std::lock_guard<std::mutex> lk(mu_);
          auto it = data_.find(key);
          found = it != data_.end();
          if (found) val = it->second;
        }
        uint32_t len = found ? static_cast<uint32_t>(val.size()) : 0xFFFFFFFFu;
        if (!write_full(fd, &len, 4)) break;
        if (found && !val.empty() && !write_full(fd, val.data(), val.size()))
          break;
      } else if (op == ADD) {
        uint32_t vlen;
        if (!read_full(fd, &vlen, 4)) break;
        std::string val(vlen, '\0');
        if (vlen && !read_full(fd, val.data(), vlen)) break;
        int64_t inc = 0;
        std::memcpy(&inc, val.data(), std::min<size_t>(8, val.size()));
        int64_t out;
        {
          std::lock_guard<std::mutex> lk(mu_);
          int64_t cur = 0;
          auto it = data_.find(key);
          if (it != data_.end())
            std::memcpy(&cur, it->second.data(),
                        std::min<size_t>(8, it->second.size()));
          out = cur + inc;
          std::string nv(8, '\0');
          std::memcpy(nv.data(), &out, 8);
          data_[key] = nv;
        }
        cv_.notify_all();
        if (!write_full(fd, &out, 8)) break;
      } else if (op == WAIT) {
        std::string val;
        {
          std::unique_lock<std::mutex> lk(mu_);
          cv_.wait(lk, [&] {
            return stop_.load() || data_.count(key) > 0;
          });
          if (stop_) break;
          val = data_[key];
        }
        uint32_t len = static_cast<uint32_t>(val.size());
        if (!write_full(fd, &len, 4)) break;
        if (!val.empty() && !write_full(fd, val.data(), val.size())) break;
      } else if (op == DEL) {
        {
          std::lock_guard<std::mutex> lk(mu_);
          data_.erase(key);
        }
        uint8_t ack = 1;
        if (!write_full(fd, &ack, 1)) break;
      } else if (op == NUM) {
        uint32_t n;
        {
          std::lock_guard<std::mutex> lk(mu_);
          n = static_cast<uint32_t>(data_.size());
        }
        if (!write_full(fd, &n, 4)) break;
      } else {
        break;
      }
    }
    {
      std::lock_guard<std::mutex> lk(conn_mu_);
      for (auto& f : conn_fds_)
        if (f == fd) f = -1;
    }
    ::close(fd);
  }

  int listen_fd_ = -1;
  int port_;
  std::atomic<bool> stop_;
  std::thread accept_thread_;
  std::mutex conn_mu_;
  std::vector<int> conn_fds_;
  std::vector<std::thread> conn_threads_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, std::string> data_;
};

class StoreClient {
 public:
  StoreClient(const char* host, int port, int timeout_ms)
      : host_(host), port_(port) {
    Connect(timeout_ms);
  }

  ~StoreClient() { Drop(); }

  bool ok() const { return fd_ >= 0; }
  int fd() const { return fd_; }
  int last_error() const { return last_error_; }

  // wake an op blocked on the connection (it then fails); safe from any
  // thread, the op's included
  void Shutdown() {
    int fd = fd_;
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
  }

  // dial until the deadline (the server may start later); at least one
  // attempt even for timeout_ms <= 0
  bool Connect(int timeout_ms) {
    std::lock_guard<std::mutex> lk(mu_);
    Drop();
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (::inet_pton(AF_INET, host_.c_str(), &addr.sin_addr) != 1) return false;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 0);
    while (true) {
      int fd = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd >= 0 &&
          ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        fd_ = fd;
        last_error_ = 0;
        return true;
      }
      if (fd >= 0) ::close(fd);
      if (std::chrono::steady_clock::now() >= deadline) return false;
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
    }
  }

  bool Set(const std::string& key, const std::string& val) {
    std::lock_guard<std::mutex> lk(mu_);
    uint32_t vlen = static_cast<uint32_t>(val.size());
    if (!SendHeader(SET, key) || !write_full(fd_, &vlen, 4) ||
        (!val.empty() && !write_full(fd_, val.data(), val.size())))
      return Fail(1);
    uint8_t ack;
    return read_full(fd_, &ack, 1) || Fail(2);
  }

  // -1 missing, -2 failed (last_error says how), else the value's length;
  // at most cap bytes are copied into out
  int64_t Get(const std::string& key, char* out, int64_t cap, bool wait) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!SendHeader(wait ? WAIT : GET, key)) return Fail(1), -2;
    uint32_t len;
    if (!read_full(fd_, &len, 4)) return Fail(2), -2;
    if (len == 0xFFFFFFFFu) return -1;
    std::string val(len, '\0');
    if (len && !read_full(fd_, val.data(), len)) return Fail(2), -2;
    int64_t n = std::min<int64_t>(len, cap);
    std::memcpy(out, val.data(), static_cast<size_t>(n));
    return static_cast<int64_t>(len);
  }

  int64_t Add(const std::string& key, int64_t inc) {
    std::lock_guard<std::mutex> lk(mu_);
    uint32_t vlen = 8;
    if (!SendHeader(ADD, key) || !write_full(fd_, &vlen, 4) ||
        !write_full(fd_, &inc, 8))
      return Fail(1), INT64_MIN;
    int64_t out;
    if (!read_full(fd_, &out, 8)) return Fail(2), INT64_MIN;
    return out;
  }

 private:
  bool SendHeader(Op op, const std::string& key) {
    if (fd_ < 0) return false;
    last_error_ = 0;
    uint8_t o = op;
    if (!write_full(fd_, &o, 1)) return false;
    uint32_t klen = static_cast<uint32_t>(key.size());
    if (!write_full(fd_, &klen, 4)) return false;
    return key.empty() || write_full(fd_, key.data(), key.size());
  }

  // the stream's state is unknown after a failure (a late reply would be
  // read as the next op's): close it; the next op fails until a reconnect
  bool Fail(int why) {
    last_error_ = why;
    Drop();
    return false;
  }

  void Drop() {
    if (fd_ >= 0) ::close(fd_);
    fd_ = -1;
  }

  std::string host_;
  int port_;
  std::atomic<int> fd_{-1};
  int last_error_ = 0;
  std::mutex mu_;
};

}  // namespace

extern "C" {

void* tcp_store_server_create(int port) {
  auto* s = new StoreServer(port);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

int tcp_store_server_port(void* server) {
  return static_cast<StoreServer*>(server)->port();
}

void tcp_store_server_destroy(void* server) {
  delete static_cast<StoreServer*>(server);
}

void* tcp_store_client_create_t(const char* host, int port, int timeout_ms) {
  auto* c = new StoreClient(host, port, timeout_ms);
  if (!c->ok()) {
    delete c;
    return nullptr;
  }
  return c;
}

void* tcp_store_client_create(const char* host, int port) {
  return tcp_store_client_create_t(host, port, 30000);
}

void tcp_store_client_destroy(void* client) {
  delete static_cast<StoreClient*>(client);
}

int tcp_store_client_reconnect(void* client, int timeout_ms) {
  return static_cast<StoreClient*>(client)->Connect(timeout_ms) ? 0 : -1;
}

int tcp_store_client_last_error(void* client) {
  return static_cast<StoreClient*>(client)->last_error();
}

int tcp_store_client_fd(void* client) {
  return static_cast<StoreClient*>(client)->fd();
}

void tcp_store_client_shutdown(void* client) {
  static_cast<StoreClient*>(client)->Shutdown();
}

int tcp_store_set(void* client, const char* key, const char* val, int len) {
  return static_cast<StoreClient*>(client)->Set(key, std::string(val, len)) ? 0
                                                                            : -1;
}

long long tcp_store_get(void* client, const char* key, char* out,
                        long long cap, int wait) {
  return static_cast<StoreClient*>(client)->Get(key, out, cap, wait != 0);
}

long long tcp_store_add(void* client, const char* key, long long inc) {
  return static_cast<StoreClient*>(client)->Add(key, inc);
}

}  // extern "C"
