// TCP key-value store: the rendezvous and fleet-membership backend (a copy
// of the JAX package's csrc/tcp_store.cpp, so the port builds without it).
//
// A threaded TCP server with wait-until-set semantics, atomic counters,
// prefix listing and server-clock stamps, exposed through a C ABI that
// distributed/store.py binds with ctypes; utils/cpp_extension.py builds it
// with g++ (no CUDA, so the CPU tests have it too).
//
// Protocol (one request per round-trip, length-prefixed):
//   request:  u8 op | u32 klen | key | u32 vlen | val
//   response: u8 status(0 ok, 1 missing/timeout) | u32 vlen | val
// Ops: 1=SET 2=GET 3=WAIT(val=u32 timeout_ms) 4=ADD(val=i64 delta,
//      returns i64) 5=DEL 6=LIST(key=prefix, returns u32-prefixed keys)
//      7=STAMP(server-clock timestamp write; cross-host clock skew must
//      not poison liveness TTLs) 8=NOW(returns server clock, f64 seconds)

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

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> kv;
};

struct Server {
  int listen_fd = -1;
  uint16_t port = 0;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  std::vector<std::thread> conns;
  std::mutex conns_mu;
  Store store;
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_resp(int fd, uint8_t status, const std::string& val) {
  uint32_t vlen = static_cast<uint32_t>(val.size());
  if (!write_full(fd, &status, 1)) return false;
  if (!write_full(fd, &vlen, 4)) return false;
  if (vlen && !write_full(fd, val.data(), vlen)) return false;
  return true;
}

void handle_conn(Server* srv, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    uint8_t op;
    uint32_t klen, vlen;
    if (!read_full(fd, &op, 1) || !read_full(fd, &klen, 4)) break;
    if (klen > (1u << 20)) break;
    std::string key(klen, '\0');
    if (klen && !read_full(fd, key.data(), klen)) break;
    if (!read_full(fd, &vlen, 4)) break;
    if (vlen > (64u << 20)) break;
    std::string val(vlen, '\0');
    if (vlen && !read_full(fd, val.data(), vlen)) break;

    Store& st = srv->store;
    bool ok = true;
    switch (op) {
      case 1: {  // SET
        {
          std::lock_guard<std::mutex> g(st.mu);
          st.kv[key] = val;
        }
        st.cv.notify_all();
        ok = send_resp(fd, 0, "");
        break;
      }
      case 2: {  // GET
        std::unique_lock<std::mutex> g(st.mu);
        auto it = st.kv.find(key);
        if (it == st.kv.end()) {
          g.unlock();
          ok = send_resp(fd, 1, "");
        } else {
          std::string v = it->second;
          g.unlock();
          ok = send_resp(fd, 0, v);
        }
        break;
      }
      case 3: {  // WAIT
        uint32_t timeout_ms = 0;
        if (val.size() >= 4) std::memcpy(&timeout_ms, val.data(), 4);
        auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(timeout_ms);
        std::unique_lock<std::mutex> g(st.mu);
        bool found = st.cv.wait_until(g, deadline, [&] {
          return st.kv.count(key) > 0 || srv->stop.load();
        });
        if (found && st.kv.count(key)) {
          std::string v = st.kv[key];
          g.unlock();
          ok = send_resp(fd, 0, v);
        } else {
          g.unlock();
          ok = send_resp(fd, 1, "");
        }
        break;
      }
      case 4: {  // ADD
        int64_t delta = 0;
        if (val.size() >= 8) std::memcpy(&delta, val.data(), 8);
        int64_t cur = 0;
        {
          std::lock_guard<std::mutex> g(st.mu);
          auto it = st.kv.find(key);
          if (it != st.kv.end() && it->second.size() == 8)
            std::memcpy(&cur, it->second.data(), 8);
          cur += delta;
          std::string v(8, '\0');
          std::memcpy(v.data(), &cur, 8);
          st.kv[key] = v;
        }
        st.cv.notify_all();
        std::string out(8, '\0');
        std::memcpy(out.data(), &cur, 8);
        ok = send_resp(fd, 0, out);
        break;
      }
      case 5: {  // DEL
        {
          std::lock_guard<std::mutex> g(st.mu);
          st.kv.erase(key);
        }
        ok = send_resp(fd, 0, "");
        break;
      }
      case 6: {  // LIST by prefix → u32-len-prefixed key/value pairs
        std::string out;
        {
          std::lock_guard<std::mutex> g(st.mu);
          for (auto it = st.kv.lower_bound(key); it != st.kv.end(); ++it) {
            if (it->first.compare(0, key.size(), key) != 0) break;
            uint32_t kl = static_cast<uint32_t>(it->first.size());
            uint32_t vl = static_cast<uint32_t>(it->second.size());
            out.append(reinterpret_cast<char*>(&kl), 4);
            out.append(it->first);
            out.append(reinterpret_cast<char*>(&vl), 4);
            out.append(it->second);
          }
        }
        ok = send_resp(fd, 0, out);
        break;
      }
      case 7: {  // STAMP: server-clock timestamp under key
        double now = std::chrono::duration<double>(
                         std::chrono::system_clock::now().time_since_epoch())
                         .count();
        std::string v(8, '\0');
        std::memcpy(v.data(), &now, 8);
        {
          std::lock_guard<std::mutex> g(st.mu);
          st.kv[key] = v;
        }
        st.cv.notify_all();
        ok = send_resp(fd, 0, "");
        break;
      }
      case 8: {  // NOW: server clock (f64 seconds)
        double now = std::chrono::duration<double>(
                         std::chrono::system_clock::now().time_since_epoch())
                         .count();
        std::string v(8, '\0');
        std::memcpy(v.data(), &now, 8);
        ok = send_resp(fd, 0, v);
        break;
      }
      default:
        ok = send_resp(fd, 1, "");
    }
    if (!ok) break;
  }
  ::close(fd);
}

void accept_loop(Server* srv) {
  for (;;) {
    sockaddr_in addr{};
    socklen_t len = sizeof(addr);
    int fd = ::accept(srv->listen_fd,
                      reinterpret_cast<sockaddr*>(&addr), &len);
    if (fd < 0) {
      if (srv->stop.load()) return;
      continue;
    }
    std::lock_guard<std::mutex> g(srv->conns_mu);
    srv->conns.emplace_back(handle_conn, srv, fd);
  }
}

}  // namespace

extern "C" {

void* ts_server_start(uint16_t port) {
  auto* srv = new Server();
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) < 0 ||
      ::listen(srv->listen_fd, 128) < 0) {
    ::close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  srv->port = ntohs(addr.sin_port);
  srv->accept_thread = std::thread(accept_loop, srv);
  return srv;
}

uint16_t ts_server_port(void* h) {
  return h ? static_cast<Server*>(h)->port : 0;
}

void ts_server_stop(void* h) {
  if (!h) return;
  auto* srv = static_cast<Server*>(h);
  srv->stop.store(true);
  srv->store.cv.notify_all();
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  {
    std::lock_guard<std::mutex> g(srv->conns_mu);
    for (auto& t : srv->conns) t.detach();  // blocked conns die with proc
  }
  // leak srv deliberately: detached handlers may still touch the store;
  // servers are one-per-process and live for the process lifetime
}

int ts_connect(const char* host, uint16_t port, int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  for (;;) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(fd);
      return -1;
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr),
                  sizeof(addr)) == 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    ::close(fd);
    if (std::chrono::steady_clock::now() >= deadline) return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
  }
}

namespace {
int64_t request(int fd, uint8_t op, const char* key, uint32_t klen,
                const char* val, uint32_t vlen, char* out,
                int64_t out_cap) {
  if (!write_full(fd, &op, 1) || !write_full(fd, &klen, 4) ||
      (klen && !write_full(fd, key, klen)) || !write_full(fd, &vlen, 4) ||
      (vlen && !write_full(fd, val, vlen)))
    return -2;
  uint8_t status;
  uint32_t rlen;
  if (!read_full(fd, &status, 1) || !read_full(fd, &rlen, 4)) return -2;
  std::string resp(rlen, '\0');
  if (rlen && !read_full(fd, resp.data(), rlen)) return -2;
  if (status != 0) return -1;
  if (out && out_cap > 0) {
    size_t n = resp.size() < static_cast<size_t>(out_cap)
                   ? resp.size()
                   : static_cast<size_t>(out_cap);
    std::memcpy(out, resp.data(), n);
  }
  return static_cast<int64_t>(resp.size());
}
}  // namespace

int64_t ts_set(int fd, const char* key, uint32_t klen, const char* val,
               uint32_t vlen) {
  return request(fd, 1, key, klen, val, vlen, nullptr, 0);
}

int64_t ts_get(int fd, const char* key, uint32_t klen, char* out,
               int64_t cap) {
  return request(fd, 2, key, klen, nullptr, 0, out, cap);
}

int64_t ts_wait(int fd, const char* key, uint32_t klen, uint32_t timeout_ms,
                char* out, int64_t cap) {
  return request(fd, 3, key, klen, reinterpret_cast<char*>(&timeout_ms), 4,
                 out, cap);
}

int64_t ts_add(int fd, const char* key, uint32_t klen, int64_t delta) {
  char out[8] = {0};
  int64_t r = request(fd, 4, key, klen, reinterpret_cast<char*>(&delta), 8,
                      out, 8);
  if (r < 0) return INT64_MIN;
  int64_t v;
  std::memcpy(&v, out, 8);
  return v;
}

int64_t ts_del(int fd, const char* key, uint32_t klen) {
  return request(fd, 5, key, klen, nullptr, 0, nullptr, 0);
}

int64_t ts_stamp(int fd, const char* key, uint32_t klen) {
  return request(fd, 7, key, klen, nullptr, 0, nullptr, 0);
}

double ts_now(int fd) {
  char out[8] = {0};
  if (request(fd, 8, nullptr, 0, nullptr, 0, out, 8) < 0) return -1.0;
  double v;
  std::memcpy(&v, out, 8);
  return v;
}

int64_t ts_list(int fd, const char* prefix, uint32_t plen, char* out,
                int64_t cap) {
  return request(fd, 6, prefix, plen, nullptr, 0, out, cap);
}

void ts_close(int fd) { ::close(fd); }

}  // extern "C"
