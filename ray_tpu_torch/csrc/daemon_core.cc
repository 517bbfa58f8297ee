// Native daemon core: the hot task-routing loop of the node daemon (the
// port's copy of ray_tpu's native/daemon_core.cc; built by
// ray_tpu_torch/_build.py and hosted in the driver by
// ray_tpu_torch/_private/fast_lane.py).
//
// Reference capability: the C++ raylet's lease-grant + task-dispatch
// path (src/ray/raylet/node_manager.cc HandleRequestWorkerLease,
// raylet/local_task_manager.h) — the per-node engine that assigns
// queued tasks to pooled workers and pumps results back, without the
// policy layer in the loop. Here the Python daemon stays the policy
// shell (actors, placement groups, runtime envs, object pulls); this
// C++ event loop owns the per-task fast path: accept driver
// submissions, lease a free worker, forward the payload, route the
// outcome back — zero Python (and zero GIL) per task.
//
// Wire protocol (little-endian, TCP):
//   frame := u32 body_len | body
//   body  := u8 op | rest
// ops from peers:
//   0x01 HELLO_WORKER  {}                        worker registers, free
//   0x02 SUBMIT        u64 rid | payload         driver submits a task
//   0x03 RESULT        u64 tid | u8 kind | blob  worker finished tid
//   0x04 CANCEL        u64 rid                   driver cancels
//   0x05 PING          u64 rid                   health/stats probe
// ops to peers:
//   0x06 EXEC          u64 tid | payload         core -> worker
//   0x07 REPLY         u64 rid | u8 kind | blob  core -> driver
//   0x08 CANCEL_EXEC   u64 tid                   core -> worker
// kinds are opaque passthrough except core-generated:
//   0x63 CRASHED (payload = error text), 0x64 CANCELLED, 0x65 PONG.
// The task payload itself (a map built by the driver, decoded by the
// worker: a stdlib pickle of a plain dict in the port, msgpack in the
// reference) is never parsed here — the core routes bytes.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint8_t OP_HELLO_WORKER = 0x01;
constexpr uint8_t OP_SUBMIT = 0x02;
constexpr uint8_t OP_RESULT = 0x03;
constexpr uint8_t OP_CANCEL = 0x04;
constexpr uint8_t OP_PING = 0x05;
constexpr uint8_t OP_EXEC = 0x06;
constexpr uint8_t OP_REPLY = 0x07;
constexpr uint8_t OP_CANCEL_EXEC = 0x08;
// targeted lane (actors): a TAGGED worker serves exactly the submits
// addressed to its tag, strictly FIFO — the per-actor ordering the
// reference enforces via actor_scheduling_queue.h
constexpr uint8_t OP_HELLO_TAGGED = 0x09;
constexpr uint8_t OP_SUBMIT_TARGETED = 0x0a;
// core -> tagged worker: registration is LIVE. The worker reports its
// join complete only after this ack, so the daemon's create-actor
// reply (and thus the driver's first targeted submit) cannot race the
// hello bytes through the event loop.
constexpr uint8_t OP_HELLO_ACK = 0x0b;

constexpr uint8_t KIND_CRASHED = 0x63;
constexpr uint8_t KIND_CANCELLED = 0x64;
constexpr uint8_t KIND_PONG = 0x65;

constexpr size_t MAX_FRAME = size_t(1) << 31;

struct Pending {
  uint64_t rid;
  int driver_fd;
  uint64_t driver_gen;
  std::vector<uint8_t> payload;
};

struct Conn {
  int fd = -1;
  uint64_t gen = 0;          // guards against fd reuse
  bool is_worker = false;
  bool writable = true;
  bool dirty = false;        // queued frames await the end-of-iteration flush
  std::vector<uint8_t> rbuf;
  std::deque<std::vector<uint8_t>> wq;
  size_t wq_off = 0;         // bytes of wq.front() already written
  uint64_t inflight_tid = 0; // worker: task currently executing (0 = idle)
  uint64_t tag = 0;          // targeted worker: its address (0 = pool)
  // targeted worker: submits waiting for it, strictly FIFO
  std::deque<Pending> own_queue;
  // driver: rid -> tid for its in-flight tasks. Per-connection, because
  // every driver numbers its rids independently from 1 — a global map
  // would collide across drivers.
  std::unordered_map<uint64_t, uint64_t> rid_tid;
};

struct Inflight {
  uint64_t rid;
  int driver_fd;
  uint64_t driver_gen;
  int worker_fd;
};

struct Core {
  int epfd = -1;
  int listen_fd = -1;
  int stop_fd = -1;
  uint64_t next_gen = 1;
  uint64_t next_tid = 1;
  std::unordered_map<int, Conn> conns;
  std::vector<int> dirty_fds;  // conns with frames queued this iteration
  std::deque<int> free_workers;
  std::unordered_map<uint64_t, int> tagged;   // tag -> worker fd
  std::deque<Pending> queue;
  std::unordered_map<uint64_t, Inflight> inflight;

  std::atomic<uint64_t> stat_submitted{0};
  std::atomic<uint64_t> stat_completed{0};
  // Gauges mirrored from the loop-thread-owned containers so
  // rtdc_stats (called from arbitrary Python threads) never reads
  // queue/inflight/free_workers cross-thread — container size reads
  // race with the loop thread's mutations (UB, and a deque mid-resize
  // can return garbage). Refreshed by the loop thread each iteration,
  // the same ownership discipline as stat_submitted/stat_completed.
  std::atomic<uint64_t> stat_queue_depth{0};
  std::atomic<uint64_t> stat_inflight{0};
  std::atomic<uint64_t> stat_free{0};
};

Core *g_core = nullptr;
pthread_t g_thread;
std::atomic<bool> g_running{false};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void put_u32(std::vector<uint8_t> &v, uint32_t x) {
  v.push_back(x & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 24) & 0xff);
}

void put_u64(std::vector<uint8_t> &v, uint64_t x) {
  for (int i = 0; i < 8; i++) v.push_back((x >> (8 * i)) & 0xff);
}

uint32_t get_u32(const uint8_t *p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

uint64_t get_u64(const uint8_t *p) {
  uint64_t x = 0;
  for (int i = 0; i < 8; i++) x |= uint64_t(p[i]) << (8 * i);
  return x;
}

void epoll_mod(Core &c, int fd, bool want_write) {
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
  ev.data.fd = fd;
  epoll_ctl(c.epfd, EPOLL_CTL_MOD, fd, &ev);
}

// Queue a frame (header built here around op+body parts) on a conn.
// Writes are DEFERRED to the end of the event-loop iteration
// (flush_dirty): a burst handled in one iteration — several worker
// RESULTs, a driver read full of SUBMITs — leaves per peer as ONE
// scatter-gather syscall instead of one send per frame. Same-iteration
// flushing keeps single-round-trip latency unchanged.
void send_frame(Core &c, Conn &conn, uint8_t op,
                const uint8_t *h, size_t hlen,
                const uint8_t *body, size_t blen) {
  std::vector<uint8_t> f;
  f.reserve(4 + 1 + hlen + blen);
  put_u32(f, uint32_t(1 + hlen + blen));
  f.push_back(op);
  f.insert(f.end(), h, h + hlen);
  if (blen) f.insert(f.end(), body, body + blen);
  conn.wq.emplace_back(std::move(f));
  if (!conn.dirty) {
    conn.dirty = true;
    c.dirty_fds.push_back(conn.fd);
  }
}

// Drain a conn's write queue with as few syscalls as the kernel allows
// (sendmsg over up to 64 queued frames); registers EPOLLOUT on a
// short write.
void flush_conn(Core &c, Conn &conn) {
  while (!conn.wq.empty()) {
    iovec iov[64];
    int cnt = 0;
    size_t off = conn.wq_off;
    for (auto &buf : conn.wq) {
      if (cnt == 64) break;
      iov[cnt].iov_base = const_cast<uint8_t *>(buf.data()) + off;
      iov[cnt].iov_len = buf.size() - off;
      off = 0;
      cnt++;
    }
    msghdr mh{};
    mh.msg_iov = iov;
    mh.msg_iovlen = cnt;
    ssize_t n = ::sendmsg(conn.fd, &mh, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        epoll_mod(c, conn.fd, true);
        return;
      }
      return;  // peer dead; EPOLLHUP will clean up
    }
    size_t left = size_t(n);
    while (left) {
      auto &front = conn.wq.front();
      size_t avail = front.size() - conn.wq_off;
      if (left >= avail) {
        left -= avail;
        conn.wq.pop_front();
        conn.wq_off = 0;
      } else {
        conn.wq_off += left;
        left = 0;
      }
    }
  }
}

void flush_dirty(Core &c) {
  if (c.dirty_fds.empty()) return;
  std::vector<int> fds;
  fds.swap(c.dirty_fds);
  for (int fd : fds) {
    auto it = c.conns.find(fd);
    if (it == c.conns.end()) continue;  // closed this iteration
    Conn &conn = it->second;
    if (!conn.dirty) continue;          // fd reuse duplicate entry
    conn.dirty = false;
    flush_conn(c, conn);
  }
}

void reply_driver(Core &c, int fd, uint64_t gen, uint64_t rid, uint8_t kind,
                  const uint8_t *blob, size_t blen) {
  auto it = c.conns.find(fd);
  if (it == c.conns.end() || it->second.gen != gen) return;  // driver gone
  uint8_t h[9];
  memcpy(h, &rid, 8);
  h[8] = kind;
  send_frame(c, it->second, OP_REPLY, h, 9, blob, blen);
}

void dispatch(Core &c);

void complete(Core &c, uint64_t tid, uint8_t kind, const uint8_t *blob,
              size_t blen) {
  auto it = c.inflight.find(tid);
  if (it == c.inflight.end()) return;
  Inflight inf = it->second;
  c.inflight.erase(it);
  auto dit = c.conns.find(inf.driver_fd);
  if (dit != c.conns.end() && dit->second.gen == inf.driver_gen)
    dit->second.rid_tid.erase(inf.rid);
  c.stat_completed.fetch_add(1, std::memory_order_relaxed);
  reply_driver(c, inf.driver_fd, inf.driver_gen, inf.rid, kind, blob, blen);
}

void exec_on(Core &c, Conn &worker, Pending &&p) {
  uint64_t tid = c.next_tid++;
  c.inflight[tid] = Inflight{p.rid, p.driver_fd, p.driver_gen,
                             worker.fd};
  auto dit = c.conns.find(p.driver_fd);
  if (dit != c.conns.end() && dit->second.gen == p.driver_gen)
    dit->second.rid_tid[p.rid] = tid;
  worker.inflight_tid = tid;
  uint8_t h[8];
  memcpy(h, &tid, 8);
  send_frame(c, worker, OP_EXEC, h, 8, p.payload.data(),
             p.payload.size());
}

void dispatch(Core &c) {
  while (!c.queue.empty() && !c.free_workers.empty()) {
    int wfd = c.free_workers.front();
    c.free_workers.pop_front();
    auto wit = c.conns.find(wfd);
    if (wit == c.conns.end()) continue;  // stale free-list entry
    Pending p = std::move(c.queue.front());
    c.queue.pop_front();
    exec_on(c, wit->second, std::move(p));
  }
}

void close_conn(Core &c, int fd) {
  auto it = c.conns.find(fd);
  if (it == c.conns.end()) return;
  Conn &conn = it->second;
  if (conn.is_worker) {
    // crash any task it was executing AND everything queued on it
    static const char err[] = "worker process died (fast lane)";
    if (conn.inflight_tid) {
      complete(c, conn.inflight_tid, KIND_CRASHED,
               reinterpret_cast<const uint8_t *>(err), sizeof(err) - 1);
    }
    for (auto &p : conn.own_queue)
      reply_driver(c, p.driver_fd, p.driver_gen, p.rid, KIND_CRASHED,
                   reinterpret_cast<const uint8_t *>(err),
                   sizeof(err) - 1);
    conn.own_queue.clear();
    if (conn.tag) c.tagged.erase(conn.tag);
    for (auto fit = c.free_workers.begin(); fit != c.free_workers.end();)
      fit = (*fit == fd) ? c.free_workers.erase(fit) : fit + 1;
  } else {
    // driver: purge its queued submits and orphan its in-flights
    for (auto qit = c.queue.begin(); qit != c.queue.end();)
      qit = (qit->driver_fd == fd && qit->driver_gen == conn.gen)
                ? c.queue.erase(qit)
                : qit + 1;
    for (auto &kv : c.conns) {
      if (!kv.second.is_worker) continue;
      auto &oq = kv.second.own_queue;
      for (auto qit = oq.begin(); qit != oq.end();)
        qit = (qit->driver_fd == fd && qit->driver_gen == conn.gen)
                  ? oq.erase(qit)
                  : qit + 1;
    }
    for (auto &kv : c.inflight)
      if (kv.second.driver_fd == fd && kv.second.driver_gen == conn.gen)
        kv.second.driver_fd = -1;  // result will be discarded
  }
  epoll_ctl(c.epfd, EPOLL_CTL_DEL, fd, nullptr);
  ::close(fd);
  c.conns.erase(it);
  dispatch(c);
}

// Handle one complete frame from a peer.
void on_frame(Core &c, int fd, const uint8_t *body, size_t len) {
  auto it = c.conns.find(fd);
  if (it == c.conns.end() || len < 1) return;
  Conn &conn = it->second;
  uint8_t op = body[0];
  const uint8_t *p = body + 1;
  size_t n = len - 1;
  switch (op) {
    case OP_HELLO_WORKER: {
      conn.is_worker = true;
      conn.inflight_tid = 0;
      c.free_workers.push_back(fd);
      dispatch(c);
      break;
    }
    case OP_HELLO_TAGGED: {
      if (n < 8) return;
      conn.is_worker = true;
      conn.inflight_tid = 0;
      conn.tag = get_u64(p);
      c.tagged[conn.tag] = fd;      // NOT in free_workers
      send_frame(c, conn, OP_HELLO_ACK, nullptr, 0, nullptr, 0);
      break;
    }
    case OP_SUBMIT_TARGETED: {
      if (n < 16) return;
      uint64_t rid = get_u64(p);
      uint64_t tag = get_u64(p + 8);
      c.stat_submitted.fetch_add(1, std::memory_order_relaxed);
      auto tit = c.tagged.find(tag);
      if (tit == c.tagged.end()) {
        static const char err[] = "no such targeted worker";
        reply_driver(c, fd, conn.gen, rid, KIND_CRASHED,
                     reinterpret_cast<const uint8_t *>(err),
                     sizeof(err) - 1);
        return;
      }
      auto wit = c.conns.find(tit->second);
      if (wit == c.conns.end()) return;
      Pending pend{rid, fd, conn.gen,
                   std::vector<uint8_t>(p + 16, p + n)};
      if (wit->second.inflight_tid == 0 && wit->second.own_queue.empty())
        exec_on(c, wit->second, std::move(pend));
      else
        wit->second.own_queue.emplace_back(std::move(pend));
      break;
    }
    case OP_SUBMIT: {
      if (n < 8) return;
      uint64_t rid = get_u64(p);
      c.stat_submitted.fetch_add(1, std::memory_order_relaxed);
      Pending pend{rid, fd, conn.gen,
                   std::vector<uint8_t>(p + 8, p + n)};
      c.queue.emplace_back(std::move(pend));
      dispatch(c);
      break;
    }
    case OP_RESULT: {
      if (n < 9 || !conn.is_worker) return;
      uint64_t tid = get_u64(p);
      uint8_t kind = p[8];
      // require the worker's current assignment: a duplicate/stale
      // RESULT must not double-free-list the worker (two concurrent
      // EXECs on one worker would interleave)
      if (conn.inflight_tid != tid) return;
      conn.inflight_tid = 0;
      complete(c, tid, kind, p + 9, n - 9);
      if (conn.tag) {
        // targeted worker: strictly its own FIFO, never the pool
        if (!conn.own_queue.empty()) {
          Pending pend = std::move(conn.own_queue.front());
          conn.own_queue.pop_front();
          exec_on(c, conn, std::move(pend));
        }
        break;
      }
      // pool worker is free again
      c.free_workers.push_back(fd);
      dispatch(c);
      break;
    }
    case OP_CANCEL: {
      if (n < 8) return;
      uint64_t rid = get_u64(p);
      uint8_t force = (n >= 9) ? p[8] : 0;
      // still queued? drop + CANCELLED (pool queue, then per-worker
      // targeted queues)
      for (auto qit = c.queue.begin(); qit != c.queue.end(); ++qit) {
        if (qit->rid == rid && qit->driver_fd == fd &&
            qit->driver_gen == conn.gen) {
          Pending pend = std::move(*qit);
          c.queue.erase(qit);
          reply_driver(c, pend.driver_fd, pend.driver_gen, rid,
                       KIND_CANCELLED, nullptr, 0);
          return;
        }
      }
      for (auto &kv : c.conns) {
        if (!kv.second.is_worker) continue;
        auto &oq = kv.second.own_queue;
        for (auto qit = oq.begin(); qit != oq.end(); ++qit) {
          if (qit->rid == rid && qit->driver_fd == fd &&
              qit->driver_gen == conn.gen) {
            oq.erase(qit);
            reply_driver(c, fd, conn.gen, rid, KIND_CANCELLED,
                         nullptr, 0);
            return;
          }
        }
      }
      // in flight? forward to the executing worker — soft interrupt,
      // or force (worker exits, surfacing as CRASHED, the classic
      // force-kill contract); the outcome flows back normally
      auto rit = conn.rid_tid.find(rid);
      if (rit != conn.rid_tid.end()) {
        auto iit = c.inflight.find(rit->second);
        if (iit != c.inflight.end() && iit->second.driver_fd == fd) {
          auto wit = c.conns.find(iit->second.worker_fd);
          if (wit != c.conns.end()) {
            uint8_t h[9];
            uint64_t tid = rit->second;
            memcpy(h, &tid, 8);
            h[8] = force;
            send_frame(c, wit->second, OP_CANCEL_EXEC, h, 9, nullptr, 0);
          }
        }
      }
      break;
    }
    case OP_PING: {
      if (n < 8) return;
      uint64_t rid = get_u64(p);
      // stats blob: 4 x u64 (queued, inflight, workers, completed)
      std::vector<uint8_t> s;
      put_u64(s, c.queue.size());
      put_u64(s, c.inflight.size());
      uint64_t nworkers = 0;
      for (auto &kv : c.conns)
        if (kv.second.is_worker) nworkers++;
      put_u64(s, nworkers);
      put_u64(s, c.stat_completed.load(std::memory_order_relaxed));
      reply_driver(c, fd, conn.gen, rid, KIND_PONG, s.data(), s.size());
      break;
    }
    default:
      break;
  }
}

void on_readable(Core &c, int fd) {
  auto it = c.conns.find(fd);
  if (it == c.conns.end()) return;
  Conn &conn = it->second;
  uint8_t tmp[64 * 1024];
  for (;;) {
    ssize_t r = ::recv(fd, tmp, sizeof(tmp), 0);
    if (r > 0) {
      conn.rbuf.insert(conn.rbuf.end(), tmp, tmp + r);
      continue;
    }
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    close_conn(c, fd);
    return;
  }
  size_t off = 0;
  for (;;) {
    if (conn.rbuf.size() - off < 4) break;
    uint32_t blen = get_u32(conn.rbuf.data() + off);
    if (blen > MAX_FRAME) {
      close_conn(c, fd);
      return;
    }
    if (conn.rbuf.size() - off < 4 + size_t(blen)) break;
    on_frame(c, fd, conn.rbuf.data() + off + 4, blen);
    // on_frame may have closed the conn (protocol error)
    auto again = c.conns.find(fd);
    if (again == c.conns.end() || &again->second != &conn) return;
    off += 4 + blen;
  }
  if (off) conn.rbuf.erase(conn.rbuf.begin(), conn.rbuf.begin() + off);
}

void on_writable(Core &c, int fd) {
  auto it = c.conns.find(fd);
  if (it == c.conns.end()) return;
  Conn &conn = it->second;
  flush_conn(c, conn);
  if (conn.wq.empty()) epoll_mod(c, fd, false);
}

void *loop_main(void *) {
  Core &c = *g_core;
  epoll_event evs[64];
  while (g_running.load(std::memory_order_acquire)) {
    int n = epoll_wait(c.epfd, evs, 64, 500);
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == c.stop_fd) {
        uint64_t x;
        (void)!read(c.stop_fd, &x, 8);
        continue;
      }
      if (fd == c.listen_fd) {
        for (;;) {
          int cfd = ::accept(c.listen_fd, nullptr, nullptr);
          if (cfd < 0) break;
          set_nonblock(cfd);
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn conn;
          conn.fd = cfd;
          conn.gen = c.next_gen++;
          c.conns.emplace(cfd, std::move(conn));
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(c.epfd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(c, fd);
        continue;
      }
      if (evs[i].events & EPOLLIN) on_readable(c, fd);
      if (evs[i].events & EPOLLOUT) on_writable(c, fd);
    }
    // one coalesced write per peer for everything this iteration queued
    flush_dirty(c);
    // publish the stats gauges from the loop thread (sole owner of the
    // containers); cross-thread rtdc_stats reads only these atomics
    c.stat_queue_depth.store(c.queue.size(), std::memory_order_relaxed);
    c.stat_inflight.store(c.inflight.size(), std::memory_order_relaxed);
    c.stat_free.store(c.free_workers.size(), std::memory_order_relaxed);
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Start the core; returns the bound port, or -1. host must be an IPv4
// literal (e.g. "0.0.0.0" or "127.0.0.1").
int rtdc_start(const char *host, int port) {
  if (g_running.load()) return -1;
  g_core = new Core();
  Core &c = *g_core;
  c.epfd = epoll_create1(0);
  c.listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(c.listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return -1;
  if (bind(c.listen_fd, reinterpret_cast<sockaddr *>(&addr),
           sizeof(addr)) != 0)
    return -1;
  if (listen(c.listen_fd, 256) != 0) return -1;
  socklen_t alen = sizeof(addr);
  getsockname(c.listen_fd, reinterpret_cast<sockaddr *>(&addr), &alen);
  set_nonblock(c.listen_fd);
  c.stop_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = c.listen_fd;
  epoll_ctl(c.epfd, EPOLL_CTL_ADD, c.listen_fd, &ev);
  ev.data.fd = c.stop_fd;
  epoll_ctl(c.epfd, EPOLL_CTL_ADD, c.stop_fd, &ev);
  g_running.store(true, std::memory_order_release);
  if (pthread_create(&g_thread, nullptr, loop_main, nullptr) != 0) {
    g_running.store(false);
    return -1;
  }
  return int(ntohs(addr.sin_port));
}

void rtdc_stop(void) {
  if (!g_running.load()) return;
  g_running.store(false, std::memory_order_release);
  uint64_t one = 1;
  (void)!write(g_core->stop_fd, &one, 8);
  pthread_join(g_thread, nullptr);
  Core &c = *g_core;
  for (auto &kv : c.conns) ::close(kv.first);
  ::close(c.listen_fd);
  ::close(c.stop_fd);
  ::close(c.epfd);
  delete g_core;
  g_core = nullptr;
}

// out[0..3] = queued, inflight, workers(free), submitted
void rtdc_stats(uint64_t *out) {
  if (!g_running.load() || !g_core) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  out[0] = g_core->stat_queue_depth.load(std::memory_order_relaxed);
  out[1] = g_core->stat_inflight.load(std::memory_order_relaxed);
  out[2] = g_core->stat_free.load(std::memory_order_relaxed);
  out[3] = g_core->stat_submitted.load(std::memory_order_relaxed);
}

}  // extern "C"
