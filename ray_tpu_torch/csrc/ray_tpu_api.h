// ray_tpu_torch embedded C++ API (header-only facade; the port's copy of
// native/ray_tpu_api.h).
//
// The embedded runtime is the native wire client (csrc/cpp_client.cc,
// built as a shared library with the C ABI `rtc_*`); this header gives a
// C++ program RAII handles and typed argument/result marshalling, with no
// Python anywhere in the process.
//
// Usage:
//   ray_tpu_api::Runtime rt;
//   rt.Init(head_host, head_port, daemon_host, daemon_port);
//   rt.KvPut("k", "v");
//   auto r = rt.SubmitTask("add", ray_tpu_api::Args().I(2).I(3));
//   int64_t five = r.AsInt();
//   rt.CreateActor("Counter", "c1", ray_tpu_api::Args());
//   rt.CallActor("c1", "inc", ray_tpu_api::Args()).AsInt();
//
// Values cross the boundary in the port's wire encoding: a protocol-5
// pickle of plain data only (ints, floats, strings, bools, bytes, None),
// the subset that rpc.loads_frame reads and csrc/cpp_client.cc writes;
// never a pickle of a user object.

#pragma once

#include <dlfcn.h>
#include <stdint.h>

#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace ray_tpu_api {

// -- the value encoding (the writer's subset of protocol-5 pickles) ---------

class Args {
 public:
  Args &I(int64_t v) {
    if (v >= INT32_MIN && v <= INT32_MAX) {
      buf_.push_back('J');                       // BININT
      Le(uint32_t(int32_t(v)), 4);
    } else {
      buf_.push_back(char(0x8a));                // LONG1, 8 bytes
      buf_.push_back(char(8));
      Le(uint64_t(v), 8);
    }
    return *this;
  }
  Args &D(double v) {
    buf_.push_back('G');                         // BINFLOAT, big-endian
    uint64_t bits;
    memcpy(&bits, &v, 8);
    for (int i = 7; i >= 0; i--) buf_.push_back(char((bits >> (8 * i)) & 0xff));
    return *this;
  }
  Args &B(bool v) {
    buf_.push_back(char(v ? 0x88 : 0x89));       // NEWTRUE / NEWFALSE
    return *this;
  }
  Args &S(const std::string &s) {
    if (s.size() < 256) {
      buf_.push_back(char(0x8c));                // SHORT_BINUNICODE
      buf_.push_back(char(s.size()));
    } else {
      buf_.push_back('X');                       // BINUNICODE
      Le(s.size(), 4);
    }
    buf_.append(s);
    return *this;
  }
  Args &Bin(const std::string &b) {
    buf_.push_back('B');                         // BINBYTES
    Le(b.size(), 4);
    buf_.append(b);
    return *this;
  }

  // a pickle of the LIST of the accumulated values
  std::string Packed() const {
    std::string out("\x80\x05]", 3);           // PROTO 5, EMPTY_LIST
    if (!buf_.empty()) {
      out.push_back('(');                        // MARK
      out.append(buf_);
      out.push_back('e');                        // APPENDS
    }
    out.push_back('.');                          // STOP
    return out;
  }

 private:
  void Le(uint64_t v, int n) {
    for (int i = 0; i < n; i++) buf_.push_back(char((v >> (8 * i)) & 0xff));
  }
  std::string buf_;
};

// -- result decoding ----------------------------------------------------------

struct Result {
  bool ok = false;
  std::string raw;     // the pickled value on ok; UTF-8 error text otherwise
  std::string Error() const { return ok ? "" : raw; }

  int64_t AsInt() const {
    const uint8_t *p = Value();
    if (p[0] == 'J') return int32_t(uint32_t(ReadLE(p + 1, 4)));
    if (p[0] == 'K') return ReadLE(p + 1, 1);
    if (p[0] == 'M') return ReadLE(p + 1, 2);
    if (p[0] == 0x8a) {                          // LONG1
      int n = p[1];
      if (n > 8) throw std::runtime_error("int wider than 64 bits");
      uint64_t u = uint64_t(ReadLE(p + 2, n));
      if (n > 0 && n < 8 && (p[1 + n] & 0x80)) u |= ~uint64_t(0) << (8 * n);
      return int64_t(u);
    }
    throw std::runtime_error("result is not an int");
  }
  double AsDouble() const {
    const uint8_t *p = Value();
    if (p[0] == 'G') {
      uint64_t bits = 0;
      for (int i = 1; i <= 8; i++) bits = (bits << 8) | p[i];
      double v;
      memcpy(&v, &bits, 8);
      return v;
    }
    return double(AsInt());
  }
  std::string AsString() const {
    const uint8_t *p = Value();
    size_t n, off;
    if (p[0] == 0x8c) {                          // SHORT_BINUNICODE
      n = p[1];
      off = 2;
    } else if (p[0] == 'X') {                    // BINUNICODE
      n = size_t(ReadLE(p + 1, 4));
      off = 5;
    } else {
      throw std::runtime_error("result is not a string");
    }
    return std::string(reinterpret_cast<const char *>(p + off), n);
  }
  bool AsBool() const { return Value()[0] == 0x88; }
  bool IsNil() const { return raw.size() > 2 && Value()[0] == 'N'; }

 private:
  // the value's first opcode, past PROTO 5
  const uint8_t *Value() const {
    if (raw.size() < 3) throw std::runtime_error("empty result");
    return reinterpret_cast<const uint8_t *>(raw.data()) + 2;
  }
  static int64_t ReadLE(const uint8_t *p, int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
    return int64_t(v);
  }
};

// -- the embedded runtime ---------------------------------------------------

class Runtime {
 public:
  Runtime() = default;
  ~Runtime() { Shutdown(); }
  Runtime(const Runtime &) = delete;
  Runtime &operator=(const Runtime &) = delete;

  // Connect to a running cluster: the head (KV plane) and one node
  // daemon (task/actor/object planes). lib_path is the client library
  // (ray_tpu_torch/_build.py:build_host("cpp_client"); a bare name is
  // looked up on LD_LIBRARY_PATH).
  void Init(const std::string &head_host, int head_port,
            const std::string &daemon_host, int daemon_port,
            const std::string &lib_path = "libray_tpu_cpp_client.so") {
    lib_ = dlopen(lib_path.c_str(), RTLD_NOW);
    if (!lib_) throw std::runtime_error(std::string("dlopen: ") + dlerror());
    Load();
    head_ = connect_(head_host.c_str(), head_port);
    if (!head_) throw std::runtime_error("cannot reach head");
    daemon_ = connect_(daemon_host.c_str(), daemon_port);
    if (!daemon_) throw std::runtime_error("cannot reach daemon");
  }

  void Shutdown() {
    if (head_) close_(head_), head_ = nullptr;
    if (daemon_) close_(daemon_), daemon_ = nullptr;
    if (lib_) dlclose(lib_), lib_ = nullptr;
  }

  // -- KV plane (head InternalKV) --------------------------------------
  bool KvPut(const std::string &key, const std::string &value) {
    return kv_put_(head_, U(key), int(key.size()), U(value),
                   int(value.size())) == 0;
  }
  bool KvGet(const std::string &key, std::string *out) {
    uint8_t *buf = nullptr;
    int64_t n = 0;
    int rc = kv_get_(head_, U(key), int(key.size()), &buf, &n);
    if (rc != 0) return false;
    out->assign(reinterpret_cast<char *>(buf), size_t(n));
    free_(buf);
    return true;
  }

  // -- object plane (daemon object table / shm arena) ------------------
  bool PutObject(const std::string &oid, const std::string &blob) {
    return put_object_(daemon_, U(oid), int(oid.size()), U(blob),
                       int64_t(blob.size())) == 0;
  }
  bool GetObject(const std::string &oid, std::string *out) {
    uint8_t *buf = nullptr;
    int64_t n = 0;
    int rc = get_object_(daemon_, U(oid), int(oid.size()), &buf, &n);
    if (rc != 0) return false;
    out->assign(reinterpret_cast<char *>(buf), size_t(n));
    free_(buf);
    return true;
  }

  long Ping() { return ping_(daemon_); }

  // -- tasks / actors (cross-language by NAME) -------------------------
  Result SubmitTask(const std::string &name, const Args &args) {
    uint8_t *buf = nullptr;
    int64_t n = 0;
    std::string packed = args.Packed();
    int rc = submit_(daemon_, name.c_str(), U(packed),
                     int(packed.size()), &buf, &n);
    return Finish(rc, buf, n);
  }
  Result CreateActor(const std::string &cls, const std::string &name,
                     const Args &args) {
    std::string packed = args.Packed();
    int rc = create_actor_(daemon_, cls.c_str(), name.c_str(), U(packed),
                           int(packed.size()));
    Result r;
    r.ok = rc == 0;
    if (!r.ok) r.raw = last_error_(daemon_);
    return r;
  }
  Result CallActor(const std::string &name, const std::string &method,
                   const Args &args) {
    uint8_t *buf = nullptr;
    int64_t n = 0;
    std::string packed = args.Packed();
    int rc = call_actor_(daemon_, name.c_str(), method.c_str(), U(packed),
                         int(packed.size()), &buf, &n);
    return Finish(rc, buf, n);
  }

 private:
  Result Finish(int rc, uint8_t *buf, int64_t n) {
    Result r;
    r.ok = rc == 0;
    if (buf) {
      r.raw.assign(reinterpret_cast<char *>(buf), size_t(n));
      free_(buf);
    } else if (rc < 0) {
      r.raw = "transport error";
    }
    return r;
  }
  static const uint8_t *U(const std::string &s) {
    return reinterpret_cast<const uint8_t *>(s.data());
  }
  template <typename T>
  void Sym(T &fn, const char *name) {
    fn = reinterpret_cast<T>(dlsym(lib_, name));
    if (!fn) throw std::runtime_error(std::string("missing symbol ") + name);
  }
  void Load() {
    Sym(connect_, "rtc_connect");
    Sym(close_, "rtc_close");
    Sym(free_, "rtc_free");
    Sym(kv_put_, "rtc_kv_put");
    Sym(kv_get_, "rtc_kv_get");
    Sym(put_object_, "rtc_put_object");
    Sym(get_object_, "rtc_get_object");
    Sym(ping_, "rtc_ping");
    Sym(submit_, "rtc_submit_task");
    Sym(create_actor_, "rtc_create_actor");
    Sym(call_actor_, "rtc_call_actor");
    Sym(last_error_, "rtc_last_error");
  }

  void *lib_ = nullptr;
  void *head_ = nullptr;
  void *daemon_ = nullptr;
  void *(*connect_)(const char *, int) = nullptr;
  void (*close_)(void *) = nullptr;
  void (*free_)(void *) = nullptr;
  int (*kv_put_)(void *, const uint8_t *, int, const uint8_t *, int) = nullptr;
  int (*kv_get_)(void *, const uint8_t *, int, uint8_t **, int64_t *) = nullptr;
  int (*put_object_)(void *, const uint8_t *, int, const uint8_t *,
                     int64_t) = nullptr;
  int (*get_object_)(void *, const uint8_t *, int, uint8_t **,
                     int64_t *) = nullptr;
  long (*ping_)(void *) = nullptr;
  int (*submit_)(void *, const char *, const uint8_t *, int, uint8_t **,
                 int64_t *) = nullptr;
  int (*create_actor_)(void *, const char *, const char *, const uint8_t *,
                       int) = nullptr;
  int (*call_actor_)(void *, const char *, const char *, const uint8_t *, int,
                     uint8_t **, int64_t *) = nullptr;
  const char *(*last_error_)(void *) = nullptr;
};

}  // namespace ray_tpu_api
