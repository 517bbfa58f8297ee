// C++ client for the port's control and object wire (the port's copy of
// native/cpp_client.cc, with the port's frame encoding).
//
// A native program speaks to the head (KV) and to node daemons (object
// plane, ping, cross-language tasks and actors) with no Python in its
// process. The wire is ray_tpu_torch/_private/rpc.py's: u32 big-endian
// length | frame, a frame being a stdlib pickle (protocol 5) of a dict of
// plain data ("m" = method, "i" = request id, "e" = error). The receiver's
// unpickler refuses every global, so this client writes and reads only
// the plain-data subset:
//
//   writes: PROTO, MARK, EMPTY_DICT/SETITEMS, EMPTY_LIST/APPENDS,
//           SHORT_BINUNICODE/BINUNICODE, SHORT_BINBYTES/BINBYTES/BINBYTES8,
//           BININT/LONG1, BINFLOAT, NONE, NEWTRUE/NEWFALSE, STOP;
//   reads:  all of that and what Python's pickler emits for plain data at
//           protocol 5: FRAME, MEMOIZE, BINPUT/LONG_BINPUT, BINGET/
//           LONG_BINGET, BININT1/BININT2/LONG4, the TUPLE opcodes,
//           EMPTY_SET/ADDITEMS/FROZENSET, BYTEARRAY8, BINUNICODE8, SETITEM,
//           APPEND and LIST;
//   refuses: any other opcode (GLOBAL, STACK_GLOBAL, REDUCE, ...) as a
//           decode error, as the Python side refuses a global.
//
// The same encoding carries the values of the cross-language calls: the
// "args" bytes of rtc_submit_task/rtc_create_actor/rtc_call_actor are a
// pickle of a list (the daemon decodes them with rpc.loads_frame), and a
// result comes back to the caller re-encoded by this writer.
//
// C ABI (ctypes-consumable), unchanged from JAX's client:
//   rtc_connect / rtc_close / rtc_free
//   rtc_kv_put / rtc_kv_get            (head KV)
//   rtc_put_object / rtc_get_object    (daemon object table)
//   rtc_ping                           (daemon_ping -> pid)
//   rtc_submit_task                    (cross-language task by name)
//   rtc_create_actor / rtc_call_actor  (cross-language Python actors)
//   rtc_last_error
// and two codec entry points for tests: rtc_frame_encode_test (a fixed
// value tree) and rtc_frame_roundtrip (decode a pickle, encode it again).
//
// Build: ray_tpu_torch/_build.py:build_host("cpp_client") (g++ -O2 -fPIC
// -shared -std=c++17).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// values: the plain data a frame holds
// ---------------------------------------------------------------------------

struct Value {
  enum Kind { NIL, BOOL, INT, DBL, STR, BIN, ARR, MAP } kind = NIL;
  bool b = false;
  int64_t i = 0;
  double d = 0;
  std::string s;                       // STR and BIN both land here
  std::vector<Value> arr;              // list, tuple, set
  std::map<std::string, Value> map;    // string-keyed dicts only

  const Value* get(const std::string& key) const {
    auto it = map.find(key);
    return it == map.end() ? nullptr : &it->second;
  }
};

// -- the writer --------------------------------------------------------------

constexpr char OP_MARK = '(';
constexpr char OP_STOP = '.';
constexpr char OP_NONE = 'N';
constexpr char OP_BININT = 'J';
constexpr char OP_BINFLOAT = 'G';
constexpr char OP_BINUNICODE = 'X';
constexpr char OP_BINBYTES = 'B';
constexpr char OP_SHORT_BINBYTES = 'C';
constexpr char OP_EMPTY_LIST = ']';
constexpr char OP_APPENDS = 'e';
constexpr char OP_EMPTY_DICT = '}';
constexpr char OP_SETITEMS = 'u';
constexpr uint8_t OP_PROTO = 0x80;
constexpr uint8_t OP_NEWTRUE = 0x88;
constexpr uint8_t OP_NEWFALSE = 0x89;
constexpr uint8_t OP_LONG1 = 0x8a;
constexpr uint8_t OP_SHORT_BINUNICODE = 0x8c;
constexpr uint8_t OP_BINBYTES8 = 0x8e;

void put_le(std::string& out, uint64_t v, int n) {
  for (int k = 0; k < n; ++k) out.push_back(static_cast<char>(v >> (8 * k)));
}

void enc_int(std::string& out, int64_t v) {
  if (v >= INT32_MIN && v <= INT32_MAX) {
    out.push_back(OP_BININT);
    put_le(out, static_cast<uint32_t>(static_cast<int32_t>(v)), 4);
    return;
  }
  // LONG1: little-endian two's complement, the fewest bytes that keep the
  // sign (what Python's encode_long gives)
  uint64_t u = static_cast<uint64_t>(v);
  int n = 8;
  while (n > 1) {
    uint8_t top = static_cast<uint8_t>(u >> (8 * (n - 1)));
    uint8_t next = static_cast<uint8_t>(u >> (8 * (n - 2)));
    if ((top == 0x00 && !(next & 0x80)) || (top == 0xff && (next & 0x80)))
      --n;
    else
      break;
  }
  out.push_back(static_cast<char>(OP_LONG1));
  out.push_back(static_cast<char>(n));
  put_le(out, u, n);
}

void enc_double(std::string& out, double d) {
  out.push_back(OP_BINFLOAT);
  uint64_t u;
  memcpy(&u, &d, 8);
  for (int s = 56; s >= 0; s -= 8) out.push_back(static_cast<char>(u >> s));
}

void enc_str(std::string& out, const std::string& s) {
  if (s.size() < 256) {
    out.push_back(static_cast<char>(OP_SHORT_BINUNICODE));
    out.push_back(static_cast<char>(s.size()));
  } else {
    out.push_back(OP_BINUNICODE);
    put_le(out, s.size(), 4);
  }
  out += s;
}

void enc_bin(std::string& out, const uint8_t* data, size_t n) {
  if (n < 256) {
    out.push_back(OP_SHORT_BINBYTES);
    out.push_back(static_cast<char>(n));
  } else if (n <= 0xffffffffULL) {
    out.push_back(OP_BINBYTES);
    put_le(out, n, 4);
  } else {
    out.push_back(static_cast<char>(OP_BINBYTES8));
    put_le(out, n, 8);
  }
  if (n) out.append(reinterpret_cast<const char*>(data), n);
}

void enc_bool(std::string& out, bool v) {
  out.push_back(static_cast<char>(v ? OP_NEWTRUE : OP_NEWFALSE));
}

void enc_value(std::string& out, const Value& v) {
  switch (v.kind) {
    case Value::NIL: out.push_back(OP_NONE); break;
    case Value::BOOL: enc_bool(out, v.b); break;
    case Value::INT: enc_int(out, v.i); break;
    case Value::DBL: enc_double(out, v.d); break;
    case Value::STR: enc_str(out, v.s); break;
    case Value::BIN:
      enc_bin(out, reinterpret_cast<const uint8_t*>(v.s.data()), v.s.size());
      break;
    case Value::ARR:
      out.push_back(OP_EMPTY_LIST);
      if (!v.arr.empty()) {
        out.push_back(OP_MARK);
        for (const Value& e : v.arr) enc_value(out, e);
        out.push_back(OP_APPENDS);
      }
      break;
    case Value::MAP:
      out.push_back(OP_EMPTY_DICT);
      if (!v.map.empty()) {
        out.push_back(OP_MARK);
        for (const auto& kv : v.map) {
          enc_str(out, kv.first);
          enc_value(out, kv.second);
        }
        out.push_back(OP_SETITEMS);
      }
      break;
  }
}

// A whole pickle of one value: PROTO 5 | value | STOP.
std::string enc_pickle(const Value& v) {
  std::string out;
  out.push_back(static_cast<char>(OP_PROTO));
  out.push_back(5);
  enc_value(out, v);
  out.push_back(OP_STOP);
  return out;
}

// -- the reader --------------------------------------------------------------

using VP = std::shared_ptr<Value>;

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  std::string err;

  std::vector<VP> stack;
  std::vector<size_t> marks;
  std::unordered_map<uint64_t, VP> memo;

  bool fail(const std::string& why) {
    if (ok) {
      ok = false;
      err = why;
    }
    return false;
  }

  uint64_t le(int n) {
    if (end - p < n) { fail("truncated frame"); return 0; }
    uint64_t v = 0;
    for (int k = 0; k < n; ++k) v |= uint64_t(p[k]) << (8 * k);
    p += n;
    return v;
  }

  bool take(size_t n, std::string* out) {
    if (static_cast<size_t>(end - p) < n) return fail("truncated frame");
    out->assign(reinterpret_cast<const char*>(p), n);
    p += n;
    return true;
  }

  void push(Value v) { stack.push_back(std::make_shared<Value>(std::move(v))); }

  static Value owned(const VP& v) {
    // a value the memo also holds is copied; one only the stack held moves
    return v.use_count() == 1 ? std::move(*v) : *v;
  }

  bool pop(VP* out) {
    if (stack.empty() || (!marks.empty() && stack.size() <= marks.back()))
      return fail("stack underflow");
    *out = std::move(stack.back());
    stack.pop_back();
    return true;
  }

  // the items above the topmost mark, which is dropped
  bool pop_mark(std::vector<VP>* items) {
    if (marks.empty()) return fail("no mark");
    size_t m = marks.back();
    marks.pop_back();
    items->assign(std::make_move_iterator(stack.begin() + m),
                  std::make_move_iterator(stack.end()));
    stack.resize(m);
    return true;
  }

  bool top(VP* out) {
    if (stack.empty()) return fail("empty stack");
    *out = stack.back();
    return true;
  }

  bool add_items(const VP& container, std::vector<VP>& items, bool pairs) {
    if (pairs) {
      if (container->kind != Value::MAP) return fail("SETITEMS on a non-dict");
      if (items.size() % 2) return fail("odd SETITEMS");
      for (size_t k = 0; k < items.size(); k += 2) {
        if (items[k]->kind == Value::STR)   // string-keyed dicts only
          container->map[items[k]->s] = owned(items[k + 1]);
      }
      return true;
    }
    if (container->kind != Value::ARR) return fail("APPENDS on a non-list");
    for (auto& it : items) container->arr.push_back(owned(it));
    return true;
  }

  bool long_bytes(size_t n) {
    if (n > 8) return fail("int wider than 64 bits");
    if (static_cast<size_t>(end - p) < n) return fail("truncated frame");
    uint64_t u = 0;
    for (size_t k = 0; k < n; ++k) u |= uint64_t(p[k]) << (8 * k);
    if (n > 0 && n < 8 && (p[n - 1] & 0x80)) u |= ~uint64_t(0) << (8 * n);
    p += n;
    Value v;
    v.kind = Value::INT;
    v.i = static_cast<int64_t>(u);
    push(std::move(v));
    return true;
  }

  bool str_of(Value::Kind kind, size_t n) {
    Value v;
    v.kind = kind;
    if (!take(n, &v.s)) return false;
    push(std::move(v));
    return true;
  }

  bool load(Value* result) {
    while (ok) {
      if (p >= end) return fail("frame without STOP");
      uint8_t op = *p++;
      Value v;
      VP a, b;
      std::vector<VP> items;
      switch (op) {
        case 0x80: le(1); break;                        // PROTO
        case 0x95: le(8); break;                        // FRAME
        case '.':                                       // STOP
          if (stack.size() != 1 || !marks.empty())
            return fail("bad stack at STOP");
          *result = owned(stack.back());
          return true;
        case '(': marks.push_back(stack.size()); break;  // MARK
        case 'N': push(Value()); break;
        case 0x88: v.kind = Value::BOOL; v.b = true; push(std::move(v)); break;
        case 0x89: v.kind = Value::BOOL; v.b = false; push(std::move(v)); break;
        case 'J':
          v.kind = Value::INT;
          v.i = static_cast<int32_t>(static_cast<uint32_t>(le(4)));
          push(std::move(v));
          break;
        case 'K': v.kind = Value::INT; v.i = le(1); push(std::move(v)); break;
        case 'M': v.kind = Value::INT; v.i = le(2); push(std::move(v)); break;
        case 0x8a: long_bytes(le(1)); break;            // LONG1
        case 0x8b: long_bytes(le(4)); break;            // LONG4
        case 'G': {                                     // BINFLOAT
          if (end - p < 8) return fail("truncated frame");
          uint64_t u = 0;
          for (int k = 0; k < 8; ++k) u = (u << 8) | p[k];
          p += 8;
          v.kind = Value::DBL;
          memcpy(&v.d, &u, 8);
          push(std::move(v));
          break;
        }
        case 0x8c: str_of(Value::STR, le(1)); break;    // SHORT_BINUNICODE
        case 'X': str_of(Value::STR, le(4)); break;     // BINUNICODE
        case 0x8d: str_of(Value::STR, le(8)); break;    // BINUNICODE8
        case 'C': str_of(Value::BIN, le(1)); break;     // SHORT_BINBYTES
        case 'B': str_of(Value::BIN, le(4)); break;     // BINBYTES
        case 0x8e: str_of(Value::BIN, le(8)); break;    // BINBYTES8
        case 0x96: str_of(Value::BIN, le(8)); break;    // BYTEARRAY8
        case ']': case ')': case 0x8f:                  // empty list/tuple/set
          v.kind = Value::ARR;
          push(std::move(v));
          break;
        case '}': v.kind = Value::MAP; push(std::move(v)); break;
        case 'a':                                       // APPEND
          if (!pop(&a) || !top(&b)) break;
          items.push_back(std::move(a));
          add_items(b, items, false);
          break;
        case 'e': case 0x90:                            // APPENDS, ADDITEMS
          if (!pop_mark(&items) || !top(&b)) break;
          add_items(b, items, false);
          break;
        case 's':                                       // SETITEM
          if (!pop(&b) || !pop(&a)) break;
          items.push_back(std::move(a));
          items.push_back(std::move(b));
          if (!top(&a)) break;
          add_items(a, items, true);
          break;
        case 'u':                                       // SETITEMS
          if (!pop_mark(&items) || !top(&b)) break;
          add_items(b, items, true);
          break;
        case 't': case 'l': case 0x91:                  // TUPLE, LIST, FROZENSET
          if (!pop_mark(&items)) break;
          v.kind = Value::ARR;
          for (auto& it : items) v.arr.push_back(owned(it));
          push(std::move(v));
          break;
        case 0x85: case 0x86: case 0x87: {              // TUPLE1..3
          size_t n = op - 0x84;
          if (stack.size() < n ||
              (!marks.empty() && stack.size() - n < marks.back()))
            return fail("stack underflow");
          v.kind = Value::ARR;
          for (size_t k = stack.size() - n; k < stack.size(); ++k)
            v.arr.push_back(owned(stack[k]));
          stack.resize(stack.size() - n);
          push(std::move(v));
          break;
        }
        case 0x94:                                      // MEMOIZE
          if (top(&a)) memo[memo.size()] = a;
          break;
        case 'q': { uint64_t k = le(1); if (top(&a)) memo[k] = a; break; }
        case 'r': { uint64_t k = le(4); if (top(&a)) memo[k] = a; break; }
        case 'h': case 'j': {                           // BINGET, LONG_BINGET
          uint64_t k = le(op == 'h' ? 1 : 4);
          auto it = memo.find(k);
          if (it == memo.end()) return fail("memo miss");
          stack.push_back(it->second);
          break;
        }
        default: {
          char buf[64];
          snprintf(buf, sizeof(buf), "refused pickle opcode 0x%02x", op);
          return fail(buf);
        }
      }
    }
    return false;
  }
};

bool dec_pickle(const uint8_t* data, size_t n, Value* out, std::string* err) {
  Reader r{data, data + n};
  if (r.load(out)) return true;
  *err = r.err;
  return false;
}

// ---------------------------------------------------------------------------
// connection
// ---------------------------------------------------------------------------

struct Client {
  int fd = -1;
  uint64_t next_id = 0;
  std::mutex mu;
  std::string last_error;

  bool send_all(const char* data, size_t n) {
    size_t off = 0;
    while (off < n) {
      ssize_t k = ::send(fd, data + off, n - off, MSG_NOSIGNAL);
      if (k <= 0) return false;
      off += static_cast<size_t>(k);
    }
    return true;
  }

  bool recv_all(uint8_t* out, size_t n) {
    size_t off = 0;
    while (off < n) {
      ssize_t r = ::recv(fd, out + off, n - off, 0);
      if (r <= 0) return false;
      off += static_cast<size_t>(r);
    }
    return true;
  }

  // One request/reply round trip; ``fields`` are the request's fields
  // beside "m" and "i".
  bool call(const std::string& method, Value fields, Value* reply) {
    std::lock_guard<std::mutex> lock(mu);
    uint64_t rid = ++next_id;
    fields.kind = Value::MAP;
    fields.map["m"].kind = Value::STR;
    fields.map["m"].s = method;
    fields.map["i"].kind = Value::INT;
    fields.map["i"].i = static_cast<int64_t>(rid);
    std::string body = enc_pickle(fields);
    uint32_t len = htonl(static_cast<uint32_t>(body.size()));
    if (!send_all(reinterpret_cast<const char*>(&len), 4) ||
        !send_all(body.data(), body.size())) {
      last_error = "send failed";
      return false;
    }
    // read frames until the one carrying our id (pushes have no "i")
    while (true) {
      uint8_t hdr[4];
      if (!recv_all(hdr, 4)) { last_error = "recv failed"; return false; }
      uint32_t blen = (uint32_t(hdr[0]) << 24) | (uint32_t(hdr[1]) << 16) |
                      (uint32_t(hdr[2]) << 8) | uint32_t(hdr[3]);
      std::vector<uint8_t> buf(blen);
      if (!recv_all(buf.data(), blen)) {
        last_error = "recv failed";
        return false;
      }
      Value msg;
      std::string err;
      if (!dec_pickle(buf.data(), blen, &msg, &err) ||
          msg.kind != Value::MAP) {
        last_error = "bad frame: " + err;
        return false;
      }
      const Value* id = msg.get("i");
      if (id == nullptr || id->kind != Value::INT ||
          static_cast<uint64_t>(id->i) != rid) {
        continue;  // a server push or a stale frame: skip
      }
      const Value* e = msg.get("e");
      if (e != nullptr && e->kind == Value::STR && !e->s.empty()) {
        last_error = e->s;
        return false;
      }
      *reply = std::move(msg);
      return true;
    }
  }
};

Value str_v(const std::string& s) {
  Value v;
  v.kind = Value::STR;
  v.s = s;
  return v;
}

Value bin_v(const uint8_t* data, size_t n) {
  Value v;
  v.kind = Value::BIN;
  if (n) v.s.assign(reinterpret_cast<const char*>(data), n);
  return v;
}

Value bool_v(bool b) {
  Value v;
  v.kind = Value::BOOL;
  v.b = b;
  return v;
}

uint8_t* dup_buffer(const std::string& s, int64_t* out_len) {
  auto* out = static_cast<uint8_t*>(malloc(s.size() ? s.size() : 1));
  if (!s.empty()) memcpy(out, s.data(), s.size());
  *out_len = static_cast<int64_t>(s.size());
  return out;
}

// 0 + *out (the result, a pickle) on ok; 1 + *out (error text) on an
// application error; -1 on a transport error.
int xlang_finish(Client* c, bool sent, const Value& reply, uint8_t** out,
                 int64_t* out_len) {
  if (!sent) return -1;
  const Value* outcome = reply.get("outcome");
  if (outcome != nullptr && outcome->s == "ok") {
    const Value* result = reply.get("result");
    std::string packed = enc_pickle(result != nullptr ? *result : Value());
    if (out != nullptr) *out = dup_buffer(packed, out_len);
    return 0;
  }
  const Value* err = reply.get("error");
  std::string e = err != nullptr ? err->s : "unknown xlang error";
  c->last_error = e;
  if (out != nullptr) *out = dup_buffer(e, out_len);
  return 1;
}

}  // namespace

extern "C" {

void* rtc_connect(const char* host, int port) {
  struct addrinfo hints;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  std::string port_s = std::to_string(port);
  if (getaddrinfo(host, port_s.c_str(), &hints, &res) != 0 || !res) {
    return nullptr;
  }
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    if (fd >= 0) close(fd);
    freeaddrinfo(res);
    return nullptr;
  }
  freeaddrinfo(res);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // bound every send and recv (the Python client defaults to 30 s): a
  // wedged peer returns an error instead of hanging the caller
  struct timeval tv;
  tv.tv_sec = 30;
  tv.tv_usec = 0;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  auto* c = new Client();
  c->fd = fd;
  return c;
}

void rtc_close(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (c == nullptr) return;
  if (c->fd >= 0) close(c->fd);
  delete c;
}

void rtc_free(void* p) { free(p); }

// -- head KV ------------------------------------------------------------------

int rtc_kv_put(void* handle, const uint8_t* key, int klen,
               const uint8_t* value, int vlen) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  f.kind = Value::MAP;
  f.map["key"] = bin_v(key, static_cast<size_t>(klen));
  f.map["value"] = bin_v(value, static_cast<size_t>(vlen));
  f.map["overwrite"] = bool_v(true);
  f.map["ns"] = bin_v(nullptr, 0);
  Value reply;
  return c->call("kv_put", std::move(f), &reply) ? 0 : -1;
}

// 0 + *out on a hit, 1 on a miss, -1 on a transport error.
int rtc_kv_get(void* handle, const uint8_t* key, int klen, uint8_t** out,
               int64_t* out_len) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  f.kind = Value::MAP;
  f.map["key"] = bin_v(key, static_cast<size_t>(klen));
  f.map["ns"] = bin_v(nullptr, 0);
  Value reply;
  if (!c->call("kv_get", std::move(f), &reply)) return -1;
  const Value* v = reply.get("value");
  if (v == nullptr || v->kind == Value::NIL) return 1;
  *out = dup_buffer(v->s, out_len);
  return 0;
}

// -- daemon object plane ------------------------------------------------------

int rtc_put_object(void* handle, const uint8_t* oid, int oid_len,
                   const uint8_t* blob, int64_t blob_len) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  f.kind = Value::MAP;
  f.map["oid"] = bin_v(oid, static_cast<size_t>(oid_len));
  f.map["blob"] = bin_v(blob, static_cast<size_t>(blob_len));
  Value reply;
  return c->call("put_object", std::move(f), &reply) ? 0 : -1;
}

// 0 + *out on a hit, 1 on a miss, -1 on a transport error.
int rtc_get_object(void* handle, const uint8_t* oid, int oid_len,
                   uint8_t** out, int64_t* out_len) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  f.kind = Value::MAP;
  f.map["oid"] = bin_v(oid, static_cast<size_t>(oid_len));
  f.map["prefer_shm"] = bool_v(false);
  Value reply;
  if (!c->call("get_object", std::move(f), &reply)) return -1;
  const Value* missing = reply.get("missing");
  if (missing != nullptr && missing->kind == Value::BOOL && missing->b) {
    return 1;
  }
  const Value* blob = reply.get("blob");
  if (blob == nullptr || blob->kind == Value::NIL) return 1;
  *out = dup_buffer(blob->s, out_len);
  return 0;
}

// -- cross-language tasks and actors (daemon) ---------------------------------

int rtc_submit_task(void* handle, const char* name, const uint8_t* args,
                    int args_len, uint8_t** out, int64_t* out_len) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  f.kind = Value::MAP;
  f.map["name"] = str_v(name);
  f.map["args"] = bin_v(args, static_cast<size_t>(args_len));
  Value reply;
  bool sent = c->call("xlang_submit", std::move(f), &reply);
  return xlang_finish(c, sent, reply, out, out_len);
}

int rtc_create_actor(void* handle, const char* cls, const char* name,
                     const uint8_t* args, int args_len) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  f.kind = Value::MAP;
  f.map["cls"] = str_v(cls);
  f.map["name"] = str_v(name);
  f.map["args"] = bin_v(args, static_cast<size_t>(args_len));
  Value reply;
  bool sent = c->call("xlang_create_actor", std::move(f), &reply);
  return xlang_finish(c, sent, reply, nullptr, nullptr);
}

int rtc_call_actor(void* handle, const char* name, const char* method,
                   const uint8_t* args, int args_len, uint8_t** out,
                   int64_t* out_len) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  f.kind = Value::MAP;
  f.map["name"] = str_v(name);
  f.map["method"] = str_v(method);
  f.map["args"] = bin_v(args, static_cast<size_t>(args_len));
  Value reply;
  bool sent = c->call("xlang_call_actor", std::move(f), &reply);
  return xlang_finish(c, sent, reply, out, out_len);
}

// -- daemon ping --------------------------------------------------------------

// The daemon's pid, or -1.
long rtc_ping(void* handle) {
  auto* c = static_cast<Client*>(handle);
  Value f;
  Value reply;
  if (!c->call("daemon_ping", std::move(f), &reply)) return -1;
  const Value* pid = reply.get("pid");
  return pid != nullptr ? static_cast<long>(pid->i) : -1;
}

const char* rtc_last_error(void* handle) {
  auto* c = static_cast<Client*>(handle);
  return c->last_error.c_str();
}

// -- the codec, for tests -----------------------------------------------------

// A fixed value tree through the writer: {"none": None, "t": True,
// "f": False, "small": -7, "big": 2**40 + 3, "neg": -(2**40), "pi": 3.25,
// "s": "héllo", "long": 300 x "w", "b": b"\x00\x01", "blob": n_blob bytes
// of 0x5a, "list": [1, [2, "x"], {}], "empty": []}.
int rtc_frame_encode_test(int64_t n_blob, uint8_t** out, int64_t* out_len) {
  Value root;
  root.kind = Value::MAP;
  root.map["none"] = Value();
  root.map["t"] = bool_v(true);
  root.map["f"] = bool_v(false);
  Value v;
  v.kind = Value::INT;
  v.i = -7;
  root.map["small"] = v;
  v.i = (int64_t(1) << 40) + 3;
  root.map["big"] = v;
  v.i = -(int64_t(1) << 40);
  root.map["neg"] = v;
  Value d;
  d.kind = Value::DBL;
  d.d = 3.25;
  root.map["pi"] = d;
  root.map["s"] = str_v("h\xc3\xa9llo");
  root.map["long"] = str_v(std::string(300, 'w'));
  const uint8_t two[2] = {0, 1};
  root.map["b"] = bin_v(two, 2);
  std::string blob(static_cast<size_t>(n_blob), 'Z');
  root.map["blob"] = bin_v(reinterpret_cast<const uint8_t*>(blob.data()),
                           blob.size());
  Value inner;
  inner.kind = Value::ARR;
  v.i = 2;
  inner.arr.push_back(v);
  inner.arr.push_back(str_v("x"));
  Value list;
  list.kind = Value::ARR;
  v.i = 1;
  list.arr.push_back(v);
  list.arr.push_back(inner);
  Value empty_map;
  empty_map.kind = Value::MAP;
  list.arr.push_back(empty_map);
  root.map["list"] = list;
  Value empty_list;
  empty_list.kind = Value::ARR;
  root.map["empty"] = empty_list;
  *out = dup_buffer(enc_pickle(root), out_len);
  return 0;
}

// Decode a pickle and encode it again with the writer: 0 + *out on
// success, 1 + *out (the decode error) on refusal.
int rtc_frame_roundtrip(const uint8_t* data, int64_t n, uint8_t** out,
                        int64_t* out_len) {
  Value v;
  std::string err;
  if (!dec_pickle(data, static_cast<size_t>(n), &v, &err)) {
    *out = dup_buffer(err, out_len);
    return 1;
  }
  *out = dup_buffer(enc_pickle(v), out_len);
  return 0;
}

}  // extern "C"
