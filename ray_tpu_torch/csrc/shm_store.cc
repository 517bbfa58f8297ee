// Shared-memory object store: the native host-buffer tier (the port's copy
// of ray_tpu's native/shm_store.cc; built by ray_tpu_torch/_build.py).
//
// Reference capability (NOT a port): plasma, src/ray/object_manager/plasma/
//   - store.h / object_store.h  : object table, create/seal/get/release
//   - plasma_allocator.cc       : allocator over shared memory (dlmalloc
//                                 there; first-fit coalescing free list here)
//   - eviction_policy.h         : LRU eviction of sealed, unreferenced
//   - create_request_queue.h    : create backpressure (here: create fails
//                                 with RTPU_ERR_FULL after eviction fails;
//                                 the Python layer queues/spills)
//   - client.cc / fling.cc      : cross-process clients; here the segment
//                                 is attached BY NAME (rtpu_store_attach)
//                                 and per-object refcounts live in a slot
//                                 table INSIDE the segment, so any attached
//                                 process can pin a buffer against eviction
//                                 without a store round trip.
//
// Segment layout:
//
//   [ ArenaHeader: magic | nslots | ExtSlot[NSLOTS] ]  (page aligned)
//   [ object data region: first-fit allocations ]
//
// Each object entry owns one ExtSlot for the lifetime of the entry. The
// slot's `refs` field is a PROCESS-SHARED refcount mutated with atomic
// builtins from any process that mapped the segment; `gen` bumps when
// the slot is recycled so a stale (slot, gen) pair is detectable. The
// store owner (the daemon) only frees/evicts a buffer when BOTH its
// in-process refcount and the slot's external refcount are zero — LRU
// eviction can never unmap bytes a worker still views.
//
// Objects are immutable after seal. Clients map the same shm segment and
// read payloads zero-copy (numpy frombuffer on the offset). A pthread
// mutex guards the owner's metadata; attached handles touch only the
// slot table (atomics) and raw ranges.
//
// Backing (this copy's one departure from the reference): the segment is
// ftruncate'd to its capacity, sparse, and a store on a mount smaller than
// that capacity (a container's /dev/shm) would take SIGBUS on the first
// write past what tmpfs can back. So the header at open and each object's
// range at create are fallocate'd first: where the mount is out of room,
// open fails and create returns RTPU_ERR_FULL (the caller's Python tier
// takes the object), never a fault.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <map>
#include <string>
#include <vector>

namespace {

constexpr int RTPU_OK = 0;
constexpr int RTPU_ERR_FULL = -1;
constexpr int RTPU_ERR_NOT_FOUND = -2;
constexpr int RTPU_ERR_EXISTS = -3;
constexpr int RTPU_ERR_NOT_SEALED = -4;
constexpr int RTPU_ERR_BAD = -5;

constexpr uint64_t RTPU_MAGIC = 0x314d485355505452ULL;  // "RTPUSHM1"
constexpr uint32_t RTPU_NSLOTS = 4096;
constexpr uint32_t RTPU_NO_SLOT = UINT32_MAX;

struct ExtSlot {
  uint32_t refs;  // process-shared refcount (atomic builtins only)
  uint32_t gen;   // bumped on slot recycle (forensics; the grant
                  // protocol never hands out a slot across a recycle:
                  // the owner only recycles at refs==0 under its
                  // mutex, and grants ref-before-reply)
};

struct ArenaHeader {
  uint64_t magic;
  uint32_t nslots;
  uint32_t reserved;
  ExtSlot slots[RTPU_NSLOTS];
};

// data region starts page-aligned past the header
constexpr uint64_t RTPU_DATA_OFF =
    ((sizeof(ArenaHeader) + 4095) / 4096) * 4096;

struct FreeBlock {
  uint64_t offset;
  uint64_t size;
};

struct ObjectEntry {
  uint64_t offset = 0;
  uint64_t size = 0;
  bool sealed = false;
  bool deleted = false;  // delete requested while refs outstanding
  bool pinned = false;   // creator ref retained; delete() consumes it
  int64_t refcount = 0;
  uint32_t slot = RTPU_NO_SLOT;  // ext-refcount slot in the header
  uint64_t lru_tick = 0;  // last release time; eviction order
};

struct Store {
  void* base = nullptr;
  uint64_t capacity = 0;
  uint64_t used = 0;
  uint64_t tick = 0;
  int shm_fd = -1;
  bool attached = false;  // attach-only handle: no metadata, no unlink
  std::string shm_name;
  pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
  std::map<std::string, ObjectEntry> objects;
  std::vector<FreeBlock> free_list;  // sorted by offset, coalesced
  std::vector<uint8_t> slot_used;    // owner-side slot allocation map
  uint32_t next_slot = 0;

  ArenaHeader* hdr() const { return reinterpret_cast<ArenaHeader*>(base); }

  uint32_t ext_refs(uint32_t slot) const {
    if (slot >= RTPU_NSLOTS) return 0;
    return __atomic_load_n(&hdr()->slots[slot].refs, __ATOMIC_ACQUIRE);
  }

  uint32_t alloc_slot() {
    for (uint32_t i = 0; i < RTPU_NSLOTS; ++i) {
      uint32_t cand = (next_slot + i) % RTPU_NSLOTS;
      if (!slot_used[cand]) {
        slot_used[cand] = 1;
        next_slot = (cand + 1) % RTPU_NSLOTS;
        return cand;
      }
    }
    return RTPU_NO_SLOT;  // table full: entry gets no ext slot
  }

  void free_slot(uint32_t slot) {
    if (slot >= RTPU_NSLOTS) return;
    // recycle: bump gen (a forensic marker for debugging recycled
    // slots), then clear usage. refs is 0 by the caller's contract.
    __atomic_add_fetch(&hdr()->slots[slot].gen, 1, __ATOMIC_RELEASE);
    slot_used[slot] = 0;
  }

  uint64_t allocate(uint64_t size) {
    // first fit
    for (size_t i = 0; i < free_list.size(); ++i) {
      if (free_list[i].size >= size) {
        uint64_t off = free_list[i].offset;
        free_list[i].offset += size;
        free_list[i].size -= size;
        if (free_list[i].size == 0) free_list.erase(free_list.begin() + i);
        used += size;
        return off;
      }
    }
    return UINT64_MAX;
  }

  void deallocate(uint64_t offset, uint64_t size) {
    used -= size;
    // insert sorted, coalesce neighbours
    size_t i = 0;
    while (i < free_list.size() && free_list[i].offset < offset) ++i;
    free_list.insert(free_list.begin() + i, FreeBlock{offset, size});
    // coalesce right
    if (i + 1 < free_list.size() &&
        free_list[i].offset + free_list[i].size == free_list[i + 1].offset) {
      free_list[i].size += free_list[i + 1].size;
      free_list.erase(free_list.begin() + i + 1);
    }
    // coalesce left
    if (i > 0 &&
        free_list[i - 1].offset + free_list[i - 1].size ==
            free_list[i].offset) {
      free_list[i - 1].size += free_list[i].size;
      free_list.erase(free_list.begin() + i);
    }
  }

  void free_entry(std::map<std::string, ObjectEntry>::iterator it) {
    deallocate(it->second.offset, it->second.size);
    free_slot(it->second.slot);
    objects.erase(it);
  }

  // Reap deleted entries whose last reference (in-process AND external)
  // is gone: external releases are silent atomic decrements from other
  // processes, so deferred deletes need this sweep to complete.
  uint64_t reap() {
    uint64_t freed = 0;
    for (auto it = objects.begin(); it != objects.end();) {
      auto cur = it++;
      if (cur->second.deleted && cur->second.refcount == 0 &&
          ext_refs(cur->second.slot) == 0) {
        freed += cur->second.size;
        free_entry(cur);
      }
    }
    return freed;
  }

  // Evict sealed refcount-0 ext-0 objects (oldest release first) until
  // `needed` bytes could be contiguously available or nothing evictable.
  uint64_t evict(uint64_t needed) {
    uint64_t freed = reap();  // deferred deletes first: already dead
    while (true) {
      if (allocatable(needed)) return freed;
      const std::string* victim = nullptr;
      uint64_t best_tick = UINT64_MAX;
      for (auto& kv : objects) {
        if (kv.second.sealed && kv.second.refcount == 0 &&
            !kv.second.deleted && ext_refs(kv.second.slot) == 0 &&
            kv.second.lru_tick < best_tick) {
          best_tick = kv.second.lru_tick;
          victim = &kv.first;
        }
      }
      if (victim == nullptr) return freed;
      auto it = objects.find(*victim);
      freed += it->second.size;
      free_entry(it);
    }
  }

  bool allocatable(uint64_t size) const {
    for (const auto& b : free_list)
      if (b.size >= size) return true;
    return false;
  }
};

// Reserve the mount's pages under [offset, offset + size) of the segment.
// false only where the mount is out of room; a filesystem without
// fallocate keeps the reference's sparse behaviour.
bool back_range(int fd, uint64_t offset, uint64_t size) {
  int rc;
  do {
    rc = fallocate(fd, 0, (off_t)offset, (off_t)size);
  } while (rc != 0 && errno == EINTR);
  return rc == 0 || errno == EOPNOTSUPP || errno == ENOSYS;
}

}  // namespace

extern "C" {

// Create (or re-initialize) the segment as its OWNER: the header is
// reset and allocations start fresh. `capacity` is the DATA capacity —
// the segment is sized capacity + header so callers keep their byte
// accounting. Attach to a live store with rtpu_store_attach instead —
// opening an existing arena here would wipe its slot table under the
// owner.
Store* rtpu_store_open(const char* name, uint64_t capacity) {
  if (capacity == 0) return nullptr;
  uint64_t segment = capacity + RTPU_DATA_OFF;
  std::string shm_name = std::string("/") + name;
  int fd = shm_open(shm_name.c_str(), O_CREAT | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)segment) != 0) {
    close(fd);
    shm_unlink(shm_name.c_str());
    return nullptr;
  }
  void* base =
      mmap(nullptr, segment, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(shm_name.c_str());
    return nullptr;
  }
  if (!back_range(fd, 0, RTPU_DATA_OFF)) {  // the header is written below
    munmap(base, segment);
    close(fd);
    shm_unlink(shm_name.c_str());
    return nullptr;
  }
  Store* s = new Store();
  s->base = base;
  s->capacity = segment;
  s->shm_fd = fd;
  s->shm_name = shm_name;
  s->slot_used.assign(RTPU_NSLOTS, 0);
  s->free_list.push_back(FreeBlock{RTPU_DATA_OFF, capacity});
  // header init: zero the slot table, publish the magic LAST (release)
  // so an attacher that sees the magic sees an initialized table
  ArenaHeader* h = s->hdr();
  std::memset(h, 0, sizeof(ArenaHeader));
  h->nslots = RTPU_NSLOTS;
  __atomic_store_n(&h->magic, RTPU_MAGIC, __ATOMIC_RELEASE);
  return s;
}

// Attach an EXISTING segment by name (the fd-passing role of plasma's
// fling.cc, done via shm_open-by-name): maps read-write (direct puts
// write payload bytes), touches only raw ranges + the slot table.
// Returns nullptr when the segment is absent or not an arena.
Store* rtpu_store_attach(const char* name) {
  std::string shm_name = std::string("/") + name;
  int fd = shm_open(shm_name.c_str(), O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size <= RTPU_DATA_OFF) {
    close(fd);
    return nullptr;
  }
  uint64_t capacity = (uint64_t)st.st_size;
  void* base =
      mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->base = base;
  s->capacity = capacity;
  s->shm_fd = fd;
  s->attached = true;
  s->shm_name = shm_name;
  if (__atomic_load_n(&s->hdr()->magic, __ATOMIC_ACQUIRE) != RTPU_MAGIC) {
    munmap(base, capacity);
    close(fd);
    delete s;
    return nullptr;
  }
  return s;
}

int rtpu_store_is_attached(Store* s) { return s->attached ? 1 : 0; }

void rtpu_store_close(Store* s, int unlink) {
  if (s == nullptr) return;
  munmap(s->base, s->capacity);
  close(s->shm_fd);
  if (unlink && !s->attached) shm_unlink(s->shm_name.c_str());
  delete s;
}

// Unlink the segment name WITHOUT unmapping: used at shutdown while
// zero-copy views into the arena are still alive in user code. The
// mapping (and Store) are deliberately leaked until process exit so
// those views stay valid; the name is removed so /dev/shm doesn't leak.
void rtpu_store_unlink(Store* s) {
  if (s == nullptr || s->attached) return;
  shm_unlink(s->shm_name.c_str());
}

void* rtpu_store_base(Store* s) { return s->base; }
uint64_t rtpu_store_capacity(Store* s) { return s->capacity; }
uint64_t rtpu_store_data_off(void) { return RTPU_DATA_OFF; }

uint64_t rtpu_store_used(Store* s) {
  pthread_mutex_lock(&s->mu);
  uint64_t u = s->used;
  pthread_mutex_unlock(&s->mu);
  return u;
}

uint64_t rtpu_store_num_objects(Store* s) {
  pthread_mutex_lock(&s->mu);
  uint64_t n = s->objects.size();
  pthread_mutex_unlock(&s->mu);
  return n;
}

// Reserve an unsealed buffer. Returns RTPU_OK and sets *offset, or error.
int rtpu_create(Store* s, const char* id, uint64_t size, uint64_t* offset) {
  pthread_mutex_lock(&s->mu);
  if (s->objects.count(id)) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_EXISTS;
  }
  if (size == 0 || size > s->capacity - RTPU_DATA_OFF) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_BAD;
  }
  uint64_t off = s->allocate(size);
  if (off == UINT64_MAX) {
    s->evict(size);
    off = s->allocate(size);
  }
  if (off == UINT64_MAX) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_FULL;  // create backpressure: caller queues or spills
  }
  if (!back_range(s->shm_fd, off, size)) {
    s->deallocate(off, size);
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_FULL;  // the mount cannot back it: the Python tier takes it
  }
  ObjectEntry e;
  e.offset = off;
  e.size = size;
  e.sealed = false;
  e.refcount = 1;  // creator holds a ref until seal+release
  e.slot = s->alloc_slot();
  s->objects[id] = e;
  *offset = off;
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

int rtpu_seal(Store* s, const char* id) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  if (it == s->objects.end()) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_FOUND;
  }
  it->second.sealed = true;
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

// Entry metadata regardless of seal state (idempotent reserve support:
// a retried create finds the EXISTS entry and re-reads its offset).
int rtpu_stat(Store* s, const char* id, uint64_t* offset, uint64_t* size,
              int* sealed) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  if (it == s->objects.end() || it->second.deleted) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_FOUND;
  }
  *offset = it->second.offset;
  *size = it->second.size;
  *sealed = it->second.sealed ? 1 : 0;
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

// Mark the object pinned: the creator keeps its create-time ref (does not
// release after seal) and rtpu_delete consumes it. Pinned objects are
// immune to LRU eviction (their refcount stays >= 1).
int rtpu_pin(Store* s, const char* id) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  if (it == s->objects.end()) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_FOUND;
  }
  it->second.pinned = true;
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

// Get a sealed object: increfs (in-process) and returns offset+size.
int rtpu_get(Store* s, const char* id, uint64_t* offset, uint64_t* size) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  if (it == s->objects.end() || it->second.deleted) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_FOUND;
  }
  if (!it->second.sealed) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_SEALED;
  }
  it->second.refcount++;
  *offset = it->second.offset;
  *size = it->second.size;
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

// Get a sealed object for an EXTERNAL (attached-process) reader: the
// owner increments the object's process-shared slot refcount on the
// client's behalf and hands back (offset, size, slot). The client reads
// the range through its own mapping and releases with
// rtpu_ext_release(slot) — no store round trip on release, and eviction
// is blocked until the slot count drops to zero.
int rtpu_ext_get(Store* s, const char* id, uint64_t* offset,
                 uint64_t* size, uint32_t* slot) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  if (it == s->objects.end() || it->second.deleted) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_FOUND;
  }
  if (!it->second.sealed) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_SEALED;
  }
  if (it->second.slot == RTPU_NO_SLOT) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_BAD;  // slot table exhausted: caller takes blob path
  }
  __atomic_add_fetch(&s->hdr()->slots[it->second.slot].refs, 1,
                     __ATOMIC_ACQ_REL);
  *offset = it->second.offset;
  *size = it->second.size;
  *slot = it->second.slot;
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

// Release an external slot ref; valid from ANY handle (owner or
// attached) mapping the segment. CAS loop floors at zero so a buggy
// double-release cannot wrap the count and pin the slot forever.
void rtpu_ext_release(Store* s, uint32_t slot) {
  if (slot >= RTPU_NSLOTS) return;
  uint32_t* p = &s->hdr()->slots[slot].refs;
  uint32_t cur = __atomic_load_n(p, __ATOMIC_ACQUIRE);
  while (cur > 0) {
    if (__atomic_compare_exchange_n(p, &cur, cur - 1, false,
                                    __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE))
      return;
  }
}

// Bulk slot decrement for crash reclamation: drop up to n refs in one
// CAS (same floor-at-zero discipline as rtpu_ext_release) and return
// how many were actually dropped, so the caller's grant ledger can
// account for refs the dead client had already released locally.
uint32_t rtpu_ext_release_n(Store* s, uint32_t slot, uint32_t n) {
  if (slot >= RTPU_NSLOTS || n == 0) return 0;
  uint32_t* p = &s->hdr()->slots[slot].refs;
  uint32_t cur = __atomic_load_n(p, __ATOMIC_ACQUIRE);
  while (cur > 0) {
    uint32_t drop = cur < n ? cur : n;
    if (__atomic_compare_exchange_n(p, &cur, cur - drop, false,
                                    __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE))
      return drop;
  }
  return 0;
}

uint32_t rtpu_ext_refs(Store* s, uint32_t slot) {
  if (slot >= RTPU_NSLOTS) return 0;
  return __atomic_load_n(&s->hdr()->slots[slot].refs, __ATOMIC_ACQUIRE);
}

int rtpu_release(Store* s, const char* id) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  if (it == s->objects.end()) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_FOUND;
  }
  if (it->second.refcount > 0) it->second.refcount--;
  it->second.lru_tick = ++s->tick;
  if (it->second.deleted && it->second.refcount == 0 &&
      s->ext_refs(it->second.slot) == 0) {
    // Deferred delete: last outstanding reader is gone, free now.
    // (An external ref still held leaves it for reap()/evict().)
    s->free_entry(it);
  }
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

int rtpu_contains(Store* s, const char* id) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  int out = (it != s->objects.end() && it->second.sealed &&
             !it->second.deleted) ? 1 : 0;
  pthread_mutex_unlock(&s->mu);
  return out;
}

// Delete: the owner decided the object is dead. If readers still hold
// refs (in-process or external) the buffer is only MARKED deleted and
// the deallocation happens at the last release / next reap (plasma
// semantics: clients' zero-copy buffers stay valid for their lifetime;
// the object just becomes unreachable for new gets).
int rtpu_delete(Store* s, const char* id) {
  pthread_mutex_lock(&s->mu);
  auto it = s->objects.find(id);
  if (it == s->objects.end()) {
    pthread_mutex_unlock(&s->mu);
    return RTPU_ERR_NOT_FOUND;
  }
  if (it->second.pinned) {
    // Consume the creator's retained ref — otherwise pinned objects
    // (the normal host-store path) would leak as permanent zombies.
    it->second.pinned = false;
    if (it->second.refcount > 0) it->second.refcount--;
  }
  if (it->second.refcount > 0 || s->ext_refs(it->second.slot) > 0) {
    it->second.deleted = true;
  } else {
    s->free_entry(it);
  }
  pthread_mutex_unlock(&s->mu);
  return RTPU_OK;
}

uint64_t rtpu_evict_bytes(Store* s, uint64_t needed) {
  pthread_mutex_lock(&s->mu);
  uint64_t freed = s->evict(needed);
  pthread_mutex_unlock(&s->mu);
  return freed;
}

uint64_t rtpu_reap(Store* s) {
  pthread_mutex_lock(&s->mu);
  uint64_t freed = s->reap();
  pthread_mutex_unlock(&s->mu);
  return freed;
}

}  // extern "C"
