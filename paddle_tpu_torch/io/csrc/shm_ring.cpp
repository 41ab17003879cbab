// Shared-memory ring buffer — the native transport for multi-process
// DataLoader workers (the port's copy of paddle_tpu/csrc/shm_ring.cpp,
// built with g++ at first use by paddle_tpu_torch/utils/native_build.py).
//
// Parity target: the reference moves worker-produced LoDTensors through
// shared memory instead of pickling them over pipes
// (python/paddle/fluid/dataloader/dataloader_iter.py:342
// `_DataLoaderIterMultiProcess` + core._array_to_share_memory_tensor; the
// C++ double-buffer side is operators/reader/buffered_reader.cc).  Here one
// POSIX shm segment holds a byte ring with a process-shared mutex/condvar
// pair; workers write length-prefixed batches, the parent reads them without
// any serialization layer in between.  Exposed as a C ABI for ctypes.
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <string>

namespace {

struct Header {
  pthread_mutex_t mu;
  pthread_cond_t can_read;
  pthread_cond_t can_write;
  uint64_t capacity;   // ring payload capacity in bytes
  uint64_t head;       // read offset
  uint64_t tail;       // write offset
  uint64_t used;       // bytes in ring
  uint32_t closed;
};

struct Handle {
  Header* h;
  uint8_t* data;
  uint64_t capacity;
  std::string name;
  bool owner;
};

void ring_copy_in(Handle* hd, const uint8_t* src, uint64_t n) {
  Header* h = hd->h;
  uint64_t tail = h->tail;
  uint64_t first = std::min(n, h->capacity - tail);
  memcpy(hd->data + tail, src, first);
  if (n > first) memcpy(hd->data, src + first, n - first);
  h->tail = (tail + n) % h->capacity;
  h->used += n;
}

void ring_copy_out(Handle* hd, uint8_t* dst, uint64_t n) {
  Header* h = hd->h;
  uint64_t head = h->head;
  uint64_t first = std::min(n, h->capacity - head);
  memcpy(dst, hd->data + head, first);
  if (n > first) memcpy(dst + first, hd->data, n - first);
  h->head = (head + n) % h->capacity;
  h->used -= n;
}

struct timespec deadline_from_ms(int timeout_ms) {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return ts;
}

// absolute deadline so repeated wakeups can't extend the timeout
int wait_until(pthread_cond_t* cv, pthread_mutex_t* mu, int timeout_ms,
               const struct timespec* deadline) {
  if (timeout_ms < 0) return pthread_cond_wait(cv, mu);
  return pthread_cond_timedwait(cv, mu, deadline);
}

// closed states: 0 = open, 1 = graceful close (readers may drain),
// 2 = poisoned (byte-state untrustworthy — nobody drains)
constexpr uint32_t kClosed = 1, kPoisoned = 2;

// a peer died holding the lock: the ring byte-state (length prefixes,
// head/tail/used) can no longer be trusted
void poison(Header* h) {
  pthread_mutex_consistent(&h->mu);
  h->closed = kPoisoned;
  pthread_cond_broadcast(&h->can_read);
  pthread_cond_broadcast(&h->can_write);
}

}  // namespace

extern "C" {

// linger=0: the name is unlinked immediately after mmap, so the segment
// lives exactly as long as the mappings (fork-inherited) and can never leak
// into /dev/shm after a crash.  linger=1 keeps the name for shmring_open
// peers; the creator must call shmring_free.
void* shmring_create(const char* name, uint64_t capacity, int linger) {
  size_t total = sizeof(Header) + capacity;
  ::shm_unlink(name);  // stale segment from a crashed run
  int fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, static_cast<off_t>(total)) != 0) {
    ::close(fd);
    ::shm_unlink(name);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                     0);
  ::close(fd);
  if (mem == MAP_FAILED) {
    ::shm_unlink(name);
    return nullptr;
  }
  if (!linger) ::shm_unlink(name);
  auto* h = static_cast<Header*>(mem);
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->can_read, &ca);
  pthread_cond_init(&h->can_write, &ca);
  h->capacity = capacity;
  h->head = h->tail = h->used = 0;
  h->closed = 0;
  auto* hd = new Handle{h, reinterpret_cast<uint8_t*>(h + 1), capacity, name,
                        linger != 0};
  return hd;
}

void* shmring_open(const char* name) {
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
  auto* h = static_cast<Header*>(mem);
  auto* hd = new Handle{h, reinterpret_cast<uint8_t*>(h + 1), h->capacity,
                        name, false};
  return hd;
}

// returns 0 when the lock is held and the ring is trustworthy; -1 after a
// peer died holding it (ring is poisoned, caller must bail but the mutex IS
// held when -1 from EOWNERDEAD... so callers unlock)
static int lock_robust(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    poison(h);
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  return rc == 0 ? 0 : -1;
}

// write one message (length-prefixed); blocks while the ring is full.
// returns 0 ok, -1 closed/error, -2 timeout, -3 message larger than ring
int shmring_write(void* vh, const void* buf, uint64_t n, int timeout_ms) {
  auto* hd = static_cast<Handle*>(vh);
  Header* h = hd->h;
  uint64_t need = n + 8;
  if (need > h->capacity) return -3;
  if (lock_robust(h) != 0) return -1;
  struct timespec dl = deadline_from_ms(timeout_ms < 0 ? 0 : timeout_ms);
  while (!h->closed && h->capacity - h->used < need) {
    int rc = wait_until(&h->can_write, &h->mu, timeout_ms, &dl);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    if (rc == EOWNERDEAD) {
      poison(h);
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  uint64_t len = n;
  ring_copy_in(hd, reinterpret_cast<uint8_t*>(&len), 8);
  ring_copy_in(hd, static_cast<const uint8_t*>(buf), n);
  pthread_cond_signal(&h->can_read);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// read one message into buf (cap bytes). returns message length, -1 closed,
// -2 timeout, -3 under-capacity (message length returned via *need_out,
// message stays queued)
long long shmring_read(void* vh, void* buf, uint64_t cap, int timeout_ms,
                       uint64_t* need_out) {
  auto* hd = static_cast<Handle*>(vh);
  Header* h = hd->h;
  if (lock_robust(h) != 0) return -1;
  struct timespec dl = deadline_from_ms(timeout_ms < 0 ? 0 : timeout_ms);
  while (!h->closed && h->used < 8) {
    int rc = wait_until(&h->can_read, &h->mu, timeout_ms, &dl);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    if (rc == EOWNERDEAD) {
      poison(h);
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->closed == kPoisoned || h->used < 8) {
    // poisoned bytes must never be drained; graceful close drains
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  // peek the length without consuming
  uint64_t len = 0;
  uint64_t head = h->head;
  uint64_t first = std::min<uint64_t>(8, h->capacity - head);
  memcpy(&len, hd->data + head, first);
  if (first < 8)
    memcpy(reinterpret_cast<uint8_t*>(&len) + first, hd->data, 8 - first);
  if (len > cap) {
    if (need_out) *need_out = len;
    pthread_mutex_unlock(&h->mu);
    return -3;
  }
  // consume header + payload
  h->head = (head + 8) % h->capacity;
  h->used -= 8;
  ring_copy_out(hd, static_cast<uint8_t*>(buf), len);
  pthread_cond_signal(&h->can_write);
  pthread_mutex_unlock(&h->mu);
  return static_cast<long long>(len);
}

void shmring_close(void* vh) {
  auto* hd = static_cast<Handle*>(vh);
  Header* h = hd->h;
  if (lock_robust(h) == 0) {
    if (h->closed == 0) h->closed = kClosed;  // never mask a poisoned state
    pthread_cond_broadcast(&h->can_read);
    pthread_cond_broadcast(&h->can_write);
    pthread_mutex_unlock(&h->mu);
  }
}

void shmring_free(void* vh) {
  auto* hd = static_cast<Handle*>(vh);
  size_t total = sizeof(Header) + hd->capacity;
  bool owner = hd->owner;
  std::string name = hd->name;
  ::munmap(hd->h, total);
  if (owner) ::shm_unlink(name.c_str());
  delete hd;
}

}  // extern "C"
