// Process-shared bounded ring-buffer queue over POSIX shared memory (a
// copy of the JAX package's csrc/shm_queue.cpp, so the port builds without
// it).
//
// The transport between the DataLoader's worker processes and the trainer
// (io/dataloader.py): batches travel as pickled bytes, one a slot, and the
// callers release the GIL around push and pop (ctypes, io/shm_queue.py);
// utils/cpp_extension.py builds it with g++ (no CUDA, so the CPU tests
// have it too).
//
// Layout of the shm segment:
//   [Header][slot 0][slot 1]...[slot capacity-1]
//   slot = uint64 len + slot_size payload bytes
//
// Synchronisation: one PTHREAD_PROCESS_SHARED robust mutex + two condvars
// in the header.  Robustness: if a worker dies holding the lock,
// EOWNERDEAD is recovered with pthread_mutex_consistent.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
  uint64_t capacity;
  uint64_t slot_size;   // payload bytes per slot (excl. the length word)
  uint64_t head;        // next pop position
  uint64_t tail;        // next push position
  uint64_t count;
  int32_t closed;
  int32_t magic;
};

constexpr int32_t kMagic = 0x51d0c0de;

struct Queue {
  Header* h;
  uint8_t* slots;
  size_t map_len;
  char name[256];
};

inline uint8_t* slot_ptr(Queue* q, uint64_t idx) {
  return q->slots + idx * (sizeof(uint64_t) + q->h->slot_size);
}

int lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    // previous owner died: state is a ring buffer of plain words — always
    // structurally consistent, so recover and continue
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

void deadline_after(double timeout_s, timespec* ts) {
  clock_gettime(CLOCK_REALTIME, ts);
  time_t sec = static_cast<time_t>(timeout_s);
  long nsec = static_cast<long>((timeout_s - sec) * 1e9);
  ts->tv_sec += sec;
  ts->tv_nsec += nsec;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

size_t total_len(uint64_t capacity, uint64_t slot_size) {
  return sizeof(Header) + capacity * (sizeof(uint64_t) + slot_size);
}

}  // namespace

extern "C" {

// Create (and initialise) a named queue. Returns nullptr on failure.
void* ptq_create(const char* name, uint64_t capacity, uint64_t slot_size) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = total_len(capacity, slot_size);
  if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Header* h = static_cast<Header*>(mem);
  std::memset(h, 0, sizeof(Header));
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->not_empty, &ca);
  pthread_cond_init(&h->not_full, &ca);
  h->capacity = capacity;
  h->slot_size = slot_size;
  h->magic = kMagic;

  Queue* q = new Queue();
  q->h = h;
  q->slots = static_cast<uint8_t*>(mem) + sizeof(Header);
  q->map_len = len;
  std::strncpy(q->name, name, sizeof(q->name) - 1);
  return q;
}

// Open an existing queue created by ptq_create in another process.
void* ptq_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(mem);
  if (h->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Queue* q = new Queue();
  q->h = h;
  q->slots = static_cast<uint8_t*>(mem) + sizeof(Header);
  q->map_len = static_cast<size_t>(st.st_size);
  std::strncpy(q->name, name, sizeof(q->name) - 1);
  return q;
}

uint64_t ptq_slot_size(void* qp) {
  return static_cast<Queue*>(qp)->h->slot_size;
}

uint64_t ptq_size(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  lock(q->h);
  uint64_t n = q->h->count;
  pthread_mutex_unlock(&q->h->mu);
  return n;
}

// 0 ok; -1 timeout; -2 closed; -3 payload larger than slot_size
int ptq_push(void* qp, const void* buf, uint64_t len, double timeout_s) {
  Queue* q = static_cast<Queue*>(qp);
  Header* h = q->h;
  if (len > h->slot_size) return -3;
  timespec ts;
  if (timeout_s > 0) deadline_after(timeout_s, &ts);
  lock(h);
  while (h->count == h->capacity && !h->closed) {
    int rc = timeout_s > 0
                 ? pthread_cond_timedwait(&h->not_full, &h->mu, &ts)
                 : pthread_cond_wait(&h->not_full, &h->mu);
    if (rc == EOWNERDEAD) {
      // waiter reacquired the mutex after its owner died — same recovery
      // as lock(): the ring state is always structurally consistent
      pthread_mutex_consistent(&h->mu);
    } else if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  uint8_t* slot = slot_ptr(q, h->tail);
  std::memcpy(slot, &len, sizeof(uint64_t));
  std::memcpy(slot + sizeof(uint64_t), buf, len);
  h->tail = (h->tail + 1) % h->capacity;
  h->count++;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// >=0: payload length; -1 timeout; -2 closed and drained; -4 buffer small
int64_t ptq_pop(void* qp, void* buf, uint64_t buflen, double timeout_s) {
  Queue* q = static_cast<Queue*>(qp);
  Header* h = q->h;
  timespec ts;
  if (timeout_s > 0) deadline_after(timeout_s, &ts);
  lock(h);
  while (h->count == 0 && !h->closed) {
    int rc = timeout_s > 0
                 ? pthread_cond_timedwait(&h->not_empty, &h->mu, &ts)
                 : pthread_cond_wait(&h->not_empty, &h->mu);
    if (rc == EOWNERDEAD) {
      pthread_mutex_consistent(&h->mu);
    } else if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->count == 0 && h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  uint8_t* slot = slot_ptr(q, h->head);
  uint64_t len;
  std::memcpy(&len, slot, sizeof(uint64_t));
  if (len > buflen) {
    pthread_mutex_unlock(&h->mu);
    return -4;
  }
  std::memcpy(buf, slot + sizeof(uint64_t), len);
  h->head = (h->head + 1) % h->capacity;
  h->count--;
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(len);
}

// Mark closed and wake every waiter (push returns -2, pop drains then -2).
void ptq_close(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  lock(q->h);
  q->h->closed = 1;
  pthread_cond_broadcast(&q->h->not_empty);
  pthread_cond_broadcast(&q->h->not_full);
  pthread_mutex_unlock(&q->h->mu);
}

void ptq_release(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  munmap(q->h, q->map_len);
  delete q;
}

void ptq_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
