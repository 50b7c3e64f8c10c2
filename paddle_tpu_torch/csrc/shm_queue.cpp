// Shared-memory blocking ring queue for multiprocess data loading.
//
// The paddle_tpu_torch copy of the JAX package's queue (the transport of
// the reference's data loader: paddle/fluid/framework/blocking_queue.h and
// the shared-memory path of python/paddle/fluid/dataloader/): worker
// processes push pickled numpy batches into one shm ring buffer, and the
// training process pops them without a pipe.  Process-shared pthread mutex
// and condition variables in the shm header give the blocking semantics.
// Plain C interface, loaded through ctypes by
// paddle_tpu_torch/core/native.py.
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>

namespace {

struct ShmHeader {
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
  uint64_t capacity;   // data bytes
  uint64_t head;       // read offset
  uint64_t tail;       // write offset
  uint64_t used;       // bytes in use
  uint32_t closed;
  uint32_t n_items;
};

struct Queue {
  ShmHeader* hdr;
  char* data;
  uint64_t capacity;
  std::string name;
  bool owner;
};

// each item: u64 length | payload (contiguous logical ring)
void ring_write(Queue* q, const char* src, uint64_t n) {
  uint64_t t = q->hdr->tail;
  uint64_t first = std::min(n, q->capacity - t);
  std::memcpy(q->data + t, src, first);
  if (n > first) std::memcpy(q->data, src + first, n - first);
  q->hdr->tail = (t + n) % q->capacity;
}

void ring_read(Queue* q, char* dst, uint64_t n) {
  uint64_t h = q->hdr->head;
  uint64_t first = std::min(n, q->capacity - h);
  std::memcpy(dst, q->data + h, first);
  if (n > first) std::memcpy(dst + first, q->data, n - first);
  q->hdr->head = (h + n) % q->capacity;
}

}  // namespace

extern "C" {

void* shm_queue_create(const char* name, long long capacity) {
  ::shm_unlink(name);
  int fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(ShmHeader) + static_cast<uint64_t>(capacity);
  if (::ftruncate(fd, static_cast<off_t>(total)) != 0) {
    ::close(fd);
    ::shm_unlink(name);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<ShmHeader*>(mem);
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_empty, &ca);
  pthread_cond_init(&hdr->not_full, &ca);
  hdr->capacity = static_cast<uint64_t>(capacity);
  hdr->head = hdr->tail = hdr->used = 0;
  hdr->closed = 0;
  hdr->n_items = 0;
  auto* q = new Queue{hdr, reinterpret_cast<char*>(mem) + sizeof(ShmHeader),
                      hdr->capacity, name, true};
  return q;
}

void* shm_queue_open(const char* name) {
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
  auto* hdr = static_cast<ShmHeader*>(mem);
  auto* q = new Queue{hdr, reinterpret_cast<char*>(mem) + sizeof(ShmHeader),
                      hdr->capacity, name, false};
  return q;
}

static int lock_robust(ShmHeader* hdr) {
  int rc = pthread_mutex_lock(&hdr->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&hdr->mu);
    rc = 0;
  }
  return rc;
}

// push: blocks until space; returns 0 ok, -1 closed/error
int shm_queue_push(void* queue, const char* buf, long long len) {
  auto* q = static_cast<Queue*>(queue);
  auto* hdr = q->hdr;
  uint64_t need = 8 + static_cast<uint64_t>(len);
  if (need > q->capacity) return -2;
  if (lock_robust(hdr) != 0) return -1;
  while (hdr->capacity - hdr->used < need && !hdr->closed)
    pthread_cond_wait(&hdr->not_full, &hdr->mu);
  if (hdr->closed) {
    pthread_mutex_unlock(&hdr->mu);
    return -1;
  }
  uint64_t n = static_cast<uint64_t>(len);
  ring_write(q, reinterpret_cast<const char*>(&n), 8);
  ring_write(q, buf, n);
  hdr->used += need;
  hdr->n_items += 1;
  pthread_cond_signal(&hdr->not_empty);
  pthread_mutex_unlock(&hdr->mu);
  return 0;
}

// pop: blocks; returns item length (caller buffer must be >= cap) or
// -1 closed+empty, -3 cap too small (item left in queue)
long long shm_queue_pop(void* queue, char* out, long long cap) {
  auto* q = static_cast<Queue*>(queue);
  auto* hdr = q->hdr;
  if (lock_robust(hdr) != 0) return -1;
  while (hdr->n_items == 0 && !hdr->closed)
    pthread_cond_wait(&hdr->not_empty, &hdr->mu);
  if (hdr->n_items == 0 && hdr->closed) {
    pthread_mutex_unlock(&hdr->mu);
    return -1;
  }
  uint64_t n;
  uint64_t save_head = hdr->head;
  ring_read(q, reinterpret_cast<char*>(&n), 8);
  if (static_cast<long long>(n) > cap) {
    hdr->head = save_head;  // put back
    pthread_mutex_unlock(&hdr->mu);
    return -3;
  }
  ring_read(q, out, n);
  hdr->used -= (8 + n);
  hdr->n_items -= 1;
  pthread_cond_signal(&hdr->not_full);
  pthread_mutex_unlock(&hdr->mu);
  return static_cast<long long>(n);
}

long long shm_queue_size(void* queue) {
  auto* q = static_cast<Queue*>(queue);
  lock_robust(q->hdr);
  long long n = q->hdr->n_items;
  pthread_mutex_unlock(&q->hdr->mu);
  return n;
}

void shm_queue_close(void* queue) {
  auto* q = static_cast<Queue*>(queue);
  lock_robust(q->hdr);
  q->hdr->closed = 1;
  pthread_cond_broadcast(&q->hdr->not_empty);
  pthread_cond_broadcast(&q->hdr->not_full);
  pthread_mutex_unlock(&q->hdr->mu);
}

// remove the segment's name; the segment lives on while a process maps
// it, and destroy no longer unlinks
void shm_queue_unlink(void* queue) {
  auto* q = static_cast<Queue*>(queue);
  if (q->owner) ::shm_unlink(q->name.c_str());
  q->owner = false;
}

void shm_queue_destroy(void* queue) {
  auto* q = static_cast<Queue*>(queue);
  uint64_t total = sizeof(ShmHeader) + q->capacity;
  bool owner = q->owner;
  std::string name = q->name;
  ::munmap(q->hdr, total);
  if (owner) ::shm_unlink(name.c_str());
  delete q;
}

}  // extern "C"
