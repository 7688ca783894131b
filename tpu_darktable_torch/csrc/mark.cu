// A device mark for the port's tracer (utils/timing.py): one thread reads the
// card's nanosecond clock (%globaltimer) and appends (time, mark id) to the
// device's ring of marks.
//
// The launch is the mark: enqueued eagerly it records when the stream
// reaches it; captured into a CUDA graph it becomes a node of the graph and
// records again on every replay.  The ring is a (capacity, 2) int64 array
// and `count` the number of marks ever written to it; a mark takes its slot
// with an atomicAdd on `count` and writes row slot % capacity, so the ring
// keeps the newest `capacity` marks and the host, knowing `count`, finds
// them in the order they took their slots.  No other kernel reads the ring.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void trace_mark_write(unsigned long long* count, long long* ring,
                                 unsigned long long capacity, long long id) {
  const unsigned long long t = globaltimer_ns();
  const unsigned long long slot = atomicAdd(count, 1ULL) % capacity;
  ring[2 * slot] = (long long)t;
  ring[2 * slot + 1] = id;
}

}  // namespace

extern "C" int trace_mark_launch(void* count, void* ring, unsigned long long capacity,
                                 long long id, void* stream) {
  trace_mark_write<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(count), static_cast<long long*>(ring), capacity, id);
  return (int)cudaGetLastError();
}
