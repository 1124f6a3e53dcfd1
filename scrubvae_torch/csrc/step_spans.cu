// Span stamps of the train step, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's step is one XLA program whose
// layers a trace names by their ops, while a CUDA graph replay of the
// port's step shows the profiler kernels with no layer attached. A stamp
// is recorded where the step passes from one layer to the next
// (utils/profiling.py names the slots); captured in the step's graph it
// becomes a node, so every replay stamps with no host work.
//
// One stamp, one thread: read the GPU's %globaltimer (nanoseconds), add the
// time since the previous stamp to its slot's total and count it, then
// record its own time. The buffer is int64, 2 * n_slots + 1 words: the
// slots' totals, their counts, the time of the last stamp. A last time of
// 0 (the epoch's start, written by the host) charges nothing. The step's
// kernels run in order on one stream, so a stamp starts when everything
// before it has ended, and the intervals split the step.
//
// What bounds it: the launch itself, about as long as any kernel's least
// time on the card; it moves 32 bytes. The design keeps it one thread of
// one block, no atomics (stamps on one stream never overlap) and nothing
// the host waits for.
//
// A nested span (a kind of block inside the slots, such as the
// transformer's attention) is a second kernel of the same form over a
// buffer of its own, int64, 3 * n_spans words: each span's total, its
// count, the time it was last opened. Opening records the time; closing
// adds the time since the opening to the span's total and counts it. It
// leaves the slots' last time alone, so the slots still split the step.

#include <cuda_runtime.h>

__global__ void span_stamp_kernel(long long* buf, int n_slots, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* last = buf + 2 * n_slots;
  long long prev = *last;
  if (prev != 0) {
    buf[slot] += (long long)now - prev;
    buf[n_slots + slot] += 1;
  }
  *last = (long long)now;
}

extern "C" int span_stamp_launch(void* buf, int n_slots, int slot, void* stream) {
  span_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)buf, n_slots, slot);
  return (int)cudaGetLastError();
}

__global__ void nested_span_kernel(long long* buf, int n_spans, int span, int close) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* opened = buf + 2 * n_spans + span;
  if (close) {
    buf[span] += (long long)now - *opened;
    buf[n_spans + span] += 1;
  } else {
    *opened = (long long)now;
  }
}

extern "C" int nested_span_launch(void* buf, int n_spans, int span, int close, void* stream) {
  nested_span_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)buf, n_spans, span, close);
  return (int)cudaGetLastError();
}
