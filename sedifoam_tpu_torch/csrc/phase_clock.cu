// The phase clock of the coupled step (sedifoam_tpu_torch/telemetry.py):
// device time by phase, read on the device's own timer, with nothing sent
// to the host and no sync.
//
// It replaces no TPU kernel. The reference's step is one XLA program, so
// its only phase split is an eager re-run of each phase (writeCPUTime.H,
// runner.timing_split); here the marks sit inside the captured step and
// time the replays themselves.
//
//   phase_clock_mark  a one-thread kernel: reads %globaltimer (ns), adds
//                     the time since the last mark on the device into
//                     acc[slot] (none at the very first mark), keeps the
//                     time as the last mark, and with count_step adds one
//                     to acc[steps]. In a stream of one capture, or eager
//                     on one stream, a mark starts when the kernel before
//                     it ends, so acc[slot] holds the time of the work
//                     between the mark before and this one.
//   phase_clock_ticks a one-thread kernel that reads the timer until it
//                     has changed n times and writes the smallest and the
//                     largest change (ns) and the time spent: the timer's
//                     resolution on this card.
//
// Bound: one thread, a few words read and written; the mark costs a
// launch (in a graph, one node) and nothing else.
// Every function returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void mark(long long* last, long long* acc, int slot, int steps,
                     int count_step) {
  long long now = global_ns();
  long long before = *last;
  if (before != 0) acc[slot] += now - before;
  *last = now;
  if (count_step) acc[steps] += 1;
}

__global__ void ticks(long long* out, int n) {
  long long first = global_ns();
  long long prev = first;
  long long lo = 0, hi = 0;
  for (int seen = 0; seen < n;) {
    long long now = global_ns();
    if (now != prev) {
      long long d = now - prev;
      lo = (seen == 0 || d < lo) ? d : lo;
      hi = d > hi ? d : hi;
      prev = now;
      ++seen;
    }
  }
  out[0] = lo;
  out[1] = hi;
  out[2] = prev - first;
}

}  // namespace

extern "C" {

const char* phase_clock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int phase_clock_mark(void* stream, void* last, void* acc, int slot,
                     int steps, int count_step) {
  mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(last), static_cast<long long*>(acc), slot,
      steps, count_step);
  return cudaGetLastError();
}

int phase_clock_ticks(void* stream, void* out, int n) {
  ticks<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), n);
  return cudaGetLastError();
}

}  // extern "C"
