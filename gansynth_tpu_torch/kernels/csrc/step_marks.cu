// The training step's phase marks: five one-thread kernels, one at each
// boundary of a step (train/step.py: _StepProgram._body), that add the
// time since the previous mark to a phase's total on the device.
//
// Replaces no TPU kernel. The JAX package's step is one compiled program
// that a profiler sees whole; the port's step is a CUDA graph, whose
// replays run kernels alone, so a host range around a phase marks only
// the capture. A mark is a kernel, so it is captured with the step and
// runs at every replay, in stream order: it starts when the work before
// it has finished. Each reads the device's nanosecond clock
// (%globaltimer), adds now - last to its phase's total, and keeps now as
// last; the end mark also counts the step, the critic mark (one after
// each critic update) the critic updates. Nothing is read back between
// replays: the host copies the totals when it chooses. The kernel's name
// carries the mark, so a profiler's trace places each boundary on the
// trace's own clock.
//
// totals (int64, contiguous, on the device): [frontend, critic, generator,
// ema, between, steps, last, critic updates]. last == 0 means no mark has run: the first
// start mark adds nothing to "between". A sixth kernel, the anchor, sets
// last to now and adds nothing, so that the next mark counts only from
// it (a reader that copies the totals, then waits, anchors before its
// window).
//
// What bounds it: a launch (a few microseconds in a graph), once per
// boundary: five a step, and one more for each critic update past the
// first.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFrontend = 0, kCritic = 1, kGenerator = 2, kEma = 3,
              kBetween = 4, kSteps = 5, kLast = 6, kCritics = 7;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__device__ __forceinline__ void mark(long long* totals, int phase,
                                     int count) {
  const long long now = global_ns();
  const long long last = totals[kLast];
  if (last != 0) {
    totals[phase] += now - last;
  }
  if (count >= 0) {
    totals[count] += 1;
  }
  totals[kLast] = now;
}

}  // namespace

__global__ void
step_mark_start(long long* totals) { mark(totals, kBetween, -1); }

__global__ void
step_mark_frontend(long long* totals) { mark(totals, kFrontend, -1); }

__global__ void
step_mark_critic(long long* totals) { mark(totals, kCritic, kCritics); }

__global__ void
step_mark_generator(long long* totals) { mark(totals, kGenerator, -1); }

__global__ void
step_mark_end(long long* totals) { mark(totals, kEma, kSteps); }

__global__ void
step_mark_anchor(long long* totals) { totals[kLast] = global_ns(); }

extern "C" {

// which: 0 start, 1 frontend, 2 critic, 3 generator, 4 end, 5 anchor.
int step_mark(int which, void* totals, void* stream) {
  using Kernel = void (*)(long long*);
  static const Kernel kernels[] = {step_mark_start, step_mark_frontend,
                                   step_mark_critic, step_mark_generator,
                                   step_mark_end, step_mark_anchor};
  if (which < 0 || which > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernels[which]<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(totals));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
