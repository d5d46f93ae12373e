// Stage marks of a request's device program: a one-thread kernel that writes
// the card's global timer (%globaltimer, ns) into one int64 slot.
//
// The program (diffusion/pipeline.py::_program) marks its start and the end
// of each of its stages on the stream it runs on; captured into the CUDA
// graph, every replay writes its own times, which travel to the host beside
// the images (ops/stage_clock.py). Each slot is its own instance,
// stage_mark<slot>, so that a profiler trace names which boundary a launch
// marks. No PTX but the timer read: the kernel takes ~2 us of device time.

#include <cuda_runtime.h>

namespace {

template <int Slot>
__global__ void stage_mark(long long* stamps) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[Slot] = (long long)t;
}

}  // namespace

extern "C" {

// stamps: int64 [slots] on the current device; slot in [0, 5).
int c2d_stage_mark(void* stamps, int slot, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* p = (long long*)stamps;
  switch (slot) {
    case 0: stage_mark<0><<<1, 1, 0, s>>>(p); break;
    case 1: stage_mark<1><<<1, 1, 0, s>>>(p); break;
    case 2: stage_mark<2><<<1, 1, 0, s>>>(p); break;
    case 3: stage_mark<3><<<1, 1, 0, s>>>(p); break;
    case 4: stage_mark<4><<<1, 1, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* c2d_cuda_error_string_stage(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
