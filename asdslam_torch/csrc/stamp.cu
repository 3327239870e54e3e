// The stage clock's stamp: one thread writes the card's %globaltimer (ns)
// into one int64 slot, on the caller's stream.
//
// Launched between the stages of a step, it runs once the stage before it
// has finished (stream order) and before the stage after it starts, so the
// difference of two stamps is the device time of what ran between them.
// Inside a CUDA-graph capture the launch becomes a kernel node of the graph,
// and each replay writes fresh stamps into the same slots.

#include <cstdint>

#include <cuda_runtime.h>

__global__ void stamp_kernel(long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = (long long)t;
}

extern "C" int stamp_launch(long long* buf, int i, void* stream) {
  if (i < 0) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(buf + i);
  return (int)cudaGetLastError();
}
