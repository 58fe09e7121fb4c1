// A host stand-in for <cuda_runtime.h>, enough to compile
// deepvariant_tpu_torch/csrc/pileup_paint.cu with a C++ compiler and run
// its kernel's logic on the CPU (tests/test_torch_paint_emulation.py).
//
// A launch runs the blocks one after another. Within a block the kernel
// body runs once per thread and per barrier phase: in phase p every
// thread runs from the top and returns at its p-th __syncthreads(), so
// all threads have passed barrier p - 1 before any runs beyond it. That
// is sound for a kernel whose work before a barrier only writes values
// that do not depend on how often it runs (table fills, tile writes), as
// this one's does. Shared memory is static storage. Nothing here says
// anything about speed, bank conflicts or register use: those are
// measured on the card.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct EmuDim3 {
  unsigned x = 0, y = 0, z = 0;
};
static EmuDim3 threadIdx, blockIdx;
static int emu_barriers_left;
alignas(16) static unsigned char emu_dynamic_shared[64 * 1024];

#define __syncthreads()                      \
  do {                                       \
    if (--emu_barriers_left == 0) return;    \
  } while (0)

using std::max;
using std::min;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static inline int cudaGetLastError() { return cudaSuccess; }
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) {
  return cudaSuccess;
}

// `barriers`: how many __syncthreads() the kernel body passes.
template <class Body>
void emu_launch(int blocks, int threads, int barriers, Body body) {
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    for (int phase = 1; phase <= barriers + 1; ++phase) {
      for (int t = 0; t < threads; ++t) {
        threadIdx.x = t;
        emu_barriers_left = phase;
        body();
      }
    }
  }
}
