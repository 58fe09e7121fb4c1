// A host stand-in for <cuda_runtime.h> that runs a kernel's threads as
// threads: enough to compile deepvariant_tpu_torch/csrc/batch_norm_relu.cu
// with a C++ compiler and run its kernels' logic on the CPU
// (tests/test_torch_batch_norm_relu.py).
//
// `emu_launch(grid, block, body)` runs the blocks one after another;
// within a block every CUDA thread is a std::thread, and __syncthreads()
// is a std::barrier over them, so a kernel whose threads carry state
// across barriers (the tree merges) runs as it would on the card. Shared
// memory is static storage, shared by the threads of the block running.
// Every thread must pass every barrier (no return before the last one),
// as on the card. Nothing here says anything about speed: that is
// measured on the card.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) double2 {
  double x, y;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline double2 make_double2(double x, double y) { return double2{x, y}; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;

#define __syncthreads() emu_barrier->arrive_and_wait()

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }

template <class Body>
void emu_launch(dim3 grid, dim3 block, Body body) {
  gridDim = grid;
  blockDim = block;
  const unsigned threads = block.x * block.y * block.z;
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(threads);
      emu_barrier = &bar;
      std::vector<std::thread> team;
      team.reserve(threads);
      for (unsigned t = 0; t < threads; ++t) {
        team.emplace_back([&, t, bx, by]() {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          body();
        });
      }
      for (auto& th : team) th.join();
    }
  }
}
