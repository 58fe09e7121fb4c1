// 7-channel WGS pileup paint, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paint_kernel` of
// deepvariant_tpu/ops/pileup_paint.py (launched by `_paint_pileup` through
// pl.pallas_call, one candidate per grid step; math in `_channels_for_tile`).
//
// What it computes, for each pixel (n, r, w) of the read rows:
//   0 read_base              A=250 G=180 T=100 C=30, anything else 0
//   1 base_quality           254 * min(q, 40) / 40
//   2 mapping_quality        mapq_color[n, r]
//   3 strand                 strand_color[n, r]
//   4 read_supports_variant  support_color[n, r]
//   5 base_differs_from_ref  50 where b == ref[n, w], else 254
//   6 insert_size            tlen_color[n, r]
// each multiplied by covered[n, r, w] (0 or 1), then cast float -> int32
// (truncation toward zero) -> uint8 (mod 256), as the JAX kernel does.
// The float32 operations and their order are the JAX kernel's, and the
// file is compiled without --use_fast_math, so the division stays IEEE and
// the output is bit-identical to the plain version.
//
// Bound: device memory. Each pixel reads 3 bytes (b, q, covered) and
// writes 7; the row colors and the reference add 16 bytes per row and 1
// per column. There is no arithmetic to speak of (about 20 float
// operations per pixel against 10 bytes moved). At the main path's shapes
// (N=512 candidates, R=95 rows, W=221 columns: 10.75M pixels) that is
// about 32.2 MB read (b, q, covered) + 0.9 MB (colors, reference) and
// 75.2 MB written, 108 MB in all, or about 32 us at 3.35 TB/s.
//
// Design, right and simple first: one block per (candidate, row), one
// thread per column. A thread reads its own b, q and covered byte (the
// warp's loads are contiguous), reads the row's four colors and ref[n, w]
// directly by candidate (the Pallas kernel loaded those arrays whole only
// because of the TPU's block-shape rule), and writes its pixel's 7 bytes.
// The 7-byte stores are not 16-byte aligned; staging the row in shared
// memory for vectorised stores is left for a later change.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float base_color(uint8_t b) {
  return b == 'A'   ? 250.0f
         : b == 'G' ? 180.0f
         : b == 'T' ? 100.0f
         : b == 'C' ? 30.0f
                    : 0.0f;
}

__device__ __forceinline__ uint8_t to_pixel(float value, float mask) {
  return static_cast<uint8_t>(static_cast<int32_t>(value * mask));
}

__global__ void pileup_paint_kernel(
    const uint8_t* __restrict__ b, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ covered, const uint8_t* __restrict__ ref,
    const float* __restrict__ mapq_color,
    const float* __restrict__ strand_color,
    const float* __restrict__ support_color,
    const float* __restrict__ tlen_color, uint8_t* __restrict__ out,
    int rows, int width) {
  const int w = threadIdx.x;
  if (w >= width) return;
  const int64_t row = blockIdx.x;  // n * rows + r
  const int64_t n = row / rows;
  const int64_t pix = row * width + w;

  const uint8_t base = b[pix];
  const float qf = static_cast<float>(q[pix]);
  const float mask = covered[pix] ? 1.0f : 0.0f;
  const float differs = base == ref[n * width + w] ? 50.0f : 254.0f;

  uint8_t* o = out + pix * 7;
  o[0] = to_pixel(base_color(base), mask);
  o[1] = to_pixel(254.0f * fminf(qf, 40.0f) / 40.0f, mask);
  o[2] = to_pixel(mapq_color[row], mask);
  o[3] = to_pixel(strand_color[row], mask);
  o[4] = to_pixel(support_color[row], mask);
  o[5] = to_pixel(differs, mask);
  o[6] = to_pixel(tlen_color[row], mask);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// caller checks shapes, types and contiguity and allocates `out`.
extern "C" int dv_pileup_paint(const void* b, const void* q,
                               const void* covered, const void* ref,
                               const void* mapq_color,
                               const void* strand_color,
                               const void* support_color,
                               const void* tlen_color, void* out, int n,
                               int rows, int width, void* stream) {
  if (n <= 0 || rows <= 0 || width <= 0 || width > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (width + 31) / 32 * 32;
  pileup_paint_kernel<<<n * rows, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<const uint8_t*>(q),
      static_cast<const uint8_t*>(covered), static_cast<const uint8_t*>(ref),
      static_cast<const float*>(mapq_color),
      static_cast<const float*>(strand_color),
      static_cast<const float*>(support_color),
      static_cast<const float*>(tlen_color), static_cast<uint8_t*>(out),
      rows, width);
  return static_cast<int>(cudaGetLastError());
}
