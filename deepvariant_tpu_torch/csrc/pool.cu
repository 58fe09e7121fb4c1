// InceptionV3's two pools for NHWC tensors, hand-written for Hopper
// (sm_90a): the 3x3 box filter and the 3x3 stride-2 max pool, forward
// and backward.
//
// They replace no TPU kernel: the JAX package leaves both pools to XLA.
// In the port they were torch's avg_pool2d and max_pool2d kernels, the
// top device entries of the train step (about 49 / 32 ms a step in the
// WGS / PacBio cell at batch 2,048, some 13 times their byte floor), and
// torch's max pool saved int64 indices for its backward.
//
// What they compute, on an (N, H, W, C) tensor whose positions (n, h, w)
// lie `ld` elements apart (ld >= C; a channel slice of a wider tensor
// has ld > C), with A the accumulator type (float for bfloat16 and
// float32, double for float64):
//   box3x3      y[h, w] = (sum of the nine x[h + i, w + j], i, j in
//               -1..1, taken in A from 0 in row-major window order, the
//               taps outside the image left out) / 9, rounded once to
//               x's type. That is F.avg_pool2d(x, 3, 1, 1,
//               count_include_pad=True) as torch's CUDA kernels compute
//               it, bit for bit. The map is self-adjoint, so its backward
//               is the same call on the incoming gradient.
//   max3x3s2    y[h, w] = the maximum of x[2h + i, 2w + j], i, j in 0..2
//   forward     (VALID), by torch's rule: the window is walked in
//               row-major order from -infinity, and a tap replaces the
//               maximum if it is greater or NaN. So the first maximum
//               wins, and of several NaNs the last. The value is copied,
//               not rounded.
//   max3x3s2    dx[h, w] = the sum, over the windows that cover (h, w)
//   backward    (at most 2 x 2) and whose maximum (by the rule above,
//               recomputed from x) is (h, w), of dy, in A from 0 in
//               row-major window order. An element covered by exactly
//               one window takes dy or 0 as it is, without the sum. That
//               is torch's max_pool_backward_nhwc given the indices of
//               its max_pool_forward_nhwc, bit for bit, down to the sign
//               of a zero. That includes torch's case of a window of
//               nothing but -infinity, which keeps torch's first index,
//               position (0, 0) of the image: its gradient goes there if
//               that lies in the window and is dropped otherwise. (The
//               network's pools read ReLU outputs and never meet one.)
// bfloat16 is rounded as torch rounds it on sm_80 and later
// (__float2bfloat16_rn: to nearest even, NaN to 0x7fff). Sums are
// per element and in a fixed order, with no atomics, so a run repeats
// bit for bit. One exception to "bit for bit", in float64 only: a
// float64 add passes a NaN operand on, and where two NaNs meet in a box
// filter's sum (inf - inf, then a NaN tap) which one it passes depends on
// the operand order the compiler chose, here as in torch; the result is
// NaN in both, of either sign.
//
// Bound: device memory. The box filter reads x and writes y; the max
// pool's forward reads x and writes y; its backward reads x and dy and
// writes dx. No index tensor is written or read: the backward recomputes
// each window's maximum from the saved x, which the layer before keeps
// alive anyway. At batch 2,048 the network's 13 pools cross about 12.1
// GB a step at 100x221x7 and 7.7 GB at 100x147x10 (each pool's input and
// output once forward and once backward), 3.6 and 2.3 ms at 3.35 TB/s.
//
// Design. A thread owns L channels of one image column (16 bytes: 8
// bfloat16, 4 float32 or 2 float64, where C, ld and the pointers allow
// 16-byte access; else 1 channel) and walks down the column, so a warp
// reads whole 16-byte pieces of consecutive positions, the taps a thread
// shares with its neighbours come from L1, and what the next row needs
// stays in registers:
//   box3x3      each row's three taps finish one output, continue the
//               next and start the one after: two partial sums a
//               channel, each in window order, and 3 loads a row.
//   forward     the window's last row is the next window's first: 6
//               loads an output.
//   backward    a thread owns a 2-column strip of input (columns 2j and
//               2j + 1) and walks it two rows at a time. The windows
//               that cover rows 2k and 2k + 1 of the strip are (k - 1,
//               j - 1), (k - 1, j), (k, j - 1) and (k, j); each step
//               finds the maxima of the two new ones from their 18 taps
//               and keeps them, with their dy, for the next step, where
//               they are the upper two. A window's maximum is kept as its
//               tap's position, 4 bits a channel.
// The backward's cost was the maxima: 9 compares a channel a window. In
// bfloat16 they take two channels at once: the window's maximum with
// NaN carried (__hmax2_nan), then the first tap equal to it (__heq2_mask,
// a scan from the last tap back), which is torch's first maximum; a NaN
// maximum takes the last NaN's position instead, and a maximum of
// -infinity the start.
// One launch per call: a 1-D grid over (n, column or strip, channel
// group), 128 threads a block.
//
// Measured on the H100: PERF.md.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>

#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace {

constexpr int kThreads = 128;
// A window's maximum, as the position (3 * row + column) of its tap;
// kNone where no tap replaced -infinity (a window of -infinity only).
constexpr unsigned kNone = 15u;

template <typename T> struct Traits;
template <> struct Traits<uint16_t> { using A = float; };
template <> struct Traits<float> { using A = float; };
template <> struct Traits<double> { using A = double; };

// L channels of one position, as stored.
template <typename T, int L>
struct Vec {
  T v[L];
};

template <typename T, int L>
__device__ __forceinline__ Vec<T, L> load(const T* p) {
  Vec<T, L> out;
  if constexpr (sizeof(T) * L == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&out, &u, 16);
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) out.v[j] = p[j];
  }
  return out;
}

template <typename T, int L>
__device__ __forceinline__ void store(T* p, const Vec<T, L>& in) {
  if constexpr (sizeof(T) * L == 16) {
    uint4 u;
    memcpy(&u, &in, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) p[j] = in.v[j];
  }
}

template <typename T, int L>
__device__ __forceinline__ Vec<T, L> zeros() {
  Vec<T, L> out;
#pragma unroll
  for (int j = 0; j < L; ++j) out.v[j] = T(0);
  return out;
}

// Stored value -> accumulator, exactly.
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float widen(float f) { return f; }
__device__ __forceinline__ double widen(double d) { return d; }

// Accumulator -> stored value, rounded to nearest even.
template <typename T>
__device__ __forceinline__ T narrow(typename Traits<T>::A a);
template <>
__device__ __forceinline__ uint16_t narrow<uint16_t>(float f) {
#ifdef __CUDA_ARCH__
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
#else
  const unsigned b = __float_as_uint(f);
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0x7fffu;
  return static_cast<uint16_t>((b + 0x7fffu + ((b >> 16) & 1u)) >> 16);
#endif
}
template <>
__device__ __forceinline__ float narrow<float>(float f) {
  return f;
}
template <>
__device__ __forceinline__ double narrow<double>(double d) {
  return d;
}

// -infinity as stored.
template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ uint16_t neg_inf<uint16_t>() {
  return 0xff80u;
}
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return -INFINITY;
}
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return -static_cast<double>(INFINITY);
}

// torch's max rule: a tap replaces the maximum if greater or NaN.
template <typename A>
__device__ __forceinline__ bool replaces(A tap, A best) {
  return tap > best || tap != tap;
}

struct Shape {
  long long n;       // images
  int c, h, w;       // channels, rows, columns of the input
  int ho, wo;        // rows, columns of the output (max pool)
  long long ld_x;    // elements between positions of x
  long long ld_dy;   // ... of dy (max pool backward)
};

// The box filter: a thread per (n, column, channel group), walking the
// rows. Row r's three taps (columns col - 1 .. col + 1) finish output
// r - 1, continue output r and start output r + 1, so the thread keeps
// two partial sums, each taken in window order, and loads each row once.
// A tap outside the image is +0, added to a sum that starts at +0: that
// leaves the sum as leaving the tap out does, so the padded row below
// the image is not added at all.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    box3x3(const T* __restrict__ x, T* __restrict__ y, Shape s) {
  using A = typename Traits<T>::A;
  const long long groups = s.c / L;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (item >= s.n * s.w * groups) return;
  const long long g = item % groups;
  const int col = static_cast<int>((item / groups) % s.w);
  const long long n = item / groups / s.w;
  const T* xin = x + n * s.h * s.w * s.ld_x + g * L;
  T* yout = y + (n * s.h * s.w + col) * s.c + g * L;
  const bool left = col > 0, right = col + 1 < s.w;

  // done[j]: output r - 1 (rows r - 2, r - 1 summed); half[j]: output r
  // (row r - 1 summed).
  A done[L], half[L];
#pragma unroll
  for (int j = 0; j < L; ++j) done[j] = half[j] = A(0);
  for (int r = 0; r < s.h; ++r) {
    const T* p = xin + (static_cast<long long>(r) * s.w + col) * s.ld_x;
    const Vec<T, L> t0 = left ? load<T, L>(p - s.ld_x) : zeros<T, L>();
    const Vec<T, L> t1 = load<T, L>(p);
    const Vec<T, L> t2 = right ? load<T, L>(p + s.ld_x) : zeros<T, L>();
    Vec<T, L> out;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const A a = widen(t0.v[j]), b = widen(t1.v[j]), c = widen(t2.v[j]);
      out.v[j] = narrow<T>((((done[j] + a) + b) + c) / A(9));
      done[j] = ((half[j] + a) + b) + c;
      half[j] = ((A(0) + a) + b) + c;
    }
    if (r > 0) {
      store<T, L>(yout + static_cast<long long>(r - 1) * s.w * s.c, out);
    }
  }
  Vec<T, L> out;
#pragma unroll
  for (int j = 0; j < L; ++j) out.v[j] = narrow<T>(done[j] / A(9));
  store<T, L>(yout + static_cast<long long>(s.h - 1) * s.w * s.c, out);
}

// The max pool's forward: a thread per (n, output column, channel
// group), walking the output rows; the window's last row is the next
// window's first.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    max3x3s2_forward(const T* __restrict__ x, T* __restrict__ y, Shape s) {
  using A = typename Traits<T>::A;
  const long long groups = s.c / L;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (item >= s.n * s.wo * groups) return;
  const long long g = item % groups;
  const int col = static_cast<int>((item / groups) % s.wo);
  const long long n = item / groups / s.wo;
  const T* xin = x + (n * s.h * s.w + 2 * col) * s.ld_x + g * L;
  T* yout = y + (n * s.ho * s.wo + col) * s.c + g * L;

  Vec<T, L> first[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) first[k] = load<T, L>(xin + k * s.ld_x);
  for (int h = 0; h < s.ho; ++h) {
    A best[L];
    Vec<T, L> out;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      out.v[j] = neg_inf<T>();
      best[j] = widen(out.v[j]);
    }
    auto take = [&](const Vec<T, L>& tap) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const A v = widen(tap.v[j]);
        if (replaces(v, best[j])) {
          best[j] = v;
          out.v[j] = tap.v[j];
        }
      }
    };
#pragma unroll
    for (int k = 0; k < 3; ++k) take(first[k]);
#pragma unroll
    for (int r = 1; r < 3; ++r) {
      const T* p = xin + static_cast<long long>(2 * h + r) * s.w * s.ld_x;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Vec<T, L> tap = load<T, L>(p + k * s.ld_x);
        take(tap);
        if (r == 2) first[k] = tap;
      }
    }
    store<T, L>(yout + static_cast<long long>(h) * s.wo * s.c, out);
  }
}

// A window's maximum by torch's rule, as its tap's position (0..8,
// row-major) in 4 bits a channel, from its nine taps in row-major order;
// `start` is the position a window keeps if no tap replaces -infinity
// (a window of -infinity only): 0 for window (0, 0), else kNone, as
// torch's index starts at position (0, 0) of the image.
template <typename T, int L>
__device__ __forceinline__ unsigned window_code(const Vec<T, L> (&tap)[9],
                                                unsigned start) {
  using A = typename Traits<T>::A;
  A best[L];
  unsigned code = 0;
#pragma unroll
  for (int c = 0; c < L; ++c) {
    best[c] = widen(neg_inf<T>());
    code |= start << (4 * c);
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int c = 0; c < L; ++c) {
      const A v = widen(tap[t].v[c]);
      if (replaces(v, best[c])) {
        best[c] = v;
        code = (code & ~(15u << (4 * c))) |
               (static_cast<unsigned>(t) << (4 * c));
      }
    }
  }
  return code;
}

// Two bfloat16 channels a 32-bit word (channel 2p in the low half):
// the maximum, NaN if either is NaN; and 0xffff in each half where a ==
// b as floats (so never for NaN, and +0 == -0).
__device__ __forceinline__ unsigned max_nan2(unsigned a, unsigned b) {
#ifdef __CUDA_ARCH__
  __nv_bfloat162 r = __hmax2_nan(*reinterpret_cast<__nv_bfloat162*>(&a),
                                 *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<unsigned*>(&r);
#else
  unsigned out = 0;
  for (int h = 0; h < 2; ++h) {
    const uint16_t x = static_cast<uint16_t>(a >> (16 * h));
    const uint16_t y = static_cast<uint16_t>(b >> (16 * h));
    const float fx = widen(x), fy = widen(y);
    const uint16_t m = (fx != fx || fy != fy) ? 0x7fffu : (fy > fx ? y : x);
    out |= static_cast<unsigned>(m) << (16 * h);
  }
  return out;
#endif
}

__device__ __forceinline__ unsigned eq_mask2(unsigned a, unsigned b) {
#ifdef __CUDA_ARCH__
  return __heq2_mask(*reinterpret_cast<__nv_bfloat162*>(&a),
                     *reinterpret_cast<__nv_bfloat162*>(&b));
#else
  unsigned out = 0;
  for (int h = 0; h < 2; ++h) {
    const float fx = widen(static_cast<uint16_t>(a >> (16 * h)));
    const float fy = widen(static_cast<uint16_t>(b >> (16 * h)));
    if (fx == fy) out |= 0xffffu << (16 * h);
  }
  return out;
#endif
}

// Eight bfloat16 channels, two at a time: the window's maximum m with
// NaN carried; the position of the first tap equal to m (a scan from the
// last tap back); the start where m is -infinity (no tap replaced it);
// and where m is NaN, the position of the last NaN, torch's rule there.
template <>
__device__ __forceinline__ unsigned window_code<uint16_t, 8>(
    const Vec<uint16_t, 8> (&tap)[9], unsigned start) {
  unsigned w[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t) memcpy(w[t], &tap[t], 16);
  unsigned code = 0, nan = 0;
  unsigned pos[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    unsigned m = w[0][p];
#pragma unroll
    for (int t = 1; t < 9; ++t) m = max_nan2(m, w[t][p]);
    pos[p] = 0;
#pragma unroll
    for (int t = 8; t >= 0; --t) {
      const unsigned eq = eq_mask2(w[t][p], m);
      pos[p] = (eq & (t * 0x00010001u)) | (~eq & pos[p]);
    }
    const unsigned none = eq_mask2(m, 0xff80ff80u);
    pos[p] = (none & (start * 0x00010001u)) | (~none & pos[p]);
    const unsigned is_nan = ~eq_mask2(m, m);
    nan |= is_nan;
    if (is_nan) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const unsigned take = is_nan & ~eq_mask2(w[t][p], w[t][p]);
        pos[p] = (take & (t * 0x00010001u)) | (~take & pos[p]);
      }
    }
    code |= ((pos[p] & 15u) | ((pos[p] >> 12) & 0xf0u)) << (8 * p);
  }
  return code;
}

// The max pool's backward: a thread per (n, 2-column strip j, channel
// group), walking the strip two rows at a time. Step k writes rows 2k
// and 2k + 1 of columns 2j and 2j + 1, which the windows q = 0 (k - 1,
// j - 1), 1 (k - 1, j), 2 (k, j - 1) and 3 (k, j) cover. The upper two
// are the last step's lower two; the lower two are read from x.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    max3x3s2_backward(const T* __restrict__ x, const T* __restrict__ dy,
                      T* __restrict__ dx, Shape s) {
  using A = typename Traits<T>::A;
  const long long groups = s.c / L;
  const int strips = (s.w + 1) / 2;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (item >= s.n * strips * groups) return;
  const long long g = item % groups;
  const int j = static_cast<int>((item / groups) % strips);
  const long long n = item / groups / strips;
  const T* xin = x + n * s.h * s.w * s.ld_x + g * L;
  const T* dyin = dy + n * s.ho * s.wo * s.ld_dy + g * L;
  T* dxout = dx + n * s.h * s.w * s.c + g * L;

  bool on[4] = {false, false, false, false};
  unsigned code[4] = {kNone, kNone, kNone, kNone};
  Vec<T, L> grad[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) grad[q] = zeros<T, L>();
  for (int k = 0; 2 * k < s.h; ++k) {
    on[0] = on[2];
    on[1] = on[3];
    code[0] = code[2];
    code[1] = code[3];
    grad[0] = grad[2];
    grad[1] = grad[3];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = j - 1 + q;
      on[2 + q] = k < s.ho && col >= 0 && col < s.wo;
      grad[2 + q] = zeros<T, L>();
      if (!on[2 + q]) continue;
      const T* p = xin + (2LL * k * s.w + 2 * col) * s.ld_x;
      Vec<T, L> tap[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        tap[t] = load<T, L>(p + (t / 3 * s.w + t % 3) * s.ld_x);
      }
      code[2 + q] = window_code<T, L>(tap, (k == 0 && col == 0) ? 0u : kNone);
      grad[2 + q] = load<T, L>(dyin + (static_cast<long long>(k) * s.wo +
                                       col) * s.ld_dy);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int ih = 2 * k + a;
      if (ih >= s.h) break;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int iw = 2 * j + b;
        if (iw >= s.w) break;
        // The covering windows, in row-major order, and this element's
        // tap position in each: row 2 of the upper windows (a = 0 only),
        // row a of the lower; column 2 of the left (b = 0 only), column
        // b of the right.
        bool use[4];
        unsigned pos[4];
        int count = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool upper = q < 2, left = (q & 1) == 0;
          use[q] = on[q] && !(upper && a == 1) && !(left && b == 1);
          pos[q] = 3u * (upper ? 2u : static_cast<unsigned>(a)) +
                   (left ? 2u : static_cast<unsigned>(b));
          count += use[q];
        }
        Vec<T, L> out;
        if (count == 1) {
#pragma unroll
          for (int c = 0; c < L; ++c) {
            out.v[c] = T(0);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (use[q] && ((code[q] >> (4 * c)) & 15u) == pos[q]) {
                out.v[c] = grad[q].v[c];
              }
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < L; ++c) {
            A sum = A(0);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (use[q] && ((code[q] >> (4 * c)) & 15u) == pos[q]) {
                sum += widen(grad[q].v[c]);
              }
            }
            out.v[c] = narrow<T>(sum);
          }
        }
        store<T, L>(dxout + (static_cast<long long>(ih) * s.w + iw) * s.c,
                    out);
      }
    }
  }
}

// 16-byte access where the channels, the strides and every pointer
// allow it.
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

int blocks_for(long long items, unsigned* blocks) {
  const long long b = (items + kThreads - 1) / kThreads;
  if (b <= 0 || b > 0x7fffffffLL) return 0;
  *blocks = static_cast<unsigned>(b);
  return 1;
}

template <typename T, int L>
int launch_box(const void* x, void* y, const Shape& s, cudaStream_t st) {
  unsigned blocks;
  if (!blocks_for(s.n * s.w * (s.c / L), &blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  box3x3<T, L><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x),
                                            static_cast<T*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int launch_max_forward(const void* x, void* y, const Shape& s,
                       cudaStream_t st) {
  unsigned blocks;
  if (!blocks_for(s.n * s.wo * (s.c / L), &blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  max3x3s2_forward<T, L><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int launch_max_backward(const void* x, const void* dy, void* dx,
                        const Shape& s, cudaStream_t st) {
  unsigned blocks;
  if (!blocks_for(s.n * ((s.w + 1) / 2) * (s.c / L), &blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  max3x3s2_backward<T, L><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), s);
  return static_cast<int>(cudaGetLastError());
}

// Whether positions of `ld` elements and C channels of T allow 16-byte
// access (with 16-byte aligned pointers).
template <typename T>
bool wide(const Shape& s, long long ld_other) {
  const long long v = 16 / sizeof(T);
  return s.c % v == 0 && s.ld_x % v == 0 && ld_other % v == 0;
}

bool valid(const Shape& s, bool max_pool) {
  if (s.n <= 0 || s.c <= 0 || s.h <= 0 || s.w <= 0 || s.ld_x < s.c) {
    return false;
  }
  if (max_pool) {
    return s.h >= 3 && s.w >= 3 && s.ho == (s.h - 3) / 2 + 1 &&
           s.wo == (s.w - 3) / 2 + 1 && s.ld_dy >= s.c;
  }
  return true;
}

template <typename T>
int box(const void* x, void* y, const Shape& s, cudaStream_t st) {
  if (wide<T>(s, s.c) && aligned16({x, y})) {
    return launch_box<T, 16 / sizeof(T)>(x, y, s, st);
  }
  return launch_box<T, 1>(x, y, s, st);
}

template <typename T>
int max_forward(const void* x, void* y, const Shape& s, cudaStream_t st) {
  if (wide<T>(s, s.c) && aligned16({x, y})) {
    return launch_max_forward<T, 16 / sizeof(T)>(x, y, s, st);
  }
  return launch_max_forward<T, 1>(x, y, s, st);
}

template <typename T>
int max_backward(const void* x, const void* dy, void* dx, const Shape& s,
                 cudaStream_t st) {
  if (wide<T>(s, s.ld_dy) && aligned16({x, dy, dx})) {
    return launch_max_backward<T, 16 / sizeof(T)>(x, dy, dx, s, st);
  }
  return launch_max_backward<T, 1>(x, dy, dx, s, st);
}

}  // namespace

// dtype: 0 bfloat16, 1 float32, 2 float64. x is (n, h, w, c) with its
// positions `ld_x` elements apart (ld_dy for dy); every output is dense
// NHWC. The caller allocates the outputs. Each entry launches one kernel
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.

// The 3x3 stride-1 box filter with zero padding 1, divided by 9: y is
// (n, h, w, c). Also the box filter's backward, applied to dy.
extern "C" int dv_box3x3_nhwc(int dtype, const void* x, long long ld_x,
                              void* y, long long n, int c, int h, int w,
                              void* stream) {
  const Shape s{n, c, h, w, h, w, ld_x, c};
  if (!valid(s, false)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return box<uint16_t>(x, y, s, st);
    case 1: return box<float>(x, y, s, st);
    case 2: return box<double>(x, y, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The 3x3 stride-2 VALID max pool: y is (n, (h - 3) / 2 + 1,
// (w - 3) / 2 + 1, c). Nothing else is written.
extern "C" int dv_max3x3s2_forward_nhwc(int dtype, const void* x,
                                        long long ld_x, void* y, long long n,
                                        int c, int h, int w, void* stream) {
  const Shape s{n, c, h, w, (h - 3) / 2 + 1, (w - 3) / 2 + 1, ld_x, c};
  if (!valid(s, true)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return max_forward<uint16_t>(x, y, s, st);
    case 1: return max_forward<float>(x, y, s, st);
    case 2: return max_forward<double>(x, y, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Its backward: dx (n, h, w, c) from the forward's x and dy; every
// element of dx is written.
extern "C" int dv_max3x3s2_backward_nhwc(int dtype, const void* x,
                                         long long ld_x, const void* dy,
                                         long long ld_dy, void* dx,
                                         long long n, int c, int h, int w,
                                         void* stream) {
  const Shape s{n, c, h, w, (h - 3) / 2 + 1, (w - 3) / 2 + 1, ld_x, ld_dy};
  if (!valid(s, true)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return max_backward<uint16_t>(x, dy, dx, s, st);
    case 1: return max_backward<float>(x, dy, dx, s, st);
    case 2: return max_backward<double>(x, dy, dx, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
