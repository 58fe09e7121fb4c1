// Batch norm + ReLU for training, hand-written for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves InceptionV3's batch
// norm and ReLU to XLA, which fuses them. In the port the layer was some
// twenty PyTorch ops a layer (a float32 copy, two means, a square, the
// running update, torch.batch_norm, the ReLU), 94 times a train step,
// and it held about 40% of the step's device time. These four kernels
// compute the same function in two launches forward and two backward.
//
// What it computes, per channel c of an (N, C, H, W) channels_last x,
// read as an (M = N*H*W, C) row-major matrix, with A the accumulator
// type (float for bfloat16 and float32 input, double for float64):
//   mean, var   the batch's mean and biased variance over the M rows,
//               the variance centred (each block's mean and sum of
//               squared deviations, merged by Chan et al.'s formula);
//   rstd        1 / sqrt(var + eps);
//   y           relu((x - mean) * rstd + bias) in A, rounded once to x's
//               type;
//   running     ra = m * ra + (1 - m) * batch, in place, the variance's
//               batch value E[x^2] - E[x]^2 clamped at 0 (flax's form);
// and in the backward, with x^ = (x - mean) * rstd and g = dy where
// (x - mean) * rstd + bias > 0 (recomputed in the forward's arithmetic,
// the same fma), else 0:
//   dbias       sum of g;
//   dx          rstd * (g - mean(g) - x^ * mean(g * x^)).
// Sums are taken in A in a fixed order (each thread's rows in order, a
// fixed tree over the block, the chunks in order), with no atomics, so
// a run repeats bit for bit.
//
// Bound: device memory. bfloat16 moves 16 bytes an element: the forward
// reads x twice (statistics, then apply) and writes y; the backward reads
// dy and x twice and writes dx. At batch 2,048 InceptionV3's 94 layers
// hold 1,793,808 elements an example at 100x221x7 (58.8 GB a step, 17.5
// ms at 3.35 TB/s) and 1,140,432 at 100x147x10 (37.4 GB, 11.2 ms).
//
// Design. A thread owns 16 bytes of a row (8 bfloat16, 4 float32 or 2
// float64 channels) and walks the rows of its block's chunk with a
// stride, so a warp reads whole rows with 16-byte loads. Every C of the
// network is a multiple of 8. The block is a tile of up to 64 such
// columns by `ty` row lanes (512 threads); wider rows take several tiles
// (grid.y). The rows are cut into `chunks` (grid.x), chosen on the host
// from (M, C) so that the grid fills the card a few times over while the
// partials stay few. Launch 1 (statistics, or the backward's sums)
// writes one partial per (chunk, channel). Launch 2 (apply) merges the
// partials of its tile's channels in every block, in the same order, so
// all blocks normalize with the same numbers; chunk 0's blocks write the
// saved mean and rstd, the running statistics and dbias once. The
// partials are chunks x C values each, and every apply block reads its
// channels' share, so the host caps chunks at about sqrt(M / 3): the
// layers of 10,240-98,304 rows then trade a full card for merges read
// from L2. A thread merges every S-th chunk (S = threads / channels of
// the tile) and the block adds the S sums in order.
//
// Measured on the H100: PERF.md.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// Row lanes a stats block merges in its first tree step, at most
// kThreads / 2 slots of one lane and column each.
constexpr int kSlots = kThreads / 2;

// The launch geometry, computed by the host (ops/batch_norm_relu.py).
struct Geometry {
  long long rows;      // M = N*H*W
  long long ld_dy;     // row stride of dy in elements (backward)
  int channels;        // C
  int rows_per_chunk;  // rows of every chunk but the last
  int chunks;          // grid.x
  int vc;              // 16-byte columns per tile; blockDim.x = vc * ty
  int ty;              // row lanes
};

// 16 bytes of a row as V values of A.
__device__ __forceinline__ void load16(const uint16_t* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 u = *reinterpret_cast<const double2*>(p);
  v[0] = u.x;
  v[1] = u.y;
}

// float -> bfloat16 bits, rounded to nearest even (torch's rounding; NaN
// becomes torch's quiet NaN).
__device__ __forceinline__ unsigned bf16_bits(float f) {
  const unsigned b = __float_as_uint(f);
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (b + 0x7fffu + ((b >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ void store16(uint16_t* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float inv_sqrt(float v) { return 1.0f / sqrtf(v); }
__device__ __forceinline__ double inv_sqrt(double v) { return 1.0 / sqrt(v); }

// Storage type T (uint16_t holds bfloat16) -> accumulator A, V values in
// 16 bytes.
template <typename T> struct Traits;
template <> struct Traits<uint16_t> { using A = float; static constexpr int V = 8; };
template <> struct Traits<float> { using A = float; static constexpr int V = 4; };
template <> struct Traits<double> { using A = double; static constexpr int V = 2; };

// Where a thread sits: its 16-byte column in the row and its row lane.
struct Place {
  int cl, lane, col;
  bool on;  // the column exists (the last tile may be narrower)
  long long r0, r1;  // the chunk's rows
  __device__ Place(const Geometry& g, int vec) {
    cl = threadIdx.x % g.vc;
    lane = threadIdx.x / g.vc;
    col = blockIdx.y * g.vc + cl;
    on = col < g.channels / vec;
    r0 = static_cast<long long>(blockIdx.x) * g.rows_per_chunk;
    r1 = r0 + g.rows_per_chunk < g.rows ? r0 + g.rows_per_chunk : g.rows;
  }
};

template <typename A>
__device__ __forceinline__ A chunk_rows(const Geometry& g, int i) {
  const long long start = static_cast<long long>(i) * g.rows_per_chunk;
  const long long n = g.rows - start < g.rows_per_chunk ? g.rows - start
                                                        : g.rows_per_chunk;
  return static_cast<A>(n);
}

// The forward's statistics: for each (chunk, channel) the chunk's mean,
// sum of squared deviations and sum of squares, at part[k][chunk][c] for
// k = 0, 1, 2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_stats(const T* __restrict__ x, typename Traits<T>::A* __restrict__ part,
             Geometry g) {
  using A = typename Traits<T>::A;
  constexpr int V = Traits<T>::V;
  __shared__ A s_mean[kSlots * V], s_m2[kSlots * V], s_sq[kSlots * V];
  __shared__ long long s_n[kSlots];
  const Place p(g, V);
  const long long C = g.channels;
  const long long c0 = static_cast<long long>(p.col) * V;

  // Sums of (x - shift) and its square, shifted by the lane's first row
  // so that the centred sum loses nothing to cancellation, and of x^2.
  A shift[V], s[V], q[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) shift[j] = s[j] = q[j] = sq[j] = A(0);
  long long n = 0;
  long long r = p.r0 + p.lane;
  if (p.on && r < p.r1) load16(x + r * C + c0, shift);
  if (p.on) {
    for (; r + g.ty < p.r1; r += 2 * g.ty) {
      A a[V], b[V];
      load16(x + r * C + c0, a);
      load16(x + (r + g.ty) * C + c0, b);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const A da = a[j] - shift[j];
        s[j] += da;
        q[j] = fma_(da, da, q[j]);
        sq[j] = fma_(a[j], a[j], sq[j]);
        const A db = b[j] - shift[j];
        s[j] += db;
        q[j] = fma_(db, db, q[j]);
        sq[j] = fma_(b[j], b[j], sq[j]);
      }
      n += 2;
    }
    if (r < p.r1) {
      A a[V];
      load16(x + r * C + c0, a);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const A da = a[j] - shift[j];
        s[j] += da;
        q[j] = fma_(da, da, q[j]);
        sq[j] = fma_(a[j], a[j], sq[j]);
      }
      n += 1;
    }
  }
  A mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = m2[j] = A(0);
    if (n > 0) {
      const A inv = A(1) / static_cast<A>(n);
      mean[j] = fma_(s[j], inv, shift[j]);
      const A d = q[j] - s[j] * s[j] * inv;
      m2[j] = d > A(0) ? d : A(0);
    }
  }

  // The lanes' states merged by a fixed tree: while `active` lanes hold
  // one, the upper r..active-1 hand theirs to lanes 0..h-1.
  for (int active = g.ty; active > 1;) {
    const int h = active / 2, rr = active - h;
    if (p.lane >= rr && p.lane < active) {
      const int slot = (p.lane - rr) * g.vc + p.cl;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_mean[slot * V + j] = mean[j];
        s_m2[slot * V + j] = m2[j];
        s_sq[slot * V + j] = sq[j];
      }
      if (p.cl == 0) s_n[p.lane - rr] = n;
    }
    __syncthreads();
    if (p.lane < h) {
      const int slot = p.lane * g.vc + p.cl;
      const long long nb = s_n[p.lane];
      if (nb > 0) {
        const long long nn = n + nb;
        const A fb = static_cast<A>(nb) / static_cast<A>(nn);
        const A na = static_cast<A>(n);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const A d = s_mean[slot * V + j] - mean[j];
          mean[j] = fma_(d, fb, mean[j]);
          m2[j] = m2[j] + s_m2[slot * V + j] + d * d * (na * fb);
          sq[j] += s_sq[slot * V + j];
        }
        n = nn;
      }
    }
    __syncthreads();
    active = rr;
  }
  if (p.lane == 0 && p.on) {
    const long long plane = static_cast<long long>(g.chunks) * C;
    A* out = part + static_cast<long long>(blockIdx.x) * C + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = mean[j];
      out[plane + j] = m2[j];
      out[2 * plane + j] = sq[j];
    }
  }
}

// The apply's per-channel numbers for this block's tile, in shared
// memory: `first`, `second` and (forward) `third` of the tile's channels.
template <typename A>
struct TileNumbers {
  A first[kThreads], second[kThreads], third[kThreads];
  A red0[kThreads], red1[kThreads];
};

// Forward apply: merge the statistics, write the saved and running ones
// (chunk 0), then y = relu((x - mean) * rstd + bias).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_apply(const T* __restrict__ x, T* __restrict__ y,
                  const typename Traits<T>::A* __restrict__ part,
                  const typename Traits<T>::A* __restrict__ bias,
                  typename Traits<T>::A* __restrict__ running_mean,
                  typename Traits<T>::A* __restrict__ running_var,
                  typename Traits<T>::A* __restrict__ mean_out,
                  typename Traits<T>::A* __restrict__ rstd_out, Geometry g,
                  typename Traits<T>::A momentum,
                  typename Traits<T>::A keep_new,
                  typename Traits<T>::A eps) {
  using A = typename Traits<T>::A;
  constexpr int V = Traits<T>::V;
  __shared__ TileNumbers<A> sh;
  const Place p(g, V);
  const long long C = g.channels;
  const int ct = g.vc * V;  // channels of a full tile
  const long long t0 = static_cast<long long>(blockIdx.y) * ct;
  const int nch = C - t0 < ct ? static_cast<int>(C - t0) : ct;
  const int t = threadIdx.x;
  // Thread t merges channel t % ct over the chunks seg, seg + S, ...
  const int S = blockDim.x / ct;
  const int c = t % ct, seg = t / ct;
  const bool merging = seg < S && c < nch;
  const long long plane = static_cast<long long>(g.chunks) * C;
  const A total = static_cast<A>(g.rows);

  A sum = A(0), sq = A(0);
  if (merging) {
#pragma unroll 4
    for (int i = seg; i < g.chunks; i += S) {
      const long long k = static_cast<long long>(i) * C + t0 + c;
      sum = fma_(chunk_rows<A>(g, i), part[k], sum);
      sq += part[2 * plane + k];
    }
  }
  sh.red0[t] = sum;
  sh.red1[t] = sq;
  __syncthreads();
  if (t < nch) {
    A all = A(0), all_sq = A(0);
    for (int k = 0; k < S; ++k) {
      all += sh.red0[k * ct + t];
      all_sq += sh.red1[k * ct + t];
    }
    sh.first[t] = all / total;      // mean
    sh.third[t] = all_sq / total;   // E[x^2]
  }
  __syncthreads();
  A m2 = A(0);
  if (merging) {
    const A mu = sh.first[c];
#pragma unroll 4
    for (int i = seg; i < g.chunks; i += S) {
      const long long k = static_cast<long long>(i) * C + t0 + c;
      const A d = part[k] - mu;
      m2 += part[plane + k] + chunk_rows<A>(g, i) * d * d;
    }
  }
  sh.red0[t] = m2;
  __syncthreads();
  if (t < nch) {
    A all = A(0);
    for (int k = 0; k < S; ++k) all += sh.red0[k * ct + t];
    const A mean = sh.first[t];
    const A rstd = inv_sqrt(all / total + eps);
    sh.second[t] = rstd;
    const A e2 = sh.third[t];
    sh.third[t] = bias[t0 + t];
    if (blockIdx.x == 0) {
      const long long ch = t0 + t;
      mean_out[ch] = mean;
      rstd_out[ch] = rstd;
      A var = e2 - mean * mean;
      var = var > A(0) ? var : A(0);
      running_mean[ch] = add_rn(mul_rn(momentum, running_mean[ch]),
                                mul_rn(keep_new, mean));
      running_var[ch] = add_rn(mul_rn(momentum, running_var[ch]),
                               mul_rn(keep_new, var));
    }
  }
  __syncthreads();
  if (!p.on) return;
  A mu[V], rs[V], bi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = sh.first[p.cl * V + j];
    rs[j] = sh.second[p.cl * V + j];
    bi[j] = sh.third[p.cl * V + j];
  }
  const long long c0 = static_cast<long long>(p.col) * V;
  long long r = p.r0 + p.lane;
  for (; r + g.ty < p.r1; r += 2 * g.ty) {
    A a[V], b[V];
    load16(x + r * C + c0, a);
    load16(x + (r + g.ty) * C + c0, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const A va = fma_(a[j] - mu[j], rs[j], bi[j]);
      a[j] = va <= A(0) ? A(0) : va;
      const A vb = fma_(b[j] - mu[j], rs[j], bi[j]);
      b[j] = vb <= A(0) ? A(0) : vb;
    }
    store16(y + r * C + c0, a);
    store16(y + (r + g.ty) * C + c0, b);
  }
  if (r < p.r1) {
    A a[V];
    load16(x + r * C + c0, a);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const A va = fma_(a[j] - mu[j], rs[j], bi[j]);
      a[j] = va <= A(0) ? A(0) : va;
    }
    store16(y + r * C + c0, a);
  }
}

// The backward's gate and normalized input at one element: g = dy where
// the forward's pre-activation is positive, x^ = (x - mean) * rstd.
template <typename A>
__device__ __forceinline__ A gated(A xv, A dyv, A mu, A rs, A bi, A& xhat) {
  const A d = xv - mu;
  xhat = d * rs;
  return fma_(d, rs, bi) > A(0) ? dyv : A(0);
}

// Backward sums: for each (chunk, channel) the sum of g and of g * x^, at
// part[k][chunk][c] for k = 0, 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_grad_sums(const T* __restrict__ x, const T* __restrict__ dy,
                      const typename Traits<T>::A* __restrict__ mean,
                      const typename Traits<T>::A* __restrict__ rstd,
                      const typename Traits<T>::A* __restrict__ bias,
                      typename Traits<T>::A* __restrict__ part, Geometry g) {
  using A = typename Traits<T>::A;
  constexpr int V = Traits<T>::V;
  __shared__ A s_g[kSlots * V], s_gx[kSlots * V];
  const Place p(g, V);
  const long long C = g.channels;
  const long long ld = g.ld_dy;
  const long long c0 = static_cast<long long>(p.col) * V;
  A sg[V], sgx[V], mu[V], rs[V], bi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sg[j] = sgx[j] = A(0);
    mu[j] = rs[j] = bi[j] = A(0);
  }
  if (p.on) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = mean[c0 + j];
      rs[j] = rstd[c0 + j];
      bi[j] = bias[c0 + j];
    }
    long long r = p.r0 + p.lane;
    for (; r + g.ty < p.r1; r += 2 * g.ty) {
      A xa[V], da[V], xb[V], db[V];
      load16(x + r * C + c0, xa);
      load16(dy + r * ld + c0, da);
      load16(x + (r + g.ty) * C + c0, xb);
      load16(dy + (r + g.ty) * ld + c0, db);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        A xh;
        A gv = gated(xa[j], da[j], mu[j], rs[j], bi[j], xh);
        sg[j] += gv;
        sgx[j] = fma_(gv, xh, sgx[j]);
        gv = gated(xb[j], db[j], mu[j], rs[j], bi[j], xh);
        sg[j] += gv;
        sgx[j] = fma_(gv, xh, sgx[j]);
      }
    }
    if (r < p.r1) {
      A xa[V], da[V];
      load16(x + r * C + c0, xa);
      load16(dy + r * ld + c0, da);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        A xh;
        const A gv = gated(xa[j], da[j], mu[j], rs[j], bi[j], xh);
        sg[j] += gv;
        sgx[j] = fma_(gv, xh, sgx[j]);
      }
    }
  }
  for (int active = g.ty; active > 1;) {
    const int h = active / 2, rr = active - h;
    if (p.lane >= rr && p.lane < active) {
      const int slot = (p.lane - rr) * g.vc + p.cl;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_g[slot * V + j] = sg[j];
        s_gx[slot * V + j] = sgx[j];
      }
    }
    __syncthreads();
    if (p.lane < h) {
      const int slot = p.lane * g.vc + p.cl;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sg[j] += s_g[slot * V + j];
        sgx[j] += s_gx[slot * V + j];
      }
    }
    __syncthreads();
    active = rr;
  }
  if (p.lane == 0 && p.on) {
    const long long plane = static_cast<long long>(g.chunks) * C;
    A* out = part + static_cast<long long>(blockIdx.x) * C + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = sg[j];
      out[plane + j] = sgx[j];
    }
  }
}

// Backward apply: merge the sums, write dbias (chunk 0), then
// dx = rstd * (g - mean(g) - x^ * mean(g * x^)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_relu_grad_apply(const T* __restrict__ x, const T* __restrict__ dy,
                       T* __restrict__ dx,
                       const typename Traits<T>::A* __restrict__ mean,
                       const typename Traits<T>::A* __restrict__ rstd,
                       const typename Traits<T>::A* __restrict__ bias,
                       const typename Traits<T>::A* __restrict__ part,
                       typename Traits<T>::A* __restrict__ dbias,
                       Geometry g) {
  using A = typename Traits<T>::A;
  constexpr int V = Traits<T>::V;
  __shared__ TileNumbers<A> sh;
  const Place p(g, V);
  const long long C = g.channels;
  const long long ld = g.ld_dy;
  const int ct = g.vc * V;
  const long long t0 = static_cast<long long>(blockIdx.y) * ct;
  const int nch = C - t0 < ct ? static_cast<int>(C - t0) : ct;
  const int t = threadIdx.x;
  const int S = blockDim.x / ct;
  const int c = t % ct, seg = t / ct;
  const long long plane = static_cast<long long>(g.chunks) * C;
  const A total = static_cast<A>(g.rows);

  A sg = A(0), sgx = A(0);
  if (seg < S && c < nch) {
#pragma unroll 4
    for (int i = seg; i < g.chunks; i += S) {
      const long long k = static_cast<long long>(i) * C + t0 + c;
      sg += part[k];
      sgx += part[plane + k];
    }
  }
  sh.red0[t] = sg;
  sh.red1[t] = sgx;
  __syncthreads();
  if (t < nch) {
    A all = A(0), all_x = A(0);
    for (int k = 0; k < S; ++k) {
      all += sh.red0[k * ct + t];
      all_x += sh.red1[k * ct + t];
    }
    sh.first[t] = all / total;     // mean(g)
    sh.second[t] = all_x / total;  // mean(g * x^)
    if (blockIdx.x == 0) dbias[t0 + t] = all;
  }
  __syncthreads();
  if (!p.on) return;
  const long long c0 = static_cast<long long>(p.col) * V;
  A mu[V], rs[V], bi[V], mg[V], mgx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = mean[c0 + j];
    rs[j] = rstd[c0 + j];
    bi[j] = bias[c0 + j];
    mg[j] = sh.first[p.cl * V + j];
    mgx[j] = sh.second[p.cl * V + j];
  }
  long long r = p.r0 + p.lane;
  for (; r + g.ty < p.r1; r += 2 * g.ty) {
    A xa[V], da[V], xb[V], db[V];
    load16(x + r * C + c0, xa);
    load16(dy + r * ld + c0, da);
    load16(x + (r + g.ty) * C + c0, xb);
    load16(dy + (r + g.ty) * ld + c0, db);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      A xh;
      A gv = gated(xa[j], da[j], mu[j], rs[j], bi[j], xh);
      xa[j] = rs[j] * (gv - mg[j] - xh * mgx[j]);
      gv = gated(xb[j], db[j], mu[j], rs[j], bi[j], xh);
      xb[j] = rs[j] * (gv - mg[j] - xh * mgx[j]);
    }
    store16(dx + r * C + c0, xa);
    store16(dx + (r + g.ty) * C + c0, xb);
  }
  if (r < p.r1) {
    A xa[V], da[V];
    load16(x + r * C + c0, xa);
    load16(dy + r * ld + c0, da);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      A xh;
      const A gv = gated(xa[j], da[j], mu[j], rs[j], bi[j], xh);
      xa[j] = rs[j] * (gv - mg[j] - xh * mgx[j]);
    }
    store16(dx + r * C + c0, xa);
  }
}

// The geometry the kernels assume: every tile's column 0 exists (its lane
// counts are written from there), a tile's channels fit the block (the
// apply merges one channel a thread), and the chunks cover the rows.
bool valid(const Geometry& g, int vec, int tiles) {
  const long long cols = g.channels / vec;
  return g.rows > 0 && g.channels > 0 && g.channels % vec == 0 &&
         g.vc > 0 && g.ty >= vec && g.vc * g.ty <= kThreads &&
         g.ty / 2 * g.vc <= kSlots && tiles > 0 &&
         static_cast<long long>(tiles) * g.vc >= cols &&
         static_cast<long long>(tiles - 1) * g.vc < cols &&
         g.rows_per_chunk > 0 && g.chunks > 0 &&
         static_cast<long long>(g.chunks) * g.rows_per_chunk >= g.rows &&
         static_cast<long long>(g.chunks - 1) * g.rows_per_chunk < g.rows &&
         g.ld_dy >= g.channels && g.ld_dy % vec == 0;
}

template <typename T>
int forward(const void* x, void* y, const void* bias, void* running_mean,
            void* running_var, void* mean_out, void* rstd_out, void* part,
            const Geometry& g, int tiles, double momentum, double keep_new,
            double eps, void* stream) {
  using A = typename Traits<T>::A;
  if (!valid(g, Traits<T>::V, tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(g.chunks, tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bn_stats<T><<<grid, g.vc * g.ty, 0, s>>>(static_cast<const T*>(x),
                                           static_cast<A*>(part), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_relu_apply<T><<<grid, g.vc * g.ty, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const A*>(part), static_cast<const A*>(bias),
      static_cast<A*>(running_mean), static_cast<A*>(running_var),
      static_cast<A*>(mean_out), static_cast<A*>(rstd_out), g,
      static_cast<A>(momentum), static_cast<A>(keep_new),
      static_cast<A>(eps));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* dy, void* dx, const void* mean,
             const void* rstd, const void* bias, void* part, void* dbias,
             const Geometry& g, int tiles, void* stream) {
  using A = typename Traits<T>::A;
  if (!valid(g, Traits<T>::V, tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(g.chunks, tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bn_relu_grad_sums<T><<<grid, g.vc * g.ty, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const A*>(mean), static_cast<const A*>(rstd),
      static_cast<const A*>(bias), static_cast<A*>(part), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_relu_grad_apply<T><<<grid, g.vc * g.ty, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<const A*>(mean),
      static_cast<const A*>(rstd), static_cast<const A*>(bias),
      static_cast<const A*>(part), static_cast<A*>(dbias), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 bfloat16, 1 float32, 2 float64. The caller checks types,
// layouts and alignment, allocates every output and the partials
// (3 * chunks * C values of A forward, 2 * chunks * C backward) and
// passes the geometry; both launch on `stream` and return
// cudaGetLastError() (0 on success).
extern "C" int dv_batch_norm_relu_forward(
    int dtype, const void* x, void* y, const void* bias, void* running_mean,
    void* running_var, void* mean_out, void* rstd_out, void* part,
    long long rows, int channels, int rows_per_chunk, int chunks, int tiles,
    int vc, int ty, double momentum, double keep_new, double eps,
    void* stream) {
  const Geometry g{rows, channels, channels, rows_per_chunk, chunks, vc, ty};
  switch (dtype) {
    case 0: return forward<uint16_t>(x, y, bias, running_mean, running_var,
                                     mean_out, rstd_out, part, g, tiles,
                                     momentum, keep_new, eps, stream);
    case 1: return forward<float>(x, y, bias, running_mean, running_var,
                                  mean_out, rstd_out, part, g, tiles,
                                  momentum, keep_new, eps, stream);
    case 2: return forward<double>(x, y, bias, running_mean, running_var,
                                   mean_out, rstd_out, part, g, tiles,
                                   momentum, keep_new, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `ld_dy`: dy's row stride in elements (dy may be a channel slice of a
// wider channels_last tensor); x and dx are dense.
extern "C" int dv_batch_norm_relu_backward(
    int dtype, const void* x, const void* dy, long long ld_dy, void* dx,
    const void* mean, const void* rstd, const void* bias, void* part,
    void* dbias, long long rows, int channels, int rows_per_chunk,
    int chunks, int tiles, int vc, int ty, void* stream) {
  const Geometry g{rows, ld_dy, channels, rows_per_chunk, chunks, vc, ty};
  switch (dtype) {
    case 0: return backward<uint16_t>(x, dy, dx, mean, rstd, bias, part,
                                      dbias, g, tiles, stream);
    case 1: return backward<float>(x, dy, dx, mean, rstd, bias, part, dbias,
                                   g, tiles, stream);
    case 2: return backward<double>(x, dy, dx, mean, rstd, bias, part,
                                    dbias, g, tiles, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
