// 7-channel WGS pileup paint, hand-written for Hopper (sm_90a).
//
// One kernel template, two entry points:
//
// - rows form, `dv_pileup_paint`: replaces the TPU kernel `_paint_kernel`
//   of deepvariant_tpu/ops/pileup_paint.py (launched by `_paint_pileup`
//   through pl.pallas_call; math in `_channels_for_tile`). Takes b, q
//   (N,R,W) u8, covered (N,R,W) bool, ref (N,W) u8 and four (N,R) float32
//   row colors; writes the (N,R,W,7) read rows.
// - plan form, `dv_pileup_paint_plan`: what the WGS plan painter launches.
//   Takes the plan tensors as they come (bases, quals (N,R,W) u8; mapq
//   (N,R) u8; rev (N,R) bool; tlen (N,R) i32; support (N,R) i8;
//   row_valid (N,R) bool; ref (N,W) u8) and the option-derived colors,
//   and writes the whole (N, band+R, W, 7) image, reference band
//   included, in one launch. It computes coverage, the row colors, the
//   LUT lookups and the band as the WGS channels of `encode` in
//   deepvariant_tpu/make_examples/pileup_jax.py:583-656 do, where XLA
//   compiled them around no Pallas kernel.
//
// What a read-row pixel (n, r, w) gets, in channel order:
//   0 read_base              A=250 G=180 T=100 C=30, anything else 0
//   1 base_quality           254 * min(q, 40) / 40, truncated
//   2 mapping_quality        the row's mapq color
//   3 strand                 the row's strand color
//   4 read_supports_variant  the row's support color
//   5 base_differs_from_ref  50 where b == ref[n, w], else 254
//   6 insert_size            the row's tlen color
// and 0 in all seven where the pixel is not covered. A band pixel gets
// the base color of ref[n, w], then six constant band colors.
//
// Exactness. The file is built without --use_fast_math, so divisions are
// IEEE. The quality color keeps the Pallas kernel's float order
// (254*min(q,40)/40, then -> int32 -> uint8); a masked pixel is 0, which
// is what its float mask multiply gives. The rows form turns a row color
// into a byte the same way (float -> int32 -> uint8). The plan form's row
// colors follow the encoder's `scale`, 254*(min(v,cap)/cap), and its
// 254*t/1000 for tlen, and convert float -> uint8 as XLA does: truncate
// and saturate at 0 and 255. abs(tlen) wraps in int32 as jnp.abs does,
// so tlen = -2**31 gives color 0. A support code indexes its table the
// JAX way: a negative code wraps once, then clamps to 0..2.
//
// Bound: device memory. Per pixel the rows form reads 3 bytes (b, q,
// covered) and writes 7; the plan form reads 2 (b, q) and writes 7 for
// each read-row pixel and 7 for each band pixel. Row scalars are 16 B a
// row (rows form) or 8 B (plan form), the reference 1 B a column. At the
// main path's shapes (N=512, R=95, band 5, W=221) the rows form moves
// 108.4 MB, 32.4 us at 3.35 TB/s; the plan form 21.5 MB of bases and
// quals, 0.39 MB of row scalars, 0.11 MB of reference and 79.2 MB of
// image, 101.2 MB or 30.2 us. There are a few dozen integer operations a
// pixel, against about a hundred the card can spend at that rate.
//
// Design. Stores are 70-78% of the bytes, and nothing is aligned: a pixel
// is 7 bytes, a row 7W, a candidate 7HW. So the kernel tiles the flat
// output, not (candidate, row): a block owns 2048 consecutive pixels,
// whose 14,336 bytes start at a multiple of 16 (2048 * 7 = 896 * 16;
// torch.empty's base is aligned). Each thread paints groups of 4
// consecutive pixels, 28 bytes = 7 words, into the block's tile in shared
// memory (word 7g + k of group g: 7 is odd, so a warp's stores hit 32
// banks), then the block writes the tile out as 16-byte stores with
// neighbouring lanes on neighbouring addresses; only the image's last
// tile has a byte tail. Index math: each group divides its first pixel
// by W and H once and steps (n, h, w) and the input offset pixel by
// pixel. The input offset is the count of read-row pixels before the
// pixel, so it only grows by one on each read-row pixel: the band rows
// shift nothing. Each block first fills small tables in shared memory:
// the 256 base colors and the 256 quality colors (a lookup instead of a
// select chain and an IEEE division per pixel), and the packed colors and
// coverage gate of every row its tile touches (at most 2047/W + 2 rows),
// so each row's scalars are read once per tile. Inputs are read a byte a
// lane by the groups themselves: lanes 4 bytes apart cover 128 contiguous
// bytes per warp instruction, which L1 serves. The grid is one block per
// tile, 5,525 blocks of 256 threads at the main shape; the launch bounds
// hold a thread to 32 registers so that 8 blocks fit on an SM.
//
// Measured on the H100 (PERF.md): the rows form at about two thirds of
// its bound, the plan form at about three fifths. Loading the pixels
// before the tables' barrier, one or four groups a thread, streaming
// stores and the reference staged in shared memory were each no faster.

#include <cstdint>

#include <cuda_runtime.h>

// The plan form's option-derived colors, by value. ops/pileup_paint.py
// mirrors this layout in ctypes (_PlanColorsC).
struct DvPlanColors {
  int32_t band;             // reference band height
  float mapq_cap;           // mapping_quality_cap
  uint8_t strand[2];        // positive, negative strand color
  uint8_t support[3];       // read_supports_variant table, codes 0..2
  uint8_t band_colors[6];   // the band's channels 1..6
};

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;            // pixels a thread paints at once
constexpr int kGroupsPerThread = 2;
constexpr int kTile = kThreads * kGroup * kGroupsPerThread;  // pixels
constexpr int kChannels = 7;
constexpr int kTileVecs = kTile * kChannels / 16;
static_assert(kTile % 16 == 0, "a tile must start on a 16-byte boundary");

__device__ __forceinline__ uint32_t base_color(uint32_t b) {
  return b == 'A' ? 250u : b == 'G' ? 180u : b == 'T' ? 100u
                 : b == 'C' ? 30u : 0u;
}

// float -> int32 -> uint8, truncating and wrapping as the Pallas kernel.
__device__ __forceinline__ uint32_t to_pixel(float value) {
  return static_cast<uint8_t>(static_cast<int32_t>(value));
}

// float -> uint8 as XLA converts: truncate, saturate, NaN -> 0.
__device__ __forceinline__ uint32_t saturate_u8(float value) {
  return static_cast<uint32_t>(fminf(fmaxf(value, 0.0f), 255.0f));
}

// One pixel's 7 channel bytes, little-endian in the low 56 bits.
// row_colors packs the row's mapq, strand, support and tlen colors;
// base_table holds base_color of every byte.
__device__ __forceinline__ uint64_t paint_pixel(
    bool band_row, uint32_t b, uint32_t qual_color, uint32_t ref,
    bool covered, uint32_t row_colors, uint64_t band_colors,
    const uint8_t* base_table) {
  if (band_row) return base_table[ref] | band_colors << 8;
  if (!covered) return 0;
  const uint64_t differs = b == ref ? 50u : 254u;
  return base_table[b] | qual_color << 8 |
         static_cast<uint64_t>(row_colors & 0xffffffu) << 16 |
         differs << 40 | static_cast<uint64_t>(row_colors >> 24) << 48;
}

// A row's packed colors and whether its pixels can be covered at all.
struct RowInfo {
  uint32_t colors;
  uint32_t valid;
};

struct RowsForm {
  const uint8_t* covered;
  const float* mapq;
  const float* strand;
  const float* support;
  const float* tlen;

  __device__ RowInfo row(uint32_t i) const {
    return {to_pixel(mapq[i]) | to_pixel(strand[i]) << 8 |
                to_pixel(support[i]) << 16 | to_pixel(tlen[i]) << 24,
            1u};
  }
  __device__ bool covers(uint32_t pix, uint32_t, uint32_t) const {
    return covered[pix] != 0;
  }
};

struct PlanForm {
  const uint8_t* mapq;
  const uint8_t* rev;
  const int32_t* tlen;
  const int8_t* support;
  const uint8_t* row_valid;
  DvPlanColors colors;

  __device__ RowInfo row(uint32_t i) const {
    const float cap = colors.mapq_cap;
    const uint32_t mapq_color =
        saturate_u8(254.0f * (fminf(static_cast<float>(mapq[i]), cap) /
                              cap));
    // Selects, not indexing: a kernel parameter indexed at run time
    // would be copied to local memory.
    const uint32_t strand_color =
        rev[i] != 0 ? colors.strand[1] : colors.strand[0];
    int s = support[i];
    s = s < 0 ? s + 3 : s;
    const uint32_t support_color = s <= 0   ? colors.support[0]
                                   : s == 1 ? colors.support[1]
                                            : colors.support[2];
    // jnp.abs wraps: abs(-2**31) is -2**31, whose color saturates to 0.
    const int32_t t = tlen[i];
    const int32_t a =
        t < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(t)) : t;
    const float tf = static_cast<float>(min(a, 1000));
    const uint32_t tlen_color = saturate_u8(254.0f * tf / 1000.0f);
    return {mapq_color | strand_color << 8 | support_color << 16 |
                tlen_color << 24,
            static_cast<uint32_t>(row_valid[i] != 0)};
  }
  __device__ bool covers(uint32_t, uint32_t b, uint32_t valid) const {
    return b != 0 && valid != 0;
  }
};

template <class Form>
__global__ void __launch_bounds__(kThreads, 8) paint_kernel(
    const uint8_t* __restrict__ bases, const uint8_t* __restrict__ quals,
    const uint8_t* __restrict__ ref, Form form, uint64_t band_colors,
    uint8_t* __restrict__ out, uint32_t rows, uint32_t band,
    uint32_t width, uint32_t total) {
  __shared__ uint4 tile[kTileVecs];
  __shared__ uint8_t qual_table[256];
  __shared__ uint8_t base_table[256];
  extern __shared__ RowInfo row_table[];

  const uint32_t height = band + rows;
  const uint32_t tile_start = blockIdx.x * kTile;
  const uint32_t tile_pixels = min(static_cast<uint32_t>(kTile),
                                   total - tile_start);
  const uint32_t first_row = tile_start / width;
  const uint32_t n_rows = (tile_start + tile_pixels - 1) / width -
                          first_row + 1;

  static_assert(kThreads == 256, "one table entry per thread");
  base_table[threadIdx.x] = base_color(threadIdx.x);
  qual_table[threadIdx.x] = to_pixel(
      254.0f * fminf(static_cast<float>(threadIdx.x), 40.0f) / 40.0f);
  for (uint32_t i = threadIdx.x; i < n_rows; i += kThreads) {
    const uint32_t flat = first_row + i;
    const uint32_t n = flat / height;
    const uint32_t h = flat - n * height;
    row_table[i] = h < band ? RowInfo{0u, 0u}
                            : form.row(n * rows + (h - band));
  }
  __syncthreads();

  uint32_t* words = reinterpret_cast<uint32_t*>(tile);
#pragma unroll
  for (int g = 0; g < kGroupsPerThread; ++g) {
    const uint32_t group = g * kThreads + threadIdx.x;
    const uint32_t local = group * kGroup;
    if (local >= tile_pixels) break;
    // Divide once per group, then step pixel by pixel.
    const uint32_t p = tile_start + local;
    const uint32_t flat = p / width;
    uint32_t w = p - flat * width;
    uint32_t n = flat / height;
    uint32_t h = flat - n * height;
    uint32_t row = flat - first_row;
    uint32_t pix = (n * rows + (h < band ? 0u : h - band)) * width +
                   (h < band ? 0u : w);
    uint64_t px[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      px[i] = 0;
      if (local + i < tile_pixels) {
        const uint32_t r = ref[n * width + w];
        const bool band_row = h < band;
        uint32_t b = 0, q = 0;
        bool covered = false;
        if (!band_row) {
          b = bases[pix];
          q = quals[pix];
          covered = form.covers(pix, b, row_table[row].valid);
          ++pix;
        }
        px[i] = paint_pixel(band_row, b, qual_table[q], r, covered,
                            row_table[row].colors, band_colors,
                            base_table);
      }
      if (++w == width) {
        w = 0;
        ++row;
        if (++h == height) {
          h = 0;
          ++n;
        }
      }
    }
    // 4 pixels = 28 bytes = 7 little-endian words.
    uint32_t* dst = words + group * kChannels;
    dst[0] = static_cast<uint32_t>(px[0]);
    dst[1] = static_cast<uint32_t>(px[0] >> 32) |
             static_cast<uint32_t>(px[1] << 24);
    dst[2] = static_cast<uint32_t>(px[1] >> 8);
    dst[3] = static_cast<uint32_t>(px[1] >> 40) |
             static_cast<uint32_t>(px[2] << 16);
    dst[4] = static_cast<uint32_t>(px[2] >> 16);
    dst[5] = static_cast<uint32_t>(px[2] >> 48) |
             static_cast<uint32_t>(px[3] << 8);
    dst[6] = static_cast<uint32_t>(px[3] >> 24);
  }
  __syncthreads();

  // The tile starts 16-byte aligned: whole 16-byte words, then the
  // image's byte tail (last tile only).
  uint8_t* tile_out = out + static_cast<size_t>(tile_start) * kChannels;
  const uint32_t bytes = tile_pixels * kChannels;
  const uint32_t vecs = bytes / 16;
  for (uint32_t i = threadIdx.x; i < vecs; i += kThreads) {
    reinterpret_cast<uint4*>(tile_out)[i] = tile[i];
  }
  const uint8_t* tile_bytes = reinterpret_cast<const uint8_t*>(tile);
  for (uint32_t i = vecs * 16 + threadIdx.x; i < bytes; i += kThreads) {
    tile_out[i] = tile_bytes[i];
  }
}

template <class Form>
int launch(const void* bases, const void* quals, const void* ref,
           const Form& form, uint64_t band_colors, void* out, int n,
           int rows, int band, int width, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * (band + rows) * width;
  if (n <= 0 || rows < 0 || band < 0 || width <= 0 ||
      total >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((total + kTile - 1) / kTile);
  const size_t row_bytes = ((kTile - 1) / width + 2) * sizeof(RowInfo);
  paint_kernel<Form><<<blocks, kThreads, row_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(quals),
      static_cast<const uint8_t*>(ref), form, band_colors,
      static_cast<uint8_t*>(out), rows, band, width,
      static_cast<uint32_t>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows form. Launches on `stream`; returns cudaGetLastError() (0 on
// success). The caller checks shapes, types and contiguity and allocates
// `out` (N, R, W, 7), 16-byte aligned.
extern "C" int dv_pileup_paint(const void* b, const void* q,
                               const void* covered, const void* ref,
                               const void* mapq_color,
                               const void* strand_color,
                               const void* support_color,
                               const void* tlen_color, void* out, int n,
                               int rows, int width, void* stream) {
  const RowsForm form{static_cast<const uint8_t*>(covered),
                      static_cast<const float*>(mapq_color),
                      static_cast<const float*>(strand_color),
                      static_cast<const float*>(support_color),
                      static_cast<const float*>(tlen_color)};
  return launch(b, q, ref, form, 0, out, n, rows, 0, width, stream);
}

// Plan form: the whole (N, band+R, W, 7) image. Same contract as above;
// `colors` is read on the host and passed to the kernel by value.
extern "C" int dv_pileup_paint_plan(
    const void* bases, const void* quals, const void* mapq, const void* rev,
    const void* tlen, const void* support, const void* row_valid,
    const void* ref, const DvPlanColors* colors, void* out, int n,
    int rows, int width, void* stream) {
  if (colors == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const PlanForm form{static_cast<const uint8_t*>(mapq),
                      static_cast<const uint8_t*>(rev),
                      static_cast<const int32_t*>(tlen),
                      static_cast<const int8_t*>(support),
                      static_cast<const uint8_t*>(row_valid), *colors};
  uint64_t band_colors = 0;
  for (int k = 5; k >= 0; --k) {
    band_colors = band_colors << 8 | colors->band_colors[k];
  }
  return launch(bases, quals, ref, form, band_colors, out, n, rows,
                colors->band, width, stream);
}
