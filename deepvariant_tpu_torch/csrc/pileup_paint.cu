// Pileup paint, hand-written for Hopper (sm_90a).
//
// One kernel template, two entry points:
//
// - rows form, `dv_pileup_paint`: replaces the TPU kernel `_paint_kernel`
//   of deepvariant_tpu/ops/pileup_paint.py (launched by `_paint_pileup`
//   through pl.pallas_call; math in `_channels_for_tile`). Takes b, q
//   (N,R,W) u8, covered (N,R,W) bool, ref (N,W) u8 and four (N,R) float32
//   row colors; writes the (N,R,W,7) read rows of the WGS channel set.
// - plan form, `dv_pileup_paint_plan`: what the device plan painter
//   launches. Takes the plan tensors as they come (bases, quals (N,R,W)
//   u8; mapq, af (N,R) u8; rev, supp, row_valid (N,R) bool; hp, support
//   (N,R) i8; tlen (N,R) i32; ref (N,W) u8; in diff mode alt_bases
//   (N,2,R,W) u8, alt_row_valid (N,2,R) bool, alt_ref (N,2,W) u8 and
//   alt_present (N,2) bool) and the option-derived colors, and writes the
//   whole (N, band+R, W, C) image, reference band included, in one
//   launch: any ordered list of the ten device channels, then the two
//   alt-aligned diff planes in diff mode, 1 <= C <= 12. It computes what
//   `encode` of make_longread_encode_fn in
//   deepvariant_tpu/make_examples/pileup_jax.py:576-675 does, where XLA
//   compiled it around no Pallas kernel.
//
// What a read-row pixel (n, r, w) gets, by the plane's kind:
//   read_base              the base color of b (A, G, T, C; else 0)
//   base_quality           min(q, cap) * (254 * (1 / cap)), truncated
//   base_differs_from_ref  match where b == ref[n, w], else mismatch
//   mapping_quality, strand, read_supports_variant, insert_size,
//   haplotype_tag, allele_frequency, supplementary_alignment
//                          the row's color of that kind
// and 0 in all of them where the pixel is not covered (b == 0 or the row
// is not valid). A band pixel gets the base color of ref[n, w] in a
// read_base plane and the plane's constant band color elsewhere. A diff
// plane k is match/mismatch of alt_bases[n, k] against alt_ref[n, k]
// where that alt row is valid and its base is not 0, match in the band,
// and 0 everywhere, band included, where alt_present[n, k] is false.
//
// Exactness. The file is built without --use_fast_math, so divisions are
// IEEE. The rows form keeps the Pallas kernel's float order for the
// quality color (254*min(q,40)/40, then -> int32 -> uint8) and turns a
// row color into a byte the same way. The plan form computes the
// encoder's `scale`, 254*(min(v,cap)/cap), for quality and mapq as XLA
// compiles it: the division by the constant cap becomes a multiply by
// its float32 reciprocal, and the two constants fold, so the color is
// min(v,cap) * s with s = 254 * (1/cap) rounded to float32 twice (for 30
// caps up to 255, 47 among them, that is not the IEEE quotient's byte;
// at the default 40 and 60 it is). The host passes s. The tlen color is
// 254*t/1000, and floats convert to uint8 as XLA does: truncate and
// saturate at 0 and 255. abs(tlen) wraps in int32 as jnp.abs does,
// so tlen = -2**31 gives color 0. A support code indexes its table the
// JAX way: a negative code wraps once, then clamps to 0..2. The hp color
// is a table over hp clamped to 0..3, filled by the host after the
// assembly-polishing swap.
//
// Bound: device memory. Per read-row pixel the rows form reads 3 bytes
// (b, q, covered), the plan form 2 (b, q) and 2 more in diff mode (the
// two alt bases); every pixel writes C bytes. Row scalars are 16 B a row
// (rows form) or 11 B (plan form, 13 B in diff mode), the reference 1 B
// a column (3 B in diff mode). At the WGS shape (N=512, R=95, band 5,
// W=221, C=7) the plan form moves about 101 MB, 30 us at 3.35 TB/s; at
// the long-read shape (W=147, C=10, diff mode) 28.6 MB of bases, quals
// and alt bases and a 75.3 MB image, about 105 MB or 31 us. There are a
// few dozen integer operations a pixel, against about a hundred the card
// can spend at that rate.
//
// Design. Stores are most of the bytes, and nothing is aligned: a pixel
// is C bytes, a row C*W, a candidate C*H*W. So the kernel tiles the flat
// output, not (candidate, row): a block owns 2048 consecutive pixels,
// whose 2048*C bytes start at a multiple of 16 for every C (torch.empty's
// base is aligned). Each thread paints groups of 4 consecutive pixels,
// 4*C bytes = C words, into the block's tile in shared memory, then the
// block writes the tile out as 16-byte stores with neighbouring lanes on
// neighbouring addresses; only the image's last tile has a byte tail. C
// is a template parameter, so the shifts that pack 4 pixels into C words
// are constants. (Word C*g + k of group g: for odd C a warp's stores hit
// 32 banks; for even C they conflict 2-way (C = 2, 6, 10), 4-way (4, 12)
// or 8-way (8).) The channel order is data: the host turns the ordered
// channel list into one byte mask per kind (0x01 in every byte of the
// pixel that holds a plane of that kind), and a pixel is
//   row_template + base*mask_base + quality*mask_quality + differs*mask_differs
// in ceil(C/4) words (the masks' bytes are disjoint, so + is |), where row_template holds the row's seven colors at
// their planes (color*mask again, once per row and tile). A repeated
// channel costs nothing extra. Index math: each group divides its first
// pixel by W and H once and steps (n, h, w) and the input offset pixel
// by pixel. The input offset is the count of read-row pixels before the
// pixel, so it only grows by one on each read-row pixel: the band rows
// shift nothing. Each block first fills small tables in shared memory:
// the 256 base colors and the 256 quality colors (a lookup instead of a
// select chain and an IEEE division per pixel), and the template and
// gates of every row its tile touches (at most 2047/W + 2 rows), so each
// row's scalars are read once per tile. Inputs are read a byte a lane by
// the groups themselves: lanes 4 bytes apart cover 128 contiguous bytes
// per warp instruction, which L1 serves. Nothing but the band test
// branches around a pixel's loads, so a group's loads are in flight
// together (with the loads inside the covered/uncovered branches the
// kernel was about a tenth slower). The grid is one block per tile; the launch bounds hold a thread to 32 registers (8
// blocks an SM) up to 7 planes without diff mode and to 48 (5 blocks)
// above, where 40 registers spilled.
//
// Measured on the H100: PERF.md.

#include <cstdint>

#include <cuda_runtime.h>

// A painted plane's kind: what fills it. The first three vary along a
// row, the next seven are one color a row. ops/pileup_paint.py has the
// same numbers (KIND_*). The diff planes have no kind: they are the last
// two planes in diff mode.
enum DvKind : int {
  kKindBase = 0,
  kKindQuality = 1,
  kKindDiffers = 2,
  kKindMapq = 3,
  kKindStrand = 4,
  kKindSupport = 5,
  kKindTlen = 6,
  kKindHp = 7,
  kKindAf = 8,
  kKindSupp = 9,
};
constexpr int kMaskKinds = 10;
constexpr int kMaxPlanes = 12;
constexpr int kMaxWords = kMaxPlanes / 4;

// The plan form's option-derived colors, by value. ops/pileup_paint.py
// mirrors this layout in ctypes (_PlanColorsC).
struct DvPlanColors {
  int32_t band;                      // reference band height
  int32_t planes;                    // C, the diff planes included
  int32_t diff;                      // 1: the last two planes are diff planes
  float qual_cap;                    // base_quality_cap
  float qual_scale;                  // 254 * (1 / qual_cap), in float32
  float mapq_cap;                    // mapping_quality_cap
  float mapq_scale;                  // 254 * (1 / mapq_cap), in float32
  uint8_t kinds[kMaxPlanes];         // DvKind of each painted plane
  uint8_t band_colors[kMaxPlanes];   // each plane's band color (read_base
                                     // and diff planes: not read)
  uint8_t base[4];                   // colors of A, G, T, C
  uint8_t strand[2];                 // positive, negative strand color
  uint8_t support[3];                // read_supports_variant, codes 0..2
  uint8_t supp[2];                   // supplementary_alignment false, true
  uint8_t hp[4];                     // haplotype_tag of hp <= 0, 1, 2, >= 3
  uint8_t match;                     // base_differs_from_ref and diff planes
  uint8_t mismatch;
};

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;            // pixels a thread paints at once
constexpr int kGroupsPerThread = 2;
constexpr int kTile = kThreads * kGroup * kGroupsPerThread;  // pixels
static_assert(kTile % 16 == 0, "a tile must start on a 16-byte boundary");

// float -> int32 -> uint8, truncating and wrapping as the Pallas kernel.
__device__ __forceinline__ uint32_t to_pixel(float value) {
  return static_cast<uint8_t>(static_cast<int32_t>(value));
}

// float -> uint8 as XLA converts: truncate, saturate, NaN -> 0.
__device__ __forceinline__ uint32_t saturate_u8(float value) {
  return static_cast<uint32_t>(fminf(fmaxf(value, 0.0f), 255.0f));
}

// What a tile knows of one image row: the row's constant planes at their
// bytes of the pixel, and its gates.
struct RowInfo {
  uint32_t tmpl[kMaxWords];
  uint32_t flags;
};
constexpr uint32_t kRowValid = 1u;   // the row's pixels can be covered
constexpr uint32_t kRowBand = 2u;    // a reference band row
constexpr uint32_t kRowAlt0 = 4u;    // alt 0's row is valid and present
constexpr uint32_t kRowAlt1 = 8u;

// One mask per kind: 0x01 in every byte of the pixel's words whose plane
// is of that kind.
struct KindMasks {
  uint32_t m[kMaskKinds][kMaxWords];
};

// The rows form: the 7 WGS planes in their fixed order
// (base, quality, mapq, strand, support, differs, tlen).
struct RowsForm {
  static constexpr int kPlanes = 7;
  static constexpr int kMinBlocks = 8;
  const uint8_t* covered;
  const float* mapq;
  const float* strand;
  const float* support;
  const float* tlen;

  __device__ uint32_t base_mask(int j) const { return j == 0 ? 1u : 0u; }
  __device__ uint32_t qual_mask(int j) const {
    return j == 0 ? 1u << 8 : 0u;
  }
  __device__ uint32_t differs_mask(int j) const {
    return j == 1 ? 1u << 8 : 0u;
  }
  __device__ uint32_t match() const { return 50u; }
  __device__ uint32_t mismatch() const { return 254u; }
  __device__ uint32_t base_color(uint32_t b) const {
    return b == 'A' ? 250u : b == 'G' ? 180u : b == 'T' ? 100u
                   : b == 'C' ? 30u : 0u;
  }
  __device__ uint32_t qual_color(uint32_t q) const {
    return to_pixel(254.0f * fminf(static_cast<float>(q), 40.0f) / 40.0f);
  }
  __device__ RowInfo band_row(uint32_t) const { return RowInfo{}; }
  __device__ RowInfo row(uint32_t i, uint32_t, uint32_t, uint32_t) const {
    RowInfo info{};
    info.tmpl[0] = to_pixel(mapq[i]) << 16 | to_pixel(strand[i]) << 24;
    info.tmpl[1] = to_pixel(support[i]) | to_pixel(tlen[i]) << 16;
    info.flags = kRowValid;
    return info;
  }
  __device__ bool covers(uint32_t pix, uint32_t, uint32_t) const {
    return covered[pix] != 0;
  }
  __device__ void alt_diff(uint32_t*, bool, uint32_t, uint32_t, uint32_t,
                           uint32_t, uint32_t, uint32_t) const {}
};

// The plan form: C planes in the order the masks encode.
template <int C, bool Diff>
struct PlanForm {
  static constexpr int kPlanes = C;
  static constexpr int kWords = (C + 3) / 4;
  // The diff planes are the last two: byte C-2 and byte C-1 of a pixel.
  static constexpr int kAlt0 = C >= 2 ? C - 2 : 0, kAlt1 = C - 1;
  static constexpr int kAltWord0 = kAlt0 / 4, kAltShift0 = kAlt0 % 4 * 8;
  static constexpr int kAltWord1 = kAlt1 / 4, kAltShift1 = kAlt1 % 4 * 8;
  // Registers: 32 a thread (8 blocks an SM) up to the 7 WGS planes, 48
  // (5 blocks) above and in diff mode.
  static constexpr int kMinBlocks = C <= 7 && !Diff ? 8 : 5;

  const uint8_t* mapq;
  const uint8_t* rev;
  const int8_t* hp;
  const int32_t* tlen;
  const uint8_t* supp;
  const int8_t* support;
  const uint8_t* af;
  const uint8_t* row_valid;
  const uint8_t* alt_bases;
  const uint8_t* alt_row_valid;
  const uint8_t* alt_ref;
  const uint8_t* alt_present;
  KindMasks masks;
  uint32_t band_tmpl[kMaxWords];
  DvPlanColors colors;

  __device__ uint32_t base_mask(int j) const { return masks.m[kKindBase][j]; }
  __device__ uint32_t qual_mask(int j) const {
    return masks.m[kKindQuality][j];
  }
  __device__ uint32_t differs_mask(int j) const {
    return masks.m[kKindDiffers][j];
  }
  __device__ uint32_t match() const { return colors.match; }
  __device__ uint32_t mismatch() const { return colors.mismatch; }
  // Selects, not indexing: a kernel parameter indexed at run time would
  // be copied to local memory.
  __device__ uint32_t base_color(uint32_t b) const {
    return b == 'A'   ? colors.base[0]
           : b == 'G' ? colors.base[1]
           : b == 'T' ? colors.base[2]
           : b == 'C' ? colors.base[3]
                      : 0u;
  }
  __device__ uint32_t qual_color(uint32_t q) const {
    return saturate_u8(fminf(static_cast<float>(q), colors.qual_cap) *
                       colors.qual_scale);
  }

  __device__ RowInfo band_row(uint32_t n) const {
    RowInfo info{};
#pragma unroll
    for (int j = 0; j < kWords; ++j) info.tmpl[j] = band_tmpl[j];
    info.flags = kRowValid | kRowBand;
    if (Diff) {
      // The band of a diff plane is the match color where the alt is
      // present, 0 where it is not.
      const uint32_t m = colors.match;
      if (alt_present[2 * n] != 0) info.tmpl[kAltWord0] |= m << kAltShift0;
      if (alt_present[2 * n + 1] != 0) {
        info.tmpl[kAltWord1] |= m << kAltShift1;
      }
    }
    return info;
  }

  // Row i = n * rows + r of the plan.
  __device__ RowInfo row(uint32_t i, uint32_t n, uint32_t r,
                         uint32_t rows) const {
    uint32_t c[kMaskKinds];
    c[kKindMapq] = saturate_u8(
        fminf(static_cast<float>(mapq[i]), colors.mapq_cap) *
        colors.mapq_scale);
    c[kKindStrand] = rev[i] != 0 ? colors.strand[1] : colors.strand[0];
    int s = support[i];
    s = s < 0 ? s + 3 : s;
    c[kKindSupport] = s <= 0   ? colors.support[0]
                      : s == 1 ? colors.support[1]
                               : colors.support[2];
    // jnp.abs wraps: abs(-2**31) is -2**31, whose color saturates to 0.
    const int32_t t = tlen[i];
    const int32_t a =
        t < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(t)) : t;
    const float tf = static_cast<float>(min(a, 1000));
    c[kKindTlen] = saturate_u8(254.0f * tf / 1000.0f);
    const int h = hp[i];
    c[kKindHp] = h <= 0   ? colors.hp[0]
                 : h == 1 ? colors.hp[1]
                 : h == 2 ? colors.hp[2]
                          : colors.hp[3];
    c[kKindAf] = af[i];
    c[kKindSupp] = supp[i] != 0 ? colors.supp[1] : colors.supp[0];
    RowInfo info{};
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = kKindMapq; k < kMaskKinds; ++k) {
        word |= c[k] * masks.m[k][j];
      }
      info.tmpl[j] = word;
    }
    info.flags = row_valid[i] != 0 ? kRowValid : 0u;
    if (Diff) {
      const uint32_t a0 = (2 * n) * rows + r;
      if (alt_present[2 * n] != 0 && alt_row_valid[a0] != 0) {
        info.flags |= kRowAlt0;
      }
      if (alt_present[2 * n + 1] != 0 && alt_row_valid[a0 + rows] != 0) {
        info.flags |= kRowAlt1;
      }
    }
    return info;
  }

  __device__ bool covers(uint32_t, uint32_t b, uint32_t flags) const {
    return b != 0 && (flags & kRowValid) != 0;
  }

  // ORs the two diff planes of read-row pixel `pix` = (n, r, w) into the
  // pixel's words. `rw` is rows * width.
  __device__ void alt_diff(uint32_t* pw, bool band_row, uint32_t pix,
                           uint32_t n, uint32_t w, uint32_t width,
                           uint32_t rw, uint32_t flags) const {
    if (!Diff) return;
    // A band row has neither gate set, and its loads are skipped.
    const uint32_t at = pix + n * rw;   // alt_bases[n, 0, r, w]
    uint32_t a0 = 0, a1 = 0;
    if (!band_row) {
      a0 = alt_bases[at];
      a1 = alt_bases[at + rw];
    }
    const uint32_t r0 = alt_ref[2 * n * width + w];
    const uint32_t r1 = alt_ref[(2 * n + 1) * width + w];
    const uint32_t m = colors.match, mm = colors.mismatch;
    const uint32_t d0 = a0 != 0 && (flags & kRowAlt0) != 0
                            ? (a0 == r0 ? m : mm) : 0u;
    const uint32_t d1 = a1 != 0 && (flags & kRowAlt1) != 0
                            ? (a1 == r1 ? m : mm) : 0u;
    pw[kAltWord0] |= d0 << kAltShift0;
    pw[kAltWord1] |= d1 << kAltShift1;
  }
};

template <class Form>
__global__ void __launch_bounds__(kThreads, Form::kMinBlocks) paint_kernel(
    const uint8_t* __restrict__ bases, const uint8_t* __restrict__ quals,
    const uint8_t* __restrict__ ref, const Form form,
    uint8_t* __restrict__ out, uint32_t rows, uint32_t band,
    uint32_t width, uint32_t total) {
  constexpr int C = Form::kPlanes;
  constexpr int kWords = (C + 3) / 4;      // words of one pixel
  constexpr int kTileVecs = kTile * C / 16;
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
  base_table[threadIdx.x] = form.base_color(threadIdx.x);
  qual_table[threadIdx.x] = form.qual_color(threadIdx.x);
  for (uint32_t i = threadIdx.x; i < n_rows; i += kThreads) {
    const uint32_t flat = first_row + i;
    const uint32_t n = flat / height;
    const uint32_t h = flat - n * height;
    row_table[i] = h < band ? form.band_row(n)
                            : form.row(n * rows + (h - band), n, h - band,
                                       rows);
  }
  __syncthreads();

  const uint32_t rw = rows * width;
  const uint32_t match = form.match(), mismatch = form.mismatch();
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
    uint32_t packed[C];
#pragma unroll
    for (int j = 0; j < C; ++j) packed[j] = 0;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      uint32_t pw[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) pw[j] = 0;
      if (local + i < tile_pixels) {
        // No branch around the loads but the band's: the four pixels'
        // loads can then be in flight together.
        const uint32_t r = ref[n * width + w];
        const RowInfo info = row_table[row];
        const bool band_row = (info.flags & kRowBand) != 0;
        uint32_t b = 0, q = 0;
        bool on = true;
        if (!band_row) {
          b = bases[pix];
          q = quals[pix];
          on = form.covers(pix, b, info.flags);
        }
        const uint32_t base = base_table[band_row ? r : b];
        const uint32_t quality = band_row ? 0u : qual_table[q];
        const uint32_t differs = band_row ? 0u : b == r ? match : mismatch;
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          // The masks' bytes are disjoint, so + is | and each term is one
          // multiply-add.
          const uint32_t word = info.tmpl[j] + base * form.base_mask(j) +
                                quality * form.qual_mask(j) +
                                differs * form.differs_mask(j);
          pw[j] = on ? word : 0u;
        }
        form.alt_diff(pw, band_row, pix, n, w, width, rw, info.flags);
        pix += band_row ? 0u : 1u;
      }
      // Pixel i of the group is bytes [i*C, (i+1)*C) of its C words; the
      // bytes of pw beyond C are 0.
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int byte = i * C + 4 * k;
        const int j = byte / 4;
        const int shift = byte % 4 * 8;
        if (j < C) {
          packed[j] |= pw[k] << shift;
          if (shift != 0 && j + 1 < C) packed[j + 1] |= pw[k] >> (32 - shift);
        }
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
    uint32_t* dst = words + group * C;
#pragma unroll
    for (int j = 0; j < C; ++j) dst[j] = packed[j];
  }
  __syncthreads();

  // The tile starts 16-byte aligned: whole 16-byte words, then the
  // image's byte tail (last tile only).
  uint8_t* tile_out = out + static_cast<size_t>(tile_start) * C;
  const uint32_t bytes = tile_pixels * C;
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
           const Form& form, void* out, int n, int rows, int band,
           int width, void* stream) {
  constexpr int C = Form::kPlanes;
  const int64_t total = static_cast<int64_t>(n) * (band + rows) * width;
  const size_t row_bytes = ((kTile - 1) / width + 2) * sizeof(RowInfo);
  // The kernel indexes pixels and the alt bases (twice the read-row
  // pixels, with C >= 3) in 32 bits.
  if (n <= 0 || rows < 0 || band < 0 || width <= 0 ||
      total * C >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Only a pileup a few columns wide has so many rows in a tile that the
  // static tile and the row table pass the default 48 KB together.
  if (row_bytes + kTile * C + 512 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paint_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(row_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = static_cast<int>((total + kTile - 1) / kTile);
  paint_kernel<Form><<<blocks, kThreads, row_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(quals),
      static_cast<const uint8_t*>(ref), form,
      static_cast<uint8_t*>(out), rows, band, width,
      static_cast<uint32_t>(total));
  return static_cast<int>(cudaGetLastError());
}

struct PlanArgs {
  const void *bases, *quals, *mapq, *rev, *hp, *tlen, *supp, *support, *af,
      *row_valid, *ref, *alt_bases, *alt_row_valid, *alt_ref, *alt_present;
  void* out;
  int n, rows, width;
  void* stream;
};

template <int C, bool Diff>
int launch_plan(const PlanArgs& a, const DvPlanColors& colors) {
  PlanForm<C, Diff> form{};
  form.mapq = static_cast<const uint8_t*>(a.mapq);
  form.rev = static_cast<const uint8_t*>(a.rev);
  form.hp = static_cast<const int8_t*>(a.hp);
  form.tlen = static_cast<const int32_t*>(a.tlen);
  form.supp = static_cast<const uint8_t*>(a.supp);
  form.support = static_cast<const int8_t*>(a.support);
  form.af = static_cast<const uint8_t*>(a.af);
  form.row_valid = static_cast<const uint8_t*>(a.row_valid);
  form.alt_bases = static_cast<const uint8_t*>(a.alt_bases);
  form.alt_row_valid = static_cast<const uint8_t*>(a.alt_row_valid);
  form.alt_ref = static_cast<const uint8_t*>(a.alt_ref);
  form.alt_present = static_cast<const uint8_t*>(a.alt_present);
  form.colors = colors;
  // Plane k is byte k of a pixel: byte k % 4 of word k / 4.
  const int painted = Diff ? C - 2 : C;
  for (int k = 0; k < painted; ++k) {
    const int kind = colors.kinds[k];
    if (kind < 0 || kind >= kMaskKinds) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    form.masks.m[kind][k / 4] |= 1u << (k % 4 * 8);
    if (kind != kKindBase) {
      form.band_tmpl[k / 4] |= static_cast<uint32_t>(colors.band_colors[k])
                               << (k % 4 * 8);
    }
  }
  return launch(a.bases, a.quals, a.ref, form, a.out, a.n, a.rows,
                colors.band, a.width, a.stream);
}

template <int C>
int launch_plan_planes(const PlanArgs& a, const DvPlanColors& colors) {
  if (colors.diff == 0) return launch_plan<C, false>(a, colors);
  if constexpr (C >= 3) {
    if (a.alt_bases == nullptr || a.alt_row_valid == nullptr ||
        a.alt_ref == nullptr || a.alt_present == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_plan<C, true>(a, colors);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  return launch(b, q, ref, form, out, n, rows, 0, width, stream);
}

// Plan form: the whole (N, band+R, W, colors->planes) image. Same
// contract as above; the tensors come in the plan's key order, the four
// alt tensors may be null unless colors->diff is set, and `colors` is
// read on the host and passed to the kernel by value.
extern "C" int dv_pileup_paint_plan(
    const void* bases, const void* quals, const void* mapq, const void* rev,
    const void* hp, const void* tlen, const void* supp, const void* support,
    const void* af, const void* row_valid, const void* ref,
    const void* alt_bases, const void* alt_row_valid, const void* alt_ref,
    const void* alt_present, const DvPlanColors* colors, void* out, int n,
    int rows, int width, void* stream) {
  if (colors == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const PlanArgs a{bases, quals, mapq, rev, hp, tlen, supp, support, af,
                   row_valid, ref, alt_bases, alt_row_valid, alt_ref,
                   alt_present, out, n, rows, width, stream};
  switch (colors->planes) {
    case 1: return launch_plan_planes<1>(a, *colors);
    case 2: return launch_plan_planes<2>(a, *colors);
    case 3: return launch_plan_planes<3>(a, *colors);
    case 4: return launch_plan_planes<4>(a, *colors);
    case 5: return launch_plan_planes<5>(a, *colors);
    case 6: return launch_plan_planes<6>(a, *colors);
    case 7: return launch_plan_planes<7>(a, *colors);
    case 8: return launch_plan_planes<8>(a, *colors);
    case 9: return launch_plan_planes<9>(a, *colors);
    case 10: return launch_plan_planes<10>(a, *colors);
    case 11: return launch_plan_planes<11>(a, *colors);
    case 12: return launch_plan_planes<12>(a, *colors);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
