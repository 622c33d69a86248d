// The bloom pyramid for Hopper (sm_90a).
//
// Replaces the jax.numpy bloom chain of ash_tpu/ops/bloom.py:bloom_pyramid
// (:274), with _soft_threshold_cf (:235), _downsample_karis_cf (:175) and
// _upsample_tent_cf (:199), which XLA fuses into a few programs on the TPU;
// it is not a Pallas kernel. Two entries, one kernel each:
// - ash_bloom_down: level i -> level i + 1, the nine Karis-weighted taps
//   (weight / (1 + luma), the sums divided by the weights' sum). The first
//   launch reads the HDR frame and applies the soft threshold, so the
//   full-size thresholded level is never written;
// - ash_bloom_up: level i + 1 -> level i, the 9-tap tent / 16, plus level
//   i in the same launch. The last launch writes the (H, W, 3) bloom and
//   adds nothing; with no level built it reads the HDR frame through the
//   threshold, to a target of its own size.
// A pyramid of L levels is 2L launches (10 at 1080p with 5 mips), one when
// no level is built. Images are interleaved (h, w, 3) f32 throughout.
//
// Bit-exactness with the plain chain on the card
// (ash_tpu_torch/ops/bloom.py:bloom_pyramid, PyTorch's eager CUDA ops):
// - every product, sum and quotient is rounded on its own (__fmul_rn,
//   __fadd_rn, __fdiv_rn, __frcp_rn; the library is built with
//   --fmad=false), in the plain chain's order, tap by tap; a value that
//   two taps or two targets share is computed once only where it is the
//   same rounded operation on the same operands;
// - a Python float is an f32 operand: u + ox * dx adds the f32 of the
//   double ox * dx, computed here on the host in double;
// - a tensor divided by a CPU scalar is multiplied by the f32 reciprocal
//   (target_uv's / w, the threshold's / (4 knee + 1e-5), the tent's / 16);
//   weight / tensor is reciprocal(tensor) * weight (Tensor.__rtruediv__),
//   and __frcp_rn is that reciprocal, as __fdiv_rn(1, x) is;
// - torch.maximum, clamp and clamp_min propagate NaN, with fmaxf / fminf
//   otherwise, as ATen's CUDA kernels do;
// - floor, the int64 conversion and the index clamps as bilinear_planar.
// tests/test_torch_bloom_kernel.py's `cuda` probes pin these.
//
// What bounds it: the operations and the bytes, nearly alike. The function
// reads the (H, W, 3) frame once and writes the bloom once: 2 x 24.88 MB
// at 1080p, 0.0149 ms at 3.35 TB/s; with each level written and read back
// through device memory 91.1 MB, 0.0272 ms. Its f32 operations, every
// rounding kept, are about 1.08 G at 1080p with 5 mips counted as the
// plain chain does them (chip_smoke.py's OPS_BLOOM), 0.0161 ms at the f32
// peak; with --fmad=false no product and sum fuse, so the card's f32 units
// reach half that peak at most, and an IEEE division or reciprocal is a
// dozen instructions with a branch. Two launches carry most of the work:
// level 1's thresholding downsample (the frame in) and the last 2x tent
// (the bloom out). The design, which PERF.md section 6 measures launch by
// launch (chip_smoke.py --parent times each path against PR 15's kernels):
// - the thresholding 2x2-block downsample (the frame, even sides): a 32x8
//   block stages its source footprint, (2 * 8 + 2) x (2 * 32 + 2) texels,
//   in shared memory: each row's contiguous span read with 16-byte loads
//   (where the image is 16-byte aligned; scalar loads otherwise), then each
//   texel thresholded once and written out planar. A tap is the sum of two
//   half-lerps of two staged texels, and each such sum serves up to four
//   targets: the block computes each sum and its Karis reciprocal once (17
//   x 65 of them, threads walking columns so that each half-lerp is
//   computed once too), and each target's nine taps read them. What is
//   left: the threshold's division a frame texel, a reciprocal a sum and
//   three divisions a target, all IEEE;
// - the other 2x2-block downsamples (levels 2-3 at 1080p) read each
//   target's 4x4 footprint through L1, one thread a target in 64-thread
//   blocks: at 130k targets and below the staged tile's phases in series
//   cost more than the loads they share (0.0069 against 0.0055 ms at
//   480x270);
// - the exact 2x tent from 2^16 targets (levels 3-0 at 1080p): its nine
//   taps are bilinear samples at half-texel offsets, and every target's
//   taps fall on one grid of such samples, one sample a target: tap
//   (my, mx) of target (y, x) is the sample at (y + my - 1, x + mx - 1),
//   the x-lerp of source columns (x + mx - 1) >> 1 and one more, at 0.75
//   for odd columns and 0.25 for even ones, then the y-lerp likewise. A
//   256-thread block takes a 16x64 target tile: it stages its 12x36 source
//   texels, computes the x-lerps (12 x 68) and the y-lerps (20 x 68) once
//   each in shared memory; each thread sums four targets' taps into the
//   tile, which is written out row by row with 16-byte stores. A target
//   costs about 55 operations where a thread of its own computed 282;
// - the exact 2x tent below 2^16 targets (example 09's farm frame) samples
//   the same grid one thread a target, its 36 texels through L1;
// - the gathers (odd sources, and the tent to any other size: the levels
//   of 135x240 and below at 1080p) keep one thread a target texel, in
//   64-thread blocks so that their few thousand targets spread over more
//   SMs, the nine taps unrolled so that their loads are in flight together.
//   These and the launches at 480x270 and below are bound by launch
//   latency, a few microseconds each; they stay separate launches, which
//   the host issues one by one (ops/bloom_cuda.py converts their arguments
//   once, when the chain is planned).
// TMA and wgmma do not apply: there is no matrix product, and a tile's
// footprint is a few kilobytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// The gathers and the direct paths: one thread a target texel, 32x2 blocks.
constexpr int kGatherX = 32;
constexpr int kGatherY = 2;
// The staged 2x2-block downsample: one thread a target texel, 32x8 blocks,
// and the block's source footprint.
constexpr int kDownX = 32;
constexpr int kDownY = 8;
constexpr int kDownRows = 2 * kDownY + 2;
constexpr int kDownCols = 2 * kDownX + 2;
// A launch's path: the gather (odd sides, other sizes), or the 2x2 blocks
// or the exact 2x lerps, one thread a target from its own footprint
// ("direct") or a block's footprint staged in shared memory ("staged").
constexpr int kGatherPath = 0;
constexpr int kDirectPath = 1;
constexpr int kStagedPath = 2;
// Targets from which the 2x tent is staged. A smaller level fills the card
// with a wave of blocks or less, and there the staged tile's phases in
// series cost more than the loads they share; so do the 2x2 blocks' below
// the frame (PERF.md section 6 times both paths launch by launch).
constexpr long long kStagedUpMin = 1 << 16;
// The 2x tent: a 64x4 block takes a 16x64 target tile, four targets a
// thread (rows ty, ty + 4, ty + 8, ty + 12). Its source texels (rows Y0 - 2
// .. Y0 + 9, columns X0 - 2 .. X0 + 33 from the tile's origin / 2), their
// x-lerps at half-texel columns x0 - 3 .. x0 + 64, and the y-lerps of those
// at half-texel rows y0 - 3 .. y0 + 16.
constexpr int kUpX = 64;
constexpr int kUpY = 16;
constexpr int kUpThreadsY = kThreads / kUpX;
constexpr int kUpSrcRows = kUpY / 2 + 4;
constexpr int kUpSrcCols = kUpX / 2 + 4;
constexpr int kUpRows = kUpY + 4;
constexpr int kUpCols = kUpX + 4;

// The Python float constants of the plain chain, as f32 operands.
constexpr float kLumaR = static_cast<float>(0.2126);
constexpr float kLumaG = static_cast<float>(0.7152);
constexpr float kLumaB = static_cast<float>(0.0722);
constexpr float kBrightFloor = static_cast<float>(1e-5);

// Floats of a staged row's raw span of `cols` texels: 3 a texel, up to 3
// before the first for the 16-byte alignment, in whole float4s.
__host__ __device__ constexpr int raw_pitch(int cols) {
  return 4 * ((3 * cols + 6) / 4);
}

// _DOWN_TAPS in the plain chain's order: tap t's (ox, oy) and weight. A
// switch, not a table, so an unrolled loop folds it to constants.
__device__ __forceinline__ void down_tap(int t, int& ox, int& oy, float& w) {
  switch (t) {
    case 0: ox = 0; oy = 0; w = 0.25f; return;
    case 1: ox = -1; oy = -1; w = 0.0625f; return;
    case 2: ox = 1; oy = -1; w = 0.0625f; return;
    case 3: ox = -1; oy = 1; w = 0.0625f; return;
    case 4: ox = 1; oy = 1; w = 0.0625f; return;
    case 5: ox = -1; oy = 0; w = 0.125f; return;
    case 6: ox = 1; oy = 0; w = 0.125f; return;
    case 7: ox = 0; oy = -1; w = 0.125f; return;
    default: ox = 0; oy = 1; w = 0.125f; return;
  }
}

// The tent's taps in the plain chain's order, as (my, mx) in half source
// texels: the centre; (y-, x-), (y-, x+), (y+, x+), (y+, x-); x - 2, x + 2,
// y - 2, y + 2.
__device__ __forceinline__ void tent_tap(int t, int& my, int& mx) {
  switch (t) {
    case 0: my = 0; mx = 0; return;
    case 1: my = -1; mx = -1; return;
    case 2: my = -1; mx = 1; return;
    case 3: my = 1; mx = 1; return;
    case 4: my = 1; mx = -1; return;
    case 5: my = 0; mx = -2; return;
    case 6: my = 0; mx = 2; return;
    case 7: my = -2; mx = 0; return;
    default: my = 2; mx = 0; return;
  }
}

struct Rgb {
  float r, g, b;
};

// The soft threshold's f32 operands: threshold, knee, f32(2 knee) and the
// f32 reciprocal of f32(4 knee + 1e-5).
struct Threshold {
  float t, k, hi, inv;
};

// An image: interleaved (h, w, 3) f32.
struct Image {
  const float* p;
  int h, w;
};

// torch.maximum on the card: NaN from either side, else fmaxf.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ Rgb load(const Image& im, int y, int x) {
  const float* q = im.p + 3 * (static_cast<long long>(y) * im.w + x);
  return {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
}

// down[0] at one texel: the colour times _contribution of its brightness
// (the NaN-propagating max of the three channels).
__device__ __forceinline__ Rgb threshold(const Rgb c, const Threshold& th) {
  const float bright = nan_max(c.r, nan_max(c.g, c.b));
  float soft = __fadd_rn(__fsub_rn(bright, th.t), th.k);
  soft = soft != soft ? soft : fminf(fmaxf(soft, 0.0f), th.hi);
  soft = __fmul_rn(__fmul_rn(soft, soft), th.inv);
  const float contribution = nan_max(soft, __fsub_rn(bright, th.t));
  const float lower = bright != bright ? bright : fmaxf(bright, kBrightFloor);
  const float f = __fdiv_rn(contribution, lower);
  return {__fmul_rn(c.r, f), __fmul_rn(c.g, f), __fmul_rn(c.b, f)};
}

// A texel of the source, thresholded when the source is the HDR frame.
template <bool kThreshold>
__device__ __forceinline__ Rgb fetch(const Image& im, int y, int x,
                                     const Threshold& th) {
  const Rgb c = load(im, y, x);
  return kThreshold ? threshold(c, th) : c;
}

__device__ __forceinline__ float lerp(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ Rgb lerp(const Rgb& a, float wa, const Rgb& b,
                                    float wb) {
  return {lerp(a.r, wa, b.r, wb), lerp(a.g, wa, b.g, wb),
          lerp(a.b, wa, b.b, wb)};
}

__device__ __forceinline__ Rgb add(const Rgb& a, const Rgb& b) {
  return {__fadd_rn(a.r, b.r), __fadd_rn(a.g, b.g), __fadd_rn(a.b, b.b)};
}

__device__ __forceinline__ Rgb scale(const Rgb& a, float s) {
  return {__fmul_rn(a.r, s), __fmul_rn(a.g, s), __fmul_rn(a.b, s)};
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// Stage rows r0 .. r0 + kRows - 1 and columns c0 .. c0 + kCols - 1 of `im`,
// each clamped to the image, into `out`, planar [3][kRows][kCols], each
// texel thresholded once when kThreshold. Each row's span is first copied
// into `raw` (kRows rows of raw_pitch(kCols) floats, 16-byte aligned) with
// 16-byte loads from the float4 that holds its first float, or with scalar
// loads when the image is not 16-byte aligned. Ends with a barrier.
template <bool kThreshold, int kRows, int kCols>
__device__ __forceinline__ void stage(const Image& im, int r0, int c0,
                                      const Threshold& th, float* raw,
                                      float* out) {
  constexpr int kPitch = raw_pitch(kCols);
  constexpr int kChunks = kPitch / 4;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int lo = clampi(c0, im.w - 1), hi = clampi(c0 + kCols - 1, im.w - 1);
  const int n = 3 * im.h * im.w;  // sizes_ok: fits in an int
  const bool vec = (reinterpret_cast<uintptr_t>(im.p) & 15) == 0;
  for (int i = tid; i < kRows * kChunks; i += n_threads) {
    const int r = i / kChunks, k = i - r * kChunks;
    // The row's first float, and the float4 that holds it.
    const int first = 3 * (clampi(r0 + r, im.h - 1) * im.w + lo);
    const int f = (first & ~3) + 4 * k;
    if (f >= first + 3 * (hi - lo + 1)) continue;
    float* dst = raw + r * kPitch + 4 * k;
    if (vec && f <= n - 4) {
      *reinterpret_cast<float4*>(dst) =
          __ldg(reinterpret_cast<const float4*>(im.p + f));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (f + j < n) dst[j] = __ldg(im.p + f + j);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * kCols; i += n_threads) {
    const int r = i / kCols, c = i - r * kCols;
    const int first = 3 * (clampi(r0 + r, im.h - 1) * im.w + lo);
    const float* q = raw + r * kPitch + (first & 3) +
                     3 * (clampi(c0 + c, im.w - 1) - lo);
    Rgb t{q[0], q[1], q[2]};
    if (kThreshold) t = threshold(t, th);
    out[i] = t.r;
    out[kRows * kCols + i] = t.g;
    out[2 * kRows * kCols + i] = t.b;
  }
  __syncthreads();
}

// bilinear_planar at one (u, v): edge-clamped, the weights 1 - f and f.
template <bool kThreshold>
__device__ Rgb bilinear(const Image& im, float u, float v,
                        const Threshold& th) {
  const float px = __fsub_rn(__fmul_rn(u, static_cast<float>(im.w)), 0.5f);
  const float py = __fsub_rn(__fmul_rn(v, static_cast<float>(im.h)), 0.5f);
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const float fx = __fsub_rn(px, x0f);
  const float fy = __fsub_rn(py, y0f);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int xa = clampi(x0, im.w - 1), xb = clampi(x0 + 1, im.w - 1);
  const int ya = clampi(y0, im.h - 1), yb = clampi(y0 + 1, im.h - 1);
  const Rgb top = lerp(fetch<kThreshold>(im, ya, xa, th), gx,
                       fetch<kThreshold>(im, ya, xb, th), fx);
  const Rgb bot = lerp(fetch<kThreshold>(im, yb, xa, th), gx,
                       fetch<kThreshold>(im, yb, xb, th), fx);
  return lerp(top, gy, bot, fy);
}

// A target texel's centre: (i + 0.5) times the f32 reciprocal of n.
__device__ __forceinline__ float centre(int i, float inv_n) {
  return __fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), inv_n);
}

// The gather's per-launch operands: the target's reciprocal sides and the
// f32 tap offsets (down: ox / w for ox in -1..1 at index ox + 1; up:
// m * 0.5 / w for m in -2..2 at index m + 2), in u and in v.
struct Gather {
  float inv_w, inv_h;
  float du[5], dv[5];
};

// d[i] for i in 0..4 known only at run time, by selects: indexing the
// kernel's parameter array would copy it to local memory.
__device__ __forceinline__ float pick5(const float (&d)[5], int i) {
  return i == 0 ? d[0] : i == 1 ? d[1] : i == 2 ? d[2] : i == 3 ? d[3] : d[4];
}

struct DownArgs {
  Image src;
  float* dst;
  int dh, dw;
  Threshold th;
  Gather g;
};

// The Karis weight's reciprocal at one tap: reciprocal(1 + luma).
__device__ __forceinline__ float karis_rcp(const Rgb& s) {
  const float luma = __fadd_rn(
      __fadd_rn(__fmul_rn(s.r, kLumaR), __fmul_rn(s.g, kLumaG)),
      __fmul_rn(s.b, kLumaB));
  return __frcp_rn(__fadd_rn(luma, 1.0f));
}

// The Karis sum of one tap into (acc, wsum): weight / (1 + luma) is
// reciprocal(1 + luma) * weight, `rcp` that reciprocal.
__device__ __forceinline__ void karis(const Rgb& s, float rcp, float wgt,
                                      bool first, Rgb& acc, float& wsum) {
  const float kw = __fmul_rn(rcp, wgt);
  const Rgb t = scale(s, kw);
  if (first) {
    acc = t;
    wsum = kw;
  } else {
    acc = add(acc, t);
    wsum = __fadd_rn(wsum, kw);
  }
}

__device__ __forceinline__ void store_rgb(float* dst, int w, int y, int x,
                                          const Rgb& c) {
  float* out = dst + 3 * (static_cast<long long>(y) * w + x);
  out[0] = c.r;
  out[1] = c.g;
  out[2] = c.b;
}

// The thresholding 2x2-block downsample of an even frame: a 32x8 tile of
// targets from its staged footprint. Target (y, x) reads source rows 2y - 1 ..
// 2y + 2 and columns 2x - 1 .. 2x + 2, clamped: staged rows 2ty .. 2ty + 3 and
// columns 2tx .. 2tx + 3. Its tap (ox, oy) is the sum T of two half-lerps, at
// staged rows r = 2ty + oy + 1 and r + 1 of columns c = 2tx + ox + 1 and c +
// 1, scale(lerp(a, 0.5, b, 0.5), 0.5) each: a tap of up to four targets (a
// tile of 17 x 65 of them). Each T and its Karis reciprocal are computed once,
// by threads walking a column so that each half-lerp is computed once too, and
// every target's taps read them.
template <bool kThreshold>
__device__ __forceinline__ void down_blocks(const DownArgs& a) {
  constexpr int kPlane = kDownRows * kDownCols;
  constexpr int kTRows = kDownRows - 1, kTCols = kDownCols - 1;
  // T's columns in a row: the even ones, then the odd ones, so that the
  // threads of a warp read neighbouring words.
  constexpr int kTHalf = (kTCols + 1) / 2;
  constexpr int kTPlane = kTRows * 2 * kTHalf;
  // Row groups of the column walks: as many as the block's threads cover.
  constexpr int kWalks = kDownX * kDownY / kTCols;
  static_assert(kDownRows * raw_pitch(kDownCols) <= 4 * kTPlane,
                "the raw rows fit in T's space");
  static_assert(kWalks >= 1, "one column walk a thread");
  __shared__ __align__(16) float tile[3 * kPlane];
  // T's three planes, then the reciprocals; first the raw rows.
  __shared__ __align__(16) float sums[4 * kTPlane];
  const int x0 = blockIdx.x * kDownX, y0 = blockIdx.y * kDownY;
  const int tid = threadIdx.y * kDownX + threadIdx.x;
  stage<kThreshold, kDownRows, kDownCols>(a.src, 2 * y0 - 1, 2 * x0 - 1,
                                          a.th, sums, tile);
  auto half_lerp = [&](int r, int c) {
    const float* q = tile + r * kDownCols + c;
    return Rgb{__fmul_rn(lerp(q[0], 0.5f, q[1], 0.5f), 0.5f),
               __fmul_rn(lerp(q[kPlane], 0.5f, q[kPlane + 1], 0.5f), 0.5f),
               __fmul_rn(lerp(q[2 * kPlane], 0.5f, q[2 * kPlane + 1], 0.5f),
                         0.5f)};
  };
  auto t_index = [](int r, int c) {
    return r * 2 * kTHalf + (c & 1) * kTHalf + (c >> 1);
  };
  if (tid < kTCols * kWalks) {
    const int g = tid / kTCols, c = tid - g * kTCols;
    const int r_end = (g + 1) * kTRows / kWalks;
    int r = g * kTRows / kWalks;
    Rgb top = half_lerp(r, c);
    for (; r < r_end; ++r) {
      const Rgb bot = half_lerp(r + 1, c);
      const Rgb t = add(top, bot);
      const int j = t_index(r, c);
      sums[j] = t.r;
      sums[kTPlane + j] = t.g;
      sums[2 * kTPlane + j] = t.b;
      sums[3 * kTPlane + j] = karis_rcp(t);
      top = bot;
    }
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= a.dw || y >= a.dh) return;
  Rgb acc;
  float wsum;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    int ox, oy;
    float wgt;
    down_tap(t, ox, oy, wgt);
    const int j = t_index(2 * threadIdx.y + oy + 1, 2 * threadIdx.x + ox + 1);
    karis({sums[j], sums[kTPlane + j], sums[2 * kTPlane + j]},
          sums[3 * kTPlane + j], wgt, t == 0, acc, wsum);
  }
  store_rgb(a.dst, a.dw, y, x,
            {__fdiv_rn(acc.r, wsum), __fdiv_rn(acc.g, wsum),
             __fdiv_rn(acc.b, wsum)});
}

// The 2x2-block downsample of an even level below the frame: one thread a
// target from its own 4x4 footprint,
// source rows 2y - 1 .. 2y + 2 and columns 2x - 1 .. 2x + 2, clamped, read
// through L1. Tap (ox, oy) is the same sum T of two half-lerps as
// down_blocks', at footprint rows oy + 1, oy + 2 and columns ox + 1, ox + 2.
__device__ __forceinline__ void down_blocks_direct(const DownArgs& a) {
  const int x = blockIdx.x * kGatherX + threadIdx.x;
  const int y = blockIdx.y * kGatherY + threadIdx.y;
  if (x >= a.dw || y >= a.dh) return;
  Rgb f[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int sy = clampi(2 * y - 1 + r, a.src.h - 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      f[r][c] = load(a.src, sy, clampi(2 * x - 1 + c, a.src.w - 1));
    }
  }
  Rgb acc;
  float wsum;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    int ox, oy;
    float wgt;
    down_tap(t, ox, oy, wgt);
    const int r = oy + 1, c = ox + 1;
    const Rgb s = add(scale(lerp(f[r][c], 0.5f, f[r][c + 1], 0.5f), 0.5f),
                      scale(lerp(f[r + 1][c], 0.5f, f[r + 1][c + 1], 0.5f),
                            0.5f));
    karis(s, karis_rcp(s), wgt, t == 0, acc, wsum);
  }
  store_rgb(a.dst, a.dw, y, x,
            {__fdiv_rn(acc.r, wsum), __fdiv_rn(acc.g, wsum),
             __fdiv_rn(acc.b, wsum)});
}

// The gathered downsample (an odd side): one thread a target texel.
template <bool kThreshold>
__device__ __forceinline__ void down_gather(const DownArgs& a) {
  const int x = blockIdx.x * kGatherX + threadIdx.x;
  const int y = blockIdx.y * kGatherY + threadIdx.y;
  if (x >= a.dw || y >= a.dh) return;
  const float u = centre(x, a.g.inv_w);
  const float v = centre(y, a.g.inv_h);
  Rgb acc;
  float wsum;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    int ox, oy;
    float wgt;
    down_tap(t, ox, oy, wgt);
    const Rgb s = bilinear<kThreshold>(
        a.src, __fadd_rn(u, pick5(a.g.du, ox + 1)),
        __fadd_rn(v, pick5(a.g.dv, oy + 1)), a.th);
    karis(s, karis_rcp(s), wgt, t == 0, acc, wsum);
  }
  store_rgb(a.dst, a.dw, y, x,
            {__fdiv_rn(acc.r, wsum), __fdiv_rn(acc.g, wsum),
             __fdiv_rn(acc.b, wsum)});
}

template <int kPath, bool kThreshold>
__global__ void __launch_bounds__(kThreads)
    bloom_down_kernel(const DownArgs a) {
  if constexpr (kPath == kStagedPath) {
    down_blocks<kThreshold>(a);
  } else if constexpr (kPath == kDirectPath) {
    down_blocks_direct(a);
  } else {
    down_gather<kThreshold>(a);
  }
}

struct UpArgs {
  Image src;
  const float* addend;  // level i, or null
  float* dst;
  int dh, dw;
  Threshold th;
  Gather g;
};

// The tent's sum in the plain chain's order: c = centre * 4; c + (the four
// diagonal taps, left to right) * 2; c + (the four edge taps); / 16.0 (times
// the reciprocal 0.0625). `tap(my, mx)` is one channel's tap. The plain
// chain's last `* intensity` multiplies by 1.0, which changes no value.
template <typename Tap>
__device__ __forceinline__ float tent(Tap tap) {
  float c = __fmul_rn(tap(0, 0), 4.0f);
  float g = __fadd_rn(__fadd_rn(__fadd_rn(tap(-1, -1), tap(-1, 1)),
                                tap(1, 1)), tap(1, -1));
  c = __fadd_rn(c, __fmul_rn(g, 2.0f));
  g = __fadd_rn(__fadd_rn(__fadd_rn(tap(0, -2), tap(0, 2)), tap(-2, 0)),
                tap(2, 0));
  return __fmul_rn(__fadd_rn(c, g), 0.0625f);
}

// The exact 2x tent (_axis_up2 along x, then along y, for each tap): a
// 16x64 tile of targets. Tap (my, mx) of target (y, x) is the y-lerp at
// half-texel row y + my - 1 of the x-lerps at half-texel column
// x + mx - 1, where half-texel column g lerps source columns g >> 1 and
// (g >> 1) + 1 (clamped) with weights 0.25, 0.75 for odd g and 0.75, 0.25
// for even g: _UP_TAB's (shift, fraction) for every tap and parity.
__device__ __forceinline__ void up_double(const UpArgs& a) {
  constexpr int kSrcPlane = kUpSrcRows * kUpSrcCols;
  constexpr int kXPlane = kUpSrcRows * kUpCols;
  constexpr int kYPlane = kUpRows * kUpCols;
  constexpr int kOutRow = 3 * kUpX;  // a tile row's interleaved floats
  // src, then the x-lerps, then the y-lerps (first the raw rows); the
  // targets, interleaved, over src and the x-lerps once the y-lerps are in.
  static_assert(kUpSrcRows * raw_pitch(kUpSrcCols) <= 3 * kYPlane,
                "the raw rows fit in the y-lerps' space");
  static_assert(kUpY * kOutRow <= 3 * (kSrcPlane + kXPlane),
                "the targets fit in the source's and x-lerps' space");
  __shared__ __align__(16) float smem[3 * (kSrcPlane + kXPlane + kYPlane)];
  float* const src = smem;
  float* const xl = smem + 3 * kSrcPlane;
  float* const yl = xl + 3 * kXPlane;
  float* const out = smem;
  const int x0 = blockIdx.x * kUpX, y0 = blockIdx.y * kUpY;
  const int tid = threadIdx.y * kUpX + threadIdx.x;
  stage<false, kUpSrcRows, kUpSrcCols>(a.src, y0 / 2 - 2, x0 / 2 - 2, a.th,
                                       yl, src);
  // x-lerp k of staged row r: half-texel column x0 - 3 + k, from staged
  // columns (k + 1) >> 1 and one more.
  for (int i = tid; i < kXPlane; i += kThreads) {
    const int r = i / kUpCols, k = i - r * kUpCols;
    const int j = r * kUpSrcCols + ((k + 1) >> 1);
    const float f = (k & 1) ? 0.25f : 0.75f, g = (k & 1) ? 0.75f : 0.25f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* s = src + ch * kSrcPlane + j;
      xl[ch * kXPlane + i] = lerp(s[0], g, s[1], f);
    }
  }
  __syncthreads();
  // y-lerp (m, k): half-texel row y0 - 3 + m, from x-lerp rows (m + 1) >> 1
  // and one more.
  for (int i = tid; i < kYPlane; i += kThreads) {
    const int m = i / kUpCols, k = i - m * kUpCols;
    const int j = ((m + 1) >> 1) * kUpCols + k;
    const float f = (m & 1) ? 0.25f : 0.75f, g = (m & 1) ? 0.75f : 0.25f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* s = xl + ch * kXPlane + j;
      yl[ch * kYPlane + i] = lerp(s[0], g, s[kUpCols], f);
    }
  }
  __syncthreads();
  // Each thread's four targets' tents, into the tile.
#pragma unroll
  for (int q = 0; q < kUpY / kUpThreadsY; ++q) {
    const int ly = threadIdx.y + q * kUpThreadsY;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* centre_tap =
          yl + ch * kYPlane + (ly + 2) * kUpCols + threadIdx.x + 2;
      out[ly * kOutRow + 3 * threadIdx.x + ch] = tent([&](int my, int mx) {
        return centre_tap[my * kUpCols + mx];
      });
    }
  }
  __syncthreads();
  // The tile's rows, plus the addend, with 16-byte loads and stores where
  // the row starts on a float4 (x0 is a multiple of 64, so 3 * x0 is).
  const int n_row = 3 * (min(x0 + kUpX, a.dw) - x0);
  const bool vec = ((reinterpret_cast<uintptr_t>(a.dst) |
                     reinterpret_cast<uintptr_t>(a.addend)) & 15) == 0;
  for (int i = tid; i < kUpY * (kOutRow / 4); i += kThreads) {
    const int ly = i / (kOutRow / 4), k = 4 * (i - ly * (kOutRow / 4));
    const int y = y0 + ly;
    if (y >= a.dh || k >= n_row) continue;
    const int g = 3 * (y * a.dw + x0) + k;  // sizes_ok: fits in an int
    const float* v = out + ly * kOutRow + k;
    if (vec && (g & 3) == 0 && k + 4 <= n_row) {
      float4 c = *reinterpret_cast<const float4*>(v);
      if (a.addend != nullptr) {
        const float4 d = __ldg(reinterpret_cast<const float4*>(a.addend + g));
        c = make_float4(__fadd_rn(c.x, d.x), __fadd_rn(c.y, d.y),
                        __fadd_rn(c.z, d.z), __fadd_rn(c.w, d.w));
      }
      *reinterpret_cast<float4*>(a.dst + g) = c;
    } else {
      for (int j = 0; j < 4 && k + j < n_row; ++j) {
        a.dst[g + j] = a.addend != nullptr
            ? __fadd_rn(v[j], __ldg(a.addend + g + j)) : v[j];
      }
    }
  }
}

// The exact 2x tent of a small level (below kStagedUpMin targets): one
// thread a target, each of its nine taps the y-lerp of two x-lerps of its
// own four source texels, read through L1, as up_double's grid defines
// them: tap (my, mx) is the sample at half-texel row y + my - 1 and column
// x + mx - 1; half-texel index g lerps source texels g >> 1 and one more
// (clamped), weighing the first 0.75 for an even g and 0.25 for an odd one.
__device__ __forceinline__ void up_double_direct(const UpArgs& a) {
  const int x = blockIdx.x * kGatherX + threadIdx.x;
  const int y = blockIdx.y * kGatherY + threadIdx.y;
  if (x >= a.dw || y >= a.dh) return;
  Rgb taps[5][5];  // by (my + 2, mx + 2); the nine taps only
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    int my, mx;
    tent_tap(t, my, mx);
    const int m = y + my - 1, g = x + mx - 1;
    const float fy = (m & 1) ? 0.25f : 0.75f, fx = (g & 1) ? 0.25f : 0.75f;
    const int ya = clampi(m >> 1, a.src.h - 1);
    const int yb = clampi((m >> 1) + 1, a.src.h - 1);
    const int xa = clampi(g >> 1, a.src.w - 1);
    const int xb = clampi((g >> 1) + 1, a.src.w - 1);
    const Rgb top = lerp(load(a.src, ya, xa), fx, load(a.src, ya, xb),
                         1.0f - fx);
    const Rgb bot = lerp(load(a.src, yb, xa), fx, load(a.src, yb, xb),
                         1.0f - fx);
    taps[my + 2][mx + 2] = lerp(top, fy, bot, 1.0f - fy);
  }
  Rgb c = {tent([&](int my, int mx) { return taps[my + 2][mx + 2].r; }),
           tent([&](int my, int mx) { return taps[my + 2][mx + 2].g; }),
           tent([&](int my, int mx) { return taps[my + 2][mx + 2].b; })};
  const long long i = 3 * (static_cast<long long>(y) * a.dw + x);
  if (a.addend != nullptr) {
    c = add(c, {__ldg(a.addend + i), __ldg(a.addend + i + 1),
                __ldg(a.addend + i + 2)});
  }
  a.dst[i] = c.r;
  a.dst[i + 1] = c.g;
  a.dst[i + 2] = c.b;
}

// The gathered tent (any other target size): one thread a target texel,
// each tap bilinear at (u, v) plus its offset.
template <bool kThreshold>
__device__ __forceinline__ void up_gather(const UpArgs& a) {
  const int x = blockIdx.x * kGatherX + threadIdx.x;
  const int y = blockIdx.y * kGatherY + threadIdx.y;
  if (x >= a.dw || y >= a.dh) return;
  // The centre tap's u + 0 is u, as the plain chain's bilinear(src, u, v).
  const float u = centre(x, a.g.inv_w);
  const float v = centre(y, a.g.inv_h);
  Rgb c, group;
  auto tap = [&](int t) {
    int my, mx;
    tent_tap(t, my, mx);
    const Rgb s = bilinear<kThreshold>(
        a.src, __fadd_rn(u, pick5(a.g.du, mx + 2)),
        __fadd_rn(v, pick5(a.g.dv, my + 2)), a.th);
    // tent()'s sum, tap by tap in tent_tap's order.
    if (t == 0) {
      c = scale(s, 4.0f);
    } else if (t == 1 || t == 5) {
      group = s;
    } else {
      group = add(group, s);
    }
    if (t == 4) c = add(c, scale(group, 2.0f));
    if (t == 8) c = add(c, group);
  };
  // Unrolled, the nine taps' loads are in flight together; the thresholding
  // gather (the frame to its own size, with no level) stays rolled, where
  // unrolling spilled.
  if constexpr (kThreshold) {
#pragma unroll 1
    for (int t = 0; t < 9; ++t) tap(t);
  } else {
#pragma unroll
    for (int t = 0; t < 9; ++t) tap(t);
  }
  c = scale(c, 0.0625f);
  const long long i = 3 * (static_cast<long long>(y) * a.dw + x);
  if (a.addend != nullptr) {
    c = add(c, {__ldg(a.addend + i), __ldg(a.addend + i + 1),
                __ldg(a.addend + i + 2)});
  }
  a.dst[i] = c.r;
  a.dst[i + 1] = c.g;
  a.dst[i + 2] = c.b;
}

template <int kPath, bool kThreshold>
__global__ void __launch_bounds__(kThreads) bloom_up_kernel(const UpArgs a) {
  if constexpr (kPath == kStagedPath) {
    up_double(a);
  } else if constexpr (kPath == kDirectPath) {
    up_double_direct(a);
  } else {
    up_gather<kThreshold>(a);
  }
}

// The probe of tests/test_torch_bloom_kernel.py: __frcp_rn(x) and
// __fdiv_rn(1, x) for each x.
__global__ void bloom_probe_kernel(const float* x, int n, float* rcp,
                                   float* quot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rcp[i] = __frcp_rn(x[i]);
  quot[i] = __fdiv_rn(1.0f, x[i]);
}

// The gather's operands for a target of (dh, dw) over a source of (h, w):
// the f32 of the double offset `step * m / side` (step 1 for the
// downsample's whole texels, 0.5 for the tent's half texels).
Gather make_gather(int h, int w, int dh, int dw, double step, int m0) {
  Gather g;
  g.inv_w = 1.0f / static_cast<float>(dw);
  g.inv_h = 1.0f / static_cast<float>(dh);
  for (int i = 0; i < 5; ++i) {
    const int m = i + m0;
    g.du[i] = static_cast<float>(m * (step / w));
    g.dv[i] = static_cast<float>(m * (step / h));
  }
  return g;
}

dim3 grid_of(int dh, int dw, int bx, int by) {
  return dim3((dw + bx - 1) / bx, (dh + by - 1) / by);
}

bool sizes_ok(int h, int w, int dh, int dw) {
  return h > 0 && w > 0 && dh > 0 && dw > 0 &&
         static_cast<long long>(h) * w * 3 <= INT_MAX &&
         static_cast<long long>(dh) * dw * 3 <= INT_MAX;
}

}  // namespace

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// its launch (0 = success); the caller raises on anything else. Images are
// contiguous interleaved (rows, cols, 3) f32. `threshold_src` non-zero: the
// source is the HDR frame, read through the soft threshold with operands
// (t, k, hi, inv) = (f32 threshold, f32 knee, f32 of 2 knee, the f32
// reciprocal of the f32 of 4 knee + 1e-5).
//
// ash_bloom_down: src (h, w) -> dst (max(h / 2, 1), max(w / 2, 1)); even
// sides take the 2x2 blocks, others the gather.
extern "C" int ash_bloom_down(const float* src, int h, int w,
                              int threshold_src, float t, float k, float hi,
                              float inv, float* dst, int dh, int dw,
                              void* stream) {
  if (src == nullptr || dst == nullptr || !sizes_ok(h, w, dh, dw) ||
      dh != max(h / 2, 1) || dw != max(w / 2, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DownArgs a{Image{src, h, w}, dst, dh, dw,
                   Threshold{t, k, hi, inv},
                   make_gather(h, w, dh, dw, 1.0, -1)};
  const bool even = h % 2 == 0 && w % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks_grid = grid_of(dh, dw, kDownX, kDownY);
  const dim3 blocks_block(kDownX, kDownY);
  const dim3 gather_grid = grid_of(dh, dw, kGatherX, kGatherY);
  const dim3 gather_block(kGatherX, kGatherY);
  if (even && threshold_src) {
    bloom_down_kernel<kStagedPath, true>
        <<<blocks_grid, blocks_block, 0, s>>>(a);
  } else if (even) {
    bloom_down_kernel<kDirectPath, false>
        <<<gather_grid, gather_block, 0, s>>>(a);
  } else if (threshold_src) {
    bloom_down_kernel<kGatherPath, true>
        <<<gather_grid, gather_block, 0, s>>>(a);
  } else {
    bloom_down_kernel<kGatherPath, false>
        <<<gather_grid, gather_block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ash_bloom_up: src (h, w) -> dst (dh, dw) by the tent, plus `addend`
// (dh, dw) when it is not null. An exact 2x target takes the separable
// lerps, any other the gather; a thresholded source takes only the gather
// (it is the frame, to a target of its own size).
extern "C" int ash_bloom_up(const float* src, int h, int w,
                            int threshold_src, float t, float k, float hi,
                            float inv, const float* addend, float* dst,
                            int dh, int dw, void* stream) {
  const bool twice = dh == 2 * h && dw == 2 * w;
  if (src == nullptr || dst == nullptr || !sizes_ok(h, w, dh, dw) ||
      (twice && threshold_src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const UpArgs a{Image{src, h, w}, addend, dst, dh, dw,
                 Threshold{t, k, hi, inv},
                 make_gather(h, w, dh, dw, 0.5, -2)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 gather_grid = grid_of(dh, dw, kGatherX, kGatherY);
  const dim3 gather_block(kGatherX, kGatherY);
  if (twice && static_cast<long long>(dh) * dw >= kStagedUpMin) {
    bloom_up_kernel<kStagedPath, false><<<grid_of(dh, dw, kUpX, kUpY),
                                          dim3(kUpX, kUpThreadsY), 0, s>>>(a);
  } else if (twice) {
    bloom_up_kernel<kDirectPath, false>
        <<<gather_grid, gather_block, 0, s>>>(a);
  } else if (threshold_src) {
    bloom_up_kernel<kGatherPath, true><<<gather_grid, gather_block, 0, s>>>(a);
  } else {
    bloom_up_kernel<kGatherPath, false>
        <<<gather_grid, gather_block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ash_bloom_probe_rcp: rcp[i] = __frcp_rn(x[i]) and quot[i] =
// __fdiv_rn(1, x[i]) for i < n (the tests' probe of the reciprocal).
extern "C" int ash_bloom_probe_rcp(const float* x, int n, float* rcp,
                                   float* quot, void* stream) {
  if (x == nullptr || rcp == nullptr || quot == nullptr || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bloom_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, n, rcp, quot);
  return static_cast<int>(cudaGetLastError());
}
