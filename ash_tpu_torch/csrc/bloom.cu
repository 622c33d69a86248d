// The bloom pyramid for Hopper (sm_90a).
//
// Replaces the jax.numpy bloom chain of ash_tpu/ops/bloom.py:bloom_pyramid
// (:274), with _soft_threshold_cf (:235), _downsample_karis_cf (:175) and
// _upsample_tent_cf (:199), which XLA fuses into a few programs on the TPU;
// it is not a Pallas kernel. Two entries, one kernel each:
// - ash_bloom_down: level i -> level i + 1, one thread a target texel: the
//   nine Karis-weighted taps (weight / (1 + luma), the sums divided by the
//   weights' sum). A source of even sides takes the 0.5/0.5 lerps of
//   edge-clamped 2x2 blocks, read once as the texel's 4x4 footprint; a
//   source with an odd side the bilinear gather at u + ox * dx. The first
//   launch reads the HDR frame and applies the soft threshold to every
//   texel it reads, so the full-size thresholded level is never written;
// - ash_bloom_up: level i + 1 -> level i, one thread a target texel: the
//   9-tap tent / 16, plus level i in the same launch. An exact 2x target
//   takes the parity-fixed separable lerps, any other the gather. The last
//   launch writes the (H, W, 3) bloom and adds nothing; with no level built
//   it reads the HDR frame through the threshold, to a target of its own
//   size.
// A pyramid of L levels is 2L launches (10 at 1080p with 5 mips), one when
// no level is built. Images are interleaved (h, w, 3) f32 throughout.
//
// Bit-exactness with the plain chain on the card
// (ash_tpu_torch/ops/bloom.py:bloom_pyramid, PyTorch's eager CUDA ops):
// - every product, sum and quotient is rounded on its own (__fmul_rn,
//   __fadd_rn, __fdiv_rn; the library is built with --fmad=false), in the
//   plain chain's order, tap by tap;
// - a Python float is an f32 operand: u + ox * dx adds the f32 of the
//   double ox * dx, computed here on the host in double;
// - a tensor divided by a CPU scalar is multiplied by the f32 reciprocal
//   (target_uv's / w, the threshold's / (4 knee + 1e-5), the tent's / 16);
//   weight / tensor is reciprocal(tensor) * weight (Tensor.__rtruediv__);
// - torch.maximum, clamp and clamp_min propagate NaN, with fmaxf / fminf
//   otherwise, as ATen's CUDA kernels do;
// - floor, the int64 conversion and the index clamps as bilinear_planar.
// tests/test_torch_bloom_kernel.py's `cuda` probes pin these.
//
// What bounds it: the bytes and the operations, nearly alike. The function
// reads the (H, W, 3) frame once and writes the bloom once: 2 x 24.88 MB
// at 1080p, 0.0149 ms at 3.35 TB/s. With each level written and read back
// through device memory it is 91.1 MB, 0.0272 ms. Its f32 operations,
// every rounding kept, are about 1.08 G at 1080p with 5 mips (a few hundred
// a target texel: chip_smoke.py's OPS_BLOOM), 0.0161 ms at the f32 peak.
// Levels of 135x240 and below are bound by launch latency, not by either:
// a few thousand threads each. The eager chain instead ran about 3,200
// kernels at 1080p, most of them small. TMA and wgmma do not apply: each
// texel reads 16-36 taps of 12 bytes and there is no matrix product.
// Neighbouring threads read overlapping footprints, which L1 serves;
// staging a block's footprint in shared memory is left for later.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// The Python float constants of the plain chain, as f32 operands.
constexpr float kLumaR = static_cast<float>(0.2126);
constexpr float kLumaG = static_cast<float>(0.7152);
constexpr float kLumaB = static_cast<float>(0.0722);
constexpr float kBrightFloor = static_cast<float>(1e-5);

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

// _UP_TAB: for a tap offset m in half source texels (index m + 2) and the
// target's parity, the source shift s and fraction f of the axis lerp
// img[j + s] * (1 - f) + img[j + s + 1] * f.
__constant__ int kUpShift[5][2] = {{-2, -1}, {-1, -1}, {-1, 0}, {0, 0}, {0, 1}};
__constant__ float kUpFrac[5][2] = {{0.75f, 0.25f}, {0.25f, 0.75f},
                                    {0.75f, 0.25f}, {0.25f, 0.75f},
                                    {0.75f, 0.25f}};

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

// The Karis sum of one tap into (acc, wsum).
__device__ __forceinline__ void karis(const Rgb& s, float wgt, bool first,
                                      Rgb& acc, float& wsum) {
  const float luma = __fadd_rn(
      __fadd_rn(__fmul_rn(s.r, kLumaR), __fmul_rn(s.g, kLumaG)),
      __fmul_rn(s.b, kLumaB));
  const float kw = __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(luma, 1.0f)), wgt);
  const Rgb t = scale(s, kw);
  if (first) {
    acc = t;
    wsum = kw;
  } else {
    acc = add(acc, t);
    wsum = __fadd_rn(wsum, kw);
  }
}

template <bool kEven, bool kThreshold>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    bloom_down_kernel(const DownArgs a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.dw || y >= a.dh) return;
  Rgb acc;
  float wsum;
  if (kEven) {
    // The 4x4 footprint src[2y - 1 .. 2y + 2, 2x - 1 .. 2x + 2], clamped:
    // tap (ox, oy) lerps its rows oy + 1, oy + 2 and columns ox + 1, ox + 2.
    Rgb f[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int sy = clampi(2 * y - 1 + r, a.src.h - 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        f[r][c] = fetch<kThreshold>(a.src, sy, clampi(2 * x - 1 + c,
                                                      a.src.w - 1), a.th);
      }
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      int ox, oy;
      float wgt;
      down_tap(t, ox, oy, wgt);
      const int r = oy + 1, c = ox + 1;
      const Rgb top = scale(lerp(f[r][c], 0.5f, f[r][c + 1], 0.5f), 0.5f);
      const Rgb bot = scale(lerp(f[r + 1][c], 0.5f, f[r + 1][c + 1], 0.5f),
                            0.5f);
      karis(add(top, bot), wgt, t == 0, acc, wsum);
    }
  } else {
    const float u = centre(x, a.g.inv_w);
    const float v = centre(y, a.g.inv_h);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      int ox, oy;
      float wgt;
      down_tap(t, ox, oy, wgt);
      const Rgb s = bilinear<kThreshold>(
          a.src, __fadd_rn(u, pick5(a.g.du, ox + 1)),
          __fadd_rn(v, pick5(a.g.dv, oy + 1)), a.th);
      karis(s, wgt, t == 0, acc, wsum);
    }
  }
  float* out = a.dst + 3 * (static_cast<long long>(y) * a.dw + x);
  out[0] = __fdiv_rn(acc.r, wsum);
  out[1] = __fdiv_rn(acc.g, wsum);
  out[2] = __fdiv_rn(acc.b, wsum);
}

struct UpArgs {
  Image src;
  const float* addend;  // level i, or null
  float* dst;
  int dh, dw;
  Threshold th;
  Gather g;
};

// One tap of the 2x tent at half-source-texel offset (my, mx): the lerp
// along x (_axis_up2 on axis 2) at two source rows, then along y.
__device__ __forceinline__ Rgb up2_tap(const Image& im, int y, int x, int my,
                                       int mx) {
  const int sx = kUpShift[mx + 2][x & 1], sy = kUpShift[my + 2][y & 1];
  const float fx = kUpFrac[mx + 2][x & 1], fy = kUpFrac[my + 2][y & 1];
  const float gx = 1.0f - fx, gy = 1.0f - fy;  // exact: 0.25 or 0.75
  const int xa = clampi((x >> 1) + sx, im.w - 1);
  const int xb = clampi((x >> 1) + sx + 1, im.w - 1);
  const int ya = clampi((y >> 1) + sy, im.h - 1);
  const int yb = clampi((y >> 1) + sy + 1, im.h - 1);
  const Rgb top = lerp(load(im, ya, xa), gx, load(im, ya, xb), fx);
  const Rgb bot = lerp(load(im, yb, xa), gx, load(im, yb, xb), fx);
  return lerp(top, gy, bot, fy);
}

// Tent tap t at target texel (y, x), centre (u, v) for the gather.
template <bool kDouble, bool kThreshold>
__device__ __forceinline__ Rgb tent_sample(const UpArgs& a, int y, int x,
                                           float u, float v, int t) {
  int my, mx;
  tent_tap(t, my, mx);
  if (kDouble) return up2_tap(a.src, y, x, my, mx);
  return bilinear<kThreshold>(a.src, __fadd_rn(u, pick5(a.g.du, mx + 2)),
                              __fadd_rn(v, pick5(a.g.dv, my + 2)), a.th);
}

// The tent's sum in the plain chain's order: c = centre * 4; c + (the four
// diagonal taps, left to right) * 2; c + (the four edge taps).
__device__ __forceinline__ void tent_sum(int t, const Rgb& s, Rgb& c,
                                         Rgb& group) {
  if (t == 0) {
    c = scale(s, 4.0f);
  } else if (t == 1 || t == 5) {
    group = s;
  } else {
    group = add(group, s);
  }
  if (t == 4) c = add(c, scale(group, 2.0f));
  if (t == 8) c = add(c, group);
}

template <bool kDouble, bool kThreshold>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    bloom_up_kernel(const UpArgs a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.dw || y >= a.dh) return;
  Rgb c, group;
  if (kDouble) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      tent_sum(t, tent_sample<true, false>(a, y, x, 0.0f, 0.0f, t), c, group);
    }
  } else {
    // The centre tap's u + 0 is u, as the plain chain's bilinear(src, u, v).
    const float u = centre(x, a.g.inv_w);
    const float v = centre(y, a.g.inv_h);
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      tent_sum(t, tent_sample<false, kThreshold>(a, y, x, u, v, t), c, group);
    }
  }
  // / 16.0 (times the reciprocal 0.0625), then * intensity 1.0.
  c = scale(scale(c, 0.0625f), 1.0f);
  const long long i = 3 * (static_cast<long long>(y) * a.dw + x);
  if (a.addend != nullptr) {
    c = add(c, {__ldg(a.addend + i), __ldg(a.addend + i + 1),
                __ldg(a.addend + i + 2)});
  }
  a.dst[i] = c.r;
  a.dst[i + 1] = c.g;
  a.dst[i + 2] = c.b;
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

dim3 grid_of(int dh, int dw) {
  return dim3((dw + kBlockX - 1) / kBlockX, (dh + kBlockY - 1) / kBlockY);
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
  const dim3 grid = grid_of(dh, dw), block(kBlockX, kBlockY);
  if (even && threshold_src) {
    bloom_down_kernel<true, true><<<grid, block, 0, s>>>(a);
  } else if (even) {
    bloom_down_kernel<true, false><<<grid, block, 0, s>>>(a);
  } else if (threshold_src) {
    bloom_down_kernel<false, true><<<grid, block, 0, s>>>(a);
  } else {
    bloom_down_kernel<false, false><<<grid, block, 0, s>>>(a);
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
  const dim3 grid = grid_of(dh, dw), block(kBlockX, kBlockY);
  if (twice) {
    bloom_up_kernel<true, false><<<grid, block, 0, s>>>(a);
  } else if (threshold_src) {
    bloom_up_kernel<false, true><<<grid, block, 0, s>>>(a);
  } else {
    bloom_up_kernel<false, false><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
