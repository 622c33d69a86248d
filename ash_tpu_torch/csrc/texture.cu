// Anisotropic and trilinear texture sampling over the bindless pool, for
// Hopper (sm_90a).
//
// Replaces the jax.numpy sampler of ash_tpu/ops/shade.py:_sample_map (over
// ash_tpu/ops/texture_sample.py:sample_trilinear), which is not a TPU kernel:
// XLA fuses it there. The port ran it as eager PyTorch, tap by tap: about 70
// small full-frame ops per trilinear sample, 16 samples a map at anisotropy
// 16, five maps a frame. This kernel computes what
// ash_tpu_torch/ops/texture_sample.py:sample_footprint computes for a
// Footprint(lod, n_taps, major_uv), or sample_trilinear for a bare LOD, one
// thread per element:
//
// - each of the element's n_taps taps sits at
//   uv + major_uv * ((i + 0.5) / n_taps - 0.5); without n_taps there is one
//   tap at uv;
// - the LOD is clamped to [min_level, levels - 1] and split into two mip
//   levels l0 = floor(lod), l1 = min(l0 + 1, levels - 1) and a weight;
// - each level takes four REPEAT-wrapped bilinear fetches (torch.remainder's
//   floor modulo), each one 8-byte load of the bf16x4 texel widened to f32;
// - the taps are summed and the sum divided by n_taps;
// - a negative index is white (every tap is 1).
//
// Bit-exactness with the plain version: every product, sum and quotient is
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, and the
// library is built with --fmad=false) in the plain version's order, and
// (i + 0.5) / n_taps is the plain version's reciprocal times (i + 0.5)
// (Tensor.__rtruediv__). Float-to-int conversions saturate and send NaN to
// 0, as PyTorch's CUDA casts do; torch.maximum / minimum propagate NaN, and
// so do the LOD clamps here. A tap past an element's n_taps adds exactly 0
// in the plain version, so each element runs only its own taps and no
// shared trip count is needed. The mip table entries depend only on the
// element's LOD, so they are read once an element, not once a tap.
//
// Elements outside the mask (the G-buffer's uncovered pixels) are skipped
// and written 0: every caller discards them.
//
// What bounds it: the bytes, 45 an element it samples (29 in, 16 out), 17
// an element it skips, and the texels of the mip levels its elements select,
// against about 115 f32 operations a tap (two bilinear levels of 46, the
// trilinear blend, the tap position and the sum). The texel loads hit L1
// and L2: neighbouring threads (16x16 blocks over a screen; 256 in a row
// over a one-dimensional worklist) fetch neighbouring texels, and the whole
// pool of a scene fits in the 50 MB L2.

#include <climits>
#include <cuda_runtime.h>

namespace {

// A block covers a kTile x kTile tile of a (rows, cols) grid of elements,
// or kThreads elements of a single row (a worklist).
constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

struct Level {
  int off, w, h;
};

// One texel: 4 bf16 in 8 bytes, widened to f32 (bf16 is f32's high half).
__device__ __forceinline__ float4 texel(const uint2* __restrict__ texels,
                                        int flat) {
  const uint2 t = __ldg(texels + flat);
  return make_float4(__uint_as_float(t.x << 16),
                     __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16),
                     __uint_as_float(t.y & 0xffff0000u));
}

// torch.remainder on int32: the floor modulo, the divisor's sign.
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// int32 arithmetic that wraps, as PyTorch's does.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// torch.maximum / torch.minimum: NaN in either operand gives NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// `.to(torch.int32)` of floor(x) on the card: round toward zero, saturating,
// NaN to 0.
__device__ __forceinline__ int floor_to_int(float x) {
  return __float2int_rz(floorf(x));
}

// a * (1 - t) + b * t, each operation rounded on its own.
__device__ __forceinline__ float lerp(float a, float b, float one_minus_t,
                                      float t) {
  return __fadd_rn(__fmul_rn(a, one_minus_t), __fmul_rn(b, t));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float one_minus_t,
                                        float t) {
  return make_float4(lerp(a.x, b.x, one_minus_t, t),
                     lerp(a.y, b.y, one_minus_t, t),
                     lerp(a.z, b.z, one_minus_t, t),
                     lerp(a.w, b.w, one_minus_t, t));
}

// The REPEAT-addressed texel (xi, yi) of one level: texture_sample.py's
// `fetch`, its flat index clamped to the pool as there.
__device__ __forceinline__ float4 fetch(const uint2* __restrict__ texels,
                                        int last, const Level& l, int xi,
                                        int yi) {
  const int xw = l.w > 0 ? floor_mod(xi, max(l.w, 1)) : 0;
  const int yw = l.h > 0 ? floor_mod(yi, max(l.h, 1)) : 0;
  const int flat = wrap_add(wrap_add(l.off, wrap_mul(yw, l.w)), xw);
  return texel(texels, min(max(flat, 0), last));
}

// texture_sample.py:_bilinear_at_level at one element.
__device__ __forceinline__ float4 bilinear(const uint2* __restrict__ texels,
                                           int last, const Level& l, float u,
                                           float v) {
  const float px = __fsub_rn(__fmul_rn(u, static_cast<float>(l.w)), 0.5f);
  const float py = __fsub_rn(__fmul_rn(v, static_cast<float>(l.h)), 0.5f);
  const int x0 = floor_to_int(px);
  const int y0 = floor_to_int(py);
  const float fx = __fsub_rn(px, static_cast<float>(x0));
  const float fy = __fsub_rn(py, static_cast<float>(y0));
  const int x1 = wrap_add(x0, 1), y1 = wrap_add(y0, 1);
  const float gx = __fsub_rn(1.0f, fx);
  const float4 top = lerp4(fetch(texels, last, l, x0, y0),
                           fetch(texels, last, l, x1, y0), gx, fx);
  const float4 bot = lerp4(fetch(texels, last, l, x0, y1),
                           fetch(texels, last, l, x1, y1), gx, fx);
  return lerp4(top, bot, __fsub_rn(1.0f, fy), fy);
}

struct Pool {
  const uint2* texels;
  int last;  // texel count - 1
  const int* table;  // (n_tex, max_mips, 3): offset, width, height
  const int* levels;  // (n_tex,)
  const int* min_level;  // (n_tex,) or null
  int n_tex, max_mips;
};

__device__ __forceinline__ Level level_entry(const Pool& p, int tex, int lv) {
  const int* e = p.table + (static_cast<long long>(tex) * p.max_mips +
                            min(max(lv, 0), p.max_mips - 1)) * 3;
  return Level{__ldg(e), __ldg(e + 1), __ldg(e + 2)};
}

__global__ void __launch_bounds__(kThreads)
sample_kernel(Pool pool, const int* __restrict__ index,
              const float* __restrict__ uv, const float* __restrict__ lod,
              const float* __restrict__ n_taps,
              const float* __restrict__ major_uv,
              const unsigned char* __restrict__ mask,
              float4* __restrict__ out, int rows, int cols, int tiles_x) {
  const int tile = blockIdx.x;
  const int row = (tile / tiles_x) * blockDim.y + threadIdx.y;
  const int col = (tile % tiles_x) * blockDim.x + threadIdx.x;
  if (row >= rows || col >= cols) return;
  const long long e = static_cast<long long>(row) * cols + col;
  if (!mask[e]) {
    out[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const int idx = __ldg(index + e);
  const float u = __ldg(uv + 2 * e), v = __ldg(uv + 2 * e + 1);

  // The element's two levels: texture_sample.py:sample_trilinear.
  const int tex = min(max(idx, 0), pool.n_tex - 1);
  const int levels = __ldg(pool.levels + tex);
  const float max_level = static_cast<float>(levels - 1);
  const float floor_level =
      pool.min_level != nullptr
          ? static_cast<float>(__ldg(pool.min_level + tex)) : 0.0f;
  const float l = nan_min(
      nan_max(lod != nullptr ? __ldg(lod + e) : 0.0f, floor_level), max_level);
  const int l0 = floor_to_int(l);
  const int l1 = min(wrap_add(l0, 1), levels - 1);
  const float f = __fsub_rn(l, static_cast<float>(l0));
  const float g = __fsub_rn(1.0f, f);
  const Level lv0 = level_entry(pool, tex, l0);
  const Level lv1 = level_entry(pool, tex, l1);

  auto trilinear = [&](float tu, float tv) {
    if (idx < 0) return make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    return lerp4(bilinear(pool.texels, pool.last, lv0, tu, tv),
                 bilinear(pool.texels, pool.last, lv1, tu, tv), g, f);
  };

  if (n_taps == nullptr) {
    out[e] = trilinear(u, v);
    return;
  }
  // texture_sample.py:sample_footprint: the live taps only.
  const float n = __ldg(n_taps + e);
  const float mu = __ldg(major_uv + 2 * e), mv = __ldg(major_uv + 2 * e + 1);
  const float rcp = __fdiv_rn(1.0f, n);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = 0; static_cast<float>(i) < n; ++i) {
    const float frac = __fsub_rn(
        __fmul_rn(rcp, __fadd_rn(static_cast<float>(i), 0.5f)), 0.5f);
    const float4 tap = trilinear(__fadd_rn(u, __fmul_rn(mu, frac)),
                                 __fadd_rn(v, __fmul_rn(mv, frac)));
    acc = make_float4(__fadd_rn(acc.x, tap.x), __fadd_rn(acc.y, tap.y),
                      __fadd_rn(acc.z, tap.z), __fadd_rn(acc.w, tap.w));
  }
  out[e] = make_float4(__fdiv_rn(acc.x, n), __fdiv_rn(acc.y, n),
                       __fdiv_rn(acc.z, n), __fdiv_rn(acc.w, n));
}

}  // namespace

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = success); the caller raises on anything else.
//
// The pool: `texels` (num_texels, 4) bf16, 8-byte aligned; `table`
// (num_textures, max_mips, 3) int32; `levels` and `min_level` (num_textures,)
// int32, `min_level` null for a pool without residency. The elements, a
// (rows, cols) grid in row-major order: `index` int32, `uv` (.., 2) f32,
// `lod` f32 or null (LOD 0), `n_taps` f32 and `major_uv` (.., 2) f32, both
// null for one trilinear tap, `mask` bool, and `out` (.., 4) f32, 16-byte
// aligned.
extern "C" int ash_sample_footprint(
    const void* texels, int num_texels, const int* table, int num_textures,
    int max_mips, const int* levels, const int* min_level, const int* index,
    const float* uv, const float* lod, const float* n_taps,
    const float* major_uv, const unsigned char* mask, float* out, int rows,
    int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || num_texels <= 0 || num_textures <= 0 ||
      max_mips <= 0 || mask == nullptr ||
      (n_taps == nullptr) != (major_uv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block = rows == 1 ? dim3(kThreads, 1) : dim3(kTile, kTile);
  const int tiles_x = (cols + block.x - 1) / block.x;
  const long long blocks =
      static_cast<long long>((rows + block.y - 1) / block.y) * tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Pool pool{static_cast<const uint2*>(texels), num_texels - 1, table,
                  levels, min_level, num_textures, max_mips};
  sample_kernel<<<static_cast<int>(blocks), block, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      pool, index, uv, lod, n_taps, major_uv, mask,
      reinterpret_cast<float4*>(out), rows, cols, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
