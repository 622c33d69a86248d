// Anisotropic and trilinear texture sampling over the bindless pool, for
// Hopper (sm_90a).
//
// Replaces the jax.numpy sampler of ash_tpu/ops/shade.py:_sample_map (over
// ash_tpu/ops/texture_sample.py:sample_trilinear), which is not a TPU kernel:
// XLA fuses it there. Two entries:
//
// - ash_sample_maps: shade_pbr's five maps in one launch. For every covered
//   element and map it computes what ash_tpu_torch/ops/texture_sample.py's
//   sample_maps computes: the map's footprint (map_footprint: level 0's
//   size, the two axes' lengths, the tap count and the LOD) in registers,
//   then its anisotropic sample (sample_footprint);
// - ash_sample_trilinear: one trilinear tap at a given LOD (or LOD 0) per
//   element, texture_sample.py:sample_trilinear; the alpha test's sample.
//
// The sampler: each of an element's n_taps taps sits at
// uv + major_uv * ((i + 0.5) / n_taps - 0.5) (one tap at uv without
// anisotropy); the LOD is clamped to [min_level, levels - 1] and split into
// l0 = floor(lod), l1 = min(l0 + 1, levels - 1) and a weight; each level
// takes four REPEAT-wrapped bilinear fetches (torch.remainder's floor
// modulo), each one 8-byte load of the bf16x4 texel widened to f32; the taps
// are summed in order and the sum divided by n_taps; a negative index is
// white (every tap is 1).
//
// Bit-exactness with the plain version, found on the H100 (torch 2.11):
// - every product, sum and quotient is rounded on its own (__fmul_rn /
//   __fadd_rn / __fdiv_rn, and the library is built with --fmad=false) in
//   the plain version's order; (i + 0.5) / n_taps is the reciprocal times
//   (i + 0.5), as Tensor.__rtruediv__ computes it;
// - torch.linalg.vector_norm over a last dimension of 2 is
//   sqrt(rn(x0 * x0) + rn(x1 * x1)) on the card: its reduction puts each
//   square in its own lane (no fused multiply-add) and adds the two. Held on
//   about 2 million seeded pairs at 1080p's shape and others (zeros,
//   denormals, 1e-20, 1e20; tests/test_torch_texture_kernel.py), where a
//   fused order differs;
// - torch.log2 is libdevice's log2f, as here (which is not correctly
//   rounded); held by the footprint probe of the same test file;
// - float-to-int conversions saturate and send NaN to 0, as PyTorch's CUDA
//   casts do; torch.maximum / minimum, clamp and clamp_min propagate NaN,
//   and so do the clamps here (fmaxf does not);
// - a tap past an element's n_taps adds exactly 0 in the plain version, so
//   each element runs only its own taps, still summed in tap order.
//
// Elements outside the mask (the G-buffer's uncovered pixels) are skipped
// and written 0: every caller discards them.
//
// What bounds it: the bytes. The five maps of a covered element read 45
// bytes (mask 1, uv 8, the derivatives 16, five indices 20) and write 80; an
// uncovered element reads 1 and writes 80; the table entries and the mip
// levels the elements select are read once: about 198 MB in the 1080p
// textured frame, 0.059 ms at 3.35 TB/s. The operations, 115 f32
// operations an anisotropic tap and 26 a footprint, take a quarter of that
// at the f32 rate. What it spends its time on instead is the taps' integer
// and float work around 8 data-dependent 8-byte gathers each, 1 to 16 taps
// an item (2.26 on average in that frame), with 71% of the pixels
// uncovered. The design:
// - one block takes a 16x16 tile of pixels (256 along the row for a
//   one-row worklist); it compacts the tile's covered elements with
//   __ballot_sync / __popc into shared memory, staging their uv,
//   derivatives and indices, so the inputs are read once for all five maps
//   and no lane idles on the background;
// - the (element, map) items are dealt out map by map, so a warp's items
//   sample one texture at neighbouring pixels, whose tap counts tend to
//   agree;
// - REPEAT wrapping takes the low bits for a power-of-two width (every
//   level of a power-of-two texture) and the division otherwise, which is
//   20-odd instructions, 16 times a tap; what the division alone cost on the
//   card is not measured by a committed script;
// - one lane takes one item at a time and runs its taps in order. Lanes
//   sharing an item's taps (2, 4 or 8, added in tap order through
//   __shfl_sync) and two items a lane, their taps side by side, were timed
//   on the textured frame and were slower (PERF.md section 6): at 2.26 taps
//   an item the shared items leave lanes idle, and two items a lane take 80
//   registers and lower the occupancy;
// - the alpha test's single tap takes one thread an element over the same
//   tiles and shares the sampler's device functions, without the
//   compaction, whose barriers and staging round one tap does not repay
//   (PERF.md section 6);
// - texel loads stay __ldg: a scene's pool (14.7 MB in the textured frame)
//   fits in the 50 MB L2. TMA and wgmma do not apply: the loads are
//   data-dependent 8-byte gathers, not tiles, and there is no matrix
//   product.

#include <climits>
#include <cuda_runtime.h>

namespace {

// A block covers a kTile x kTile tile of a (rows, cols) grid of elements,
// or kThreads elements of a single row (a worklist).
constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
// shade_pbr's maps: base colour, normal, metallic-roughness, occlusion,
// emissive.
constexpr int kMaps = 5;
constexpr unsigned kFull = 0xffffffffu;

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

// torch.remainder(a, w) for a width w > 0. A power of two takes the low
// bits, which is the floor modulo of every int32 in two's complement; other
// widths take the division, 20-odd instructions, 16 times a tap.
__device__ __forceinline__ int wrap_coord(int a, int w) {
  return (w & (w - 1)) == 0 ? (a & (w - 1)) : floor_mod(a, w);
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

// Tensor.clamp_min / clamp with scalar bounds: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// torch.linalg.vector_norm of (x, y) on the card: both squares rounded, then
// their sum (see the note at the top).
__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
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

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The REPEAT-addressed texel (xi, yi) of one level: texture_sample.py's
// `fetch`, its flat index clamped to the pool as there.
__device__ __forceinline__ float4 fetch(const uint2* __restrict__ texels,
                                        int last, const Level& l, int xi,
                                        int yi) {
  const int xw = l.w > 0 ? wrap_coord(xi, l.w) : 0;
  const int yw = l.h > 0 ? wrap_coord(yi, l.h) : 0;
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

// An item's two mip levels and their weights: texture_sample.py:
// sample_trilinear's LOD clamp and split.
struct Mips {
  Level l0, l1;
  float f, g;  // the weight of l1, and 1 - f
};

__device__ __forceinline__ Mips mips(const Pool& pool, int tex, float lod) {
  const int levels = __ldg(pool.levels + tex);
  const float max_level = static_cast<float>(levels - 1);
  const float floor_level =
      pool.min_level != nullptr
          ? static_cast<float>(__ldg(pool.min_level + tex)) : 0.0f;
  const float l = nan_min(nan_max(lod, floor_level), max_level);
  const int l0 = floor_to_int(l);
  const int l1 = min(wrap_add(l0, 1), levels - 1);
  const float f = __fsub_rn(l, static_cast<float>(l0));
  return Mips{level_entry(pool, tex, l0), level_entry(pool, tex, l1), f,
              __fsub_rn(1.0f, f)};
}

__device__ __forceinline__ float4 trilinear(const Pool& pool, const Mips& m,
                                            int idx, float u, float v) {
  if (idx < 0) return make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  return lerp4(bilinear(pool.texels, pool.last, m.l0, u, v),
               bilinear(pool.texels, pool.last, m.l1, u, v), m.g, m.f);
}

// A map's footprint: ops/texture_sample.py:map_footprint, in its order.
struct Footprint {
  float lod;
  float n_taps;  // anisotropic only
  float mu, mv;  // the major axis in uv, anisotropic only
};

__device__ __forceinline__ Footprint footprint(const Pool& pool, int tex,
                                               float2 dx, float2 dy,
                                               int max_aniso) {
  const Level base = level_entry(pool, tex, 0);
  const float tw = static_cast<float>(base.w);
  const float th = static_cast<float>(base.h);
  const float lu = norm2(__fmul_rn(dx.x, tw), __fmul_rn(dx.y, th));
  const float lv = norm2(__fmul_rn(dy.x, tw), __fmul_rn(dy.y, th));
  const float rho_max = clamp_min(nan_max(lu, lv), 1e-8f);
  if (max_aniso <= 1) {
    return Footprint{clamp_min(log2f(rho_max), 0.0f), 1.0f, 0.0f, 0.0f};
  }
  const float rho_min = clamp_min(nan_min(lu, lv), 1e-8f);
  const float n = clamp(ceilf(__fdiv_rn(rho_max, rho_min)), 1.0f,
                        static_cast<float>(max_aniso));
  const bool major_u = lu >= lv;  // torch.where(lu >= lv, ddx, ddy)
  return Footprint{clamp_min(log2f(__fdiv_rn(rho_max, n)), 0.0f), n,
                   major_u ? dx.x : dy.x, major_u ? dx.y : dy.y};
}

struct Elements {
  const int* index;  // S x maps
  const float* uv;  // S x 2
  const float* ddx;  // S x 2, maps only
  const float* ddy;  // S x 2, maps only
  const float* lod;  // S or null, trilinear only
  const unsigned char* mask;  // S
  float4* out[kMaps];  // S each, one a map (the trilinear tap: out[0])
  int rows, cols, tile_h, tile_w, tiles_x;
  int max_aniso;  // maps only
};

// Thread t's element of a block: its row and column in a tile, in
// row-major order.
__device__ __forceinline__ int2 element_of(const Elements& a, int t) {
  return make_int2((blockIdx.x % a.tiles_x) * a.tile_w + t % a.tile_w,
                   (blockIdx.x / a.tiles_x) * a.tile_h + t / a.tile_w);
}

// A block's covered elements, compacted, and their inputs.
struct Stage {
  int elem[kThreads];
  int index[kMaps][kThreads];
  float2 uv[kThreads], dx[kThreads], dy[kThreads];
  int count[kWarps];
};

// One (element, map) item: its footprint, levels and live tap count.
struct Item {
  int m, p, idx, live;
  float u, v, rcp;
  Footprint fp;
  Mips mip;
};

// Item k < total * kMaps of a block whose compacted elements number
// `total`, map-major.
__device__ __forceinline__ Item item_at(const Pool& pool, const Stage& st,
                                        int max_aniso, int k, int total) {
  Item it;
  it.m = k / total;
  it.p = k - it.m * total;
  it.idx = st.index[it.m][it.p];
  it.u = st.uv[it.p].x;
  it.v = st.uv[it.p].y;
  const int tex = min(max(it.idx, 0), pool.n_tex - 1);
  it.fp = footprint(pool, tex, st.dx[it.p], st.dy[it.p], max_aniso);
  it.mip = mips(pool, tex, it.fp.lod);
  // The taps i with i < n_taps: ceil(n_taps) of them; none for NaN.
  it.live = max_aniso <= 1 ? 1
      : (it.fp.n_taps > 0.0f ? __float2int_ru(it.fp.n_taps) : 0);
  it.rcp = __fdiv_rn(1.0f, it.fp.n_taps);
  return it;
}

// Tap i of an item: texture_sample.py:sample_footprint's tap position.
__device__ __forceinline__ float4 tap_at(const Pool& pool, const Item& it,
                                         bool aniso, int i) {
  float tu = it.u, tv = it.v;
  if (aniso) {
    const float frac = __fsub_rn(
        __fmul_rn(it.rcp, __fadd_rn(static_cast<float>(i), 0.5f)), 0.5f);
    tu = __fadd_rn(it.u, __fmul_rn(it.fp.mu, frac));
    tv = __fadd_rn(it.v, __fmul_rn(it.fp.mv, frac));
  }
  return trilinear(pool, it.mip, it.idx, tu, tv);
}

// The five maps with their footprints (ash_sample_maps).
__global__ void __launch_bounds__(kThreads)
texture_maps_kernel(Pool pool, Elements a) {
  __shared__ Stage st;

  // 1. Compact the tile's covered elements, in row-major order, and stage
  // their inputs; write the uncovered ones' zeros.
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int2 rc = element_of(a, t);
  const bool inside = rc.y < a.rows && rc.x < a.cols;
  const long long e = static_cast<long long>(rc.y) * a.cols + rc.x;
  const bool covered = inside && a.mask[e];
  const unsigned ballot = __ballot_sync(kFull, covered);
  if (lane == 0) st.count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? st.count[w] : 0;
    total += st.count[w];
  }
  if (covered) {
    const int p = before + __popc(ballot & ((1u << lane) - 1u));
    st.elem[p] = static_cast<int>(e);
    for (int m = 0; m < kMaps; ++m) {
      st.index[m][p] = __ldg(a.index + e * kMaps + m);
    }
    st.uv[p] = make_float2(__ldg(a.uv + 2 * e), __ldg(a.uv + 2 * e + 1));
    st.dx[p] = make_float2(__ldg(a.ddx + 2 * e), __ldg(a.ddx + 2 * e + 1));
    st.dy[p] = make_float2(__ldg(a.ddy + 2 * e), __ldg(a.ddy + 2 * e + 1));
  } else if (inside) {
    for (int m = 0; m < kMaps; ++m) {
      a.out[m][e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();

  // 2. The items (element, map), map-major, so a warp's items sample one
  // texture at neighbouring pixels; each lane sums its item's taps in order.
  const bool aniso = a.max_aniso > 1;
  for (int k = t; k < total * kMaps; k += kThreads) {
    const Item it = item_at(pool, st, a.max_aniso, k, total);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < it.live; ++i) {
      const float4 tap = tap_at(pool, it, aniso, i);
      acc = aniso ? add4(acc, tap) : tap;
    }
    if (aniso) {
      acc = make_float4(__fdiv_rn(acc.x, it.fp.n_taps),
                        __fdiv_rn(acc.y, it.fp.n_taps),
                        __fdiv_rn(acc.z, it.fp.n_taps),
                        __fdiv_rn(acc.w, it.fp.n_taps));
    }
    a.out[it.m][st.elem[it.p]] = acc;
  }
}

// One trilinear tap (ash_sample_trilinear): one thread an element, without
// the compaction, whose barriers and staging a single tap does not repay.
__global__ void __launch_bounds__(kThreads)
texture_trilinear_kernel(Pool pool, Elements a) {
  const int2 rc = element_of(a, threadIdx.x);
  if (rc.y >= a.rows || rc.x >= a.cols) return;
  const long long e = static_cast<long long>(rc.y) * a.cols + rc.x;
  float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.mask[e]) {
    const int idx = __ldg(a.index + e);
    const int tex = min(max(idx, 0), pool.n_tex - 1);
    const float lod = a.lod != nullptr ? __ldg(a.lod + e) : 0.0f;
    out = trilinear(pool, mips(pool, tex, lod), idx, __ldg(a.uv + 2 * e),
                    __ldg(a.uv + 2 * e + 1));
  }
  a.out[0][e] = out;
}

// Checks the pool and the grid, and launches the maps' or the trilinear
// kernel.
int launch(const void* texels, int num_texels, const int* table,
           int num_textures, int max_mips, const int* levels,
           const int* min_level, Elements a, bool maps, void* stream) {
  if (a.rows <= 0 || a.cols <= 0 || num_texels <= 0 || num_textures <= 0 ||
      max_mips <= 0 || a.mask == nullptr || a.index == nullptr ||
      a.uv == nullptr || (maps && (a.ddx == nullptr || a.ddy == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int m = 0; m < (maps ? kMaps : 1); ++m) {
    if (a.out[m] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.tile_w = a.rows == 1 ? kThreads : kTile;
  a.tile_h = kThreads / a.tile_w;
  a.tiles_x = (a.cols + a.tile_w - 1) / a.tile_w;
  const long long blocks =
      static_cast<long long>((a.rows + a.tile_h - 1) / a.tile_h) * a.tiles_x;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Pool pool{static_cast<const uint2*>(texels), num_texels - 1, table,
                  levels, min_level, num_textures, max_mips};
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (maps) {
    texture_maps_kernel<<<grid, kThreads, 0, s>>>(pool, a);
  } else {
    texture_trilinear_kernel<<<grid, kThreads, 0, s>>>(pool, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// the launch (0 = success); the caller raises on anything else.
//
// The pool: `texels` (num_texels, 4) bf16, 8-byte aligned; `table`
// (num_textures, max_mips, 3) int32; `levels` and `min_level` (num_textures,)
// int32, `min_level` null for a pool without residency. The elements, a
// (rows, cols) grid in row-major order, every array contiguous: `uv` (.., 2)
// f32, `mask` bool.

// The five maps: `indices` (.., 5) int32, `ddx` and `ddy` (.., 2) f32, the
// footprint's `max_aniso`; `out` five pointers, one a map, each (.., 4)
// f32 and 16-byte aligned.
extern "C" int ash_sample_maps(
    const void* texels, int num_texels, const int* table, int num_textures,
    int max_mips, const int* levels, const int* min_level, const int* indices,
    const float* uv, const float* ddx, const float* ddy,
    const unsigned char* mask, int max_aniso, float* const* out, int rows,
    int cols, void* stream) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Elements a{};
  a.index = indices;
  a.uv = uv;
  a.ddx = ddx;
  a.ddy = ddy;
  a.mask = mask;
  for (int m = 0; m < kMaps; ++m) a.out[m] = reinterpret_cast<float4*>(out[m]);
  a.rows = rows;
  a.cols = cols;
  a.max_aniso = max_aniso;
  return launch(texels, num_texels, table, num_textures, max_mips, levels,
                min_level, a, true, stream);
}

// One trilinear tap: `index` int32, `lod` f32 or null (LOD 0); `out`
// (.., 4) f32, 16-byte aligned.
extern "C" int ash_sample_trilinear(
    const void* texels, int num_texels, const int* table, int num_textures,
    int max_mips, const int* levels, const int* min_level, const int* index,
    const float* uv, const float* lod, const unsigned char* mask, float* out,
    int rows, int cols, void* stream) {
  Elements a{};
  a.index = index;
  a.uv = uv;
  a.lod = lod;
  a.mask = mask;
  a.out[0] = reinterpret_cast<float4*>(out);
  a.rows = rows;
  a.cols = cols;
  return launch(texels, num_texels, table, num_textures, max_mips, levels,
                min_level, a, false, stream);
}
