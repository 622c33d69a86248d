// The Forward+ light loop for Hopper (sm_90a).
//
// Replaces the light loop of ash_tpu/ops/shade.py:shade_pbr (:558-640), a
// jax.numpy `lax.fori_loop` over the tile's light slots with a traced trip
// count, which XLA fuses on the TPU; it is not a Pallas kernel. One entry,
// ash_light_loop: for every covered element it computes what
// ash_tpu_torch/ops/light_loop.py:light_slots computes, walking slots
// 0 .. min(count[tile], cap) - 1 of its tile's culled light list and adding
// each light's contribution to `lo` in slot order: the point light's
// windowed inverse-square falloff, the spot cone, the directional entry's
// constant direction, then GGX, Smith-Schlick, Fresnel-Schlick, the
// specular cap and kD, in f32 or, for shade_dtype "bf16", with the BRDF
// rounded to bf16 where PyTorch's bf16 ops round.
//
// Bit-exactness with the plain version on the card (torch 2.11):
// - every product, sum and quotient is rounded on its own (__fmul_rn /
//   __fadd_rn / __fdiv_rn, and the library is built with --fmad=false) in
//   the plain version's order; Python float constants are f32 operands
//   (static_cast<float> of the double), and a clamp's bound is rounded to
//   the tensor's dtype; x / PI is x times the f32 reciprocal of PI and
//   10.0 / x the reciprocal of x times 10 (PyTorch's division by a CPU
//   scalar, and Tensor.__rtruediv__);
// - `(a * b).sum(-1)` and `torch.linalg.vector_norm` of a 3-vector reduce
//   over two lanes on the card: lane 0 adds elements 0 and 2 and lane 1
//   holds element 1, so the sum is (p0 + p2) + p1, the norm
//   sqrt((rn(x*x) + rn(z*z)) + rn(y*y)), accumulated in f32 (in bf16 too)
//   and rounded to the dtype once; a sum is never -0 (each lane starts at
//   +0). tests/test_torch_light_kernel.py's probes pin both orders;
// - torch.cos is libdevice's cosf, as here; torch.minimum, clamp and
//   clamp_min propagate NaN, and so do the clamps here;
// - bf16: each bf16 op computes in f32 and rounds to nearest even, as
//   c10::BFloat16(float) does; the inputs are widened exactly.
// Slots past a tile's count hold -1 (ops/light_cull.py), for which the
// plain loop adds +0: the kernel does not walk them, so a -0 in `lo` may
// stay -0 where the plain loop makes it +0 (equal under torch.equal).
//
// Elements outside the mask (the G-buffer's uncovered pixels) are skipped:
// their `lo` never reaches the image. `lo` is updated in place.
//
// What bounds it: the bytes. A covered element reads its mask, position and
// the seven shading inputs once and reads and writes `lo`: 97 bytes in f32,
// 61 in bf16; an uncovered one reads its mask (1 byte); the tile lists and
// light rows are read once. In the rich 1080p frame (638k covered pixels)
// that is about 64 MB, 0.019 ms at 3.35 TB/s. A pixel-light pair is 149
// f32 operations (chip_smoke.py's OPS_PER_LIGHT_PAIR), 18 of them IEEE
// divisions and 2 square roots; that frame's tile counts give 1.5 M pairs
// (2.4 a covered pixel, 19 in the fullest tile), 0.004 ms at the f32 peak.
// The eager loop instead gathered the 64-byte light row for every pixel and
// slot and ran some 95 full-frame kernels a slot, over every pixel, covered
// or not, up to the frame's largest tile count. The design:
// - on the pixel grid with 16-pixel light tiles (every frame's main and
//   band passes), a block takes one 16x16 pixel tile, which is one light
//   tile: the whole block walks one list with one trip count, so the loop
//   does not diverge; the tile's light ids and each light's own terms (its
//   clamped radius, colour times intensity, normalised direction and its
//   negation, the cone's cosines) are computed once into shared memory, 64
//   slots a round, so a pair costs only its own arithmetic;
// - a block with no covered pixel, or whose tile has no light, returns at
//   once (the background, and tiles the culling emptied);
// - elements given by `pixel_xy` (the edge MSAA shading: pixel centres at
//   the sample rate, and the worklist's samples) and other tile sizes take
//   one thread an element, which reads its own tile's list through L1 and
//   computes the light's terms itself;
// - TMA and wgmma do not apply: the loads are a few bytes an element, and
//   there is no matrix product.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
// Light slots staged in shared memory a round.
constexpr int kStage = 64;
// Floats in a packed GpuLight row: position, radius, colour, intensity,
// direction, type, inner and outer cone angles, range, enabled.
constexpr int kRow = 16;

// The Python float constants of the plain loop, as PyTorch's CUDA kernels
// take a CPU scalar in an f32 (or bf16) op: the double rounded to f32.
constexpr float kPi = static_cast<float>(3.14159265359);
constexpr float kSpecBias = static_cast<float>(0.001);
constexpr float kRadiusFloor = static_cast<float>(1e-3);
constexpr float kDistFloor = static_cast<float>(1e-6);
constexpr float kOuterFloor = static_cast<float>(1e-3);
constexpr float kInnerFloor = static_cast<float>(5e-4);
constexpr float kConeFloor = static_cast<float>(1e-4);
constexpr float kNormFloor = static_cast<float>(1e-8);
constexpr float kF0Floor = static_cast<float>(0.04);

// f32 to bf16, round to nearest even (c10::BFloat16(float)); NaN stays NaN.
// The result is kept as the f32 of the same value.
__device__ __forceinline__ float bf16_rn(float x) {
  if (x != x) return x;
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// The result of an op in the shading dtype: bf16 (B) rounds, f32 keeps it.
template <bool B>
__device__ __forceinline__ float rnd(float x) {
  return B ? bf16_rn(x) : x;
}

template <bool B>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (B) {
    return __uint_as_float(static_cast<unsigned>(
                               __ldg(static_cast<const unsigned short*>(p) + i))
                           << 16);
  }
  return __ldg(static_cast<const float*>(p) + i);
}

template <bool B>
__device__ __forceinline__ void store(void* p, long long i, float x) {
  if (B) {
    static_cast<unsigned short*>(p)[i] =
        static_cast<unsigned short>(__float_as_uint(x) >> 16);
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

template <bool B>
__device__ __forceinline__ float3 load3(const void* p, long long e) {
  return make_float3(load<B>(p, 3 * e), load<B>(p, 3 * e + 1),
                     load<B>(p, 3 * e + 2));
}

// torch.minimum: NaN in either operand gives NaN.
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

// Python's floor division of ints (torch's // on integer tensors).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// (a * b).sum(-1) of 3-vectors on the card: products in the dtype, their sum
// in f32 over the reduction's two lanes, (p0 + p2) + p1, rounded once; the
// lanes start at +0, so the sum is never -0.
template <bool B>
__device__ __forceinline__ float dot3(float3 a, float3 b) {
  const float p0 = rnd<B>(__fmul_rn(a.x, b.x));
  const float p1 = rnd<B>(__fmul_rn(a.y, b.y));
  const float p2 = rnd<B>(__fmul_rn(a.z, b.z));
  return rnd<B>(__fadd_rn(__fadd_rn(__fadd_rn(p0, p2), p1), 0.0f));
}

// torch.linalg.vector_norm of a 3-vector on the card, the same lanes.
template <bool B>
__device__ __forceinline__ float norm3(float3 v) {
  return rnd<B>(__fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.z, v.z)),
      __fmul_rn(v.y, v.y))));
}

// light_loop.py:_normalize.
template <bool B>
__device__ __forceinline__ float3 normalize3(float3 v) {
  const float n = clamp_min(norm3<B>(v), rnd<B>(kNormFloor));
  return make_float3(rnd<B>(__fdiv_rn(v.x, n)), rnd<B>(__fdiv_rn(v.y, n)),
                     rnd<B>(__fdiv_rn(v.z, n)));
}

// A light row's own terms: what the plain loop computes from the row alone.
struct Light {
  float3 pos;
  float radius;  // clamp_min(radius, 1e-3)
  float3 color;  // colour * intensity, in the shading dtype
  float type;  // 0 point, 1 spot, 2 directional
  float3 dir;  // _normalize(direction), f32
  float3 neg_dir;  // _normalize(-direction), in the shading dtype
  float cos_outer;  // cos(clamp_min(outer, 1e-3))
  float cone;  // clamp_min(cos(clamp_min(inner, 5e-4)) - cos_outer, 1e-4)
};

template <bool B>
__device__ __forceinline__ Light light_terms(const float* __restrict__ lights,
                                             int n_lights, int lid) {
  const float* row = lights + static_cast<long long>(min(lid, n_lights - 1)) *
                                  kRow;
  Light l;
  l.pos = make_float3(__ldg(row), __ldg(row + 1), __ldg(row + 2));
  l.radius = clamp_min(__ldg(row + 3), kRadiusFloor);
  const float intensity = __ldg(row + 7);
  l.color = make_float3(rnd<B>(__fmul_rn(__ldg(row + 4), intensity)),
                        rnd<B>(__fmul_rn(__ldg(row + 5), intensity)),
                        rnd<B>(__fmul_rn(__ldg(row + 6), intensity)));
  l.type = __ldg(row + 11);
  const float3 d = make_float3(__ldg(row + 8), __ldg(row + 9), __ldg(row + 10));
  l.dir = normalize3<false>(d);
  const float3 nd = normalize3<false>(make_float3(-d.x, -d.y, -d.z));
  l.neg_dir = make_float3(rnd<B>(nd.x), rnd<B>(nd.y), rnd<B>(nd.z));
  l.cos_outer = cosf(clamp_min(__ldg(row + 13), kOuterFloor));
  const float cos_inner = cosf(clamp_min(__ldg(row + 12), kInnerFloor));
  l.cone = clamp_min(__fsub_rn(cos_inner, l.cos_outer), kConeFloor);
  return l;
}

// A covered element's inputs and its running `lo`.
struct Pixel {
  float3 world, n, v, base, f0, lo;
  float metallic, roughness, ndotv;
};

struct Args {
  const float* lights;
  int n_lights;
  const int* indices;  // (tiles_y, tiles_x, slot_stride), the first cap used
  int tiles_y, tiles_x, slot_stride, cap;
  const int* counts;  // (tiles_y, tiles_x) or null: cap slots a tile
  int tile_size;
  const int* pixel_x;  // per element, or null: the element's grid place
  const int* pixel_y;
  const unsigned char* mask;
  const float* world;
  const void *normal, *view_dir, *base_color, *metallic, *roughness, *f0,
      *ndotv;
  void* lo;
  int rows, cols;
};

template <bool B>
__device__ __forceinline__ Pixel load_pixel(const Args& a, long long e) {
  Pixel p;
  p.world = make_float3(__ldg(a.world + 3 * e), __ldg(a.world + 3 * e + 1),
                        __ldg(a.world + 3 * e + 2));
  p.n = load3<B>(a.normal, e);
  p.v = load3<B>(a.view_dir, e);
  p.base = load3<B>(a.base_color, e);
  p.f0 = load3<B>(a.f0, e);
  p.lo = load3<B>(a.lo, e);
  p.metallic = load<B>(a.metallic, e);
  p.roughness = load<B>(a.roughness, e);
  p.ndotv = load<B>(a.ndotv, e);
  return p;
}

template <bool B>
__device__ __forceinline__ void store_lo(const Args& a, long long e,
                                         float3 lo) {
  store<B>(a.lo, 3 * e, lo.x);
  store<B>(a.lo, 3 * e + 1, lo.y);
  store<B>(a.lo, 3 * e + 2, lo.z);
}

// The slots a tile walks: min(count, cap), or cap without counts.
__device__ __forceinline__ int slot_count(const Args& a, long long tile) {
  const int c = a.counts != nullptr ? __ldg(a.counts + tile) : a.cap;
  return max(0, min(c, a.cap));
}

// light_loop.py:geometry_schlick_ggx.
template <bool B>
__device__ __forceinline__ float schlick(float x, float k) {
  return rnd<B>(__fdiv_rn(
      x, rnd<B>(__fadd_rn(rnd<B>(__fmul_rn(x, rnd<B>(__fsub_rn(1.0f, k)))),
                          k))));
}

// One channel of the light's contribution added to lo: fresnel_schlick, the
// capped specular, kD and the sum, in the plain loop's order.
template <bool B>
__device__ __forceinline__ float channel(float lo, float f0, float base,
                                         float color, float t5, float dg,
                                         float den4, float one_minus_metal,
                                         float weight, float inv_pi,
                                         float f0_floor) {
  const float ff = rnd<B>(__fadd_rn(
      f0, rnd<B>(__fmul_rn(rnd<B>(__fsub_rn(1.0f, f0)), t5))));
  const float spec = nan_min(
      rnd<B>(__fdiv_rn(rnd<B>(__fmul_rn(dg, ff)), den4)),
      rnd<B>(__fmul_rn(rnd<B>(__fdiv_rn(1.0f, clamp_min(f0, f0_floor))),
                       10.0f)));
  const float kd = rnd<B>(__fmul_rn(rnd<B>(__fsub_rn(1.0f, ff)),
                                    one_minus_metal));
  const float diffuse = rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(kd, base)), inv_pi));
  const float contrib = rnd<B>(__fmul_rn(
      rnd<B>(__fmul_rn(rnd<B>(__fadd_rn(diffuse, spec)), color)), weight));
  return rnd<B>(__fadd_rn(lo, contrib));
}

// Add one light (a slot whose id is >= 0) to a pixel's lo: light_slots' body.
template <bool B>
__device__ __forceinline__ void add_light(Pixel& p, const Light& l,
                                          float inv_pi) {
  // The direction and the attenuation, in f32.
  const float3 tl = make_float3(__fsub_rn(l.pos.x, p.world.x),
                                __fsub_rn(l.pos.y, p.world.y),
                                __fsub_rn(l.pos.z, p.world.z));
  const float dist = norm3<false>(tl);
  const float dc = clamp_min(dist, kDistFloor);
  const float3 lp = make_float3(__fdiv_rn(tl.x, dc), __fdiv_rn(tl.y, dc),
                                __fdiv_rn(tl.z, dc));
  const bool directional = l.type >= 1.5f;
  const float q = __fdiv_rn(dist, l.radius);
  const float q2 = __fmul_rn(q, q);
  const float win = clamp(__fsub_rn(1.0f, __fmul_rn(q2, q2)), 0.0f, 1.0f);
  float atten = __fdiv_rn(__fmul_rn(win, win),
                          __fadd_rn(__fmul_rn(dist, dist), 1.0f));
  const float cos_angle =
      dot3<false>(l.dir, make_float3(-lp.x, -lp.y, -lp.z));
  const float spot = clamp(
      __fdiv_rn(__fsub_rn(cos_angle, l.cos_outer), l.cone), 0.0f, 1.0f);
  atten = directional ? 1.0f
      : (l.type >= 0.5f ? __fmul_rn(__fmul_rn(atten, spot), spot) : atten);
  atten = rnd<B>(atten);
  const float3 ld = directional
      ? l.neg_dir : make_float3(rnd<B>(lp.x), rnd<B>(lp.y), rnd<B>(lp.z));

  // The BRDF in the shading dtype.
  const float nl = clamp_min(dot3<B>(p.n, ld), 0.0f);
  const float3 h = normalize3<B>(make_float3(rnd<B>(__fadd_rn(p.v.x, ld.x)),
                                             rnd<B>(__fadd_rn(p.v.y, ld.y)),
                                             rnd<B>(__fadd_rn(p.v.z, ld.z))));
  const float nh = clamp_min(dot3<B>(p.n, h), 0.0f);
  const float vh = clamp_min(dot3<B>(p.v, h), 0.0f);
  // distribution_ggx(nh, roughness)
  const float a = rnd<B>(__fmul_rn(p.roughness, p.roughness));
  const float a2 = rnd<B>(__fmul_rn(a, a));
  const float den = rnd<B>(__fadd_rn(
      rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(nh, nh)), rnd<B>(__fsub_rn(a2, 1.0f)))),
      1.0f));
  const float dd = rnd<B>(__fdiv_rn(
      a2, rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(den, kPi)), den))));
  // geometry_smith(ndotv, nl, roughness)
  const float r1 = rnd<B>(__fadd_rn(p.roughness, 1.0f));
  const float k = rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(r1, r1)), 0.125f));
  const float gg = rnd<B>(__fmul_rn(schlick<B>(p.ndotv, k), schlick<B>(nl, k)));
  // fresnel_schlick(vh, f0)'s power of (1 - vh)
  const float t = clamp(rnd<B>(__fsub_rn(1.0f, vh)), 0.0f, 1.0f);
  const float t2 = rnd<B>(__fmul_rn(t, t));
  const float t5 = rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(t2, t2)), t));
  const float dg = rnd<B>(__fmul_rn(dd, gg));
  const float den4 = rnd<B>(__fadd_rn(
      rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(4.0f, p.ndotv)), nl)), kSpecBias));
  const float one_minus_metal = rnd<B>(__fsub_rn(1.0f, p.metallic));
  const float weight = rnd<B>(__fmul_rn(nl, atten));
  const float f0_floor = rnd<B>(kF0Floor);
  p.lo.x = channel<B>(p.lo.x, p.f0.x, p.base.x, l.color.x, t5, dg, den4,
                      one_minus_metal, weight, inv_pi, f0_floor);
  p.lo.y = channel<B>(p.lo.y, p.f0.y, p.base.y, l.color.y, t5, dg, den4,
                      one_minus_metal, weight, inv_pi, f0_floor);
  p.lo.z = channel<B>(p.lo.z, p.f0.z, p.base.z, l.color.z, t5, dg, den4,
                      one_minus_metal, weight, inv_pi, f0_floor);
}

// x / PI divides by a CPU scalar: PyTorch multiplies by its f32 reciprocal.
__device__ __forceinline__ float inv_pi() { return __fdiv_rn(1.0f, kPi); }

// The pixel grid with 16-pixel light tiles: a block is one 16x16 pixel tile,
// which is one light tile (clamped to the list's grid, as the plain loop's
// tile lookup clamps), and stages the lights' terms in shared memory. Two
// blocks an SM are promised: with no minimum ptxas held the kernel to 64
// registers and spilled 8 bytes; allowed 128 it takes 71 and spills none.
template <bool B>
__global__ void __launch_bounds__(kThreads, 2) light_tile_kernel(Args a) {
  __shared__ Light stage[kStage];
  __shared__ int live[kStage];
  const int t = threadIdx.x;
  const int row = blockIdx.y * kTile + t / kTile;
  const int col = blockIdx.x * kTile + t % kTile;
  const bool inside = row < a.rows && col < a.cols;
  const long long e = static_cast<long long>(row) * a.cols + col;
  const bool covered = inside && a.mask[e];
  if (!__syncthreads_or(covered)) return;
  const long long tile =
      static_cast<long long>(min(static_cast<int>(blockIdx.y), a.tiles_y - 1)) *
          a.tiles_x + min(static_cast<int>(blockIdx.x), a.tiles_x - 1);
  const int count = slot_count(a, tile);
  if (count == 0) return;
  Pixel p;
  if (covered) p = load_pixel<B>(a, e);
  const float ip = inv_pi();
  const int* list = a.indices + tile * a.slot_stride;
  for (int base = 0; base < count; base += kStage) {
    const int n = min(kStage, count - base);
    __syncthreads();  // the last round's reads are done
    for (int s = t; s < n; s += kThreads) {
      const int lid = __ldg(list + base + s);
      live[s] = lid >= 0;
      if (lid >= 0) stage[s] = light_terms<B>(a.lights, a.n_lights, lid);
    }
    __syncthreads();
    if (covered) {
      for (int s = 0; s < n; ++s) {
        if (live[s]) add_light<B>(p, stage[s], ip);
      }
    }
  }
  if (covered) store_lo<B>(a, e, p.lo);
}

// Any other elements (pixel_xy, or another tile size): one thread an
// element, its tile's list read through L1.
template <bool B>
__global__ void __launch_bounds__(kThreads) light_element_kernel(Args a) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= static_cast<long long>(a.rows) * a.cols || !a.mask[e]) return;
  int px, py;
  if (a.pixel_x != nullptr) {
    px = __ldg(a.pixel_x + e);
    py = __ldg(a.pixel_y + e);
  } else {
    py = static_cast<int>(e / a.cols);
    px = static_cast<int>(e % a.cols);
  }
  const int ty = min(max(floor_div(py, a.tile_size), 0), a.tiles_y - 1);
  const int tx = min(max(floor_div(px, a.tile_size), 0), a.tiles_x - 1);
  const long long tile = static_cast<long long>(ty) * a.tiles_x + tx;
  const int count = slot_count(a, tile);
  if (count == 0) return;
  Pixel p = load_pixel<B>(a, e);
  const float ip = inv_pi();
  const int* list = a.indices + tile * a.slot_stride;
  for (int s = 0; s < count; ++s) {
    const int lid = __ldg(list + s);
    if (lid >= 0) {
      add_light<B>(p, light_terms<B>(a.lights, a.n_lights, lid), ip);
    }
  }
  store_lo<B>(a, e, p.lo);
}

template <bool B>
void launch_kernel(const Args& a, cudaStream_t s) {
  if (a.pixel_x == nullptr && a.tile_size == kTile) {
    const dim3 grid((a.cols + kTile - 1) / kTile, (a.rows + kTile - 1) / kTile);
    light_tile_kernel<B><<<grid, kThreads, 0, s>>>(a);
  } else {
    const long long n = static_cast<long long>(a.rows) * a.cols;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    light_element_kernel<B><<<blocks, kThreads, 0, s>>>(a);
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = success); the caller raises on anything else.
//
// `lights` (n_lights, 16) f32; `indices` int32, tile (y, x)'s slot s at
// (y * tiles_x + x) * slot_stride + s, the first `cap` slots used; `counts`
// (tiles_y, tiles_x) int32 or null (every tile walks cap slots);
// `pixel_x` / `pixel_y` int32 per element or null (the element's place in
// the grid). The elements, a (rows, cols) grid in row-major order, every
// array contiguous: `mask` bool, `world` (.., 3) f32; `normal`, `view_dir`,
// `base_color`, `f0` and `lo` (.., 3) and `metallic`, `roughness`, `ndotv`
// in the shading dtype, bf16 when `bf16` is non-zero, else f32. `lo` is
// updated in place on the covered elements.
extern "C" int ash_light_loop(
    const float* lights, int n_lights, const int* indices, int tiles_y,
    int tiles_x, int slot_stride, int cap, const int* counts, int tile_size,
    const int* pixel_x, const int* pixel_y, const unsigned char* mask,
    const float* world, const void* normal, const void* view_dir,
    const void* base_color, const void* metallic, const void* roughness,
    const void* f0, const void* ndotv, void* lo, int rows, int cols,
    int bf16, void* stream) {
  if (rows <= 0 || cols <= 0 || n_lights <= 0 || tiles_y <= 0 ||
      tiles_x <= 0 || cap < 0 || slot_stride < cap || tile_size <= 0 ||
      (pixel_x == nullptr) != (pixel_y == nullptr) || lights == nullptr ||
      indices == nullptr || mask == nullptr || world == nullptr ||
      normal == nullptr || view_dir == nullptr || base_color == nullptr ||
      metallic == nullptr || roughness == nullptr || f0 == nullptr ||
      ndotv == nullptr || lo == nullptr ||
      static_cast<long long>(rows) * cols > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{lights, n_lights, indices, tiles_y, tiles_x, slot_stride, cap,
               counts, tile_size, pixel_x, pixel_y, mask, world, normal,
               view_dir, base_color, metallic, roughness, f0, ndotv, lo, rows,
               cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_kernel<true>(a, s);
  } else {
    launch_kernel<false>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
