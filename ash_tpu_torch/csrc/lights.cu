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
//   __fadd_rn / __fdiv_rn / __frcp_rn, and the library is built with
//   --fmad=false) in the plain version's order; Python float constants are
//   f32 operands (static_cast<float> of the double), and a clamp's bound is
//   rounded to the tensor's dtype; x / PI is x times the f32 reciprocal of
//   PI and 10.0 / x the reciprocal of x times 10 (PyTorch's division by a
//   CPU scalar, and Tensor.__rtruediv__);
// - `(a * b).sum(-1)` and `torch.linalg.vector_norm` of a 3-vector reduce
//   over two lanes on the card: lane 0 adds elements 0 and 2 and lane 1
//   holds element 1, so the sum is (p0 + p2) + p1, the norm
//   sqrt((rn(x*x) + rn(z*z)) + rn(y*y)), accumulated in f32 (in bf16 too)
//   and rounded to the dtype once; a sum is never -0 (each lane starts at
//   +0). tests/test_torch_light_kernel.py's probes pin both orders;
// - torch.cos is libdevice's cosf, as here; torch.minimum, clamp and
//   clamp_min propagate NaN, and so do the clamps here;
// - bf16: each bf16 op computes in f32 and rounds to nearest even with the
//   card's conversion (__float2bfloat16_rn, one cvt.rn.bf16.f32), which is
//   what c10::BFloat16(float) calls on sm_80 and later; the inputs are
//   widened exactly;
// - a term that depends only on the element or only on the light is
//   computed once, as the same rounded operations on the same operands,
//   and a branch the light's type selects away is not computed.
// Slots past a tile's count hold -1 (ops/light_cull.py), for which the
// plain loop adds +0: the kernel does not walk them, so a -0 in `lo` may
// stay -0 where the plain loop makes it +0 (equal under torch.equal).
//
// Elements outside the mask (the G-buffer's uncovered pixels) are skipped:
// their `lo` never reaches the image. `lo` is updated in place.
//
// What bounds it: the bytes, and the operations that bit equality needs. A
// covered element reads its mask, position and the seven shading inputs
// once and reads and writes `lo`: 97 bytes in f32, 61 in bf16; an uncovered
// one reads its mask (1 byte); the tile lists and light rows are read once.
// In the rich 1080p frame (638k covered pixels) that is about 64 MB, 0.019
// ms at 3.35 TB/s. A pixel-light pair is 149 f32 operations as the plain
// loop counts them (chip_smoke.py's OPS_PER_LIGHT_PAIR), 0.004 ms for that
// frame's 1.5 M pairs at the f32 peak; but 18 of them are IEEE divisions
// and 2 square roots, each a dozen instructions, and in bf16 every
// operation adds its rounding, so the pairs' instructions, not the bytes,
// set the kernel's time. The design:
// - on the pixel grid with 16-pixel light tiles (every frame's main and
//   band passes), a block takes one 16x16 pixel tile, which is one light
//   tile: the whole block walks one list with one trip count, so the loop
//   does not diverge, and the light's type is the block's, so a point
//   light skips the cone and a directional one the falloff;
// - a block with no covered pixel, or whose tile has no light, returns at
//   once (the background, and tiles the culling emptied);
// - each light's own terms (its clamped radius, colour times intensity,
//   normalised direction and its negation, the cone's cosines) are computed
//   once a block into shared memory: for up to 64 lights, every light of
//   the table by its id, one thread a light, issued with the tile's count,
//   its first 64 slots and the element's inputs, so that no load waits for
//   another; with more lights, the tile's slots, 64 a round, as they are
//   read;
// - each element's own terms (GGX's a^2 and a^2 - 1, Smith's k and its
//   schlick(n.v), 4 n.v, 1 - metallic, and per channel 1 - f0 and the
//   specular cap 10 / max(f0, 0.04)) are computed once, before the slots;
//   a pair then does 13 IEEE divisions for a point light (8 for a
//   directional one) where it did 18. The per-channel ones and f0 and base
//   colour wait in shared memory, read once a pair in reach: in registers
//   they held the kernel to 3 blocks an SM (70-72 registers; 4 spilled),
//   in shared memory it takes 56-62 and runs 4;
// - most pairs of a lit frame are out of their point light's reach: the
//   culling keeps a light for a whole tile, and its window
//   clamp(1 - (d / r)^4, 0, 1) is 0 at most of the tile's pixels (78% of
//   the small lit bench frame's pairs). Such a pair's weight n.l * 0 is +0,
//   so it adds +-0 wherever the BRDF is finite. Each pixel's inputs are
//   checked once against bounds under which it is finite for any light
//   direction (Pixel::tame), each light's too (Light::tame); then the pair
//   stops after its window, four operations and one division past the
//   distance. A pixel or light outside the bounds walks every pair in
//   full, so NaN and infinity arise as in the plain loop;
// - elements given by `pixel_xy` (the edge MSAA shading: pixel centres at
//   the sample rate, and the worklist's samples) and other tile sizes take
//   one thread an element, which reads its own tile's list through L1 and
//   the light terms from the block's table (up to 64 lights) or computes
//   them itself;
// - loads stay scalar: a 3-vector of a 16-pixel row is 192 bytes that the
//   warp's loads cover once through L1, and the kernel's loads and stores
//   alone already run at about its byte bound.
// What it leaves (PERF.md section 6 measures each with a variant of this
// file): the pairs in reach, whose IEEE divisions and, in bf16, roundings
// (one conversion each) are most of their instructions. Compacting a
// tile's covered pixels into the first warps measured slower. TMA and wgmma
// do not apply: there is no matrix product.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
// The tile kernel's blocks an SM, which its registers fit.
constexpr int kMinBlocks = 4;
// A pixel's per-channel terms (f0, 1 - f0, the specular cap, base colour),
// kept in shared memory, a column of kChan words a thread, which leaves the
// registers for kMinBlocks blocks.
constexpr int kChan = 12;
// Light terms in shared memory: the whole table by id up to this many
// lights, else this many slots a round.
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

// f32 to bf16, round to nearest even, by the card's conversion (as
// c10::BFloat16(float) on the card), kept as the f32 of the same value.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// Bounds on a pixel's and a light's inputs under which a pair's BRDF is
// finite for any light direction (see Pixel::tame).
constexpr float kTameInput = 0x1p20f;
constexpr float kTamePosition = 0x1p60f;

// A light row's own terms: what the plain loop computes from the row alone;
// read from shared memory in 16-byte loads.
struct __align__(16) Light {
  float3 pos;
  float radius;  // clamp_min(radius, 1e-3)
  float3 color;  // colour * intensity, in the shading dtype
  float type;  // 0 point, 1 spot, 2 directional
  float3 dir;  // _normalize(direction), f32
  float3 neg_dir;  // _normalize(-direction), in the shading dtype
  float cos_outer;  // cos(clamp_min(outer, 1e-3))
  float cone;  // clamp_min(cos(clamp_min(inner, 5e-4)) - cos_outer, 1e-4)
  bool tame;  // position and colour finite, each at most kTamePosition
};

__device__ __forceinline__ bool within(float3 v, float bound) {
  return fabsf(v.x) <= bound && fabsf(v.y) <= bound && fabsf(v.z) <= bound;
}

// _normalize(-d) is -_normalize(d) bit for bit: the norm squares each
// component, and a quotient's rounding is symmetric in its sign.
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
  l.dir = normalize3<false>(
      make_float3(__ldg(row + 8), __ldg(row + 9), __ldg(row + 10)));
  l.neg_dir = make_float3(rnd<B>(-l.dir.x), rnd<B>(-l.dir.y),
                          rnd<B>(-l.dir.z));
  l.cos_outer = cosf(clamp_min(__ldg(row + 13), kOuterFloor));
  const float cos_inner = cosf(clamp_min(__ldg(row + 12), kInnerFloor));
  l.cone = clamp_min(__fsub_rn(cos_inner, l.cos_outer), kConeFloor);
  l.tame = within(l.pos, kTamePosition) && within(l.color, kTamePosition);
  return l;
}

// A covered element's inputs, its running `lo`, and the BRDF's terms that
// depend on the element alone (light_loop.py's expressions, hoisted).
struct Pixel {
  float3 world, n, v, lo;
  // Channel c's f0, 1 - f0 (fresnel_schlick), 10 / f0.clamp_min(0.04) and
  // base colour at chan[(4c + j) * kThreads], j = 0..3: this thread's
  // column of a shared kChan x kThreads array.
  float* chan;
  float one_minus_metal;  // 1 - metallic
  float a2, a2_minus_1;  // distribution_ggx's a * a and a2 - 1
  float k, one_minus_k;  // geometry_smith's k, and 1 - k
  float smith_v;  // geometry_schlick_ggx(ndotv, k)
  float four_ndotv;  // 4 * ndotv
  // The pair's BRDF, (kd * base / PI + spec) * colour, is finite for any
  // light direction ld of norm at most 1 (rounded) and any tame light:
  // n, v, base, metallic at most 2^20, f0 and ndotv in [0, 2^20] (so that
  // spec = min(., cap) lies in [0, 250]), roughness in [0, 1.5] (so that
  // Smith's k is in [1/8, 0.8]), world at most 2^60, and GGX's denominator
  // 1 + (n.h)^2 (a^2 - 1) at least kDenMargin for any unit h, with n.h
  // bounded by |n| and the roundings of h and the dot (kNhRoom). A point
  // light whose window is 0 then adds +-0 (weight = n.l * 0 = +0), and the
  // pair leaves lo as it is.
  bool tame;
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

// light_loop.py:geometry_schlick_ggx with 1 - k given.
template <bool B>
__device__ __forceinline__ float schlick(float x, float k, float one_minus_k) {
  return rnd<B>(__fdiv_rn(
      x, rnd<B>(__fadd_rn(rnd<B>(__fmul_rn(x, one_minus_k)), k))));
}

template <bool B>
__device__ __forceinline__ Pixel load_pixel(const Args& a, long long e,
                                            float* chan) {
  Pixel p;
  p.world = make_float3(__ldg(a.world + 3 * e), __ldg(a.world + 3 * e + 1),
                        __ldg(a.world + 3 * e + 2));
  p.n = load3<B>(a.normal, e);
  p.v = load3<B>(a.view_dir, e);
  const float3 base = load3<B>(a.base_color, e);
  const float3 f0 = load3<B>(a.f0, e);
  p.lo = load3<B>(a.lo, e);
  const float metallic = load<B>(a.metallic, e);
  const float roughness = load<B>(a.roughness, e);
  const float ndotv = load<B>(a.ndotv, e);
  p.one_minus_metal = rnd<B>(__fsub_rn(1.0f, metallic));
  const float ar = rnd<B>(__fmul_rn(roughness, roughness));
  p.a2 = rnd<B>(__fmul_rn(ar, ar));
  p.a2_minus_1 = rnd<B>(__fsub_rn(p.a2, 1.0f));
  const float r1 = rnd<B>(__fadd_rn(roughness, 1.0f));
  p.k = rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(r1, r1)), 0.125f));
  p.one_minus_k = rnd<B>(__fsub_rn(1.0f, p.k));
  p.smith_v = schlick<B>(ndotv, p.k, p.one_minus_k);
  p.four_ndotv = rnd<B>(__fmul_rn(4.0f, ndotv));
  const float f0_floor = rnd<B>(kF0Floor);
  p.chan = chan;
  const float f0c[3] = {f0.x, f0.y, f0.z}, basec[3] = {base.x, base.y, base.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    chan[(4 * c) * kThreads] = f0c[c];
    chan[(4 * c + 1) * kThreads] = rnd<B>(__fsub_rn(1.0f, f0c[c]));
    chan[(4 * c + 2) * kThreads] = rnd<B>(
        __fmul_rn(rnd<B>(__frcp_rn(clamp_min(f0c[c], f0_floor))), 10.0f));
    chan[(4 * c + 3) * kThreads] = basec[c];
  }
  // |n|^2, widened by kNhRoom: at least (n.h)^2 for a unit h, rounded as
  // the kernel rounds it (f32: h and the dot within 2^-21; bf16: h's norm
  // and components, the products and the sum each within 2^-9).
  constexpr float kNhRoom = B ? 1.03125f : 1.0000038f;  // 1 + 2^-5, 1 + 2^-18
  constexpr float kDenMargin = B ? 0x1p-6f : 0x1p-20f;  // over den's rounding
  const float n2 = __fadd_rn(
      __fadd_rn(__fmul_rn(p.n.x, p.n.x), __fmul_rn(p.n.z, p.n.z)),
      __fmul_rn(p.n.y, p.n.y));
  const float den_low = __fsub_rn(
      1.0f, __fmul_rn(__fmul_rn(n2, kNhRoom), __fsub_rn(1.0f, p.a2)));
  p.tame = within(p.n, kTameInput) && within(p.v, kTameInput) &&
           within(base, kTameInput) && within(p.world, kTamePosition) &&
           f0.x >= 0.0f && f0.y >= 0.0f && f0.z >= 0.0f &&
           within(f0, kTameInput) && fabsf(metallic) <= kTameInput &&
           ndotv >= 0.0f && ndotv <= kTameInput && roughness >= 0.0f &&
           roughness <= 1.5f && den_low >= kDenMargin;
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

// One channel of the light's contribution added to lo: fresnel_schlick, the
// capped specular, kD and the sum, in the plain loop's order.
template <bool B>
__device__ __forceinline__ float channel(float lo, const float* chan,
                                         float color, float t5, float dg,
                                         float den4, float one_minus_metal,
                                         float weight, float inv_pi) {
  const float f0 = chan[0], one_minus_f0 = chan[kThreads];
  const float cap = chan[2 * kThreads], base = chan[3 * kThreads];
  const float ff = rnd<B>(__fadd_rn(f0, rnd<B>(__fmul_rn(one_minus_f0, t5))));
  const float spec =
      nan_min(rnd<B>(__fdiv_rn(rnd<B>(__fmul_rn(dg, ff)), den4)), cap);
  const float kd = rnd<B>(__fmul_rn(rnd<B>(__fsub_rn(1.0f, ff)),
                                    one_minus_metal));
  const float diffuse = rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(kd, base)), inv_pi));
  const float contrib = rnd<B>(__fmul_rn(
      rnd<B>(__fmul_rn(rnd<B>(__fadd_rn(diffuse, spec)), color)), weight));
  return rnd<B>(__fadd_rn(lo, contrib));
}

// Add one light (a slot whose id is >= 0) to a pixel's lo: light_slots' body.
// The plain loop computes every type's terms and selects; here the light's
// type picks the branch (the same values where the select keeps them).
template <bool B>
__device__ __forceinline__ void add_light(Pixel& p, const Light& l,
                                          float inv_pi) {
  float atten;
  float3 ld;
  if (l.type >= 1.5f) {  // directional: no falloff, a constant direction
    atten = 1.0f;
    ld = l.neg_dir;
  } else {
    // The direction and the attenuation, in f32.
    const float3 tl = make_float3(__fsub_rn(l.pos.x, p.world.x),
                                  __fsub_rn(l.pos.y, p.world.y),
                                  __fsub_rn(l.pos.z, p.world.z));
    const float dist = norm3<false>(tl);
    const float q = __fdiv_rn(dist, l.radius);
    const float q2 = __fmul_rn(q, q);
    const float win = clamp(__fsub_rn(1.0f, __fmul_rn(q2, q2)), 0.0f, 1.0f);
    // A point light out of reach adds +-0 to a tame pixel (Pixel::tame).
    if (win == 0.0f && l.type < 0.5f && p.tame && l.tame) return;
    const float dc = clamp_min(dist, kDistFloor);
    const float3 lp = make_float3(__fdiv_rn(tl.x, dc), __fdiv_rn(tl.y, dc),
                                  __fdiv_rn(tl.z, dc));
    atten = __fdiv_rn(__fmul_rn(win, win),
                      __fadd_rn(__fmul_rn(dist, dist), 1.0f));
    if (l.type >= 0.5f) {  // spot: the cone
      const float cos_angle =
          dot3<false>(l.dir, make_float3(-lp.x, -lp.y, -lp.z));
      const float spot = clamp(
          __fdiv_rn(__fsub_rn(cos_angle, l.cos_outer), l.cone), 0.0f, 1.0f);
      atten = __fmul_rn(__fmul_rn(atten, spot), spot);
    }
    atten = rnd<B>(atten);
    ld = make_float3(rnd<B>(lp.x), rnd<B>(lp.y), rnd<B>(lp.z));
  }

  // The BRDF in the shading dtype.
  const float nl = clamp_min(dot3<B>(p.n, ld), 0.0f);
  const float3 h = normalize3<B>(make_float3(rnd<B>(__fadd_rn(p.v.x, ld.x)),
                                             rnd<B>(__fadd_rn(p.v.y, ld.y)),
                                             rnd<B>(__fadd_rn(p.v.z, ld.z))));
  const float nh = clamp_min(dot3<B>(p.n, h), 0.0f);
  const float vh = clamp_min(dot3<B>(p.v, h), 0.0f);
  // distribution_ggx(nh, roughness)
  const float den = rnd<B>(__fadd_rn(
      rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(nh, nh)), p.a2_minus_1)), 1.0f));
  const float dd = rnd<B>(__fdiv_rn(
      p.a2, rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(den, kPi)), den))));
  // geometry_smith(ndotv, nl, roughness)
  const float gg =
      rnd<B>(__fmul_rn(p.smith_v, schlick<B>(nl, p.k, p.one_minus_k)));
  // fresnel_schlick(vh, f0)'s power of (1 - vh)
  const float t = clamp(rnd<B>(__fsub_rn(1.0f, vh)), 0.0f, 1.0f);
  const float t2 = rnd<B>(__fmul_rn(t, t));
  const float t5 = rnd<B>(__fmul_rn(rnd<B>(__fmul_rn(t2, t2)), t));
  const float dg = rnd<B>(__fmul_rn(dd, gg));
  const float den4 =
      rnd<B>(__fadd_rn(rnd<B>(__fmul_rn(p.four_ndotv, nl)), kSpecBias));
  const float weight = rnd<B>(__fmul_rn(nl, atten));
  p.lo.x = channel<B>(p.lo.x, p.chan, l.color.x, t5, dg, den4,
                      p.one_minus_metal, weight, inv_pi);
  p.lo.y = channel<B>(p.lo.y, p.chan + 4 * kThreads, l.color.y, t5, dg, den4,
                      p.one_minus_metal, weight, inv_pi);
  p.lo.z = channel<B>(p.lo.z, p.chan + 8 * kThreads, l.color.z, t5, dg, den4,
                      p.one_minus_metal, weight, inv_pi);
}

// x / PI divides by a CPU scalar: PyTorch multiplies by its f32 reciprocal.
__device__ __forceinline__ float inv_pi() { return __frcp_rn(kPi); }

// The pixel grid with 16-pixel light tiles: a block is one 16x16 pixel tile,
// which is one light tile (clamped to the list's grid, as the plain loop's
// tile lookup clamps).
template <bool B>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    light_tile_kernel(Args a) {
  __shared__ Light stage[kStage];
  __shared__ int ids[kStage];
  __shared__ float chan[kChan * kThreads];
  const int t = threadIdx.x;
  const int row = blockIdx.y * kTile + t / kTile;
  const int col = blockIdx.x * kTile + t % kTile;
  const long long e = static_cast<long long>(row) * a.cols + col;
  const bool covered = row < a.rows && col < a.cols && a.mask[e];
  if (!__syncthreads_or(covered)) return;
  const long long tile =
      static_cast<long long>(min(static_cast<int>(blockIdx.y), a.tiles_y - 1)) *
          a.tiles_x + min(static_cast<int>(blockIdx.x), a.tiles_x - 1);
  const int* list = a.indices + tile * a.slot_stride;
  // Issued together: the table of every light's terms (up to kStage
  // lights), the first round's slots, the count and the element's inputs.
  const bool by_id = a.n_lights <= kStage;
  if (by_id && t < a.n_lights) {
    stage[t] = light_terms<B>(a.lights, a.n_lights, t);
  }
  const int first = t < min(kStage, a.cap) ? __ldg(list + t) : -1;
  const int count = slot_count(a, tile);
  if (count == 0) return;
  Pixel p;
  if (covered) p = load_pixel<B>(a, e, chan + t);
  const float ip = inv_pi();
  for (int base = 0; base < count; base += kStage) {
    const int n = min(kStage, count - base);
    __syncthreads();  // the table is written; the last round's reads done
    if (t < n) {
      const int lid = base == 0 ? first : __ldg(list + base + t);
      ids[t] = lid;
      if (!by_id && lid >= 0) {
        stage[t] = light_terms<B>(a.lights, a.n_lights, lid);
      }
    }
    __syncthreads();
    if (covered) {
      for (int s = 0; s < n; ++s) {
        const int lid = ids[s];
        if (lid >= 0) {
          add_light<B>(p, stage[by_id ? min(lid, a.n_lights - 1) : s], ip);
        }
      }
    }
  }
  if (covered) store_lo<B>(a, e, p.lo);
}

// Any other elements (pixel_xy, or another tile size): one thread an
// element, its tile's list read through L1, the light terms from the
// block's table (up to kStage lights) or computed for each pair.
template <bool B>
__global__ void __launch_bounds__(kThreads) light_element_kernel(Args a) {
  __shared__ Light table[kStage];
  __shared__ float chan[kChan * kThreads];
  const int t = threadIdx.x;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + t;
  const bool covered =
      e < static_cast<long long>(a.rows) * a.cols && a.mask[e];
  if (!__syncthreads_or(covered)) return;
  const bool by_id = a.n_lights <= kStage;
  if (by_id && t < a.n_lights) {
    table[t] = light_terms<B>(a.lights, a.n_lights, t);
  }
  __syncthreads();
  if (!covered) return;
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
  Pixel p = load_pixel<B>(a, e, chan + t);
  const float ip = inv_pi();
  const int* list = a.indices + tile * a.slot_stride;
  for (int s = 0; s < count; ++s) {
    const int lid = __ldg(list + s);
    if (lid >= 0) {
      add_light<B>(p, by_id ? table[min(lid, a.n_lights - 1)]
                            : light_terms<B>(a.lights, a.n_lights, lid),
                   ip);
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

// The probe of tests/test_torch_light_kernel.py: the bf16 bits of each x by
// the conversion rnd<true> uses.
__global__ void light_probe_kernel(const float* x, int n,
                                   unsigned short* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = static_cast<unsigned short>(__float_as_uint(bf16_rn(x[i])) >> 16);
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

// ash_light_probe_bf16: out[i] = the bf16 bits of x[i] as the kernel rounds
// it, for i < n (the tests' probe of the conversion).
extern "C" int ash_light_probe_bf16(const float* x, int n,
                                    unsigned short* out, void* stream) {
  if (x == nullptr || out == nullptr || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  light_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}
