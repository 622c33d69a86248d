// The surface shading of shade_pbr for Hopper (sm_90a): the material, the
// normal frame, the directional light's BRDF, the ambient and emissive
// terms and the composite, one thread an element.
//
// Replaces the jax.numpy shade_pbr of ash_tpu/ops/shade.py:415, which is not
// a TPU kernel: XLA fuses it there. One entry, ash_shade, computes what the
// port's plain ash_tpu_torch/ops/shade.py:shade_pbr computes in f32 with the
// flat ambient term, bit for bit, except the three calls that have kernels
// of their own, whose outputs it takes: the five texture samples
// (csrc/texture.cu), the shadow term (csrc/shadow.cu) and the Forward+
// lights (csrc/lights.cu), which add into `lo` between the directional
// light and the composite. So the entry has three stages, one kernel each:
// - shade: all of it, for a call without lights, in one launch;
// - surface: with lights, everything up to `lo`; it writes `lo` and the
//   per-element inputs that ash_light_loop takes (the shading normal, the
//   view direction, base colour, metallic, roughness, f0 and n.v), and the
//   ambient term (times the occlusion) and the emissive term for compose;
// - compose: with lights, after ash_light_loop has added into `lo`:
//   (ambient + lo) + emissive, the optional Reinhard, the clear colour.
// A shade or surface launch also writes the blend's coverage alpha
// (shade.py:pixel_alpha without a texture pool) where it is asked for.
// Where the plain version runs about 88 eager kernels a shaded layer (about
// 150 with a texture pool), a layer takes one launch here (two around the
// light kernel) and six small eager ops that make its inputs.
//
// Bit-exactness with the plain version on the card (torch 2.11):
// - every product, sum and quotient is rounded on its own (__fmul_rn /
//   __fadd_rn / __fsub_rn / __fdiv_rn; the library is built with
//   --fmad=false) in the plain version's order, left to right where it
//   chains Python floats (PI * denom * denom, (r * r) * 0.125, t2 * t2 * t);
//   Python floats are f32 operands (static_cast<float> of the double), and
//   so are the bounds of a comparison with a tensor;
// - (a * b).sum(-1) and torch.linalg.vector_norm of a 3-vector reduce over
//   two lanes on the card, (p0 + p2) + p1 and sqrt((x*x + z*z) + y*y), each
//   product rounded, the sum never -0 (csrc/lights.cu, csrc/gbuffer.cu and
//   their tests pin both; the norm of a (..., 4)[..., :3] view reduces the
//   same way, which tests/test_torch_shade_kernel.py probes);
// - x / PI divides by a CPU scalar, which PyTorch computes as x times the
//   f32 reciprocal, and 10.0 / x is Tensor.__rtruediv__, reciprocal(x) *
//   10.0; tensor-by-tensor quotients and square roots are IEEE;
// - clamp, clamp_min and torch.minimum propagate NaN; a comparison with NaN
//   is false, so where() takes its other side;
// - .to(torch.int32) of a material's texture index is the truncating
//   conversion (cvt.rzi, as static_cast on the card: NaN gives 0);
// - the draw id indexes the material table as PyTorch's indexing does:
//   below 0 from the end, out of range stops the kernel (__trap);
// - the backface flip multiplies by +-1.0, as the plain version does.
// Uncovered elements (mask off) get the clear colour; what is computed for
// them (triangle 0's values, inf and NaN included) stays in their own
// outputs, which the light kernel skips and compose overwrites.
//
// What bounds it: the bytes. An untextured element reads its mask, world
// position, normal, facing, draw id and shadow term (34 bytes) and writes
// its colour (12): 46 bytes, 95 MB at 1920x1080, 0.028 ms at 3.35 TB/s; the
// material rows are read once through L1. A textured element also reads
// its tangent and the used channels of the five samples (64 bytes). With
// lights, the surface stage writes the light kernel's inputs (72 bytes)
// and compose reads `lo` back. The design is the simple one: one thread an
// element, scalar loads and stores, no shared memory; the material row is
// gathered by its draw id, and neighbouring elements mostly share one.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Floats in a packed MaterialUniform row: base colour factor (0-3),
// emissive factor (4-7), metallic, roughness, occlusion strength, normal
// scale, the five texture indices (12-16), alpha cutoff.
constexpr int kMatRow = 18;

// The Python float constants of the plain version, as PyTorch's CUDA kernels
// take a CPU scalar: the double rounded to f32.
constexpr float kPi = static_cast<float>(3.14159265359);
constexpr float kF0Dielectric = static_cast<float>(0.04);
constexpr float kRoughFloor = static_cast<float>(0.04);
constexpr float kF0Floor = static_cast<float>(0.04);
constexpr float kNdotvFloor = static_cast<float>(0.001);
constexpr float kSpecBias = static_cast<float>(0.001);
constexpr float kNormFloor = static_cast<float>(1e-8);
constexpr float kLenTest = static_cast<float>(1e-3);

// The stages (the C entry's `stage`).
constexpr int kShade = 0;
constexpr int kSurface = 1;
constexpr int kCompose = 2;

struct Args {
  int n;  // elements, every array contiguous in element order
  const unsigned char* mask;
  const float *world, *normal, *tangent;  // (n, 3), (n, 3), (n, 4)
  const unsigned char* front;
  const int* draw_id;
  const float* materials;  // (n_draws, 18)
  int n_draws;
  // (3,) each, on the device.
  const float *camera_pos, *light_dir, *light_color, *ambient, *clear;
  const float* shadow;  // (n,) or null: no shadow
  // (n, 4) each: base colour, normal, metallic-roughness, occlusion,
  // emissive; read only by the textured instantiations.
  const float *s_base, *s_normal, *s_mr, *s_occ, *s_emis;
  int reinhard;
  float* color;  // (n, 3): shade and compose
  float* alpha;  // (n,) or null: shade and surface
  // surface writes these, compose reads lo, amb and emis.
  float *lo, *o_normal, *o_view, *o_base, *o_metal, *o_rough, *o_f0,
      *o_ndotv, *amb, *emis;
};

// PyTorch's index: below 0 counts from the end, out of range stops.
__device__ __forceinline__ int take(int i, int n) {
  if (i < 0) i += n;
  if (i < 0 || i >= n) __trap();
  return i;
}

// Tensor.clamp_min / clamp with scalar bounds, torch.minimum: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float3 load3(const float* p, long long e) {
  return make_float3(__ldg(p + 3 * e), __ldg(p + 3 * e + 1),
                     __ldg(p + 3 * e + 2));
}
__device__ __forceinline__ void store3(float* p, long long e, float3 v) {
  p[3 * e] = v.x;
  p[3 * e + 1] = v.y;
  p[3 * e + 2] = v.z;
}

__device__ __forceinline__ float3 add3(float3 a, float3 b) {
  return make_float3(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z));
}
__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z));
}
__device__ __forceinline__ float3 mul3(float3 a, float3 b) {
  return make_float3(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ float3 scale3(float3 a, float s) {
  return make_float3(__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                     __fmul_rn(a.z, s));
}

// (a * b).sum(-1) of 3-vectors on the card: (p0 + p2) + p1 from +0
// (csrc/lights.cu's dot3 in f32).
__device__ __forceinline__ float dot3(float3 a, float3 b) {
  const float p0 = __fmul_rn(a.x, b.x);
  const float p1 = __fmul_rn(a.y, b.y);
  const float p2 = __fmul_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fadd_rn(p0, p2), p1), 0.0f);
}

// torch.linalg.vector_norm of a 3-vector on the card, the same lanes.
__device__ __forceinline__ float norm3(float3 v) {
  return __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.z, v.z)),
      __fmul_rn(v.y, v.y)));
}

// light_loop.py:_normalize.
__device__ __forceinline__ float3 normalize3(float3 v) {
  const float n = clamp_min(norm3(v), kNormFloor);
  return make_float3(__fdiv_rn(v.x, n), __fdiv_rn(v.y, n),
                     __fdiv_rn(v.z, n));
}

// geometry.py:_cross, component by component.
__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
                     __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
                     __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// light_loop.py:geometry_schlick_ggx with 1 - k given.
__device__ __forceinline__ float schlick(float x, float k, float one_minus_k) {
  return __fdiv_rn(x, __fadd_rn(__fmul_rn(x, one_minus_k), k));
}

// Tensor.to(torch.int32) of a float, as PyTorch's CUDA cast truncates.
__device__ __forceinline__ int to_int(float x) { return __float2int_rz(x); }

// The optional Reinhard and the clear colour: shade.py's last lines.
__device__ __forceinline__ void composite(const Args& a, long long e,
                                          bool covered, float3 c) {
  if (a.reinhard) {
    c = make_float3(__fdiv_rn(c.x, __fadd_rn(c.x, 1.0f)),
                    __fdiv_rn(c.y, __fadd_rn(c.y, 1.0f)),
                    __fdiv_rn(c.z, __fadd_rn(c.z, 1.0f)));
  }
  if (!covered) {
    c = make_float3(__ldg(a.clear), __ldg(a.clear + 1), __ldg(a.clear + 2));
  }
  store3(a.color, e, c);
}

// Stages shade and surface (SPLIT): shade.py:shade_pbr in f32 with the flat
// ambient term, from the material gather to `lo` (and, for shade, the
// composite); TEXTURED with the five samples.
template <bool TEXTURED, bool SPLIT>
__global__ void __launch_bounds__(kThreads) shade_kernel(const Args a) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= a.n) return;
  const bool covered = a.mask[e] != 0;
  const float* m =
      a.materials + static_cast<long long>(take(__ldg(a.draw_id + e),
                                                a.n_draws)) * kMatRow;

  const float3 world = load3(a.world, e);
  const float3 cam = make_float3(__ldg(a.camera_pos), __ldg(a.camera_pos + 1),
                                 __ldg(a.camera_pos + 2));
  const float3 view = normalize3(sub3(cam, world));
  const float3 ld = make_float3(__ldg(a.light_dir), __ldg(a.light_dir + 1),
                                __ldg(a.light_dir + 2));
  // The geometric normal with its backface flip.
  const float flip = a.front[e] ? 1.0f : -1.0f;
  const float3 g = load3(a.normal, e);
  const float3 n = scale3(g, flip);
  float metallic = __ldg(m + 8);
  float roughness = clamp_min(__ldg(m + 9), kRoughFloor);
  float3 base = make_float3(__ldg(m), __ldg(m + 1), __ldg(m + 2));
  float3 emissive = make_float3(__ldg(m + 4), __ldg(m + 5), __ldg(m + 6));
  float occlusion = 1.0f;
  float3 normal = n;
  if (TEXTURED) {
    const float4 sb = __ldg(reinterpret_cast<const float4*>(a.s_base) + e);
    base = make_float3(__fmul_rn(sb.x, base.x), __fmul_rn(sb.y, base.y),
                       __fmul_rn(sb.z, base.z));

    // The TBN frame: the tangent or the fallback (1, 0, 0), Gram-Schmidt
    // against the unflipped normal, the flip, the bitangent.
    const float4 tan4 = __ldg(reinterpret_cast<const float4*>(a.tangent) + e);
    const float3 t_raw = make_float3(tan4.x, tan4.y, tan4.z);
    const float t_len = norm3(t_raw);
    float3 t;
    if (t_len > kLenTest) {
      const float d = clamp_min(t_len, kNormFloor);
      t = make_float3(__fdiv_rn(t_raw.x, d), __fdiv_rn(t_raw.y, d),
                      __fdiv_rn(t_raw.z, d));
    } else {
      t = make_float3(1.0f, 0.0f, 0.0f);
    }
    t = scale3(normalize3(sub3(t, scale3(g, dot3(t, g)))), flip);
    const float3 b = scale3(cross3(n, t), tan4.w);
    const float4 sn = __ldg(reinterpret_cast<const float4*>(a.s_normal) + e);
    const float3 ms = make_float3(sn.x, sn.y, sn.z);
    const float nscale = __ldg(m + 11);
    const float mx = __fmul_rn(__fsub_rn(__fmul_rn(ms.x, 2.0f), 1.0f), nscale);
    const float my = __fmul_rn(__fsub_rn(__fmul_rn(ms.y, 2.0f), 1.0f), nscale);
    const float mz = __fsub_rn(__fmul_rn(ms.z, 2.0f), 1.0f);
    const float3 mapped =
        add3(add3(scale3(t, mx), scale3(b, my)), scale3(n, mz));
    if (norm3(ms) > kLenTest && norm3(mapped) > kLenTest &&
        to_int(__ldg(m + 13)) >= 0) {
      normal = normalize3(mapped);
    }

    if (to_int(__ldg(m + 14)) >= 0) {
      const float4 mr = __ldg(reinterpret_cast<const float4*>(a.s_mr) + e);
      metallic = __fmul_rn(metallic, mr.z);
      roughness = clamp_min(__fmul_rn(roughness, mr.y), kRoughFloor);
    }
    if (to_int(__ldg(m + 15)) >= 0) {
      const float occ = __ldg(a.s_occ + 4 * e);
      occlusion = __fadd_rn(
          __fmul_rn(__fsub_rn(occ, 1.0f), __ldg(m + 10)), 1.0f);
    }
    if (to_int(__ldg(m + 16)) >= 0) {
      const float4 es = __ldg(reinterpret_cast<const float4*>(a.s_emis) + e);
      emissive = mul3(emissive, make_float3(es.x, es.y, es.z));
    }
  }

  const float ndotl = clamp_min(dot3(normal, ld), 0.0f);
  const float one_minus_metal = __fsub_rn(1.0f, metallic);
  const float dielectric = __fmul_rn(one_minus_metal, kF0Dielectric);
  const float3 f0 =
      add3(make_float3(dielectric, dielectric, dielectric),
           scale3(base, metallic));
  const float3 h = normalize3(add3(view, ld));
  const float ndotv = clamp_min(dot3(normal, view), kNdotvFloor);
  const float ndoth = clamp_min(dot3(normal, h), 0.0f);
  const float vdoth = clamp_min(dot3(view, h), 0.0f);

  // distribution_ggx(ndoth, roughness)
  const float ar = __fmul_rn(roughness, roughness);
  const float a2 = __fmul_rn(ar, ar);
  const float den = __fadd_rn(
      __fmul_rn(__fmul_rn(ndoth, ndoth), __fsub_rn(a2, 1.0f)), 1.0f);
  const float dd = __fdiv_rn(a2, __fmul_rn(__fmul_rn(kPi, den), den));
  // geometry_smith(ndotv, ndotl, roughness)
  const float r1 = __fadd_rn(roughness, 1.0f);
  const float k = __fmul_rn(__fmul_rn(r1, r1), 0.125f);
  const float one_minus_k = __fsub_rn(1.0f, k);
  const float gg = __fmul_rn(schlick(ndotv, k, one_minus_k),
                             schlick(ndotl, k, one_minus_k));
  // fresnel_schlick(vdoth, f0)'s power of (1 - vdoth)
  const float t = clamp01(__fsub_rn(1.0f, vdoth));
  const float t2 = __fmul_rn(t, t);
  const float t5 = __fmul_rn(__fmul_rn(t2, t2), t);
  const float dg = __fmul_rn(dd, gg);
  const float den4 =
      __fadd_rn(__fmul_rn(__fmul_rn(4.0f, ndotv), ndotl), kSpecBias);
  // The directional light's colour times n.l times (1 - shadow).
  const float unshadowed =
      a.shadow != nullptr ? __fsub_rn(1.0f, __ldg(a.shadow + e)) : 1.0f;
  const float weight = __fmul_rn(ndotl, unshadowed);
  const float inv_pi = __frcp_rn(kPi);
  const float f0c[3] = {f0.x, f0.y, f0.z};
  const float basec[3] = {base.x, base.y, base.z};
  float lo[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f = __fadd_rn(f0c[c], __fmul_rn(__fsub_rn(1.0f, f0c[c]), t5));
    const float cap =
        __fmul_rn(__frcp_rn(clamp_min(f0c[c], kF0Floor)), 10.0f);
    const float spec = nan_min(__fdiv_rn(__fmul_rn(dg, f), den4), cap);
    const float kd = __fmul_rn(__fsub_rn(1.0f, f), one_minus_metal);
    const float diffuse = __fmul_rn(__fmul_rn(kd, basec[c]), inv_pi);
    lo[c] = __fmul_rn(__fadd_rn(diffuse, spec),
                      __fmul_rn(__ldg(a.light_color + c), weight));
  }

  // The flat ambient term times the occlusion.
  float3 ambient = make_float3(__fmul_rn(__ldg(a.ambient), base.x),
                               __fmul_rn(__ldg(a.ambient + 1), base.y),
                               __fmul_rn(__ldg(a.ambient + 2), base.z));
  if (TEXTURED) ambient = scale3(ambient, occlusion);

  if (a.alpha != nullptr) {
    // shade.py:pixel_alpha without a pool: the factor's alpha, zeroed by
    // the cutoff and off the mask.
    float alpha = __ldg(m + 3);
    const float cutoff = __ldg(m + 17);
    if (cutoff > 0.0f && alpha < cutoff) alpha = 0.0f;
    a.alpha[e] = covered ? alpha : 0.0f;
  }
  const float3 lo3 = make_float3(lo[0], lo[1], lo[2]);
  if (SPLIT) {
    store3(a.lo, e, lo3);
    store3(a.o_normal, e, normal);
    store3(a.o_view, e, view);
    store3(a.o_base, e, base);
    a.o_metal[e] = metallic;
    a.o_rough[e] = roughness;
    store3(a.o_f0, e, f0);
    a.o_ndotv[e] = ndotv;
    store3(a.amb, e, ambient);
    store3(a.emis, e, emissive);
  } else {
    composite(a, e, covered, add3(add3(ambient, lo3), emissive));
  }
}

// Stage compose: (ambient + lo) + emissive after the light kernel, the
// optional Reinhard, the clear colour.
__global__ void __launch_bounds__(kThreads) compose_kernel(const Args a) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= a.n) return;
  const bool covered = a.mask[e] != 0;
  composite(a, e, covered,
            add3(add3(load3(a.amb, e), load3(a.lo, e)), load3(a.emis, e)));
}

template <bool TEXTURED>
void launch_surface(const Args& a, bool split, unsigned blocks,
                    cudaStream_t s) {
  if (split) {
    shade_kernel<TEXTURED, true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    shade_kernel<TEXTURED, false><<<blocks, kThreads, 0, s>>>(a);
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = success); the caller raises on anything else.
//
// `stage` 0 (shade), 1 (surface) or 2 (compose); `n` elements, every array
// contiguous in element order. The G-buffer: `mask` and `front` bool,
// `world` and `normal` (n, 3) and `tangent` (n, 4) f32 (the tangent only
// with samples), `draw_id` int32; `materials` (n_draws, 18) f32.
// `uniforms`: five device pointers to (3,) f32: the camera position, the
// normalised direction towards the light, the light colour, the ambient
// colour and the clear colour. `shadow` (n,) f32 or null. `samples`: null,
// or five (n, 4) f32 pointers (base colour, normal, metallic-roughness,
// occlusion, emissive). `color` (n, 3) f32 for shade and compose; `alpha`
// (n,) f32 or null, for shade and surface; `surface`: ten pointers for
// surface and compose (null for shade): lo, the shading normal, the view
// direction, base colour, f0, the ambient and the emissive term, (n, 3)
// f32, and metallic, roughness and n.v, (n,) f32, in the order lo,
// normal, view, base, metallic, roughness, f0, ndotv, ambient, emissive.
extern "C" int ash_shade(int stage, int n, const unsigned char* mask,
                         const float* world, const float* normal,
                         const float* tangent, const unsigned char* front,
                         const int* draw_id, const float* materials,
                         int n_draws, const float* const* uniforms,
                         const float* shadow, const float* const* samples,
                         int reinhard, float* color, float* alpha,
                         float* const* surface, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (stage < kShade || stage > kCompose || n <= 0 ||
      static_cast<long long>(n) * 4 > INT_MAX || mask == nullptr ||
      uniforms == nullptr || uniforms[4] == nullptr ||
      (stage == kSurface) == (color != nullptr) ||
      (stage == kShade) != (surface == nullptr) ||
      (stage == kCompose && alpha != nullptr)) {
    return invalid;
  }
  Args a{};
  a.n = n;
  a.mask = mask;
  a.clear = uniforms[4];
  a.reinhard = reinhard;
  a.color = color;
  a.alpha = alpha;
  if (surface != nullptr) {
    for (int i = 0; i < 10; ++i) {
      if (surface[i] == nullptr) return invalid;
    }
    a.lo = surface[0];
    a.o_normal = surface[1];
    a.o_view = surface[2];
    a.o_base = surface[3];
    a.o_metal = surface[4];
    a.o_rough = surface[5];
    a.o_f0 = surface[6];
    a.o_ndotv = surface[7];
    a.amb = surface[8];
    a.emis = surface[9];
  }
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage == kCompose) {
    compose_kernel<<<blocks, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (world == nullptr || normal == nullptr || front == nullptr ||
      draw_id == nullptr || materials == nullptr || n_draws <= 0 ||
      static_cast<long long>(n_draws) * kMatRow > INT_MAX) {
    return invalid;
  }
  for (int i = 0; i < 4; ++i) {
    if (uniforms[i] == nullptr) return invalid;
  }
  a.world = world;
  a.normal = normal;
  a.front = front;
  a.draw_id = draw_id;
  a.materials = materials;
  a.n_draws = n_draws;
  a.camera_pos = uniforms[0];
  a.light_dir = uniforms[1];
  a.light_color = uniforms[2];
  a.ambient = uniforms[3];
  a.shadow = shadow;
  const bool split = stage == kSurface;
  if (samples != nullptr) {
    for (int i = 0; i < 5; ++i) {
      if (samples[i] == nullptr) return invalid;
    }
    if (tangent == nullptr) return invalid;
    a.tangent = tangent;
    a.s_base = samples[0];
    a.s_normal = samples[1];
    a.s_mr = samples[2];
    a.s_occ = samples[3];
    a.s_emis = samples[4];
    launch_surface<true>(a, split, blocks, s);
  } else {
    launch_surface<false>(a, split, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
