// The directional light's shadow term for Hopper (sm_90a): the 16-tap PCF
// against a single shadow map or a cascade array.
//
// Replaces the jax.numpy PCF of ash_tpu/ops/shadow.py: shadow_pcf16 (:46)
// and shadow_pcf16_csm (:117), which are not TPU kernels: XLA fuses them
// there. One entry, ash_shadow_pcf16, computes for every element what the
// port's plain ash_tpu_torch/ops/shadow.py computes, bit for bit:
// - C = 1, the single map: geometry.transform_points(light_space_matrix,
//   world) and then shadow_pcf16; shade_pbr's separate projection is
//   folded into the launch. A cascade array of one cascade is the same
//   function of cascade 0's matrix: _pcf16_at_layer's product sums the same
//   terms in the same order, ((m0 x + m1 y) + m2 z) + m3;
// - C = 2 to 4, the cascades: shadow_pcf16_csm, the layer picked by the
//   view-space distance against the splits, and with a blend size the next
//   cascade's lookup mixed in near the far split.
//
// Bit-exactness with the plain version on the card (torch 2.11):
// - every product, sum and quotient is rounded on its own (__fmul_rn /
//   __fadd_rn / __fdiv_rn; the library is built with --fmad=false) in the
//   plain version's order; tensor-by-tensor quotients are IEEE (proj / w,
//   the blend's fraction); `/ 16.0` is a product with 1/16, exact on the
//   tap counts;
// - Python floats are f32 operands, the double rounded to f32 on the host
//   where PyTorch rounds it: 1.0 / S (the texel size; for a size that is
//   not a power of two the card's 1.0f / S may differ), blend_size and
//   1.0 - blend_size come in as arguments; clamp bounds are rounded to the
//   tensor's dtype;
// - (normal * light_dir).sum(-1) reduces over two lanes on the card,
//   (p0 + p2) + p1, in f32 and rounded once (csrc/lights.cu has the
//   probe); for bf16 normals each product rounds to bf16 first, and
//   1.0 - ndl, 0.05 * x and the clamp each round to bf16; current - bias
//   runs in f32;
// - each of the four gather quads floors (u +- ts) * S - 0.5 on its own,
//   two rounded operations, so two quads' footprints need not be one texel
//   apart; the floor is converted to int64 as .to(torch.int64) converts it
//   (round toward zero, saturating; the tests probe NaN and infinities),
//   and the tap indices stay in 64 bits, so a huge coordinate reads the
//   white border where 32 bits would wrap into the map;
// - clamp and clamp_min propagate NaN; a NaN distance counts no split
//   (layer 0); torch.where(next > layer, frac, 0) keeps frac's NaN;
// - the blend is shadow * (1 - blend) + shadow_next * blend, two rounded
//   products and a rounded sum. Where blend is +-0 that is shadow itself
//   (shadow_next is finite), so the second lookup runs only where blend is
//   not 0.
// Every element is written, covered or not, so the whole output equals the
// plain one. Beyond the far plane (proj z > 1) the result is 0 whatever the
// taps read, so such an element reads no texel.
//
// What bounds it: the bytes, in principle. An element reads its position
// (12 bytes) and normal (12 in f32, 6 in bf16) and writes 4; the texels its
// taps touch are read once: about 58 MB for a 1080p call, plus at most the
// 2048^2 map's 16.8 MB or the three 1024^2 cascades' 12.6 MB, 0.014-0.019
// ms at 3.35 TB/s. What holds the kernel short of that is the taps, 16 (32
// with the blend) data-dependent gathers a lookup (PERF.md section 6).
// Design:
// - one thread an element over the flattened element grid (edge MSAA hands
//   shade_pbr a worklist, not a pixel grid), its position and normal read
//   with scalar loads: staging a block's elements through shared memory
//   with 16-byte loads measured slower at every f32 call;
// - the matrices, the splits and the view row are staged in shared memory
//   once a block from their device tensors (no copy to the host, so a
//   frame takes no host sync);
// - the taps take one of two paths, each its own kernel, chosen once a
//   launch by windows_pay. Where a layer holds more texels than the
//   launch has elements (the standard frame's 2048^2 map at 1080p, the
//   edge worklist), shadow_pcf_kernel takes them quad by quad as above,
//   64-bit indices and the white border, which measured fastest there.
//   Where it holds at most as many (the rich frame's 1024^2 cascades),
//   neighbouring lanes' taps share L1 lines, and shadow_window_kernel
//   reads a lookup's 16 taps as one 4x4 window where they are one: its
//   two x floors and two y floors are computed once, and its taps are the
//   product of columns {xa, xa + 1, xb, xb + 1} and rows {ya, ya + 1, yb,
//   yb + 1}; where xb = xa + 2, yb = ya + 2 and the window lies inside
//   the map (window_axis), 16 loads with 32-bit indices and no bounds to
//   test, all issued before the compares (as scalars: 16-byte row reads
//   measured slower). The count is a sum of integers, so the order of the
//   compares cannot change it. Every other lookup (floors not two apart,
//   a window on the border, NaN, infinite or huge coordinates) it takes
//   quad by quad. It keeps at most 36 registers (kBlocksPerSM), so that
//   an SM keeps 14 blocks of 128: left to itself it took 39-70, fitting
//   fewer, and ran slower. No TMA: the taps are gathers.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Threads a block (at least 64, for the staging): 128 measured faster than
// 256 and 512, and as fast as 64 (PERF.md section 6).
constexpr int kThreads = 128;
// Blocks an SM keeps in flight on the window path: caps its registers at 36.
constexpr int kBlocksPerSM = 14;
constexpr int kMaxCascades = 4;

// The Python float constants of the plain version, as PyTorch's CUDA kernels
// take a CPU scalar: the double rounded to f32.
constexpr float kWFloor = static_cast<float>(1e-8);
constexpr float kBiasSlope = static_cast<float>(0.05);
constexpr float kBiasFloor = static_cast<float>(0.005);
constexpr float kBlendFloor = static_cast<float>(1e-6);

// f32 to bf16, round to nearest even (c10::BFloat16(float) on the card),
// kept as the f32 of the same value.
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The result of an op in the normal's dtype: bf16 (B) rounds, f32 keeps it.
template <bool B>
__device__ __forceinline__ float rnd(float x) {
  return B ? bf16_rn(x) : x;
}

template <bool B>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (B) {
    const unsigned short bits =
        __ldg(static_cast<const unsigned short*>(p) + i);
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }
  return __ldg(static_cast<const float*>(p) + i);
}

// Tensor.clamp_min / clamp with scalar bounds: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// torch.floor(x).to(torch.int64) on the card: round toward zero, saturating.
__device__ __forceinline__ long long floor_to_i64(float x) {
  return __float2ll_rz(floorf(x));
}

// int64 addition that wraps, as PyTorch's int64 tensors do.
__device__ __forceinline__ long long add_wrap(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

struct Args {
  const float* maps;  // (C, rows, cols)
  const float* mats;  // (C, 4, 4), row-major
  const float* splits;  // (>= C,) for C > 1
  const float* view;  // (4, 4) for C > 1
  const float* world;  // (n, 3)
  const void* normal;  // (n, 3), f32 or bf16
  const void* light_dir;  // 3 values an element at ld_stride (0 or 3)
  float* out;  // (n,)
  // (2,): the lookups that reach the taps and those read as one window, on
  // the window path; null but in ash_shadow_pcf16_probe.
  unsigned long long* counts;
  long long ld_stride;
  int n, rows, cols;
  float ts;  // f32(1.0 / rows)
  float blend, one_minus_blend;  // f32(blend_size), f32(1.0 - blend_size)
};

// Whether a lookup's two floors along an axis of `size` texels, f0 (the
// quads at -1 texel) and f1 (at +1), make its taps one window along it:
// f1 = f0 + 2, f0 >= 0 and f1 + 1 < size. `lim` is min(size, 2^24): below
// it the integral floats add and compare exactly; NaN fails.
__device__ __forceinline__ bool window_axis(float f0, float f1, float lim) {
  return f0 >= 0.0f && f1 == f0 + 2.0f && f1 + 1.0f < lim;
}

// The 16 taps of four gather quads at (u, v) of `layer` against `compare`,
// quad by quad: each quad floors its own coordinates, its taps take 64-bit
// indices, and those off the map read the white border.
__device__ __forceinline__ int taps_by_quad(const Args& a, int layer, float u,
                                            float v, float compare) {
  const float* map =
      a.maps + static_cast<long long>(layer) * a.rows * a.cols;
  const float sx = static_cast<float>(a.cols), sy = static_cast<float>(a.rows);
  int count = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // The quads at (-1, -1), (1, -1), (-1, 1), (1, 1) texels.
    const float uq = __fadd_rn(u, (q & 1) ? a.ts : -a.ts);
    const float vq = __fadd_rn(v, (q & 2) ? a.ts : -a.ts);
    const long long x0 = floor_to_i64(__fsub_rn(__fmul_rn(uq, sx), 0.5f));
    const long long y0 = floor_to_i64(__fsub_rn(__fmul_rn(vq, sy), 0.5f));
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long xi = add_wrap(x0, t & 1);
      const long long yi = add_wrap(y0, t >> 1);
      float d = 1.0f;  // the white border
      if (xi >= 0 && xi < a.cols && yi >= 0 && yi < a.rows) {
        d = __ldg(map + static_cast<int>(yi) * a.cols + static_cast<int>(xi));
      }
      count += compare > d;
    }
  }
  return count;
}

// _pcf16_at_layer (and shadow_pcf16 after transform_points): the light-space
// position by the cascade's matrix `m`, the projection, and the 16 taps of
// four gather quads against `compare` = proj z - bias. W: a lookup whose
// taps are one 4x4 window inside the map reads them as such; `reads` and
// `windows` count the lookups that reach the taps and those read so.
template <bool W>
__device__ __forceinline__ float pcf_at(const Args& a, const float* m,
                                        int layer, float x, float y, float z,
                                        float bias, int& reads,
                                        int& windows) {
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, m[4 * i]),
                                         __fmul_rn(y, m[4 * i + 1])),
                               __fmul_rn(z, m[4 * i + 2])),
                     m[4 * i + 3]);
  }
  const float w = fabsf(p[3]) < kWFloor ? kWFloor : p[3];
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(p[0], w), 0.5f), 0.5f);
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(p[1], w), 0.5f), 0.5f);
  const float current = __fadd_rn(__fmul_rn(__fdiv_rn(p[2], w), 0.5f), 0.5f);
  // Beyond the light frustum's far plane: no shadow, whatever the taps say.
  if (current > 1.0f) return 0.0f;
  const float compare = __fsub_rn(current, bias);
  int count = 0;
  if (W) {
    // The quads at -1 texel floor (fx[0], fy[0]), those at +1 (fx[1],
    // fy[1]), as taps_by_quad floors them.
    const float sx = static_cast<float>(a.cols);
    const float sy = static_cast<float>(a.rows);
    float fx[2], fy[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      fx[j] = floorf(__fsub_rn(__fmul_rn(__fadd_rn(u, j ? a.ts : -a.ts), sx),
                               0.5f));
      fy[j] = floorf(__fsub_rn(__fmul_rn(__fadd_rn(v, j ? a.ts : -a.ts), sy),
                               0.5f));
    }
    const bool one = window_axis(fx[0], fx[1], fminf(sx, 16777216.0f)) &&
                     window_axis(fy[0], fy[1], fminf(sy, 16777216.0f));
    ++reads;
    windows += one;
    if (one) {
      // Four rows of four texels, 32-bit indices, no bounds to test; all 16
      // loads issued before the compares.
      const float* window =
          a.maps + (layer * a.rows + static_cast<int>(fy[0])) * a.cols +
          static_cast<int>(fx[0]);  // < 2^31 texels
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        d[k] = __ldg(window + (k >> 2) * a.cols + (k & 3));
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) count += compare > d[k];
    } else {
      count = taps_by_quad(a, layer, u, v, compare);
    }
  } else {
    count = taps_by_quad(a, layer, u, v, compare);
  }
  // The tap count over 16 (a product with 1/16, exact).
  return __fmul_rn(static_cast<float>(count), 0.0625f);
}

// One block's elements: C cascades (1: the single map), BLEND: the next
// cascade's lookup mixed in, B: the normal and light direction in bf16, W:
// the window path.
template <int C, bool BLEND, bool B, bool W>
__device__ __forceinline__ void shadow_pcf(const Args& a) {
  __shared__ float mats[C * 16];
  __shared__ float splits[C];
  __shared__ float view_row[4];
  const int t = threadIdx.x;
  if (t < C * 16) mats[t] = __ldg(a.mats + t);
  if (C > 1) {
    if (t < C) splits[t] = __ldg(a.splits + t);
    if (t >= 32 && t < 36) view_row[t - 32] = __ldg(a.view + 8 + (t - 32));
  }
  __syncthreads();
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + t;
  if (e >= a.n) return;

  const float x = __ldg(a.world + 3 * e);
  const float y = __ldg(a.world + 3 * e + 1);
  const float z = __ldg(a.world + 3 * e + 2);
  // ndl = (normal * light_dir).sum(-1): products in the dtype, summed in
  // f32 as (p0 + p2) + p1 and rounded once, never -0.
  const long long l = a.ld_stride * e;
  const float p0 = rnd<B>(__fmul_rn(load<B>(a.normal, 3 * e),
                                    load<B>(a.light_dir, l)));
  const float p1 = rnd<B>(__fmul_rn(load<B>(a.normal, 3 * e + 1),
                                    load<B>(a.light_dir, l + 1)));
  const float p2 = rnd<B>(__fmul_rn(load<B>(a.normal, 3 * e + 2),
                                    load<B>(a.light_dir, l + 2)));
  const float ndl = rnd<B>(__fadd_rn(__fadd_rn(__fadd_rn(p0, p2), p1), 0.0f));
  // bias = (0.05 * (1.0 - ndl)).clamp_min(0.005), in the dtype.
  const float bias = clamp_min(
      rnd<B>(__fmul_rn(kBiasSlope, rnd<B>(__fsub_rn(1.0f, ndl)))),
      rnd<B>(kBiasFloor));

  int layer = 0;
  float view_z = 0.0f;
  if (C > 1) {
    // The positive view-space distance, and the splits it passes.
    view_z = -__fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(view_row[0], x),
                            __fmul_rn(view_row[1], y)),
                  __fmul_rn(view_row[2], z)),
        view_row[3]);
    int passed = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) passed += view_z > splits[i];
    layer = min(passed, C - 1);
  }
  int reads = 0, windows = 0;
  float shadow =
      pcf_at<W>(a, mats + 16 * layer, layer, x, y, z, bias, reads, windows);
  if (BLEND) {
    const float split = splits[layer];
    const float frac = clamp(
        __fdiv_rn(__fsub_rn(view_z, __fmul_rn(split, a.one_minus_blend)),
                  clamp_min(__fmul_rn(split, a.blend), kBlendFloor)),
        0.0f, 1.0f);
    const int next = min(layer + 1, C - 1);
    const float blend = next > layer ? frac : 0.0f;
    if (blend != 0.0f) {  // NaN too
      const float shadow_next = pcf_at<W>(a, mats + 16 * next, next, x, y,
                                          z, bias, reads, windows);
      shadow = __fadd_rn(__fmul_rn(shadow, __fsub_rn(1.0f, blend)),
                         __fmul_rn(shadow_next, blend));
    }
  }
  a.out[e] = shadow;
  if (W && a.counts != nullptr) {
    if (reads) atomicAdd(a.counts, static_cast<unsigned long long>(reads));
    if (windows) {
      atomicAdd(a.counts + 1, static_cast<unsigned long long>(windows));
    }
  }
}

// The taps quad by quad, with no cap on the registers (ptxas takes 32-34).
template <int C, bool BLEND, bool B>
__global__ void __launch_bounds__(kThreads) shadow_pcf_kernel(Args a) {
  shadow_pcf<C, BLEND, B, false>(a);
}

// The window path, kBlocksPerSM blocks an SM.
template <int C, bool BLEND, bool B>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    shadow_window_kernel(Args a) {
  shadow_pcf<C, BLEND, B, true>(a);
}

template <int C, bool BLEND, bool B>
void launch_path(const Args& a, bool windows, cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  if (windows) {
    shadow_window_kernel<C, BLEND, B><<<blocks, kThreads, 0, s>>>(a);
  } else {
    shadow_pcf_kernel<C, BLEND, B><<<blocks, kThreads, 0, s>>>(a);
  }
}

template <int C, bool BLEND>
void launch_dtype(const Args& a, bool bf16, bool windows, cudaStream_t s) {
  if (bf16) {
    launch_path<C, BLEND, true>(a, windows, s);
  } else {
    launch_path<C, BLEND, false>(a, windows, s);
  }
}

template <int C>
void launch_blend(const Args& a, bool blend, bool bf16, bool windows,
                  cudaStream_t s) {
  if (blend) {
    launch_dtype<C, true>(a, bf16, windows, s);
  } else {
    launch_dtype<C, false>(a, bf16, windows, s);
  }
}

// Whether a launch takes the window path: where a layer holds at most as
// many texels as the launch has elements, so that neighbouring elements'
// windows overlap (PERF.md section 6 has the times of both paths).
bool windows_pay(int rows, int cols, int n) {
  return static_cast<long long>(rows) * cols <= n;
}

// Both entries: check the arguments, take the window path where `path` is
// 1, or -1 and windows_pay says so, and launch. -> the path taken in *taken.
int pcf16(const float* maps, int cascades, int rows, int cols,
          const float* mats, const float* splits, const float* view,
          const float* world, const void* normal, const void* light_dir,
          int ld_stride, int n, int bf16, int blend, float ts,
          float blend_size, float one_minus_blend, float* out, int path,
          unsigned long long* counts, int* taken, void* stream) {
  if (maps == nullptr || mats == nullptr || world == nullptr ||
      normal == nullptr || light_dir == nullptr || out == nullptr ||
      cascades < 1 || cascades > kMaxCascades || rows <= 0 || cols <= 0 ||
      n <= 0 || (ld_stride != 0 && ld_stride != 3) ||
      (cascades > 1 && (splits == nullptr || view == nullptr)) ||
      (blend && cascades == 1) || path < -1 || path > 1 ||
      static_cast<long long>(cascades) * rows * cols > INT_MAX ||
      static_cast<long long>(n) * 3 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{maps, mats, splits, view, world, normal, light_dir, out,
               counts, ld_stride, n, rows, cols, ts, blend_size,
               one_minus_blend};
  const bool windows = path < 0 ? windows_pay(rows, cols, n) : path == 1;
  if (taken != nullptr) *taken = windows ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cascades) {
    case 1: launch_dtype<1, false>(a, bf16 != 0, windows, s); break;
    case 2: launch_blend<2>(a, blend != 0, bf16 != 0, windows, s); break;
    case 3: launch_blend<3>(a, blend != 0, bf16 != 0, windows, s); break;
    default: launch_blend<4>(a, blend != 0, bf16 != 0, windows, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The probe of tests/test_torch_shadow_kernel.py: floor(x) converted to
// int64 as the kernel converts a tap's coordinate.
__global__ void shadow_probe_kernel(const float* x, int n, long long* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = floor_to_i64(x[i]);
}

}  // namespace

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = success); the caller raises on anything else.
//
// `maps` (cascades, rows, cols) f32 and `mats` (cascades, 4, 4) f32, with
// cascades 1 (the single map and its light_space_matrix) to 4; `splits`
// (>= cascades,) and `view` (4, 4) f32 for cascades > 1, else unused (may
// be null); `world` (n, 3) f32; `normal` (n, 3) and `light_dir` (3 values
// an element, ld_stride apart: 0 for one direction, 3 for one an element)
// in f32, or bf16 when `bf16` is non-zero; `out` (n,) f32. Every array is
// contiguous and on the device. `ts` is f32(1.0 / rows), `blend_size` and
// `one_minus_blend` f32(blend_size) and f32(1.0 - blend_size); `blend`
// non-zero mixes in the next cascade (cascades > 1 only).
extern "C" int ash_shadow_pcf16(
    const float* maps, int cascades, int rows, int cols, const float* mats,
    const float* splits, const float* view, const float* world,
    const void* normal, const void* light_dir, int ld_stride, int n, int bf16,
    int blend, float ts, float blend_size, float one_minus_blend, float* out,
    void* stream) {
  return pcf16(maps, cascades, rows, cols, mats, splits, view, world, normal,
               light_dir, ld_stride, n, bf16, blend, ts, blend_size,
               one_minus_blend, out, -1, nullptr, nullptr, stream);
}

// ash_shadow_pcf16_probe: ash_shadow_pcf16 on the path `path` (-1: the
// one ash_shadow_pcf16 takes, 0: quad by quad, 1: the window path), the
// path taken written to the host's *taken; on the window path the kernel
// adds the lookups that reach the taps to counts[0] and those it reads as
// one window to counts[1] (device, zeroed by the caller). The tests' and
// chip_smoke.py's probe of both paths.
extern "C" int ash_shadow_pcf16_probe(
    const float* maps, int cascades, int rows, int cols, const float* mats,
    const float* splits, const float* view, const float* world,
    const void* normal, const void* light_dir, int ld_stride, int n, int bf16,
    int blend, float ts, float blend_size, float one_minus_blend, float* out,
    int path, unsigned long long* counts, int* taken, void* stream) {
  if (counts == nullptr || taken == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return pcf16(maps, cascades, rows, cols, mats, splits, view, world, normal,
               light_dir, ld_stride, n, bf16, blend, ts, blend_size,
               one_minus_blend, out, path, counts, taken, stream);
}

// ash_shadow_probe_floor: out[i] = floor(x[i]) as an int64, by the kernel's
// conversion, for i < n (the tests' probe of the conversion).
extern "C" int ash_shadow_probe_floor(const float* x, int n, long long* out,
                                      void* stream) {
  if (x == nullptr || out == nullptr || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shadow_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}
