// The G-buffer fetch for Hopper (sm_90a): every shaded layer's attributes
// re-interpolated from the winning triangle ids.
//
// Replaces the jax.numpy interpolate_gbuffer of ash_tpu/ops/shade.py:127,
// which is not a TPU kernel: XLA fuses its gathers into one program there.
// One entry, ash_gbuffer, computes for every element what the port's plain
// ash_tpu_torch/ops/shade.py:interpolate_gbuffer computes, bit for bit, in
// one launch where the plain version runs about 74 eager kernels (92 with
// the motion vectors): the triangle's perspective-correct weights at the
// element and one deriv_step right and down, the mask, world position,
// normalised normal, tangent, uv, vertex colour, facing, draw id, the uv
// derivatives and, with last frame's clip positions, the velocity.
//
// Bit-exactness with the plain version on the card (torch 2.11):
// - every product, sum and quotient is rounded on its own (__fmul_rn /
//   __fadd_rn / __fsub_rn / __fdiv_rn; the library is built with
//   --fmad=false) in the plain version's order: lam_i = (e_i0 * px +
//   e_i1 * py) + e_i2, four eager kernels, and w_i = lam_i / where(|s| <
//   1e-12, 1, s), an IEEE division;
// - lam.sum(-1) over its 3 innermost values reduces over two lanes on the
//   card, (l0 + l2) + l1, and torch.linalg.vector_norm of a 3-vector as
//   sqrt((x*x + z*z) + y*y), each square rounded (csrc/lights.cu pins both);
// - _interp's (pw[..., :, None] * attr).sum(-2), a sum over an axis that
//   is not innermost, is one thread's sum of the rounded products in index
//   order, ((p0 + p1) + p2); every reduction's accumulators start at +0, so
//   no sum is -0 (tests/test_torch_gbuffer_kernel.py's probes pin all
//   three orders on the card);
// - px / fb_width divides by a host scalar, which PyTorch computes as px
//   times the f32 reciprocal of the scalar: the wrapper hands the
//   reciprocal in (1.0f / f32(fb_width), rounded on the host as PyTorch
//   rounds it); pc / w is a tensor-by-tensor IEEE division; Python floats
//   (1e-12, 1e-6, 1e-8, 0.5, deriv_step) are f32 operands;
// - clamp_min propagates NaN, a comparison with NaN is false (where()
//   takes its other side), as in PyTorch;
// - uncovered elements (tri_id < 0) read triangle 0, as the plain
//   version's clamp_min(0) does, and get its interpolation, inf and NaN
//   included; only the mask and the velocity tell them apart;
// - an index below 0 counts from the end of its table and one past it
//   stops the kernel (__trap), as PyTorch's indexing does on the card.
//
// What bounds it: the bytes. An element reads its triangle id (4 bytes; 8
// more for explicit coordinates) and writes 82 (90 with the velocity); the
// triangle and vertex tables are read once through L2 (about 2 MB at 1000
// cubes). A 1080p call moves 178 MB, 0.053 ms at 3.35 TB/s, 195 MB with
// the velocity. The design is the simple one: one thread an element, which
// loads its triangle's nine edge floats, det, draw id and three vertex ids
// once, evaluates the weights at its three positions, gathers each
// attribute's three vertices and writes every field with scalar stores.
// Neighbouring elements mostly share a triangle, so the gathers hit L1.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The Python float constants of the plain version, as PyTorch's CUDA kernels
// take a CPU scalar: the double rounded to f32.
constexpr float kSumFloor = static_cast<float>(1e-12);
constexpr float kWFloor = static_cast<float>(1e-6);
constexpr float kNormFloor = static_cast<float>(1e-8);

struct Args {
  // The elements: a (rows, cols) grid, tri_id's strides in elements.
  const int* tri_id;
  int rows, cols, tid_s0, tid_s1;
  // Explicit global render coordinates (null: the pixel grid from row y0),
  // each with its strides in elements (0 for an expanded axis).
  const float *px, *py;
  int px_s0, px_s1, py_s0, py_s1, y0;
  float step_x, step_y;
  // The tables: T triangles, Ve expanded and Vu unique vertices.
  const float *edge, *det;
  const int *tri_v, *tri_draw, *vert_uid;
  int n_tri, n_vert, n_unique;
  const float *world, *normal, *tangent, *prev_clip, *uv, *color;
  float inv_fb_w, inv_fb_h;
  // The fields.
  unsigned char *mask, *front;
  int* draw;
  float *o_world, *o_normal, *o_tangent, *o_uv, *o_color, *ddx, *ddy,
      *velocity;
};

// PyTorch's index: below 0 counts from the end, out of range stops.
__device__ __forceinline__ int take(int i, int n) {
  if (i < 0) i += n;
  if (i < 0 || i >= n) __trap();
  return i;
}

// Tensor.clamp_min with a scalar bound: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// The perspective-correct weights of ops/shade.py:_perspective_weights at
// (px, py): e holds the triangle's 3x3 edge rows, row-major.
struct Weights {
  float w[3];
};

__device__ __forceinline__ Weights weights(const float* e, float px,
                                           float py) {
  float lam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lam[i] = __fadd_rn(__fadd_rn(__fmul_rn(e[3 * i], px),
                                 __fmul_rn(e[3 * i + 1], py)),
                       e[3 * i + 2]);
  }
  // lam.sum(-1): two lanes, (l0 + l2) + l1, never -0.
  const float s =
      __fadd_rn(__fadd_rn(__fadd_rn(lam[0], lam[2]), lam[1]), 0.0f);
  const float d = fabsf(s) < kSumFloor ? 1.0f : s;
  Weights out;
#pragma unroll
  for (int i = 0; i < 3; ++i) out.w[i] = __fdiv_rn(lam[i], d);
  return out;
}

// _interp of one channel: the products rounded, then summed in index order
// from +0.
__device__ __forceinline__ float interp(const Weights& pw, float a0, float a1,
                                        float a2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pw.w[0], a0),
                                       __fmul_rn(pw.w[1], a1)),
                             __fmul_rn(pw.w[2], a2)),
                   0.0f);
}

// _interp of C channels from a (V, C) table at the three vertex ids into
// out[0 .. C).
template <int C>
__device__ __forceinline__ void interp_rows(const Weights& pw,
                                            const float* table, const int* v,
                                            float* out) {
  const float* r0 = table + static_cast<long long>(v[0]) * C;
  const float* r1 = table + static_cast<long long>(v[1]) * C;
  const float* r2 = table + static_cast<long long>(v[2]) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    out[c] = interp(pw, __ldg(r0 + c), __ldg(r1 + c), __ldg(r2 + c));
  }
}

template <int C>
__device__ __forceinline__ void store(float* dst, long long e,
                                      const float* v) {
#pragma unroll
  for (int c = 0; c < C; ++c) dst[e * C + c] = v[c];
}

__global__ void __launch_bounds__(kThreads)
    gbuffer_kernel(const Args a) {
  const long long n = static_cast<long long>(a.rows) * a.cols;
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int row = static_cast<int>(e / a.cols);
  const int col = static_cast<int>(e - static_cast<long long>(row) * a.cols);

  const int id = __ldg(a.tri_id + static_cast<long long>(row) * a.tid_s0 +
                       static_cast<long long>(col) * a.tid_s1);
  const bool covered = id >= 0;
  const int t = take(covered ? id : 0, a.n_tri);

  float edge[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) edge[k] = __ldg(a.edge + t * 9 + k);
  int vids[3], uids[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    vids[i] = take(__ldg(a.tri_v + t * 3 + i), a.n_vert);
    uids[i] = a.vert_uid != nullptr
                  ? take(__ldg(a.vert_uid + vids[i]), a.n_unique)
                  : take(vids[i], a.n_unique);
  }

  float px, py;
  if (a.px != nullptr) {
    px = __ldg(a.px + static_cast<long long>(row) * a.px_s0 +
               static_cast<long long>(col) * a.px_s1);
    py = __ldg(a.py + static_cast<long long>(row) * a.py_s0 +
               static_cast<long long>(col) * a.py_s1);
  } else {
    px = __fadd_rn(static_cast<float>(col), 0.5f);
    py = __fadd_rn(static_cast<float>(row + a.y0), 0.5f);
  }

  const Weights pw = weights(edge, px, py);
  float uv[2], uv_x[2], uv_y[2];
  interp_rows<2>(pw, a.uv, uids, uv);
  interp_rows<2>(weights(edge, __fadd_rn(px, a.step_x), py), a.uv, uids,
                 uv_x);
  interp_rows<2>(weights(edge, px, __fadd_rn(py, a.step_y)), a.uv, uids,
                 uv_y);
  float d[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) d[c] = __fsub_rn(uv_x[c], uv[c]);
  store<2>(a.ddx, e, d);
#pragma unroll
  for (int c = 0; c < 2; ++c) d[c] = __fsub_rn(uv_y[c], uv[c]);
  store<2>(a.ddy, e, d);
  store<2>(a.o_uv, e, uv);

  if (a.velocity != nullptr) {
    float pc[4];
    interp_rows<4>(pw, a.prev_clip, vids, pc);
    const float w = fabsf(pc[3]) < kWFloor ? kWFloor : pc[3];
    const bool moving = covered && pc[3] > 0.0f;
    float vel[2];
    const float cur[2] = {__fmul_rn(px, a.inv_fb_w),
                          __fmul_rn(py, a.inv_fb_h)};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float prev =
          __fadd_rn(__fmul_rn(__fdiv_rn(pc[c], w), 0.5f), 0.5f);
      vel[c] = moving ? __fsub_rn(cur[c], prev) : 0.0f;
    }
    store<2>(a.velocity, e, vel);
  }

  float v[4];
  interp_rows<3>(pw, a.world, vids, v);
  store<3>(a.o_world, e, v);
  interp_rows<3>(pw, a.normal, vids, v);
  // light_loop.py:_normalize.
  const float norm = clamp_min(
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]),
                                     __fmul_rn(v[2], v[2])),
                           __fmul_rn(v[1], v[1]))),
      kNormFloor);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __fdiv_rn(v[c], norm);
  store<3>(a.o_normal, e, v);
  interp_rows<4>(pw, a.tangent, vids, v);
  store<4>(a.o_tangent, e, v);
  interp_rows<3>(pw, a.color, uids, v);
  store<3>(a.o_color, e, v);

  a.mask[e] = covered;
  a.front[e] = __ldg(a.det + t) < 0.0f;
  a.draw[e] = __ldg(a.tri_draw + t);
}

}  // namespace

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = success); the caller raises on anything else.
//
// The elements: `tri_id` int32, a (rows, cols) grid at strides (tid_s0,
// tid_s1) elements; `px` and `py` f32 at their own strides (0 for an
// expanded axis), or both null for the pixel grid from global row y0.
// `step_x`, `step_y` are f32(deriv_step). The tables, contiguous: `edge`
// (n_tri, 3, 3) and `det` (n_tri,) f32, `tri_v` (n_tri, 3) and `tri_draw`
// (n_tri,) int32; `world`, `normal` (n_vert, 3), `tangent` (n_vert, 4) and
// `prev_clip` (n_vert, 4, or null: no velocity) f32; `vert_uid` (n_vert,)
// int32, or null where the expanded ids index the unique tables; `uv`
// (n_unique, 2) and `color` (n_unique, 3) f32. `inv_fb_w`, `inv_fb_h` are
// 1.0f / f32(fb_width) and 1.0f / f32(fb_height). The fields, contiguous,
// (rows, cols) and a last axis of 3, 4 or 2 where the G-buffer has one:
// `mask` and `front` bool, `draw` int32, the rest f32; `velocity` is
// written only with `prev_clip`.
extern "C" int ash_gbuffer(
    const int* tri_id, int rows, int cols, int tid_s0, int tid_s1,
    const float* px, const float* py, int px_s0, int px_s1, int py_s0,
    int py_s1, int y0, float step_x, float step_y, const float* edge,
    const float* det, const int* tri_v, const int* tri_draw, int n_tri,
    const int* vert_uid, int n_vert, const float* world, const float* normal,
    const float* tangent, const float* prev_clip, const float* uv,
    const float* color, int n_unique, float inv_fb_w, float inv_fb_h,
    unsigned char* mask, float* o_world, float* o_normal, float* o_tangent,
    float* o_uv, float* o_color, unsigned char* front, int* draw, float* ddx,
    float* ddy, float* velocity, void* stream) {
  if (rows <= 0 || cols <= 0 || n_tri <= 0 || n_vert <= 0 ||
      n_unique <= 0 || tri_id == nullptr ||
      (px == nullptr) != (py == nullptr) || edge == nullptr || det == nullptr || tri_v == nullptr ||
      tri_draw == nullptr || world == nullptr || normal == nullptr ||
      tangent == nullptr || uv == nullptr || color == nullptr ||
      mask == nullptr || o_world == nullptr || o_normal == nullptr ||
      o_tangent == nullptr || o_uv == nullptr || o_color == nullptr ||
      front == nullptr || draw == nullptr || ddx == nullptr ||
      ddy == nullptr || (prev_clip == nullptr) != (velocity == nullptr) ||
      static_cast<long long>(rows) * cols * 4 > INT_MAX ||
      static_cast<long long>(n_tri) * 9 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{tri_id, rows, cols, tid_s0, tid_s1, px, py, px_s0, px_s1,
               py_s0, py_s1, y0, step_x, step_y, edge, det, tri_v, tri_draw,
               vert_uid, n_tri, n_vert, n_unique, world, normal, tangent,
               prev_clip, uv, color, inv_fb_w, inv_fb_h, mask, front, draw,
               o_world, o_normal, o_tangent, o_uv, o_color, ddx, ddy,
               velocity};
  const long long n = static_cast<long long>(rows) * cols;
  gbuffer_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
