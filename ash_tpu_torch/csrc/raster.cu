// Visibility-buffer rasterizers for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ash_tpu/ops/raster_pallas.py:
// _raster_kernel (one layer; entry point ash_raster) and
// _raster_kernel_layers (a K-layer depth peel with an optional depth floor;
// entry point ash_raster_layers), with their helpers _eval_record and
// _pixel_grid, and the XLA-side record packing _pack_tile_data, whose gather
// these kernels do themselves. They compute exactly what
// ash_tpu_torch/ops/raster.py:rasterize computes: for each screen tile,
// every candidate triangle of the tile's bin list is tested in slot order
// (ascending id) at each pixel centre with three homogeneous edge functions
// lam_i = a*px + b*py + c; a pixel is covered when every
// lam_i >= -1e-6 * sum|lam|, sum(lam) > 0 and 0 <= z <= 1, where
// z = sum lam_i * z_clip_i (and, with a floor, z > floor). Each pixel keeps
// its L nearest (z, id) pairs sorted nearest first: a hit bubbles down the
// list, displacing a stored pair that is strictly farther, and the displaced
// pair moves on as the candidate. On equal depth the stored pair stays, so
// with L = 1 this is the LESS depth test where the earlier id wins a tie.
// Layer l is written straight into plane l of (L, H, W) outputs; the padded
// rows and columns of edge tiles are never stored or read.
//
// Bit-exactness with the plain version: every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn, and the library is built with
// --fmad=false) in the plain version's order, (c0*px + c1*py) + c2 and so
// on, so no FMA contraction can move a pixel across a shared edge. Both
// kernels evaluate a candidate with the one function `covers`; after it
// the peel is compares and selects only.
//
// What bounds it: the stores. The work these inputs need, the (pixel,
// candidate) pairs whose pixel centre lies in the triangle's bbox, is about
// 30 f32 operations a pair: 3.4 M pairs at 1080p, 7.7 M for the 2048^2
// shadow map, a few microseconds at the f32 peak. The outputs are 8 bytes a
// pixel a layer (16.6 MB at 1080p), the larger of the two times at the
// memory rate (about 5 us at 1080p). Testing every candidate of a tile at
// every pixel of the tile, as the Pallas kernel does, costs 80 M pairs at
// 1080p and leaves a block of a heavy tile (251 candidates) walking its
// list long after the blocks of empty tiles have finished; that design
// took 0.155 ms on an H100. This one tests about a tenth of those pairs;
// chip_smoke.py phase 5 prints its device time beside the bound, and the
// time with every list empty (the clear, the stores and the launches).
//
// Design: each warp owns one compact 8x16 pixel rectangle of a tile (lane l
// holds column l % 16 of rows l / 16 + {0, 2, 4, 6}, with each pixel's L
// (z, id) pairs in registers), and a block holds up to 8 warps of one tile.
// Every triangle gets a pixel rectangle that provably holds every pixel
// whose centre `covers` can accept (candidate_rect below: the bound of
// ops/raster.py:rect_bounds, derived from the f32 edge rows and the
// rounding of `covers`, in the same f64 operations as its plain version
// ops/raster.py:candidate_rects), computed by a small pre-pass kernel, one
// thread per triangle, that each entry point launches before the raster
// kernel. (In torch, in the wrapper, the rectangles took ~28 small ops,
// 0.5 ms of host time a call against 0.02 ms of kernel; computed inside the
// raster kernel's staging they made three instantiations spill.) The block
// stages the tile's candidates in shared memory once (256 per pass): 12
// floats of edge and depth and the rectangle each, read with plain loads.
// The records are a gather by id, so TMA's tiled copies do not apply, and
// the staging is a few kB per block from L2, so cp.async would not show.
// Each warp then walks the list 32 candidates at a time: each lane tests
// one candidate's rectangle against the warp's rectangle, __ballot_sync
// gives the mask of those that overlap, and the warp evaluates only those,
// lowest slot first (__ffs), so slot order, ties and the peel's order are
// the plain version's. A rejected candidate covers none of the warp's
// pixels, so the result is bit-equal. At 1080p a warp with any candidate
// then evaluates about 11 on average, not up to 251. Blocks of empty tiles
// write the clear and exit. No tensor cores: the work is exact f32
// compare-and-select per pixel, not a product, and TF32 would break the
// equality with the plain version.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kChunk = 256;  // candidates staged per pass
constexpr int kRecord = 12;  // 9 edge coefficients + 3 clip-space z
constexpr int kMaxLayers = 8;
// A warp's pixel rectangle, kRectH x kRectW, with kPixPerLane pixels a lane.
// The L (z, id) pairs of each pixel live in registers (at L = 8, 64
// registers on top of the one-layer state).
constexpr int kRectH = 8;
constexpr int kRectW = 16;
constexpr int kPixPerLane = kRectH * kRectW / 32;
constexpr int kLaneRows = 32 / kRectW;  // rows a warp covers per pixel slot

struct Record {
  float a0, b0, c0, a1, b1, c1, a2, b2, c2, z0, z1, z2;
};

// ops/raster.py's GAMMA3, TOL1, RECT_SCALE and RECT_ULP.
constexpr double kGamma3 = 1.8e-7;
constexpr double kTol1 = 1.000001e-6;
constexpr double kRectScale = 1.001;
constexpr double kRectUlp = 1e-6;

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dsub(double a, double b) {
  return __dsub_rn(a, b);
}

// The conservative pixel rectangle [col0, row0, col1, row1] (inclusive,
// band-local rows) of one triangle from its three f32 edge rows e (3, 3):
// ops/raster.py:rect_bounds and candidate_rects, operation for operation in
// f64, so the two agree bit for bit (rect_bounds holds the derivation).
// Empty is (width, height, -1, -1); unproven is the whole band.
__device__ int4 candidate_rect(const float* __restrict__ e, int height,
                               int width, int y0) {
  double a[3], b[3], c[3];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i] = e[3 * i];
    b[i] = e[3 * i + 1];
    c[i] = e[3 * i + 2];
    finite = finite && isfinite(a[i]) && isfinite(b[i]) && isfinite(c[i]);
  }
  const int4 band = make_int4(0, 0, width - 1, height - 1);
  if (!finite) return band;
  // det * (column i of the edge matrix's inverse) = e_{i+1} x e_{i+2}.
  double qx[3], qy[3], qz[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, k = (i + 2) % 3;
    qx[i] = dsub(dmul(b[j], c[k]), dmul(c[j], b[k]));
    qy[i] = dsub(dmul(c[j], a[k]), dmul(a[j], c[k]));
    qz[i] = dsub(dmul(a[j], b[k]), dmul(b[j], a[k]));
  }
  const double t0 = dmul(a[0], qx[0]), t1 = dmul(b[0], qy[0]),
               t2 = dmul(c[0], qz[0]);
  const double det = dadd(dadd(t0, t1), t2);
  const double mag = dadd(dadd(fabs(t0), fabs(t1)), fabs(t2));
  if (!(fabs(det) > dmul(1e-9, mag))) return band;
  const double xmax = static_cast<double>(width);
  const double ymax = static_cast<double>(y0 + height);
  double w[3], vx[3], vy[3], ebar[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i] = __ddiv_rn(qz[i], det);
    vx[i] = __ddiv_rn(qx[i], qz[i]);
    vy[i] = __ddiv_rn(qy[i], qz[i]);
    ebar[i] = dadd(dadd(dmul(fabs(a[i]), xmax), dmul(fabs(b[i]), ymax)),
                   fabs(c[i]));
  }
  const double w_lo = fmin(fmin(w[0], w[1]), w[2]);
  if (!(w_lo > 0.0)) return band;
  const double esum = dadd(dadd(ebar[0], ebar[1]), ebar[2]);
  double wt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    wt[i] = dmul(w[i], dmul(kGamma3, dadd(ebar[i], dmul(kTol1, esum))));
  }
  const double s = dadd(dadd(wt[0], wt[1]), wt[2]);
  const double rho = __ddiv_rn(fmax(fmax(w[0], w[1]), w[2]), w_lo);
  const double den = dsub(1.0, dmul(4.0 * kTol1, rho));
  if (!(den > 0.5)) return band;
  const double n = __ddiv_rn(dadd(dmul(2.0 * kTol1, rho), s), den);
  const double lo_x = fmin(fmin(vx[0], vx[1]), vx[2]);
  const double hi_x = fmax(fmax(vx[0], vx[1]), vx[2]);
  const double lo_y = fmin(fmin(vy[0], vy[1]), vy[2]);
  const double hi_y = fmax(fmax(vy[0], vy[1]), vy[2]);
  const double ext = fmax(dsub(hi_x, lo_x), dsub(hi_y, lo_y));
  const double reach =
      dadd(fmax(fmax(fabs(lo_x), fabs(hi_x)), fmax(fabs(lo_y), fabs(hi_y))),
           dadd(xmax, ymax));
  const double d = dadd(dmul(dmul(n, ext), kRectScale), dmul(kRectUlp, reach));
  const double bx0 = dsub(lo_x, d), by0 = dsub(lo_y, d);
  const double bx1 = dadd(hi_x, d), by1 = dadd(hi_y, d);
  if (!(isfinite(bx0) && isfinite(by0) && isfinite(bx1) && isfinite(by1))) {
    return band;
  }
  // Pixel c's centre c + 0.5 lies in [lo, hi] iff ceil(lo - 0.5) <= c <=
  // floor(hi - 0.5).
  const double fy0 = static_cast<double>(y0);
  const double c0 = fmax(ceil(dsub(bx0, 0.5)), 0.0);
  const double r0 = fmax(dsub(ceil(dsub(by0, 0.5)), fy0), 0.0);
  const double c1 = fmin(floor(dsub(bx1, 0.5)), xmax - 1.0);
  const double r1 = fmin(dsub(floor(dsub(by1, 0.5)), fy0),
                         static_cast<double>(height - 1));
  if (!(c0 <= c1) || !(r0 <= r1)) return make_int4(width, height, -1, -1);
  return make_int4(static_cast<int>(c0), static_cast<int>(r0),
                   static_cast<int>(c1), static_cast<int>(r1));
}

// Coverage and depth of one candidate at one pixel centre. Returns whether
// the pixel is covered with 0 <= z <= 1; z is the interpolated depth.
__device__ __forceinline__ bool covers(const Record& r, float px, float py,
                                       float& z) {
  const float l0 =
      __fadd_rn(__fadd_rn(__fmul_rn(r.a0, px), __fmul_rn(r.b0, py)), r.c0);
  const float l1 =
      __fadd_rn(__fadd_rn(__fmul_rn(r.a1, px), __fmul_rn(r.b1, py)), r.c1);
  const float l2 =
      __fadd_rn(__fadd_rn(__fmul_rn(r.a2, px), __fmul_rn(r.b2, py)), r.c2);
  const float s = __fadd_rn(__fadd_rn(l0, l1), l2);
  const float thr = __fmul_rn(
      __fadd_rn(__fadd_rn(fabsf(l0), fabsf(l1)), fabsf(l2)), -1e-6f);
  z = __fadd_rn(__fadd_rn(__fmul_rn(l0, r.z0), __fmul_rn(l1, r.z1)),
                __fmul_rn(l2, r.z2));
  return (l0 >= thr) & (l1 >= thr) & (l2 >= thr) & (s > 0.0f) &
         (z >= 0.0f) & (z <= 1.0f);
}

template <int L, bool HAS_FLOOR>
__global__ void __launch_bounds__(kMaxThreads)
raster_warp_kernel(const float* __restrict__ edge,    // (T, 3, 3)
                   const float* __restrict__ z_clip,  // (T, 3)
                   const int4* __restrict__ rects,    // (T,) candidate_rect
                   const int* __restrict__ tri_ids,   // (tiles, K)
                   const int* __restrict__ counts,    // (tiles,)
                   const float* __restrict__ floor,   // (H, W) if HAS_FLOOR
                   float* __restrict__ depth,         // (L, H, W)
                   int* __restrict__ tri_id,          // (L, H, W)
                   int num_tris, int height, int width, int tile_h,
                   int tile_w, int tiles_x, int k, int rects_x,
                   int rects_per_tile, int groups, int y0) {
  __shared__ __align__(16) float s_rec[kChunk][kRecord];
  __shared__ int4 s_rect[kChunk];
  __shared__ int s_id[kChunk];

  const int tile = blockIdx.x / groups;
  const int group = blockIdx.x - tile * groups;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rect = group * warps + (threadIdx.x >> 5);
  const int tile_x0 = (tile % tiles_x) * tile_w;
  const int tile_y0 = (tile / tiles_x) * tile_h;  // band-local first row
  const int rect_y = rect / rects_x;
  // The warp's pixel rectangle [wx0, wx1] x [wy0, wy1], clipped to its
  // tile and to the band (band-local rows).
  const int wx0 = tile_x0 + (rect - rect_y * rects_x) * kRectW;
  const int wy0 = tile_y0 + rect_y * kRectH;
  const int wx1 = min(min(wx0 + kRectW, tile_x0 + tile_w), width) - 1;
  const int wy1 = min(min(wy0 + kRectH, tile_y0 + tile_h), height) - 1;
  // Uniform across the warp: the warp has pixels to rasterize.
  const bool active = rect < rects_per_tile && wx0 <= wx1 && wy0 <= wy1;

  float px[kPixPerLane], py[kPixPerLane], fl[kPixPerLane];
  float zs[L][kPixPerLane];
  int ts[L][kPixPerLane], out[kPixPerLane];
  const int col = wx0 + (lane % kRectW);
#pragma unroll
  for (int p = 0; p < kPixPerLane; ++p) {
    const int row = wy0 + lane / kRectW + p * kLaneRows;
    px[p] = static_cast<float>(col) + 0.5f;
    py[p] = static_cast<float>(row + y0) + 0.5f;  // global pixel row
    out[p] = (active && col <= wx1 && row <= wy1) ? row * width + col : -1;
    fl[p] = (HAS_FLOOR && out[p] >= 0) ? floor[out[p]] : 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      zs[l][p] = 1.0f;
      ts[l][p] = -1;
    }
  }

  const int count = min(counts[tile], k);
  const int* ids = tri_ids + static_cast<long long>(tile) * k;
  for (int start = 0; start < count; start += kChunk) {
    const int n = min(kChunk, count - start);
    __syncthreads();  // the previous chunk has been consumed
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      int id = ids[start + j];
      if (id >= num_tris) id = -1;  // never index outside the setup arrays
      s_id[j] = id;
      // An empty rectangle overlaps no warp: padding slots are rejected.
      int4 rc = make_int4(INT_MAX, INT_MAX, INT_MIN, INT_MIN);
      if (id >= 0) {
        const float* e = edge + static_cast<long long>(id) * 9;
        const float* zc = z_clip + static_cast<long long>(id) * 3;
#pragma unroll
        for (int i = 0; i < 9; ++i) s_rec[j][i] = e[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) s_rec[j][9 + i] = zc[i];
        rc = rects[id];
      }
      s_rect[j] = rc;
    }
    __syncthreads();
    if (!active) continue;
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      bool overlap = false;
      if (j < n) {
        const int4 rc = s_rect[j];
        overlap = (rc.x <= wx1) & (rc.z >= wx0) & (rc.y <= wy1) &
                  (rc.w >= wy0);
      }
      unsigned mask = __ballot_sync(0xffffffffu, overlap);
      while (mask != 0u) {  // uniform across the warp
        const int slot = base + __ffs(mask) - 1;
        mask &= mask - 1u;
        const float4* rv = reinterpret_cast<const float4*>(s_rec[slot]);
        const float4 q0 = rv[0], q1 = rv[1], q2 = rv[2];
        const Record rec{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                         q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
        const int id = s_id[slot];
#pragma unroll
        for (int p = 0; p < kPixPerLane; ++p) {
          float cz;
          bool hit = covers(rec, px[p], py[p], cz);
          if (HAS_FLOOR) hit = hit & (cz > fl[p]);
          int ct = id;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const bool swap = hit & (cz < zs[l][p]);
            const float oz = zs[l][p];
            const int ot = ts[l][p];
            zs[l][p] = swap ? cz : oz;
            ts[l][p] = swap ? ct : ot;
            cz = swap ? oz : cz;
            ct = swap ? ot : ct;
          }
        }
      }
    }
  }

  const long long plane = static_cast<long long>(height) * width;
#pragma unroll
  for (int p = 0; p < kPixPerLane; ++p) {
    if (out[p] >= 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        depth[l * plane + out[p]] = zs[l][p];
        tri_id[l * plane + out[p]] = ts[l][p];
      }
    }
  }
}

// One thread per triangle: candidate_rect into (T, 4) int32, the raster
// kernels' pre-pass.
__global__ void candidate_rects_kernel(const float* __restrict__ edge,
                                       int4* __restrict__ rects, int num_tris,
                                       int height, int width, int y0) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < num_tris) {
    rects[t] = candidate_rect(edge + static_cast<long long>(t) * 9, height,
                              width, y0);
  }
}

int launch_rects(const float* edge, int* rects, int num_tris, int height,
                 int width, int y0, cudaStream_t stream) {
  if (num_tris > 0) {
    candidate_rects_kernel<<<(num_tris + 255) / 256, 256, 0, stream>>>(
        edge, reinterpret_cast<int4*>(rects), num_tris, height, width, y0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int L, bool HAS_FLOOR>
int launch(const float* edge, const float* z_clip, int* rects,
           const int* tri_ids,
           const int* counts, const float* floor,
           float* depth, int* tri_id, int num_tris, int height, int width,
           int tile_h, int tile_w, int k, int y0, void* stream) {
  const int tiles_y = (height + tile_h - 1) / tile_h;
  const int tiles_x = (width + tile_w - 1) / tile_w;
  const int rects_x = (tile_w + kRectW - 1) / kRectW;
  const int rects_per_tile = rects_x * ((tile_h + kRectH - 1) / kRectH);
  const int warps = min(kMaxWarps, rects_per_tile);
  const int groups = (rects_per_tile + warps - 1) / warps;
  const long long blocks = static_cast<long long>(tiles_y) * tiles_x * groups;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_rects(edge, rects, num_tris, height, width, y0, s);
  if (err != 0) return err;
  raster_warp_kernel<L, HAS_FLOOR><<<static_cast<int>(blocks), warps * 32, 0,
                                     s>>>(
          edge, z_clip, reinterpret_cast<const int4*>(rects), tri_ids,
          counts, floor, depth, tri_id, num_tris, height, width, tile_h,
          tile_w, tiles_x, k, rects_x, rects_per_tile, groups, y0);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const float*, const float*, int*, const int*,
                         const int*, const float*, float*, int*, int, int, int,
                         int, int, int, int, void*);

// [L - 2][has_floor]: the 14 instantiations of the peel.
constexpr LaunchFn kLayerLaunch[kMaxLayers - 1][2] = {
    {launch<2, false>, launch<2, true>}, {launch<3, false>, launch<3, true>},
    {launch<4, false>, launch<4, true>}, {launch<5, false>, launch<5, true>},
    {launch<6, false>, launch<6, true>}, {launch<7, false>, launch<7, true>},
    {launch<8, false>, launch<8, true>},
};

}  // namespace

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// its launches (0 = success); the caller raises on anything else. From
// `edge` the pre-pass writes each triangle's pixel rectangle into `rects`,
// (T, 4) int32 scratch, 16-byte aligned, that the raster kernel reads.

// One layer: (H, W) depth and id.
extern "C" int ash_raster(const float* edge, const float* z_clip, int* rects,
                          const int* tri_ids, const int* counts, float* depth,
                          int* tri_id, int num_tris, int height, int width,
                          int tile_h, int tile_w, int k, int y0,
                          void* stream) {
  return launch<1, false>(edge, z_clip, rects, tri_ids, counts, nullptr,
                          depth, tri_id, num_tris, height, width, tile_h,
                          tile_w, k, y0, stream);
}

// The K-layer peel, 2 <= layers <= 8: (layers, H, W) depth and id. `floor`
// is an (H, W) band-local depth floor, or null for none. Returns
// cudaErrorInvalidValue for a layer count outside [2, 8].
extern "C" int ash_raster_layers(const float* edge, const float* z_clip,
                                 int* rects, const int* tri_ids,
                                 const int* counts, const float* floor,
                                 float* depth, int* tri_id, int num_tris,
                                 int height, int width, int tile_h,
                                 int tile_w, int k, int y0, int layers,
                                 void* stream) {
  if (layers < 2 || layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kLayerLaunch[layers - 2][floor != nullptr](
      edge, z_clip, rects, tri_ids, counts, floor, depth, tri_id, num_tris,
      height, width, tile_h, tile_w, k, y0, stream);
}

// The pre-pass alone: the rectangles the raster kernels use, for holding
// against ops/raster.py:candidate_rects.
extern "C" int ash_candidate_rects(const float* edge, int* rects,
                                   int num_tris, int height, int width,
                                   int y0, void* stream) {
  return launch_rects(edge, rects, num_tris, height, width, y0,
                      static_cast<cudaStream_t>(stream));
}
