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
// Cost: each (pixel, candidate) pair costs about 30 f32 operations plus L
// predicated compare-selects, while a candidate's record (12 floats) is read
// once per block and shared by all its pixels. Design: one block covers 1024
// pixels of one tile (8 rows of a 64x128 main tile, 2040 blocks at 1080p),
// each of its 256 threads owns 4 pixels and keeps their L (z, id) pairs in
// registers, and the block stages the tile's candidate records in shared
// memory 256 at a time. Every thread walks the candidates in slot order and
// reads each record as a shared-memory broadcast. Making it faster (fewer
// wasted pixel tests through per-chunk bbox rejection, wider pixel blocks
// per thread) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr int kRecord = 12;  // 9 edge coefficients + 3 clip-space z
constexpr int kMaxLayers = 8;
// Pixels per thread. The L (z, id) pairs of each pixel live in registers:
// at L = 8 that is 64 registers on top of the one-layer state (ptxas for
// sm_90a: 47 registers at L = 1, 121 at L = 8 with a floor, no spills).
constexpr int kPixPerThread = 4;
constexpr int kSlicePixels = kThreads * kPixPerThread;

struct Record {
  float a0, b0, c0, a1, b1, c1, a2, b2, c2, z0, z1, z2;
};

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
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ edge,    // (T, 3, 3)
              const float* __restrict__ z_clip,  // (T, 3)
              const int* __restrict__ tri_ids,   // (tiles, K)
              const int* __restrict__ counts,    // (tiles,)
              const float* __restrict__ floor,   // (H, W) if HAS_FLOOR
              float* __restrict__ depth,         // (L, H, W)
              int* __restrict__ tri_id,          // (L, H, W)
              int num_tris, int height, int width, int tile_h, int tile_w,
              int tiles_x, int k, int slices, int y0) {
  __shared__ float s_rec[kChunk][kRecord];
  __shared__ int s_id[kChunk];

  const int tile = blockIdx.x / slices;
  const int slice = blockIdx.x - tile * slices;
  const int base_x = (tile % tiles_x) * tile_w;
  const int base_y = (tile / tiles_x) * tile_h;  // band-local first row
  const int tile_pixels = tile_h * tile_w;

  float px[kPixPerThread], py[kPixPerThread], fl[kPixPerThread];
  float zs[L][kPixPerThread];
  int ts[L][kPixPerThread], out[kPixPerThread];
#pragma unroll
  for (int p = 0; p < kPixPerThread; ++p) {
    const int q = slice * kSlicePixels + p * kThreads + threadIdx.x;
    const int r = q / tile_w;
    const int c = q - r * tile_w;
    const int row = base_y + r;
    const int col = base_x + c;
    px[p] = static_cast<float>(col) + 0.5f;
    py[p] = static_cast<float>(row + y0) + 0.5f;  // global pixel row
    out[p] = (q < tile_pixels && row < height && col < width)
                 ? row * width + col
                 : -1;
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
    for (int j = threadIdx.x; j < n; j += kThreads) {
      int id = ids[start + j];
      if (id >= num_tris) id = -1;  // never index outside the setup arrays
      s_id[j] = id;
      if (id >= 0) {
        const float* e = edge + static_cast<long long>(id) * 9;
        const float* zc = z_clip + static_cast<long long>(id) * 3;
#pragma unroll
        for (int i = 0; i < 9; ++i) s_rec[j][i] = e[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) s_rec[j][9 + i] = zc[i];
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int id = s_id[j];
      if (id < 0) continue;  // uniform across the block
      const float* rc = s_rec[j];
      const Record rec{rc[0], rc[1], rc[2], rc[3], rc[4],  rc[5],
                       rc[6], rc[7], rc[8], rc[9], rc[10], rc[11]};
#pragma unroll
      for (int p = 0; p < kPixPerThread; ++p) {
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

  const long long plane = static_cast<long long>(height) * width;
#pragma unroll
  for (int p = 0; p < kPixPerThread; ++p) {
    if (out[p] >= 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        depth[l * plane + out[p]] = zs[l][p];
        tri_id[l * plane + out[p]] = ts[l][p];
      }
    }
  }
}

template <int L, bool HAS_FLOOR>
int launch(const float* edge, const float* z_clip, const int* tri_ids,
           const int* counts, const float* floor, float* depth, int* tri_id,
           int num_tris, int height, int width, int tile_h, int tile_w, int k,
           int y0, void* stream) {
  const int tiles_y = (height + tile_h - 1) / tile_h;
  const int tiles_x = (width + tile_w - 1) / tile_w;
  const int slices = (tile_h * tile_w + kSlicePixels - 1) / kSlicePixels;
  const int blocks = tiles_y * tiles_x * slices;
  raster_kernel<L, HAS_FLOOR>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          edge, z_clip, tri_ids, counts, floor, depth, tri_id, num_tris,
          height, width, tile_h, tile_w, tiles_x, k, slices, y0);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const float*, const float*, const int*, const int*,
                         const float*, float*, int*, int, int, int, int, int,
                         int, int, void*);

// [L - 2][has_floor]: the 14 instantiations of the peel.
constexpr LaunchFn kLayerLaunch[kMaxLayers - 1][2] = {
    {launch<2, false>, launch<2, true>}, {launch<3, false>, launch<3, true>},
    {launch<4, false>, launch<4, true>}, {launch<5, false>, launch<5, true>},
    {launch<6, false>, launch<6, true>}, {launch<7, false>, launch<7, true>},
    {launch<8, false>, launch<8, true>},
};

}  // namespace

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// the launch (0 = success); the caller raises on anything else.

// One layer: (H, W) depth and id.
extern "C" int ash_raster(const float* edge, const float* z_clip,
                          const int* tri_ids, const int* counts, float* depth,
                          int* tri_id, int num_tris, int height, int width,
                          int tile_h, int tile_w, int k, int y0,
                          void* stream) {
  return launch<1, false>(edge, z_clip, tri_ids, counts, nullptr, depth,
                          tri_id, num_tris, height, width, tile_h, tile_w, k,
                          y0, stream);
}

// The K-layer peel, 2 <= layers <= 8: (layers, H, W) depth and id. `floor`
// is an (H, W) band-local depth floor, or null for none. Returns
// cudaErrorInvalidValue for a layer count outside [2, 8].
extern "C" int ash_raster_layers(const float* edge, const float* z_clip,
                                 const int* tri_ids, const int* counts,
                                 const float* floor, float* depth,
                                 int* tri_id, int num_tris, int height,
                                 int width, int tile_h, int tile_w, int k,
                                 int y0, int layers, void* stream) {
  if (layers < 2 || layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kLayerLaunch[layers - 2][floor != nullptr](
      edge, z_clip, tri_ids, counts, floor, depth, tri_id, num_tris, height,
      width, tile_h, tile_w, k, y0, stream);
}
