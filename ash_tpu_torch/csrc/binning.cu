// Triangle-to-tile binning for Hopper (sm_90a): each screen tile's list of
// the triangles whose bounding box overlaps it, ascending ids, -1 padded.
//
// Replaces the jax.numpy binners of ash_tpu/ops/binning.py:57
// (bin_triangles) and :142 (bin_triangles_two_level), which are not TPU
// kernels: XLA fuses their dense (tiles, T) overlap matrix and top_k there.
// The port's plain ash_tpu_torch/ops/binning.py builds the same matrix and
// compacts each row with torch.topk (a 289 MB score matrix and topk at
// k = 65,536 on each of 72 rows at the 1M-triangle frame's coarse level).
// One entry, ash_bin_level, bins one level in three launches and computes
// what the plain binner computes, array for array:
// - the dense level (bin_triangles, and the coarse level of the two-level
//   binner): the items are the T triangles; triangle i overlaps tile
//   (row, col) when it is valid, its box meets the band [y_lo, y_hi) x
//   [0, x_hi), and its tile range covers (row, col);
// - the fine level: the items of coarse tile g are its coarse list, in slot
//   order; a candidate overlaps fine tile (Y, X) of g when its box meets
//   the tile's pixel rectangle; the pad tiles past the real grid are
//   dropped (no list, no count, no overflow).
// A tile keeps min(total, K) ids: the first K in item order, or, with a
// keep score (binning_policy "nearest"), the K of largest key (below),
// either way in ascending id order, the rest of its row -1. counts =
// min(total, K); the overflow scalar takes the largest total - K over the
// level's tiles by atomicMax, so the two levels of one call share it and
// its value is the larger of theirs.
//
// The "nearest" key of triangle id, a 64-bit unsigned integer, a larger
// key kept longer: the high word is the keep score s mapped in order,
//   NaN (any sign)  -> 0xFFFFFFFF,
//   s == 0 (+-0.0)  -> 0x80000000,
//   else u = the bits of s: sign set -> ~u, sign clear -> u | 0x80000000;
// the low word is ~id. This is the order of ops/binning.py's _keep_rank
// (a stable argsort of the score, ties to the lower id), so the kernels
// need no sort: -0.0 ranks equal to +0.0, every NaN above +inf and all
// NaNs equal, and equal scores go to the lower id.
//
// Equality with the plain binner on the card (torch 2.11):
// - floor(coord / size) divides by a host int, which PyTorch computes as
//   coord times the f32 reciprocal of the size (BinaryDivTrueKernel.cu): the
//   wrapper hands in 1.0f / f32(size), rounded on the host as PyTorch
//   rounds it, and the product is rounded on its own (__fmul_rn; built with
//   --fmad=false); coord - y0 is one f32 subtraction;
// - the clamp to [0, hi] is taken in float before the conversion to int,
//   so boxes of +-1e9 and +-inf land on the edge tiles; a NaN coordinate
//   fails one of the band tests, so such a triangle overlaps nothing;
// - the fine level's px0 + tile_w and py0 + tile_h are f32 sums of f32
//   values (the plain version's float tensor plus a Python int);
// - the order of ids never depends on atomics: each chunk of items counts
//   its hits per tile (bin_count_kernel), each tile takes an exclusive scan
//   over its chunks (bin_select_kernel), and each chunk writes its hits at
//   its offset plus the hits before it in the chunk (bin_write_kernel).
//   Atomics only set bits of masks, add to histograms and take the
//   overflow's maximum, whose results do not depend on their order.
// A tile that overflows under a keep score is written by its own select
// block: an MSB-first radix select over the keys of its hits (8 bits a
// pass; the digits of ~id above the largest id's bits are all ones and
// take no pass) finds its K-th largest key, and one more ordered pass over
// its items writes the hits at or above it.
//
// What bounds it: the bytes (chip_smoke.py:binning_work). Each triangle's
// box and valid flag (and keep score) are read once, each list, count and
// the overflow written once: at the 1M-triangle frame about 21 MB in and
// 67 MB of fine lists out, 0.026 ms at 3.35 TB/s; at 1000 cubes 0.5-1.3 MB,
// under a microsecond, so there three launches in a graph set the floor.
// What the design does about what held PR 24's kernels back:
// 1. work in proportion to a coarse list: a fine count or write block whose
//    chunk starts at or past ccount[g] returns at once, and a fine select
//    block scans only ceil(ccount[g] / chunk) chunks (8 a thread, loaded
//    together); the entries of cnt past them are never written or read;
// 2. each (item, tile) pair is tested once, in the count kernel, which
//    keeps what the write kernel needs: at the fine level each warp's
//    ballot mask a tile ([group][chunk][tile][warp], 8 words a warp at 4x2
//    fine tiles); at the dense level each triangle's clamped tile range,
//    16 bits a bound (8 bytes a triangle), from which the write kernel sets
//    the same masks in shared memory. The write kernel reads no box. (A
//    fused count-and-write with a decoupled look-back was not taken: the
//    select block also pads the rows and ranks an overflowing tile, which
//    needs every chunk's count first.);
// 3. shared memory sized by the level (dynamic: a batch of tiles times the
//    warps of a chunk; 8 tiles at the fine level), cnt laid out as
//    [group][chunk][tile] so a write block reads its offsets in one
//    coalesced load, and the offsets of a tile's warps one shuffle scan a
//    tile over the block's warps;
// 4. enough blocks at 1000 cubes: the wrapper halves the chunk (256 items,
//    then 128, then 64) while a level has fewer than two blocks an SM, and
//    each triangle walks only its own tile range (a shared atomicOr a tile
//    it covers), with no global load inside the per-tile loop;
// 5. the -1 padding in 16-byte stores, with a scalar head to the row's
//    16-byte boundary and a scalar tail, for any K;
// 6. "nearest" without the argsort: the select block ranks an overflowing
//    tile by the key above, read from the score itself.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The largest chunk: the threads of a count or write block, one an item.
constexpr int kMaxChunk = 256;
// Threads of a select block.
constexpr int kSelect = 512;
constexpr int kSelectWarps = kSelect / 32;
// Chunks a select thread scans at once.
constexpr int kScan = 8;
// A write block's shared memory (two words a tile and warp) at most.
constexpr int kSharedBytes = 32768;

struct Level {
  // The triangles: (n_tri, 4) boxes [x0, y0, x1, y1], valid flags (the
  // dense level), keep scores (null: draw order).
  const float* bbox;
  const unsigned char* valid;
  const float* score;
  int n_tri;
  // The dense level's grid and band, or the fine level's coarse grid.
  int tiles_y, tiles_x;
  float inv_th, inv_tw, y_lo, y_hi, x_hi;
  // The fine level: the coarse lists (groups, kc) and their counts; the
  // fine tiles a coarse tile (cy_f, cx_f); the real fine grid; the fine
  // tile's pixels; the band's first row.
  const int* cand;
  const int* ccount;
  int kc, cy_f, cx_f, fine_ty, fine_tx, tile_h, tile_w, y0;
  // groups x per_group tiles; `items` items a group in `chunks` chunks of
  // `chunk`; count and write blocks take tiles `batch` at a time.
  int groups, per_group, items, chunk, chunks, batch;
  // Scratch: hits per (group, chunk, tile), then the chunk's offset; each
  // tile's total; the count kernel's memo (the fine level: ballot masks
  // per (group, chunk, tile, warp); the dense level: each triangle's tile
  // range, two words). Outputs: (tiles, K) ids, (tiles,) counts, the
  // overflow.
  int* cnt;
  int* total;
  unsigned* memo;
  int* ids;
  int* counts;
  int* overflow;
  int K;
};

// floor(coord * inv) clamped to [0, hi], as an int.
__device__ __forceinline__ int tile_index(float coord, float inv, int hi) {
  float t = floorf(__fmul_rn(coord, inv));
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(hi));
  return static_cast<int>(t);
}

// A dense-level triangle's tiles: columns [c0, c1] x rows [r0, r1]; empty
// (c0 > c1) for a triangle that overlaps nothing.
struct Range {
  int c0, c1, r0, r1;
};

// The dense level's test of triangle i, as the plain binner's band test
// and floor(coord / size) clamp.
__device__ __forceinline__ Range dense_range(const Level& L, int i) {
  Range r{1, 0, 1, 0};
  if (i >= L.n_tri) return r;
  const float* b = L.bbox + static_cast<size_t>(i) * 4;
  const float b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3];
  if (!(L.valid[i] && b3 >= L.y_lo && b1 < L.y_hi && b2 >= 0.0f &&
        b0 < L.x_hi)) {
    return r;
  }
  r.c0 = tile_index(b0, L.inv_tw, L.tiles_x - 1);
  r.r0 = tile_index(__fsub_rn(b1, L.y_lo), L.inv_th, L.tiles_y - 1);
  r.c1 = tile_index(b2, L.inv_tw, L.tiles_x - 1);
  r.r1 = tile_index(__fsub_rn(b3, L.y_lo), L.inv_th, L.tiles_y - 1);
  return r;
}

// A range in the memo's two words, 16 bits a bound (the grid is at most
// 65535 tiles a side).
__device__ __forceinline__ uint2 pack(const Range& r) {
  return make_uint2(
      static_cast<unsigned>(r.c0) | (static_cast<unsigned>(r.c1) << 16),
      static_cast<unsigned>(r.r0) | (static_cast<unsigned>(r.r1) << 16));
}

__device__ __forceinline__ Range unpack(uint2 w) {
  return Range{static_cast<int>(w.x & 0xffffu), static_cast<int>(w.x >> 16),
               static_cast<int>(w.y & 0xffffu), static_cast<int>(w.y >> 16)};
}

__device__ __forceinline__ bool covers(const Range& r, int tiles_x, int p) {
  const int row = p / tiles_x, col = p - row * tiles_x;
  return col >= r.c0 && col <= r.c1 && row >= r.r0 && row <= r.r1;
}

// f(p) for each tile p of the range inside [p0, p0 + n), in order.
template <typename F>
__device__ __forceinline__ void for_each_tile(const Range& r, int tiles_x,
                                              int p0, int n, F f) {
  if (r.c0 > r.c1) return;
  const int lo = max(r.r0, p0 / tiles_x);
  const int hi = min(r.r1, (p0 + n - 1) / tiles_x);
  for (int row = lo; row <= hi; ++row) {
    const int a = max(row * tiles_x + r.c0, p0);
    const int b = min(row * tiles_x + r.c1, p0 + n - 1);
    for (int p = a; p <= b; ++p) f(p);
  }
}

// The fine level: the id of slot i of coarse tile g's list (-1: past its
// count) and its box.
struct Box {
  int id;
  float x0, y0, x1, y1;
};

__device__ __forceinline__ Box fine_box(const Level& L, int g, int i, int n) {
  Box b{-1, 0.f, 0.f, 0.f, 0.f};
  if (i >= n) return b;
  const int id = L.cand[static_cast<size_t>(g) * L.kc + i];
  if (id < 0) return b;
  const float* p = L.bbox + static_cast<size_t>(id) * 4;
  return Box{id, p[0], p[1], p[2], p[3]};
}

// The fine level's test: whether the box meets fine tile p of group g.
__device__ __forceinline__ bool fine_hit(const Level& L, const Box& b, int g,
                                         int p) {
  if (b.id < 0) return false;
  const int Y = (g / L.tiles_x) * L.cy_f + p / L.cx_f;
  const int X = (g % L.tiles_x) * L.cx_f + p % L.cx_f;
  const float px0 = static_cast<float>(X * L.tile_w);
  const float py0 = static_cast<float>(Y * L.tile_h + L.y0);
  return b.x1 >= px0 && b.x0 < __fadd_rn(px0, static_cast<float>(L.tile_w)) &&
         b.y1 >= py0 && b.y0 < __fadd_rn(py0, static_cast<float>(L.tile_h));
}

// The output row of tile p of group g, or -1 for a fine pad tile.
template <bool kFine>
__device__ __forceinline__ int out_tile(const Level& L, int g, int p) {
  if (!kFine) return p;
  const int Y = (g / L.tiles_x) * L.cy_f + p / L.cx_f;
  const int X = (g % L.tiles_x) * L.cx_f + p % L.cx_f;
  return (Y < L.fine_ty && X < L.fine_tx) ? Y * L.fine_tx + X : -1;
}

// The items of group g: the dense level's triangles, or the slots of coarse
// tile g's list up to its count.
template <bool kFine>
__device__ __forceinline__ int group_items(const Level& L, int g) {
  return kFine ? min(L.ccount[g], L.items) : L.items;
}

// Where chunk `chunk` of group g keeps tile p's count and offset, and (times
// the warps of a chunk) its fine masks.
__device__ __forceinline__ size_t cnt_at(const Level& L, int g, int chunk,
                                         int p) {
  return (static_cast<size_t>(g) * L.chunks + chunk) * L.per_group + p;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The dense level: mask[(p - p0) * nw + warp] |= the calling lane's bit for
// each tile p of its range in the batch [p0, p0 + n). The block first
// zeroes the batch's masks; every thread calls it.
__device__ __forceinline__ void set_masks(const Range& r, int tiles_x, int p0,
                                          int n, unsigned* mask) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < n * nw; j += blockDim.x) mask[j] = 0;
  __syncthreads();
  const unsigned bit = 1u << (threadIdx.x & 31);
  for_each_tile(r, tiles_x, p0, n, [&](int p) {
    atomicOr(&mask[(p - p0) * nw + warp], bit);
  });
  __syncthreads();
}

// Block of `chunk` threads, (group, chunk) = blockIdx.x as g * chunks +
// chunk: the chunk's hits on each tile into cnt, and the memo.
template <bool kFine>
__global__ void __launch_bounds__(kMaxChunk) bin_count_kernel(const Level L) {
  extern __shared__ unsigned mask[];  // [batch][warps]
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int g = blockIdx.x / L.chunks, chunk = blockIdx.x % L.chunks;
  const int i = chunk * L.chunk + threadIdx.x;
  const int n = group_items<kFine>(L, g);
  if (chunk * L.chunk >= n) return;
  Box box{-1, 0.f, 0.f, 0.f, 0.f};
  Range range{1, 0, 1, 0};
  if (kFine) {
    box = fine_box(L, g, i, n);
  } else {
    range = dense_range(L, i);
    if (i < L.n_tri) reinterpret_cast<uint2*>(L.memo)[i] = pack(range);
  }
  for (int p0 = 0; p0 < L.per_group; p0 += L.batch) {
    const int nb = min(L.batch, L.per_group - p0);
    if (kFine) {
      for (int q = 0; q < nb; ++q) {
        const unsigned m =
            __ballot_sync(0xffffffffu, fine_hit(L, box, g, p0 + q));
        if ((threadIdx.x & 31) == 0) mask[q * nw + warp] = m;
      }
      __syncthreads();
      unsigned* out = L.memo + cnt_at(L, g, chunk, p0) * nw;
      for (int j = threadIdx.x; j < nb * nw; j += blockDim.x) out[j] = mask[j];
    } else {
      set_masks(range, L.tiles_x, p0, nb, mask);
    }
    for (int q = threadIdx.x; q < nb; q += blockDim.x) {
      int s = 0;
      for (int w = 0; w < nw; ++w) s += __popc(mask[q * nw + w]);
      L.cnt[cnt_at(L, g, chunk, p0 + q)] = s;
    }
    __syncthreads();
  }
}

// The exclusive sum of v over a kSelect block in thread order; *total gets
// the block's sum. Every thread calls it.
__device__ int block_exclusive_sum(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSelectWarps ? sh[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kSelectWarps) sh[lane] = w;
  }
  __syncthreads();
  const int before = warp ? sh[warp - 1] : 0;
  *total = sh[kSelectWarps - 1];
  __syncthreads();
  return before + x - v;
}

// row[from, K) = -1 by a kSelect block: 16-byte stores from the row's first
// 16-byte boundary, scalar stores before it and after the last.
__device__ __forceinline__ void pad_row(int* row, int from, int K) {
  if (from >= K) return;
  const int head =
      min(static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row + from) &
                                   15)) & 15) / 4),
          K - from);
  if (threadIdx.x < head) row[from + threadIdx.x] = -1;
  const int start = from + head;
  const int vecs = (K - start) / 4;
  int4* v = reinterpret_cast<int4*>(row + start);
  for (int j = threadIdx.x; j < vecs; j += kSelect) {
    v[j] = make_int4(-1, -1, -1, -1);
  }
  for (int j = start + 4 * vecs + threadIdx.x; j < K; j += kSelect) {
    row[j] = -1;
  }
}

// The keep score's 32-bit order key (the source note).
__device__ __forceinline__ unsigned score_key(float s) {
  if (s != s) return 0xffffffffu;
  if (s == 0.0f) return 0x80000000u;
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Item i of group g (i below the group's items): its triangle id, whether
// it overlaps tile p (from the count kernel's memo) and its key.
template <bool kFine>
__device__ __forceinline__ int item_id(const Level& L, int g, int i) {
  return kFine ? L.cand[static_cast<size_t>(g) * L.kc + i] : i;
}

template <bool kFine>
__device__ __forceinline__ bool item_hits(const Level& L, int g, int p,
                                          int i) {
  if (kFine) {
    const int nw = L.chunk >> 5;
    const int c = i / L.chunk, w = (i - c * L.chunk) >> 5;
    return (L.memo[cnt_at(L, g, c, p) * nw + w] >> (i & 31)) & 1u;
  }
  return covers(unpack(reinterpret_cast<const uint2*>(L.memo)[i]),
                L.tiles_x, p);
}

__device__ __forceinline__ unsigned long long item_key(const Level& L,
                                                       int id) {
  return (static_cast<unsigned long long>(score_key(L.score[id])) << 32) |
         static_cast<unsigned>(~id);
}

// Block of kSelect for tile p of group g (blockIdx.x = g * per_group + p):
// the exclusive scan of its chunks' hits (cnt becomes the offsets), its
// total, count and overflow, the -1 padding of its row, and, for a tile
// that overflows under a keep score, its whole list.
template <bool kFine>
__global__ void __launch_bounds__(kSelect) bin_select_kernel(const Level L) {
  __shared__ int sh[kSelectWarps];
  __shared__ int hist[256];
  __shared__ int digit[2];
  const int gp = blockIdx.x;
  const int g = gp / L.per_group, p = gp % L.per_group;
  const int out = out_tile<kFine>(L, g, p);
  if (out < 0) return;
  const int n = group_items<kFine>(L, g);
  const int active = (n + L.chunk - 1) / L.chunk;
  // kScan consecutive chunks a thread, loaded together.
  int carry = 0;
  for (int c0 = 0; c0 < active; c0 += kSelect * kScan) {
    const int c = c0 + threadIdx.x * kScan;
    int v[kScan];
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      v[k] = c + k < active ? L.cnt[cnt_at(L, g, c + k, p)] : 0;
    }
    int own = 0;
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int x = v[k];
      v[k] = own;
      own += x;
    }
    int sum;
    const int ex = block_exclusive_sum(own, sh, &sum);
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      if (c + k < active) L.cnt[cnt_at(L, g, c + k, p)] = carry + ex + v[k];
    }
    carry += sum;
  }
  const int total = carry, K = L.K;
  const int kept = min(total, K);
  if (threadIdx.x == 0) {
    L.total[gp] = total;
    L.counts[out] = kept;
    if (total > K) atomicMax(L.overflow, total - K);
  }
  int* row = L.ids + static_cast<size_t>(out) * K;
  pad_row(row, kept, K);
  if (L.score == nullptr || total <= K) return;

  // The K-th largest key among the tile's hits, 8 bits a pass from the
  // top: `prefix` holds the digits found, `mask` their bits. The digits of
  // ~id at and above bit `bits` (every id is below 2^bits) are all ones.
  int bits = 0;
  while (bits < 32 && (static_cast<unsigned>(L.n_tri - 1) >> bits)) ++bits;
  unsigned long long prefix = 0, mask = 0;
  int want = K;
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift < 32 && shift >= bits) {
      prefix |= 0xffull << shift;
      mask |= 0xffull << shift;
      continue;
    }
    for (int j = threadIdx.x; j < 256; j += kSelect) hist[j] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kSelect) {
      if (!item_hits<kFine>(L, g, p, i)) continue;
      const unsigned long long key = item_key(L, item_id<kFine>(L, g, i));
      if ((key & mask) == prefix) {
        atomicAdd(&hist[static_cast<int>((key >> shift) & 255u)], 1);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int acc = 0, d = 255;
      for (; d > 0; --d) {
        if (acc + hist[d] >= want) break;
        acc += hist[d];
      }
      digit[0] = d;
      digit[1] = want - acc;
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(digit[0]) << shift;
    mask |= 0xffull << shift;
    want = digit[1];
    __syncthreads();
  }
  // Keys are distinct: exactly K hits have a key >= prefix. Write them in
  // item order.
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += kSelect) {
    const int i = i0 + threadIdx.x;
    int id = -1;
    bool keep = false;
    if (i < n && item_hits<kFine>(L, g, p, i)) {
      id = item_id<kFine>(L, g, i);
      keep = item_key(L, id) >= prefix;
    }
    int sum;
    const int ex = block_exclusive_sum(keep ? 1 : 0, sh, &sum);
    if (keep) row[base + ex] = id;
    base += sum;
  }
}

// Block of `chunk` threads, as bin_count_kernel's: each hit of the chunk
// at its tile's offset for the chunk plus the hits before it in the chunk,
// where that is below K, from the count kernel's memo. Tiles that a select
// block wrote (overflowing under a keep score) and fine pad tiles are
// skipped.
template <bool kFine>
__global__ void __launch_bounds__(kMaxChunk) bin_write_kernel(const Level L) {
  extern __shared__ unsigned smem[];
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* mask = smem;                                  // [batch][warps]
  int* base = reinterpret_cast<int*>(smem + L.batch * nw);  // [batch][warps]
  const int g = blockIdx.x / L.chunks, chunk = blockIdx.x % L.chunks;
  const int i = chunk * L.chunk + threadIdx.x;
  const int n = group_items<kFine>(L, g);
  if (chunk * L.chunk >= n) return;
  const unsigned below = lanes_below();
  int id = -1;
  Range range{1, 0, 1, 0};
  if (kFine) {
    if (i < n) id = L.cand[static_cast<size_t>(g) * L.kc + i];
  } else if (i < n) {
    id = i;
    range = unpack(reinterpret_cast<const uint2*>(L.memo)[i]);
  }
  for (int p0 = 0; p0 < L.per_group; p0 += L.batch) {
    const int nb = min(L.batch, L.per_group - p0);
    if (kFine) {
      const unsigned* in = L.memo + cnt_at(L, g, chunk, p0) * nw;
      for (int j = threadIdx.x; j < nb * nw; j += blockDim.x) mask[j] = in[j];
      __syncthreads();
    } else {
      set_masks(range, L.tiles_x, p0, nb, mask);
    }
    // base[q][w]: where warp w's first hit on tile p0 + q goes, or K where
    // the block writes nothing on the tile. The warps' hits are scanned in
    // aligned groups of nw lanes, one group a tile; a tile the chunk does
    // not hit reads no offset (and no thread reads its base).
    for (int j0 = 0; j0 < nb * nw; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      const int v = j < nb * nw ? __popc(mask[j]) : 0;
      int x = v;
      for (int d = 1; d < nw; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d, nw);
        if ((lane & (nw - 1)) >= d) x += y;
      }
      if (__shfl_sync(0xffffffffu, x, nw - 1, nw) > 0) {
        const int p = p0 + j / nw;
        const bool skip =
            out_tile<kFine>(L, g, p) < 0 ||
            (L.score != nullptr && L.total[g * L.per_group + p] > L.K);
        base[j] = skip ? L.K : L.cnt[cnt_at(L, g, chunk, p)] + x - v;
      }
    }
    __syncthreads();
    auto put = [&](int p) {
      const int j = (p - p0) * nw + warp;
      const unsigned m = mask[j];
      const int pos = base[j] + __popc(m & below);
      if (pos < L.K) {
        L.ids[static_cast<size_t>(out_tile<kFine>(L, g, p)) * L.K + pos] = id;
      }
    };
    if (kFine) {
      for (int q = 0; q < nb; ++q) {
        if ((mask[q * nw + warp] >> lane) & 1u) put(p0 + q);
      }
    } else {
      for_each_tile(range, L.tiles_x, p0, nb, put);
    }
    __syncthreads();
  }
}

template <bool kFine>
int run_level(const Level& L, cudaStream_t stream) {
  const int blocks = L.groups * L.chunks;
  const int nw = L.chunk / 32;
  const size_t words = static_cast<size_t>(L.batch) * nw * sizeof(unsigned);
  if (blocks > 0) {
    bin_count_kernel<kFine><<<blocks, L.chunk, words, stream>>>(L);
  }
  bin_select_kernel<kFine><<<L.groups * L.per_group, kSelect, 0, stream>>>(L);
  if (blocks > 0) {
    bin_write_kernel<kFine><<<blocks, L.chunk, 2 * words, stream>>>(L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launches (0 = success); the caller raises on anything else.
//
// Bins one level into `ids` (tiles, max_per_tile) int32, `counts` (tiles,)
// int32 and the int32 scalar `overflow`, which it first zeroes when
// `zero_overflow` is set and otherwise raises to the level's overflow.
// The triangles: `bbox` (n_tri, 4) f32, `valid` (n_tri,) bool (the dense
// level), `score` (n_tri,) f32 keep scores or null (draw order), all
// contiguous. fine = 0, the dense level: a tiles_y x tiles_x grid, each
// side at most 65535; `inv_th`, `inv_tw` are 1.0f / f32(tile size); the
// band is rows [y_lo, y_hi) and columns [0, x_hi) (f32 of y0, y0 + height
// and width). fine = 1: `cand` (tiles_y * tiles_x, kc) coarse lists and
// `ccount` their counts, each coarse tile cy_f x cx_f fine tiles of tile_h
// x tile_w pixels from row y0, the real fine grid fine_ty x fine_tx.
// `chunk` is 64, 128 or 256 items a block, `chunks` ceil(items / chunk),
// items n_tri (dense) or kc (fine). Scratch, groups 1 (dense) or
// tiles_y * tiles_x, per_group tiles_y * tiles_x (dense) or cy_f * cx_f:
// `cnt` (groups * chunks * per_group) and `total` (groups * per_group)
// int32; `memo` 2 * n_tri (dense) or groups * chunks * per_group * chunk /
// 32 (fine) 32-bit words, 8-byte aligned.
extern "C" int ash_bin_level(
    int fine, int zero_overflow, const float* bbox, const unsigned char* valid,
    const float* score, int n_tri, int tiles_y, int tiles_x, float inv_th,
    float inv_tw, float y_lo, float y_hi, float x_hi, const int* cand,
    const int* ccount, int kc, int cy_f, int cx_f, int fine_ty, int fine_tx,
    int tile_h, int tile_w, int y0, int max_per_tile, int chunk, int chunks,
    int* cnt, int* total, unsigned* memo, int* ids, int* counts,
    int* overflow, void* stream) {
  const int items = fine ? kc : n_tri;
  const long long groups = fine ? static_cast<long long>(tiles_y) * tiles_x
                                : 1;
  const long long per_group = fine ? static_cast<long long>(cy_f) * cx_f
                                   : static_cast<long long>(tiles_y) *
                                         tiles_x;
  if (n_tri < 0 || tiles_y <= 0 || tiles_x <= 0 || max_per_tile <= 0 ||
      items < 0 ||
      !(chunk == 64 || chunk == 128 || chunk == kMaxChunk) ||
      chunks != (items + chunk - 1) / chunk ||
      groups * per_group > INT_MAX || groups * chunks > INT_MAX ||
      total == nullptr || ids == nullptr || counts == nullptr ||
      overflow == nullptr ||
      (chunks > 0 && (cnt == nullptr || memo == nullptr)) ||
      reinterpret_cast<uintptr_t>(memo) % 8 != 0 ||
      (n_tri > 0 && bbox == nullptr) ||
      (fine ? (cy_f <= 0 || cx_f <= 0 || fine_ty <= 0 || fine_tx <= 0 ||
               tile_h <= 0 || tile_w <= 0 || ccount == nullptr ||
               (kc > 0 && cand == nullptr))
            : (tiles_y > 65535 || tiles_x > 65535 ||
               (n_tri > 0 && valid == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_overflow) {
    const cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nw = chunk / 32;
  const int batch = static_cast<int>(
      per_group < kSharedBytes / (8 * nw) ? per_group
                                          : kSharedBytes / (8 * nw));
  Level L{bbox, valid, score, n_tri, tiles_y, tiles_x, inv_th, inv_tw, y_lo,
          y_hi, x_hi, cand, ccount, kc, cy_f, cx_f, fine_ty, fine_tx,
          tile_h, tile_w, y0, static_cast<int>(groups),
          static_cast<int>(per_group), items, chunk, chunks, batch, cnt,
          total, memo, ids, counts, overflow, max_per_tile};
  return fine ? run_level<true>(L, s) : run_level<false>(L, s);
}
