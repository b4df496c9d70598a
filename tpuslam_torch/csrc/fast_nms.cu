// Dense FAST-9/16 corner score + 3x3 non-max suppression over every level of
// an image pyramid (and every stream of each level) in one launch.
//
// Replaces the TPU kernel tpuslam/ops/fast_pallas.py::fast_nms_pallas
// (body _make_kernel). Computes exactly the plain version
// tpuslam_torch/ops/fast.py::fast_nms_plain (= the JAX package's
// _nms3(fast_response(img, min_th))), bit for bit over the whole map:
//   score(p) = max over the 16 arc starts of the min over 9 consecutive
//   circle differences, for brighter and for darker arcs; 0 unless > min_th.
//   Circle reads replicate the edge (clamped coordinates), like the plain
//   version's edge padding -- not the Pallas kernel's zero halo.
//   NMS keeps p where score + lin * bias_step >= the 3x3 max of that biased
//   score (pixels outside the image do not take part), lin = y*W + x, the
//   bias only on positive scores, all in float32 with no fused multiply-add.
//
// Bound on the H100: memory. Each pixel is read once and written once as
// float32 (8 bytes per pixel: 30.4 MB for the 8 levels of a 640x480 pyramid
// at B=4, 9.1 us at 3.35 TB/s). In practice the kernel is bound by
// instruction issue: the FAST test costs tens of instructions per pixel, so
// the design spends them only where a cheaper exact test has not decided.
//
// Design:
// - One launch. The host passes a table of at most 8 levels by value
//   (FastLevels); block b belongs to the last level whose first tile is
//   <= b, then to a stream and a tile of that level. The search is uniform
//   in a block, so the small levels share the card with the large ones
//   instead of running alone in launches of their own.
// - A block of 4 warps owns a 30x30 output tile, so the score tile with its
//   1-pixel ring is 32 wide: one warp per score row, every lane busy. The
//   image tile with a 4-pixel halo (3 for the circle, 1 for the ring) is
//   loaded once into shared memory with clamped 4-byte reads (level widths
//   such as 533 leave rows unaligned for wider loads), all of a thread's
//   loads in flight at once. The ring is recomputed by the neighbouring
//   blocks rather than passed through device memory.
// - Exact prefilters, each followed by a compaction into a shared list
//   (warp ballot, one shared atomic per warp) so that full warps do the
//   next, dearer step:
//   1. a 9-arc holds two neighbouring compass pixels (circle 0, 4, 8, 12),
//      so a pixel whose compass has no such pair past th, brighter or
//      darker, scores 0; the pair also says which sign is possible;
//   2. the 16-bit mask of x > th, x = d or -d for that sign, doubled to 32
//      bits, holds a run of 9 ones iff the pixel scores > th (for
//      th >= 0, which the wrapper requires, a brighter and a darker 9-arc
//      cannot both exist: they would share a pixel);
//   3. only those pixels search the arcs of their one sign, by min/max
//      doubling as the plain version does (exact in any order).
// - The biased score (score + lin * bias_step) is computed once, where a
//   positive score is written; NMS reads both tiles.
// Tried on the H100 and not kept, being no faster in turns: scoring the
// compass survivors in place (divergent warps), taller tiles, 8 warps per
// block, and a persistent grid with the next tile's halo prefetched by
// cp.async into a second buffer (more registers, fewer blocks per SM).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxLevels = 8;

// One level of the table. Must match tpuslam_torch/_build.py::FastLevel.
struct FastLevel {
  const float* img;  // (B, H, W) float32, contiguous
  float* out;        // (B, H, W) float32, contiguous
  int B, H, W;
  int tiles_x, tiles_y;  // tiles across and down one stream
  int tile0;             // first block of this level
  float bias_step;       // float32(-1e-6 / (H * W))
  int pad_;
};

struct FastLevels {
  FastLevel lv[kMaxLevels];
  int n_levels;
  int n_tiles;  // blocks of the launch: the sum of B * tiles_y * tiles_x
};

namespace {

constexpr int kOut = 30;                     // output tile width
constexpr int kOutH = 30;                    // output tile height
constexpr int kRing = kOut + 2;              // score tile width: one warp per row
constexpr int kRingH = kOutH + 2;
constexpr int kHalo = 4;                     // 3 for the circle, 1 for the ring
constexpr int kIn = kOut + 2 * kHalo;        // image tile width
constexpr int kInH = kOutH + 2 * kHalo;
constexpr int kInPitch = kIn + 1;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
static_assert(kRing == 32 && kRingH % kWarps == 0 && kRingH <= 128, "tile shape");

// A run of 9 ones in the 16-bit circular mask m.
__device__ __forceinline__ bool has_run9(unsigned m) {
  const unsigned m2 = m | (m << 16);
  unsigned a = m2 & (m2 >> 1);  // bit i: i..i+1 set
  a &= a >> 2;                  // i..i+3
  a &= a >> 4;                  // i..i+7
  a &= m2 >> 8;                 // i..i+8
  return (a & 0xffffu) != 0;
}

// The 16 circle differences of the pixel at tile[ty][tx] times sgn (+1:
// brighter arcs, -1: darker), in the order of ops/orb_common.py::FAST_OFFSETS.
// sgn * (t - c) is exact, and fmaf(t, sgn, -sgn * c) rounds it once: the
// same float as the plain version's circ - img, or its negation.
__device__ __forceinline__ void circle(const float (*tile)[kInPitch], int ty, int tx,
                                       float sgn, float (&x)[16]) {
  const int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const float nc = -sgn * tile[ty][tx];
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = fmaf(tile[ty + kDy[k]][tx + kDx[k]], sgn, nc);
}

// Bit k set where x[k] > th.
__device__ __forceinline__ unsigned past_mask(const float (&x)[16], float th) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) m |= static_cast<unsigned>(x[k] > th) << k;
  return m;
}

// Max over the 16 arc starts of the min over 9 consecutive circular
// entries: minima over 2, 4, 8, then 9 entries, as the plain version's
// arc9_min (exact in any order).
__device__ __forceinline__ float best_arc_min(const float (&x)[16]) {
  float m[16], t[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m[s] = fminf(x[s], x[(s + 1) & 15]);
#pragma unroll
  for (int lvl = 1; lvl <= 2; ++lvl) {
#pragma unroll
    for (int s = 0; s < 16; ++s) t[s] = fminf(m[s], m[(s + (1 << lvl)) & 15]);
#pragma unroll
    for (int s = 0; s < 16; ++s) m[s] = t[s];
  }
  float best = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) best = fmaxf(best, fminf(m[s], x[(s + 8) & 15]));
  return best;
}

// Appends items[j] to a shared list for every j and lane of the warp
// where take[j] holds, with one atomic for the warp (all 32 lanes call it).
template <int N>
__device__ __forceinline__ void append(const bool (&take)[N], const int (&items)[N],
                                       uint16_t* list, int* count, int lane) {
  unsigned ballot[N];
  int total = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, take[j]);
    total += __popc(ballot[j]);
  }
  if (total == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, total);
  base = __shfl_sync(0xffffffffu, base, 0);
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (take[j]) list[base + __popc(ballot[j] & below)] = static_cast<uint16_t>(items[j]);
    base += __popc(ballot[j]);
  }
}

// t / n for 0 <= t < 2^24 and n >= 1: a float reciprocal is off by at most
// one, which the two corrections remove (no integer division sequence).
__device__ __forceinline__ int quotient(int t, int n) {
  int q = __float2int_rz(__int2float_rn(t) * __frcp_rn(__int2float_rn(n)));
  q -= q * n > t;
  q += (q + 1) * n <= t;
  return q;
}

// List items: (row << 5) | column of the score tile, and these flags.
constexpr int kBright = 1 << 12, kDark = 1 << 13;

// The item with the one sign whose 16-bit mask holds a run of 9, or 0.
__device__ __forceinline__ int run_test(const float (*tile)[kInPitch], int item, float th) {
  const int r = (item >> 5) & 127, c = item & 31;
  const bool bright = item & kBright;
  float x[16];
  circle(tile, r + 3, c + 3, bright ? 1.0f : -1.0f, x);
  if (has_run9(past_mask(x, th))) return item & (bright ? ~kDark : ~kBright);
  if (!(bright && (item & kDark))) return 0;
  circle(tile, r + 3, c + 3, -1.0f, x);  // both signs were possible
  return has_run9(past_mask(x, th)) ? item & ~kBright : 0;
}

__global__ void __launch_bounds__(kThreads)
    fast_nms_pyramid_kernel(const __grid_constant__ FastLevels p, float th) {
  __shared__ float tile[kInH][kInPitch];
  __shared__ float score[kRingH][kRing + 1];   // raw score; -inf off the image
  __shared__ float biased[kRingH][kRing + 1];  // score + lin * bias_step where > 0
  __shared__ uint16_t cand[kRingH * kRing];   // past the compass test
  __shared__ uint16_t hits[kRingH * kRing];   // with a 9-run: score > th
  __shared__ int n_cand, n_hits;

  // This block's level: the last whose first tile is <= blockIdx.x (the
  // first tiles do not decrease), then its stream and tile.
  const int b = blockIdx.x;
  int l = 0;
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k) l += k < p.n_levels && b >= p.lv[k].tile0;
  const FastLevel& lv = p.lv[l];
  const int H = lv.H, W = lv.W, tiles_x = lv.tiles_x;
  const float bias_step = lv.bias_step;
  int t = b - lv.tile0;
  const int per_stream = tiles_x * lv.tiles_y;
  const int s = quotient(t, per_stream);
  t -= s * per_stream;
  const int ty = quotient(t, tiles_x);
  const int y0 = ty * kOutH;
  const int x0 = (t - ty * tiles_x) * kOut;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = lv.img + s * plane;
  float* o = lv.out + s * plane;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) n_cand = n_hits = 0;

  // 1. Image tile with its halo, edge replicated: all of a thread's loads
  //    are in flight before the first store (columns 32.. by lanes 0..5).
  constexpr int kLoadRows = (kInH + kWarps - 1) / kWarps;
  float near_cols[kLoadRows], far_cols[kLoadRows];
  const int xa = min(max(x0 - kHalo + lane, 0), W - 1);
  const int xb = min(max(x0 - kHalo + 32 + min(lane, kIn - 33), 0), W - 1);
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) {
    const int r = min(warp + kWarps * i, kInH - 1);
    const float* row = im + static_cast<size_t>(min(max(y0 - kHalo + r, 0), H - 1)) * W;
    near_cols[i] = __ldg(row + xa);
    far_cols[i] = __ldg(row + xb);
  }
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) {
    const int r = warp + kWarps * i;
    if (r < kInH) {
      tile[r][lane] = near_cols[i];
      if (lane < kIn - 32) tile[r][32 + lane] = far_cols[i];
    }
  }
  __syncthreads();

  // 2. Compass test of the score tile (image (y0 - 1 + r, x0 - 1 + lane) is
  //    tile[r + 3][lane + 3]): a 9-arc past th holds two neighbouring
  //    compass pixels past th.
  constexpr int kRows = kRingH / kWarps;
  bool take[kRows];
  int items[kRows];
  const bool x_inside = x0 - 1 + lane >= 0 && x0 - 1 + lane < W;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    const int y = y0 - 1 + r;
    const bool inside = x_inside && y >= 0 && y < H;
    int flags = 0;
    if (inside) {
      const int cy = r + 3, cx = lane + 3;
      const float c = tile[cy][cx];
      const float d0 = tile[cy - 3][cx] - c, d4 = tile[cy][cx + 3] - c;
      const float d8 = tile[cy + 3][cx] - c, d12 = tile[cy][cx - 3] - c;
      const float lo = fmaxf(fmaxf(fminf(d0, d4), fminf(d4, d8)),
                             fmaxf(fminf(d8, d12), fminf(d12, d0)));
      const float hi = fminf(fminf(fmaxf(d0, d4), fmaxf(d4, d8)),
                             fminf(fmaxf(d8, d12), fmaxf(d12, d0)));
      flags = (lo > th ? kBright : 0) | (hi < -th ? kDark : 0);
    }
    score[r][lane] = biased[r][lane] = inside ? 0.0f : -INFINITY;
    take[i] = flags != 0;
    items[i] = flags | (r << 5) | lane;
  }
  append(take, items, cand, &n_cand, lane);
  __syncthreads();

  // 3. The compass survivors, densely, two per thread in flight: the 16-bit
  //    mask of the possible sign (both, rarely) tested for a run of 9.
  const int nc = n_cand;
  for (int i0 = 0; i0 < nc; i0 += 2 * kThreads) {
    bool hit[2];
    int item[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = i0 + j * kThreads + threadIdx.x;
      item[j] = i < nc ? run_test(tile, cand[i], th) : 0;
      hit[j] = item[j] != 0;
    }
    append(hit, item, hits, &n_hits, lane);
  }
  __syncthreads();

  // 4. The pixels that score: the arc search of their one sign (a pixel
  //    cannot hold a brighter and a darker 9-arc at once).
  const int nh = n_hits;
  for (int i = threadIdx.x; i < nh; i += kThreads) {
    const int item = hits[i];
    const int r = (item >> 5) & 127, c = item & 31;
    float x[16];
    circle(tile, r + 3, c + 3, (item & kBright) ? 1.0f : -1.0f, x);
    const float best = best_arc_min(x);  // > th >= 0: the pixel has a 9-run
    score[r][c] = best;
    biased[r][c] = __fadd_rn(best, __fmul_rn(static_cast<float>((y0 - 1 + r) * W + x0 - 1 + c),
                                             bias_step));
  }
  __syncthreads();

  // 5. NMS of the outputs against their biased 3x3 neighbourhood.
#pragma unroll
  for (int i = 0; i < (kOutH + kWarps - 1) / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int y = y0 + r, x = x0 + lane;
    if (r >= kOutH || lane >= kOut || y >= H || x >= W) continue;
    const float sc = score[r + 1][lane + 1];
    float res = 0.0f;
    if (sc > 0.0f) {
      float m = biased[r][lane];
#pragma unroll
      for (int k = 1; k < 9; ++k) m = fmaxf(m, biased[r + k / 3][lane + k % 3]);
      if (biased[r + 1][lane + 1] >= m) res = sc;
    }
    o[static_cast<size_t>(y) * W + x] = res;
  }
}

}  // namespace

// One launch over the levels of *levels (read on the host, passed to the
// kernel by value). Returns cudaGetLastError().
extern "C" int tpuslam_fast_nms_pyramid(const FastLevels* levels, float min_th,
                                        void* stream) {
  if (levels->n_tiles > 0) {
    fast_nms_pyramid_kernel<<<levels->n_tiles, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(*levels, min_th);
  }
  return static_cast<int>(cudaGetLastError());
}
