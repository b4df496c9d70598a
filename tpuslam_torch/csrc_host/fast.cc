// Dense FAST-9/16 corner score + 3x3 NMS — native CPU kernel.
//
// Exact same semantics as the XLA fallback in tpuslam/ops/orb.py
// (fast_response + _nms3), which itself mirrors the reference's
// dual-threshold FAST with OpenCV scores
// (reference src/ORBextractor.cc:915-1002):
//   score(px) = max over 16 arc starts of (min over the 9 contiguous
//   circle differences), for brighter and darker arcs; 0 unless > min_th.
//   NMS keeps strict 3x3 local maxima with a linear-index tie-break.
//
// The XLA elementwise formulation moves ~16 (H, W) planes per level
// through memory and costs ~250 ms/frame on a 2-core host; this kernel
// with the classic 0/8-pixel early reject runs the same frame in a few
// ms — the CPU platform's extraction path calls it via jax.pure_callback
// (the TPU path keeps the fused Pallas kernel).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kOffsets[16][2] = {
    // (dx, dy) in the same circle order as ops/orb_common.FAST_OFFSETS.
    {0, -3},  {1, -3},  {2, -2},  {3, -1},  {3, 0},   {3, 1},
    {2, 2},   {1, 3},   {0, 3},   {-1, 3},  {-2, 2},  {-3, 1},
    {-3, 0},  {-3, -1}, {-2, -2}, {-1, -3},
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" int tpuslam_fast_nms(const float* img, int H, int W, float min_th,
                                float* out) {
  if (H <= 0 || W <= 0) return -1;
  const float* im = img;  // float pixels, same arithmetic as the XLA path
  std::vector<float> score(static_cast<size_t>(H) * W, 0.0f);
  const float th = min_th;

  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const float c = im[static_cast<size_t>(y) * W + x];
      float d[16];
      // Edge-clamped circle reads (== the jnp.pad(mode="edge") border).
      if (y >= 3 && y < H - 3 && x >= 3 && x < W - 3) {
        for (int k = 0; k < 16; ++k)
          d[k] = im[static_cast<size_t>(y + kOffsets[k][1]) * W + x +
                    kOffsets[k][0]] - c;
      } else {
        for (int k = 0; k < 16; ++k) {
          const int yy = clampi(y + kOffsets[k][1], 0, H - 1);
          const int xx = clampi(x + kOffsets[k][0], 0, W - 1);
          d[k] = im[static_cast<size_t>(yy) * W + xx] - c;
        }
      }
      // Early reject: a 9-long arc always contains pixel 0 or pixel 8.
      const bool maybe_bright = d[0] > th || d[8] > th;
      const bool maybe_dark = -d[0] > th || -d[8] > th;
      if (!maybe_bright && !maybe_dark) continue;

      float best = 0.0f;
      if (maybe_bright) {
        for (int s = 0; s < 16; ++s) {
          float mn = d[s];
          for (int j = 1; j < 9 && mn > best; ++j) {
            const float v = d[(s + j) & 15];
            if (v < mn) mn = v;
          }
          if (mn > best) best = mn;
        }
      }
      if (maybe_dark) {
        for (int s = 0; s < 16; ++s) {
          float mn = -d[s];
          for (int j = 1; j < 9 && mn > best; ++j) {
            const float v = -d[(s + j) & 15];
            if (v < mn) mn = v;
          }
          if (mn > best) best = mn;
        }
      }
      if (best > min_th)
        score[static_cast<size_t>(y) * W + x] = best;
    }
  }

  // 3x3 NMS with the same deterministic tie-break as _nms3: biased value
  // s = score + linear_index * (-1e-6 / (H*W)) for positive scores; keep
  // where s >= 3x3 max of s.
  // Match float32 arithmetic of the XLA path exactly.
  auto biased_f = [&](int y, int x) -> float {
    const float v = score[static_cast<size_t>(y) * W + x];
    if (v <= 0.0f) return v;
    const float b = static_cast<float>(
        (static_cast<double>(y) * W + x) * (-1e-6 / (static_cast<double>(H) * W)));
    return v + b;
  };
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(H) * W);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const float v = score[static_cast<size_t>(y) * W + x];
      if (v <= 0.0f) continue;
      const float s = biased_f(y, x);
      float mx = -1e30f;
      for (int yy = std::max(0, y - 1); yy <= std::min(H - 1, y + 1); ++yy)
        for (int xx = std::max(0, x - 1); xx <= std::min(W - 1, x + 1); ++xx)
          mx = std::max(mx, biased_f(yy, xx));
      if (s >= mx) out[static_cast<size_t>(y) * W + x] = v;
    }
  }
  return 0;
}
