// Exact sequential quadtree keypoint distribution — the behavioral oracle
// for the TPU build's parallel per-cell selection.
//
// Implements the algorithm of ORBextractor::DistributeOctTree
// (reference src/ORBextractor.cc:644, reimplemented from the
// published algorithm, not transcribed): recursively split the image
// region into quadrants, splitting nodes that hold more than one keypoint,
// until the node count reaches the target budget or no node can split;
// then keep the highest-response keypoint of each final node. The TPU
// pipeline replaces this with rank-in-cell selection (tpuslam/ops/orb.py);
// this oracle exists so tests can quantify the deviation.

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <list>
#include <vector>

namespace {

struct Node {
  float x0, y0, x1, y1;
  std::vector<int> kp;  // indices into the input arrays
  bool no_more = false; // single keypoint: never split again
};

}  // namespace

extern "C" {

// xs/ys/responses: n keypoints inside [min_x, max_x) x [min_y, max_y).
// out_keep: caller-allocated n int32 flags (1 = keypoint selected).
// Returns the number selected (<= target).
int tpuslam_distribute_quadtree(const float* xs, const float* ys,
                                const float* responses, int n, float min_x,
                                float max_x, float min_y, float max_y,
                                int target, int32_t* out_keep) {
  std::fill(out_keep, out_keep + n, 0);
  if (n == 0 || target <= 0) return 0;

  // Initial nodes: square-ish split of the region width.
  const float w = max_x - min_x, h = max_y - min_y;
  int n_init = std::max(1, int(std::lround(w / h)));
  const float hx = w / n_init;

  std::list<Node> nodes;
  for (int i = 0; i < n_init; ++i) {
    Node nd;
    nd.x0 = min_x + i * hx;
    nd.x1 = min_x + (i + 1) * hx;
    nd.y0 = min_y;
    nd.y1 = max_y;
    nodes.push_back(nd);
  }
  for (int i = 0; i < n; ++i) {
    int b = std::min(int((xs[i] - min_x) / hx), n_init - 1);
    auto it = nodes.begin();
    std::advance(it, b);
    it->kp.push_back(i);
  }
  for (auto it = nodes.begin(); it != nodes.end();) {
    if (it->kp.empty()) it = nodes.erase(it);
    else {
      it->no_more = it->kp.size() == 1;
      ++it;
    }
  }

  bool finished = false;
  while (!finished) {
    if (int(nodes.size()) >= target) break;
    // Expand: split every splittable node once per round, largest first
    // when close to the budget.
    std::vector<std::pair<size_t, std::list<Node>::iterator>> to_split;
    for (auto it = nodes.begin(); it != nodes.end(); ++it)
      if (!it->no_more) to_split.push_back({it->kp.size(), it});
    if (to_split.empty()) break;
    // Split nodes with more keypoints first so the budget lands on the
    // densest areas last (matches the reference's size-priority pass).
    std::sort(to_split.begin(), to_split.end(),
              [](auto& a, auto& b) { return a.first > b.first; });

    bool split_any = false;
    for (auto& [sz, it] : to_split) {
      if (int(nodes.size()) >= target) { finished = true; break; }
      Node& nd = *it;
      const float mx = 0.5f * (nd.x0 + nd.x1);
      const float my = 0.5f * (nd.y0 + nd.y1);
      Node q[4];
      q[0] = {nd.x0, nd.y0, mx, my, {}, false};
      q[1] = {mx, nd.y0, nd.x1, my, {}, false};
      q[2] = {nd.x0, my, mx, nd.y1, {}, false};
      q[3] = {mx, my, nd.x1, nd.y1, {}, false};
      for (int i : nd.kp) {
        int qi = (xs[i] >= mx ? 1 : 0) + (ys[i] >= my ? 2 : 0);
        q[qi].kp.push_back(i);
      }
      auto pos = nodes.erase(it);
      for (int k = 0; k < 4; ++k) {
        if (q[k].kp.empty()) continue;
        q[k].no_more = q[k].kp.size() == 1;
        nodes.insert(pos, q[k]);
      }
      split_any = true;
    }
    if (!split_any) break;
  }

  int kept = 0;
  for (auto& nd : nodes) {
    if (kept >= target) break;
    int best = nd.kp[0];
    for (int i : nd.kp)
      if (responses[i] > responses[best]) best = i;
    out_keep[best] = 1;
    ++kept;
  }
  return kept;
}

}  // extern "C"
