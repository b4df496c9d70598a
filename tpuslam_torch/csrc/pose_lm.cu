// Pose-only optimization of one SE3 vertex against unary reprojection edges:
// ORB-SLAM2's Optimizer::PoseOptimization schedule (4 rounds of 10
// Levenberg-Marquardt iterations, Huber in the first two rounds, chi2
// inlier reclassification between rounds) in one launch, one block per
// camera stream.
//
// Replaces no TPU kernel: the JAX package's
// tpuslam/optim/pose.py::pose_optimization is plain jnp under jit, which
// XLA fuses. Computes the plain PyTorch version
// tpuslam_torch/optim/pose.py::pose_optimization_plain with its formulas
// (the |z| < 1e-6 guard, the zero u_right row of mono edges, delta^2 = the
// chi2 threshold, the >= 1e-12 pivot clamp, se3_exp's Taylor branches, the
// three Newton-Schulz steps of so3_project), all in float32; its sums run in
// another, fixed order.
//
// Why a kernel: the plain form issues ~11,500 small kernels per call, and
// two calls make most of a frame step's ~24,000 dependent kernel nodes on
// the card (~16 ms of device time each), for ~24 MFLOP of work.
//
// Bound on the H100: latency, not bytes or flops. At N = 4000 edges the
// inputs are 116 KB, read once (35 ns at 3.35 TB/s), and 40 iterations of
// ~210 flops an edge are ~34 MFLOP (0.5 us at 67 TFLOP/s). Each iteration
// is a chain of dependent steps: a block reduction of the normal equations,
// a serial 6x6 solve, a second pass and a block reduction of the robust
// cost. The floor is the kernel's time at one edge (chip_smoke.py measures
// it beside the time at the main path's shapes).
//
// Design:
// - One block of 512 threads per stream (grid = the flattened batch), so
//   B streams of MultiTracker or track_step_batched run on B SMs at once.
// - Edge i belongs to thread i % 512 for the whole call. Each thread copies
//   its edges into shared memory once (7 float planes and a flag byte, 29
//   bytes an edge; up to kMaxSharedEdges, 203 KB) and never reads them from
//   device memory again. Edges past that bound (the benchmark's KITTI
//   setting has 4000 keypoint slots) are read from device memory on each
//   pass, and their active flag lives in the output mask.
// - An iteration: each thread sums its edges' 21 entries of H's upper
//   triangle, 6 of b and the robust cost in registers, in edge order; a
//   warp halves the 32 sums across its lanes in five shuffle steps (31
//   shuffles, lane j ends with sum j); warp 0 adds the 16 warps' sums in
//   warp order; thread 0 solves the damped system, takes se3_exp and the
//   compose, and hands the candidate pose over through shared memory; a
//   second pass sums the candidate's robust cost (a warp reduction, then
//   every thread adds the 16 warp sums in the same order), and every thread
//   takes the same accept/reject decision on its own copy of the pose and
//   lambda. Three block barriers an iteration.
// - No float atomics, every sum in a fixed order: results repeat to the bit.
// - Launches on the caller's stream, allocates nothing and never
//   synchronises, so it runs inside a CUDA graph capture.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // H's upper triangle (21), b (6), the robust cost
constexpr int kPlanes = 7;  // x, y, z, u, v, u_right, inv_sigma2
constexpr int kEdgeBytes = kPlanes * 4 + 1;
constexpr int kMaxSharedEdges = 7168;  // 7168 x 29 B = 203 KB of the 227 KB a block may hold
constexpr uint8_t kValid = 1, kActive = 2;

struct Camera {
  float fx, fy, cx, cy, bf, chi2_mono, chi2_stereo;
};

struct Pose {
  float R[9], t[3];
};

struct Edge {
  float x, y, z, u, v, ur, info;
};

// A stream's edges: the first `cap` in shared memory, the rest in device
// memory; the active flag of those in the output mask.
struct Edges {
  const float* pts;
  const float* uvr;
  const float* info;
  const uint8_t* valid;
  uint8_t* inliers;
  float* plane;    // kPlanes planes of cap floats
  uint8_t* flags;  // cap bytes: kValid | kActive
  int cap;

  __device__ __forceinline__ Edge get(int i) const {
    if (i < cap) {
      return {plane[i], plane[cap + i], plane[2 * cap + i], plane[3 * cap + i],
              plane[4 * cap + i], plane[5 * cap + i], plane[6 * cap + i]};
    }
    const float* p = pts + 3 * static_cast<size_t>(i);
    const float* o = uvr + 3 * static_cast<size_t>(i);
    return {p[0], p[1], p[2], o[0], o[1], o[2], info[i]};
  }
  __device__ __forceinline__ bool active(int i) const { return i < cap ? (flags[i] & kActive) : inliers[i]; }
  __device__ __forceinline__ bool is_valid(int i) const { return i < cap ? (flags[i] & kValid) : valid[i]; }
  __device__ __forceinline__ void set_active(int i, bool a) const {
    if (i < cap) {
      flags[i] = static_cast<uint8_t>((flags[i] & kValid) | (a ? kActive : 0));
    } else {
      inliers[i] = a;
    }
  }
};

__device__ __forceinline__ void to_cam(const Pose& P, const Edge& e, float& px, float& py, float& pz) {
  px = P.R[0] * e.x + P.R[1] * e.y + P.R[2] * e.z + P.t[0];
  py = P.R[3] * e.x + P.R[4] * e.y + P.R[5] * e.z + P.t[1];
  pz = P.R[6] * e.x + P.R[7] * e.y + P.R[8] * e.z + P.t[2];
}

__device__ __forceinline__ float guard_z(float z) { return fabsf(z) < 1e-6f ? 1e-6f : z; }

// Huber's rho(chi2) with delta^2 = delta_sq, or chi2 itself.
__device__ __forceinline__ float rho(float chi2, float delta_sq, bool huber) {
  if (!huber) return chi2;
  return chi2 > delta_sq ? 2.0f * sqrtf(delta_sq * fmaxf(chi2, 1e-12f)) - delta_sq : chi2;
}

// pose_optimization_plain's edge_chi2: the reprojection chi2 by division.
__device__ __forceinline__ float edge_chi2(const Camera& c, const Pose& P, const Edge& e) {
  float px, py, pz;
  to_cam(P, e, px, py, pz);
  const float z = guard_z(pz);
  const float u = c.fx * px / z + c.cx;
  const float v = c.fy * py / z + c.cy;
  const float ur = u - c.bf / z;
  const float du = e.u - u, dv = e.v - v;
  const float dur = e.ur >= 0.0f ? e.ur - ur : 0.0f;
  return (du * du + dv * dv + dur * dur) * e.info;
}

// One Jacobian row a = [p x g, g] (the row of g2o's J up to its sign, which
// H and b do not see) times w, into H's upper triangle and b.
__device__ __forceinline__ void add_row(float (&acc)[32], float px, float py, float pz,
                                        float gx, float gy, float gz, float w, float r) {
  const float a[6] = {py * gz - pz * gy, pz * gx - px * gz, px * gy - py * gx, gx, gy, gz};
  int k = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float wa = w * a[j];
#pragma unroll
    for (int l = j; l < 6; ++l) acc[k++] += wa * a[l];
    acc[21 + j] += wa * r;
  }
}

// The edge's terms of the normal equations and of the robust cost at P
// (pose_optimization_plain's _residual_jacobian and lm_round).
__device__ __forceinline__ void add_edge(float (&acc)[32], const Camera& c, const Pose& P,
                                         const Edge& e, float act, bool huber) {
  float px, py, pz;
  to_cam(P, e, px, py, pz);
  const float inv_z = 1.0f / guard_z(pz);
  const float inv_z2 = inv_z * inv_z;
  const float u = c.fx * px * inv_z + c.cx;
  const float v = c.fy * py * inv_z + c.cy;
  const float ur = u - c.bf * inv_z;
  const bool stereo = e.ur >= 0.0f;
  const float r0 = e.u - u, r1 = e.v - v, r2 = stereo ? e.ur - ur : 0.0f;
  const float info = e.info;
  const float chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * info;
  const float delta_sq = stereo ? c.chi2_stereo : c.chi2_mono;
  float w = huber ? fminf(sqrtf(delta_sq / fmaxf(chi2, 1e-12f)), 1.0f) : 1.0f;
  w = w * info * act;
  acc[27] += rho(chi2, delta_sq, huber) * act;
  const float du_dx = c.fx * inv_z, du_dz = -c.fx * px * inv_z2;
  add_row(acc, px, py, pz, du_dx, 0.0f, du_dz, w, r0);
  add_row(acc, px, py, pz, 0.0f, c.fy * inv_z, -c.fy * py * inv_z2, w, r1);
  if (stereo) add_row(acc, px, py, pz, du_dx, 0.0f, du_dz + c.bf * inv_z2, w, r2);
}

// Sums each of the 32 values across the warp's lanes: five halving steps
// (kHalf = 16, 8, 4, 2, 1), 31 shuffles; lane j ends with the sum of value j
// in v[0], in a fixed order.
template <int kHalf>
__device__ __forceinline__ void warp_sum_each(float (&v)[32], int lane) {
  const bool hi = lane & kHalf;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = hi ? v[j] : v[j + kHalf];
    const float keep = hi ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
  if constexpr (kHalf > 1) warp_sum_each<kHalf / 2>(v, lane);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// solve_spd: x = (H + lam I)^-1 b by Cholesky, each pivot clamped to
// >= 1e-12 before its square root. `s` holds H's upper triangle row by row,
// then b.
__device__ __forceinline__ void solve_damped(const float* s, float lam, float (&x)[6]) {
  float A[6][6];
  int k = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int l = j; l < 6; ++l) {
      A[j][l] = s[k];
      A[l][j] = s[k];
      ++k;
    }
    A[j][j] += lam;
  }
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float ss = 0.0f;
#pragma unroll
    for (int m = 0; m < j; ++m) ss += L[j][m] * L[j][m];
    const float d = sqrtf(fmaxf(A[j][j] - ss, 1e-12f));
    const float inv_d = 1.0f / d;
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float si = 0.0f;
#pragma unroll
      for (int m = 0; m < j; ++m) si += L[i][m] * L[j][m];
      L[i][j] = (A[i][j] - si) * inv_d;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float si = 0.0f;
#pragma unroll
    for (int m = 0; m < i; ++m) si += L[i][m] * y[m];
    y[i] = (s[21 + i] - si) / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float si = 0.0f;
#pragma unroll
    for (int m = i + 1; m < 6; ++m) si += L[m][i] * x[m];
    x[i] = (y[i] - si) / L[i][i];
  }
}

// exp(dx) * P: se3_exp with _sinc_factors' Taylor branch below
// theta^2 = 1e-8, then se3_compose.
__device__ __forceinline__ Pose step_pose(const float (&dx)[6], const Pose& P) {
  const float w0 = dx[0], w1 = dx[1], w2 = dx[2];
  const float tsq = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = tsq < 1e-8f;
  const float safe_tsq = small ? 1.0f : tsq;
  const float th = sqrtf(safe_tsq);
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.0f - tsq / 6.0f : sn / th;
  const float b = small ? 0.5f - tsq / 24.0f : (1.0f - cs) / safe_tsq;
  const float c = small ? 1.0f / 6.0f - tsq / 120.0f : (th - sn) / (safe_tsq * th);
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float KK[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      KK[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
  float Re[9], V[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    Re[i] = eye + a * K[i] + b * KK[i];
    V[i] = eye + b * K[i] + c * KK[i];
  }
  Pose out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float te = V[3 * i] * dx[3] + V[3 * i + 1] * dx[4] + V[3 * i + 2] * dx[5];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.R[3 * i + j] = Re[3 * i] * P.R[j] + Re[3 * i + 1] * P.R[3 + j] + Re[3 * i + 2] * P.R[6 + j];
    out.t[i] = Re[3 * i] * P.t[0] + Re[3 * i + 1] * P.t[1] + Re[3 * i + 2] * P.t[2] + te;
  }
  return out;
}

// so3_project: three Newton-Schulz steps X <- 0.5 X (3 I - X^T X).
__device__ __forceinline__ void so3_project(float (&X)[9]) {
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    float A[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        A[3 * i + j] = (i == j ? 3.0f : 0.0f) -
                       (X[i] * X[j] + X[3 + i] * X[3 + j] + X[6 + i] * X[6 + j]);
    float Y[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Y[3 * i + j] = 0.5f * X[3 * i] * A[j] + 0.5f * X[3 * i + 1] * A[3 + j] +
                       0.5f * X[3 * i + 2] * A[6 + j];
#pragma unroll
    for (int i = 0; i < 9; ++i) X[i] = Y[i];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    pose_lm_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                   const float* __restrict__ pts, const float* __restrict__ uvr,
                   const float* __restrict__ info, const uint8_t* __restrict__ valid,
                   float* __restrict__ R_out, float* __restrict__ t_out,
                   uint8_t* __restrict__ inliers, int64_t* __restrict__ n_inliers, int n, int cap,
                   Camera cam, int rounds, int iters) {
  extern __shared__ float plane[];
  __shared__ float part[kWarps][kSums];
  __shared__ float total[kSums];
  __shared__ float part_cost[kWarps];
  __shared__ int part_count[kWarps];
  __shared__ float cand[12];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t s = blockIdx.x;
  const Edges E{pts + 3 * n * s, uvr + 3 * n * s, info + n * s, valid + n * s, inliers + n * s,
                plane, reinterpret_cast<uint8_t*>(plane + kPlanes * cap), cap};

  // Each thread copies its own edges: no other thread reads them. Every edge
  // starts active iff valid.
  for (int i = tid; i < n; i += kThreads) {
    const bool v = E.valid[i];
    if (i < cap) {
      const float* p = E.pts + 3 * static_cast<size_t>(i);
      const float* o = E.uvr + 3 * static_cast<size_t>(i);
      plane[i] = p[0];
      plane[cap + i] = p[1];
      plane[2 * cap + i] = p[2];
      plane[3 * cap + i] = o[0];
      plane[4 * cap + i] = o[1];
      plane[5 * cap + i] = o[2];
      plane[6 * cap + i] = E.info[i];
      E.flags[i] = v ? (kValid | kActive) : 0;
    } else {
      E.inliers[i] = v;
    }
  }
  Pose P;
#pragma unroll
  for (int i = 0; i < 9; ++i) P.R[i] = R0[9 * s + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) P.t[i] = t0[3 * s + i];

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    float lam = 1e-3f;
    for (int it = 0; it < iters; ++it) {
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
#pragma unroll 1
      for (int i = tid; i < n; i += kThreads) add_edge(acc, cam, P, E.get(i), E.active(i) ? 1.0f : 0.0f, huber);
      warp_sum_each<16>(acc, lane);
      if (lane < kSums) part[warp][lane] = acc[0];
      __syncthreads();
      if (warp == 0) {
        if (lane < kSums) {
          float sum = part[0][lane];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) sum += part[w][lane];
          total[lane] = sum;
        }
        __syncwarp();
        if (lane == 0) {
          float dx[6];
          solve_damped(total, lam, dx);
          const Pose C = step_pose(dx, P);
#pragma unroll
          for (int i = 0; i < 9; ++i) cand[i] = C.R[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) cand[9 + i] = C.t[i];
        }
      }
      __syncthreads();
      Pose C;
#pragma unroll
      for (int i = 0; i < 9; ++i) C.R[i] = cand[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) C.t[i] = cand[9 + i];
      float cost = 0.0f;
#pragma unroll 1
      for (int i = tid; i < n; i += kThreads) {
        const Edge e = E.get(i);
        const float delta_sq = e.ur >= 0.0f ? cam.chi2_stereo : cam.chi2_mono;
        cost += rho(edge_chi2(cam, C, e), delta_sq, huber) * (E.active(i) ? 1.0f : 0.0f);
      }
      cost = warp_sum(cost);
      if (lane == 0) part_cost[warp] = cost;
      __syncthreads();
      float new_cost = part_cost[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) new_cost += part_cost[w];
      if (new_cost < total[27]) {
        P = C;
        lam *= 0.5f;
      } else {
        lam *= 4.0f;
      }
    }
    // Inliers of the round's pose: the next round's active edges.
#pragma unroll 1
    for (int i = tid; i < n; i += kThreads) {
      const Edge e = E.get(i);
      const float th = e.ur >= 0.0f ? cam.chi2_stereo : cam.chi2_mono;
      E.set_active(i, E.is_valid(i) && edge_chi2(cam, P, e) <= th);
    }
  }

  int count = 0;
  for (int i = tid; i < n; i += kThreads) {
    const bool a = E.active(i);
    if (i < cap) E.inliers[i] = a;
    count += a;
  }
  count = warp_sum(count);
  if (lane == 0) part_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total_count = 0;
    for (int w = 0; w < kWarps; ++w) total_count += part_count[w];
    n_inliers[s] = total_count;
    so3_project(P.R);
#pragma unroll
    for (int i = 0; i < 9; ++i) R_out[9 * s + i] = P.R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t_out[3 * s + i] = P.t[i];
  }
}

}  // namespace

// R0: (B, 3, 3), t0: (B, 3), pts: (B, n, 3), uvr: (B, n, 3) with
// u_right < 0 for a mono edge, info: (B, n) float32, valid: (B, n) bool;
// all contiguous. Writes R: (B, 3, 3), t: (B, 3), inliers: (B, n) bool,
// n_inliers: (B,) int64. Returns the first CUDA error of the launch.
extern "C" int tpuslam_pose_lm(const void* R0, const void* t0, const void* pts, const void* uvr,
                               const void* info, const void* valid, void* R, void* t,
                               void* inliers, void* n_inliers, int B, int n, float fx, float fy,
                               float cx, float cy, float bf, float chi2_mono, float chi2_stereo,
                               int rounds, int iters, void* stream) {
  if (B <= 0) return 0;
  const int cap = n < kMaxSharedEdges ? n : kMaxSharedEdges;
  const size_t smem = static_cast<size_t>(cap) * kEdgeBytes;
  cudaError_t err = cudaFuncSetAttribute(pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pose_lm_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R0), static_cast<const float*>(t0),
      static_cast<const float*>(pts), static_cast<const float*>(uvr),
      static_cast<const float*>(info), static_cast<const uint8_t*>(valid),
      static_cast<float*>(R), static_cast<float*>(t), static_cast<uint8_t*>(inliers),
      static_cast<int64_t*>(n_inliers), n, cap, Camera{fx, fy, cx, cy, bf, chi2_mono, chi2_stereo},
      rounds, iters);
  return static_cast<int>(cudaGetLastError());
}
