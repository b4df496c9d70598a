// Per-keypoint 47x47 patch gather from the stacked pyramid atlas.
//
// Replaces the TPU kernel tpuslam/ops/patches.py::gather_patches_pallas
// (_gather_blocks / _make_gather_kernel). Computes exactly the plain version
// tpuslam_torch/ops/patches.py::gather_patches_plain: out[n, r, c] =
// float(atlas[corner[n, 0] + r, corner[n, 1] + c]).
//
// Bound on the H100: memory, mostly the float32 output. At B=4 x 1000
// keypoints it writes 4000 x 2209 x 4 B = 35.3 MB and reads at most the
// 6.1 MB uint8 atlas (B * 2338 x 656; the windows overlap and stay in L2).
//
// Design of the uint8 path (the main path's):
// - Four consecutive patches per block. Their output, 4 x 8,836 B =
//   2,209 x 16 B, starts 16-byte aligned, so the block writes it as 2,209
//   float4 stores with no head or tail (a ragged last block stores floats).
// - Staged reads, the GPU's form of the TPU kernel's aligned DMA plus
//   _unshift: each 47-byte window row is covered by at most four 16-byte
//   chunks at 16-byte-aligned *addresses*, loaded as uint4 into shared
//   memory, whatever the atlas pitch. An aligned chunk never crosses a page,
//   so reading the whole chunk around a byte of the atlas is safe. The
//   row's offset inside its first chunk is kept and undone by the index
//   into shared memory, not by matmuls.
// - Every window is checked against the atlas on the device: a corner
//   outside it fails the kernel's assert (reported at the next
//   synchronisation, as PyTorch's own index kernels do), and its window is
//   not read. The host reads nothing.
// The float32 atlas path (tests, checks) reads the window directly, one
// block per keypoint, with the same assert.
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 47;
constexpr int kPP = kP * kP;           // 2209 floats per patch
constexpr int kGroup = 4;              // patches per block: 2209 float4
constexpr int kChunks = 4;             // 16-byte chunks covering a 47-byte row
constexpr int kRowChunks = kP * kChunks;
constexpr int kThreads = 256;

__device__ __forceinline__ bool window_inside(int cy, int cx, int Ha, int Wa) {
  return cy >= 0 && cx >= 0 && cy <= Ha - kP && cx <= Wa - kP;
}

__global__ void __launch_bounds__(kThreads)
    gather_u8_kernel(const uint8_t* __restrict__ atlas, const int* __restrict__ corner,
                     float* __restrict__ out, int n, int Ha, int Wa) {
  __shared__ __align__(16) uint8_t stage[kGroup][kP][kChunks * 16];
  __shared__ uint8_t shift[kGroup][kP];  // row start inside its first chunk
  const int first = blockIdx.x * kGroup;
  const int count = min(kGroup, n - first);

  for (int j = threadIdx.x; j < count * kRowChunks; j += kThreads) {
    const int p = j / kRowChunks;
    const int rc = j - p * kRowChunks;
    const int r = rc >> 2, ch = rc & 3;
    const int cy = __ldg(corner + 2 * (first + p));
    const int cx = __ldg(corner + 2 * (first + p) + 1);
    const bool inside = window_inside(cy, cx, Ha, Wa);
    assert(inside && "gather_patches: patch window outside the atlas");
    if (!inside) continue;
    const uint8_t* src = atlas + static_cast<size_t>(cy + r) * Wa + cx;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    if (ch <= (off + kP - 1) >> 4) {
      const uint4* chunk = reinterpret_cast<const uint4*>(src - off) + ch;
      *reinterpret_cast<uint4*>(&stage[p][r][ch * 16]) = __ldg(chunk);
    }
    if (ch == 0) shift[p][r] = static_cast<uint8_t>(off);
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(first) * kPP;
  if (count == kGroup) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < kPP; i += kThreads) {
      // Element 4i of the group: patch p, row r, column c.
      const int e = 4 * i;
      int p = e / kPP;
      const int w = e - p * kPP;
      int r = w / kP;
      int c = w - r * kP;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = static_cast<float>(stage[p][r][shift[p][r] + c]);
        if (++c == kP) {
          c = 0;
          if (++r == kP) {
            r = 0;
            ++p;
          }
        }
      }
      dst4[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = threadIdx.x; e < count * kPP; e += kThreads) {
      const int p = e / kPP;
      const int w = e - p * kPP;
      const int r = w / kP, c = w - r * kP;
      dst[e] = static_cast<float>(stage[p][r][shift[p][r] + c]);
    }
  }
}

__global__ void gather_f32_kernel(const float* __restrict__ atlas,
                                  const int* __restrict__ corner,
                                  float* __restrict__ out, int Ha, int Wa) {
  const int n = blockIdx.x;
  const int cy = corner[2 * n];
  const int cx = corner[2 * n + 1];
  const bool inside = window_inside(cy, cx, Ha, Wa);
  assert(inside && "gather_patches: patch window outside the atlas");
  if (!inside) return;
  const float* src = atlas + static_cast<size_t>(cy) * Wa + cx;
  float* dst = out + static_cast<size_t>(n) * kPP;
  for (int i = threadIdx.x; i < kPP; i += blockDim.x) {
    const int r = i / kP, c = i - r * kP;
    dst[i] = src[static_cast<size_t>(r) * Wa + c];
  }
}

}  // namespace

// atlas: (Ha, Wa) contiguous; corner: (n, 2) int32 (row, col); out:
// (n, 47, 47) float32, 16-byte aligned. A window outside the atlas fails the
// kernel's assert. Returns cudaGetLastError().
extern "C" int tpuslam_gather_patches_u8(const void* atlas, const void* corner,
                                         void* out, int n, int Ha, int Wa,
                                         void* stream) {
  if (n > 0) {
    gather_u8_kernel<<<(n + kGroup - 1) / kGroup, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(atlas), static_cast<const int*>(corner),
        static_cast<float*>(out), n, Ha, Wa);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpuslam_gather_patches_f32(const void* atlas, const void* corner,
                                          void* out, int n, int Ha, int Wa,
                                          void* stream) {
  if (n > 0) {
    gather_f32_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(atlas), static_cast<const int*>(corner),
        static_cast<float*>(out), Ha, Wa);
  }
  return static_cast<int>(cudaGetLastError());
}
