// RAFT correlation-window lookup for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of video_features_tpu/ops/pallas_corr.py:
//   * vft_corr_lookup_masked  <- lookup_corr_lanes (_lanes_kernel)
//   * vft_corr_lookup_padded  <- lookup_corr (_level_kernel)
//
// Both compute, for each of N pixels and each of the 4 pyramid levels
// (coords scaled by 2^-l), the (2r+1)^2 = 81 bilinear samples of that pixel's
// own correlation map around (x, y), zeros outside the map
// (grid_sample align_corners=True, padding_mode='zeros'). Output element
// l*81 + i*9 + j samples (x + i - r, y + j - r): the reference's dy-major
// order. The output is (N, 324) float32, the layout RAFT's motion encoder
// reads, written once.
//
// Levels are in their natural (N, h, w) layout (the TPU kernels' (h, w, N')
// lane transpose and 128-lane padding are artifacts of the TPU's tiling).
// The masked kernel reads the plain levels and predicates every read; the
// padded kernel reads levels zero-padded by PAD = 2r+3 on every side (done
// once per RAFT forward, outside the iteration loop) with coordinates clamped
// so that every read is in bounds, and has no predicates.
//
// What bounds it on the H100: memory. Per call it writes N*324*4 bytes and
// reads each pixel's 10x10 patch on every level (N*4*100*4 bytes at most),
// with a handful of flops per byte. Design: one thread per output element,
// so the (N, 324) store is fully coalesced; the 4 corner reads of
// neighbouring outputs fall in the same 10x10 patch, so after the first touch
// they are served from L1. The patch is not staged in shared memory: this is
// the simple first kernel, and its time stands in PERF.md beside its bound.
//
// Each entry point launches on the given stream, does not synchronize, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kRadius = 4;
constexpr int kSide = 2 * kRadius + 1;      // 9
constexpr int kWindow = kSide * kSide;      // 81
constexpr int kOut = kLevels * kWindow;     // 324
constexpr int kPad = 2 * kRadius + 3;       // 11
constexpr int kThreads = 256;

struct Levels {
  const float* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

// Clamp a coordinate to [-r-2, extent+r+1]. Any coordinate beyond that range
// has every sample of its window at least one pixel outside the map, so the
// window is all zeros either way; the clamp keeps the float->int conversion
// in range and every padded read in bounds.
__device__ __forceinline__ float clamp_coord(float v, int extent) {
  return fminf(fmaxf(v, -kRadius - 2.0f), extent + kRadius + 1.0f);
}

__device__ __forceinline__ float read_masked(const float* __restrict__ m,
                                             int h, int w, int y, int x) {
  return (x >= 0 && x < w && y >= 0 && y < h) ? __ldg(m + y * w + x) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
masked_kernel(Levels lv, const float* __restrict__ coords,
              float* __restrict__ out, int64_t n) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * kOut) return;
  const int64_t p = idx / kOut;
  const int o = (int)(idx - p * kOut);
  const int l = o / kWindow;
  const int k = o - l * kWindow;
  const int i = k / kSide;                  // x offset index
  const int j = k - i * kSide;              // y offset index
  const int h = lv.h[l];
  const int w = lv.w[l];
  const float scale = 1.0f / (float)(1 << l);   // exact power of two
  const float x = clamp_coord(__ldg(coords + 2 * p) * scale, w);
  const float y = clamp_coord(__ldg(coords + 2 * p + 1) * scale, h);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int xs = (int)x0 + i - kRadius;
  const int ys = (int)y0 + j - kRadius;
  const float* __restrict__ m = lv.ptr[l] + p * (int64_t)h * w;
  // x blend first, then y: the order of the TPU lanes kernel
  const float top = (1.0f - fx) * read_masked(m, h, w, ys, xs)
                  + fx * read_masked(m, h, w, ys, xs + 1);
  const float bot = (1.0f - fx) * read_masked(m, h, w, ys + 1, xs)
                  + fx * read_masked(m, h, w, ys + 1, xs + 1);
  out[idx] = (1.0f - fy) * top + fy * bot;
}

__global__ void __launch_bounds__(kThreads)
padded_kernel(Levels lv, const float* __restrict__ coords,
              float* __restrict__ out, int64_t n) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * kOut) return;
  const int64_t p = idx / kOut;
  const int o = (int)(idx - p * kOut);
  const int l = o / kWindow;
  const int k = o - l * kWindow;
  const int i = k / kSide;
  const int j = k - i * kSide;
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int wp = w + 2 * kPad;
  const int hp = h + 2 * kPad;
  const float scale = 1.0f / (float)(1 << l);
  const float x = clamp_coord(__ldg(coords + 2 * p) * scale, w);
  const float y = clamp_coord(__ldg(coords + 2 * p + 1) * scale, h);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = x - x0;
  const float wy = y - y0;
  // in bounds by the clamp: xs in [1, w + kPad + 1], xs + 1 <= wp - 1
  const int xs = (int)x0 - kRadius + kPad + i;
  const int ys = (int)y0 - kRadius + kPad + j;
  const float* __restrict__ m =
      lv.ptr[l] + p * (int64_t)hp * wp + (int64_t)ys * wp + xs;
  // the 4-term blend of the TPU window-slice kernel
  out[idx] = (1.0f - wx) * (1.0f - wy) * __ldg(m)
           + wx * (1.0f - wy) * __ldg(m + 1)
           + (1.0f - wx) * wy * __ldg(m + wp)
           + wx * wy * __ldg(m + wp + 1);
}

Levels make_levels(const void* l0, const void* l1, const void* l2,
                   const void* l3, int h0, int w0, int h1, int w1, int h2,
                   int w2, int h3, int w3) {
  Levels lv;
  lv.ptr[0] = static_cast<const float*>(l0);
  lv.ptr[1] = static_cast<const float*>(l1);
  lv.ptr[2] = static_cast<const float*>(l2);
  lv.ptr[3] = static_cast<const float*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  return lv;
}

}  // namespace

extern "C" {

int vft_corr_lookup_masked(const void* l0, const void* l1, const void* l2,
                           const void* l3, int h0, int w0, int h1, int w1,
                           int h2, int w2, int h3, int w3, const void* coords,
                           void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Levels lv = make_levels(l0, l1, l2, l3, h0, w0, h1, w1, h2, w2, h3, w3);
  const long long blocks = (n * kOut + kThreads - 1) / kThreads;
  masked_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

int vft_corr_lookup_padded(const void* l0, const void* l1, const void* l2,
                           const void* l3, int h0, int w0, int h1, int w1,
                           int h2, int w2, int h3, int w3, const void* coords,
                           void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Levels lv = make_levels(l0, l1, l2, l3, h0, w0, h1, w1, h2, w2, h3, w3);
  const long long blocks = (n * kOut + kThreads - 1) / kThreads;
  padded_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
