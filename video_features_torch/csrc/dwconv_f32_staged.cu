// The fp32 depthwise convolution's earlier design, kept as a yardstick on
// no path (ops/dwconv.py::dwconv_f32_staged; chip_smoke.py and the card's
// tests time it in turns with csrc/dwconv_f32.cu's kernel and hold that
// kernel's outputs byte-equal to it).
//
// What it computes: y = dwconv(x, w) + bias with x (N, H, W, C) and y (N, OH,
// OW, C) contiguous, w (C, 1, KH, KW), a stride and a zero padding per edge
// for each axis, fp32. Each output is sum over the taps, row-major (dh, then
// dw), of x * w by fmaf from 0, then the bias added.
//
// Design ("staged"): a block of 256 threads computes a tile of 8 output
// rows x 16 output columns x 32 channels (8 groups of 4) of one image. It
// stages the tile's input rows and their halo, (8 - 1) * SH + KH rows of
// (16 - 1) * SW + KW pixels of its 32 channels, zero-filled outside the
// image, in shared memory by cp.async (16 bytes along C where C % 4 == 0,
// else 4), and its channels' taps. Each thread then computes one channel
// group of 4 output pixels, a float4 FMA per tap, each reading a float4 of
// input and one of taps from shared memory: bound by shared-memory reads,
// 5.4-11.5% of its bytes bound at ConvNeXt-T's batch-8 geometries
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// The entry point launches on the given stream, does not synchronize, and
// returns a CUDA error code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTH = 8;          // output rows per block
constexpr int kTW = 16;         // output columns per block
constexpr int kCB = 32;         // channels per block
constexpr int kThreads = 256;
constexpr int kPix = kTH * kTW * (kCB / 4) / kThreads;   // pixels per thread
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

struct Dw {
  const float* x;      // (N, H, W, C)
  const float* w;      // (C, 1, KH, KW)
  const float* bias;   // (C) or null
  float* y;            // (N, OH, OW, C)
  int h, w_, c;
  int oh, ow;
  int kh, kw, sh, sw, ph, pw;   // taps, strides, low-side pads
  int pr, pc;          // staged patch rows and columns
  int tiles_w;         // column tiles per image
  int vec;             // C % 4 == 0: 16-byte copies
};

__global__ void __launch_bounds__(kThreads)
dwconv_f32_staged(const Dw g) {
  extern __shared__ float4 smem4[];
  float* patch = reinterpret_cast<float*>(smem4);          // pr x pc x 32
  float* taps = patch + (size_t)g.pr * g.pc * kCB;           // kh * kw x 32
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * kCB;
  const int th = blockIdx.x / g.tiles_w;
  const int oh0 = th * kTH, ow0 = (blockIdx.x - th * g.tiles_w) * kTW;
  const int ih0 = oh0 * g.sh - g.ph, iw0 = ow0 * g.sw - g.pw;
  const float* xn = g.x + (size_t)n * g.h * g.w_ * g.c;

  // the input patch, zero outside the image and past C
  const int pixels = g.pr * g.pc;
  if (g.vec) {
    for (int i = tid; i < pixels * (kCB / 4); i += kThreads) {
      const int p = i >> 3, j = i & 7;
      const int r = p / g.pc, col = p - r * g.pc;
      const int ih = ih0 + r, iw = iw0 + col, ch = c0 + 4 * j;
      const bool ok = (unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w_
                      && ch < g.c;
      cp_async16(smem_addr(patch + p * kCB + 4 * j),
                 ok ? xn + ((size_t)ih * g.w_ + iw) * g.c + ch : g.x, ok);
    }
  } else {
    for (int i = tid; i < pixels * kCB; i += kThreads) {
      const int p = i >> 5, j = i & 31;
      const int r = p / g.pc, col = p - r * g.pc;
      const int ih = ih0 + r, iw = iw0 + col, ch = c0 + j;
      const bool ok = (unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w_
                      && ch < g.c;
      cp_async4(smem_addr(patch + p * kCB + j),
                ok ? xn + ((size_t)ih * g.w_ + iw) * g.c + ch : g.x, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the block's taps, tap-major, channels along a row
  const int ntaps = g.kh * g.kw;
  for (int i = tid; i < ntaps * kCB; i += kThreads) {
    const int t = i >> 5, j = i & 31;
    taps[i] = c0 + j < g.c ? __ldg(g.w + (size_t)(c0 + j) * ntaps + t) : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int j = tid & 7;               // channel group
  const int ch = c0 + 4 * j;
  if (ch >= g.c) return;
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g.bias != nullptr) {
    b.x = __ldg(g.bias + ch);
    if (ch + 1 < g.c) b.y = __ldg(g.bias + ch + 1);
    if (ch + 2 < g.c) b.z = __ldg(g.bias + ch + 2);
    if (ch + 3 < g.c) b.w = __ldg(g.bias + ch + 3);
  }
  const float4* taps4 = reinterpret_cast<const float4*>(taps) + j;
#pragma unroll
  for (int e = 0; e < kPix; ++e) {
    const int p = (tid >> 3) + e * (kThreads / 8);
    const int r = p / kTW, col = p - r * kTW;
    const int oh = oh0 + r, ow = ow0 + col;
    if (oh >= g.oh || ow >= g.ow) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* base = patch + ((size_t)(r * g.sh) * g.pc + col * g.sw) * kCB
                        + 4 * j;
    for (int dh = 0; dh < g.kh; ++dh) {
      const float* row = base + (size_t)dh * g.pc * kCB;
      for (int dw = 0; dw < g.kw; ++dw) {
        const float4 xv = *reinterpret_cast<const float4*>(row + dw * kCB);
        const float4 wv = taps4[(dh * g.kw + dw) * (kCB / 4)];
        acc.x = fmaf(xv.x, wv.x, acc.x);
        acc.y = fmaf(xv.y, wv.y, acc.y);
        acc.z = fmaf(xv.z, wv.z, acc.z);
        acc.w = fmaf(xv.w, wv.w, acc.w);
      }
    }
    acc.x = __fadd_rn(acc.x, b.x);
    acc.y = __fadd_rn(acc.y, b.y);
    acc.z = __fadd_rn(acc.z, b.z);
    acc.w = __fadd_rn(acc.w, b.w);
    float* out = g.y + (((size_t)n * g.oh + oh) * g.ow + ow) * g.c + ch;
    if (g.vec) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      out[0] = acc.x;
      if (ch + 1 < g.c) out[1] = acc.y;
      if (ch + 2 < g.c) out[2] = acc.z;
      if (ch + 3 < g.c) out[3] = acc.w;
    }
  }
}

cudaError_t raise_smem(int device, int bytes) {
  static std::atomic<int> set[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[device].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(dwconv_f32_staged),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[device].store(bytes, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" {

// x: (n, h, w, c) contiguous float32; w: (c, 1, kh, kw) contiguous; bias:
// (c) or null; y: (n, oh, ow, c), which the caller allocates. ph and pw are
// the low-side pads; the high-side pads are implied by the output extent.
// Returns a CUDA error code.
int vft_dwconv_f32_staged(const void* x, const void* w, const void* bias, void* y,
                   int n, int h, int width, int c, int oh, int ow, int kh,
                   int kw, int sh, int sw, int ph, int pw, void* stream) {
  if (n < 0 || h < 1 || width < 1 || c < 1 || oh < 0 || ow < 0 || kh < 1
      || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = c % 4 == 0;
  if (vec && (reinterpret_cast<uintptr_t>(x) % 16 != 0
              || reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (n == 0 || oh == 0 || ow == 0) return (int)cudaSuccess;
  const int pr = (kTH - 1) * sh + kh, pc = (kTW - 1) * sw + kw;
  const long long bytes = ((long long)pr * pc + (long long)kh * kw) * kCB * 4;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return (int)err;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  err = raise_smem(device, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (ow + kTW - 1) / kTW;
  const long long tiles = (long long)((oh + kTH - 1) / kTH) * tiles_w;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Dw g{static_cast<const float*>(x), static_cast<const float*>(w),
       static_cast<const float*>(bias), static_cast<float*>(y), h, width, c,
       oh, ow, kh, kw, sh, sw, ph, pw, pr, pc, tiles_w, vec};
  const dim3 grid((unsigned)tiles, (unsigned)((c + kCB - 1) / kCB), (unsigned)n);
  dwconv_f32_staged<<<grid, kThreads, (size_t)bytes,
                      static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
