// A direct depthwise convolution in fp32 for Hopper (sm_90a), channels-last.
//
// Replaces no Pallas kernel. On the TPU the JAX package leaves the timm
// CNNs' depthwise convolutions (ConvNeXt's 7x7; EfficientNet's and
// MobileNetV3's 3x3 and 5x5 at stride 1 and 2) to XLA as
// feature_group_count = C convolutions (video_features_tpu/ops/nn.py:71-79),
// under precision=mixed and high at the ambient 'high'; the JAX package
// itself calls them "a VPU pattern" (models/efficientnet.py:13,
// mobilenetv3.py:18). A depthwise convolution has one input channel per
// group, so a GEMM's K is only its taps: the tensor cores would waste 8x
// the products in conv_tf32x3's narrowest grouped tile, three times over.
// This kernel does the taps as plain fp32 FMAs instead: exact fp32 products
// and fp32 sums, fp32-class and closer to the reference than 3xTF32. On the
// card the clip and timm families' lane sends every such convolution here
// (ops/dwconv.py, ops/nn.py::conv).
//
// What it computes: y = dwconv(x, w) + bias with x (N, H, W, C) and y (N, OH,
// OW, C) contiguous, w (C, 1, KH, KW), KW <= 7, a stride (1 or 2 along W)
// and a zero padding per edge for each axis, fp32. Each output is the sum
// over the taps, row-major (dh, then dw), of x * w by fmaf from 0, then the
// bias added: the loop nest below (dh -> dw -> the strip's outputs) keeps
// that order for every output, so the bytes are the staged design's
// (csrc/dwconv_f32_staged.cu) and cuDNN fp32's where those agreed.
//
// What bounds it on the H100: bytes. ConvNeXt-T's first 7x7 at batch 8 (8,
// 56, 56, 96) reads and writes 9.6 MB for 0.24 GFLOP: 2.9 us at 3.35 TB/s
// against 3.6 us of fp32 FMAs at 67 TFLOP/s. A design that reads each tap's
// input from shared memory per FMA (the staged design: 49 x 32 bytes of
// shared reads per output float4 at 7x7) is bound by shared-memory reads
// instead.
//
// Design (staged once, register-blocked): a block is a tile of the map
// planned per call (ops/dwconv.py::dw_plan): `cg` channel groups of 4 x
// `rows` output rows x every 7-column strip of a row. It stages its input
// patch ((rows - 1) * SH + KH input rows of every strip's input columns,
// zero outside the image and past C) and its taps in shared memory once,
// by 16-byte cp.async along C (neighbouring threads on neighbouring
// channel groups) where C % 4 == 0. Each thread then computes a strip of
// kStrip = 7 adjacent output columns of one output row for one channel
// group: for each tap row it reads that row's KW taps and the strip's
// (kStrip - 1) * SW + KW input columns into registers once and reuses them
// across the taps and the strip's outputs, (7 * SW + KW) / (7 * KW) of
// the staged design's shared reads. The taps come tap-major, channels
// contiguous (ops/dwconv.py::pack_taps, made once for the weight's life),
// so a tap is one 16-byte copy: read from torch's (C, 1, KH, KW) layout,
// each lane's four channels were KH * KW floats apart. Maps of 14 or fewer
// rows take the whole map a block (no halo staged twice) and narrower
// channel slices until the blocks fill the card; wide maps (56, 112)
// take up to 8 groups and several rows. (Reading the rows straight from
// global memory, with the next row's loads in flight, was tried first and
// dropped: slower on the 56 x 56 and 28 x 28 maps.) Zero padding is a zero
// float4, and its
// FMA is done (0 * w adds nothing to a sum that is never -0, and keeps an
// inf or NaN tap's NaN as the staged design did). Both strides: SW is a
// template argument (the strip's input span), SH a run-time one.
//
// The entry point launches on the given stream, does not synchronize, and
// returns a CUDA error code (0 on success) so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kStrip = 7;        // output columns per thread (56 = 8 x 7 ...)
constexpr int kMaxKw = 7;
constexpr int kMaxThreads = 256;
constexpr int kMaxDevices = 64;

struct Dw {
  const float* x;      // (N, H, W, C)
  const float* w;      // taps: (KH * KW, 4 * groups), ops/dwconv.py::pack_taps
  const float* bias;   // (C) or null
  float* y;            // (N, OH, OW, C)
  int h, w_, c;
  int oh, ow;
  int kh, sh, ph, pw;  // tap rows, row stride, low-side pads
  int groups;          // channel groups of 4: ceil(C / 4)
  int cg, rows;        // the block's tile: channel groups, output rows
  int strips;          // strips per output row: ceil(OW / kStrip)
  int pr, pc;          // the staged patch's input rows and columns
  int vec;             // C % 4 == 0: 16-byte copies and stores
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, const float4& x,
                                     const float4& w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.y = fmaf(x.y, w.y, acc.y);
  acc.z = fmaf(x.z, w.z, acc.z);
  acc.w = fmaf(x.w, w.w, acc.w);
}

template <int KW, int SW>
__global__ void __launch_bounds__(kMaxThreads)
dwconv_f32_kernel(const Dw g) {
  constexpr int kSpan = (kStrip - 1) * SW + KW;   // input columns of a strip
  extern __shared__ float4 smem4[];
  // the block's input patch, pr x pc pixels of cg channel groups, and its
  // taps, KH * KW x cg channel groups
  float4* patch = smem4;
  float4* taps = patch + (size_t)g.pr * g.pc * g.cg;
  const int t = threadIdx.x;
  const int n = blockIdx.z;
  const int oh0 = blockIdx.x * g.rows;
  const int grp0 = blockIdx.y * g.cg;
  const int ih0 = oh0 * g.sh - g.ph, iw0 = -g.pw;

  // stage the patch (zero outside the image and past C) and the taps
  const float* xn = g.x + (size_t)n * g.h * g.w_ * g.c;
  const int pixels = g.pr * g.pc;
  for (int i = t; i < pixels * g.cg; i += blockDim.x) {
    const int p = i / g.cg, j = i - p * g.cg;
    const int r = p / g.pc, col = p - r * g.pc;
    const int ih = ih0 + r, iw = iw0 + col, ch = 4 * (grp0 + j);
    const bool in = (unsigned)ih < (unsigned)g.h
                    && (unsigned)iw < (unsigned)g.w_ && ch < g.c;
    const float* src = xn + ((size_t)(in ? ih : 0) * g.w_ + (in ? iw : 0)) * g.c
                       + (in ? ch : 0);
    if (g.vec) {
      cp_async16(smem_addr(patch + i), src, in);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        v.x = __ldg(src);
        if (ch + 1 < g.c) v.y = __ldg(src + 1);
        if (ch + 2 < g.c) v.z = __ldg(src + 2);
        if (ch + 3 < g.c) v.w = __ldg(src + 3);
      }
      patch[i] = v;
    }
  }
  const int ntaps = g.kh * KW;
  for (int i = t; i < ntaps * g.cg; i += blockDim.x) {
    const int tap = i / g.cg, j = i - tap * g.cg;
    const bool in = grp0 + j < g.groups;
    cp_async16(smem_addr(taps + i),
               g.w + (size_t)tap * 4 * g.groups + 4 * (in ? grp0 + j : 0), in);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int cgi = t % g.cg;
  const int rest = t / g.cg;
  const int strip = rest % g.strips;
  const int row = rest / g.strips;
  const int oh = oh0 + row;
  const int grp = grp0 + cgi;
  if (row >= g.rows || oh >= g.oh || grp >= g.groups) return;
  const int ch = 4 * grp;
  const int ow0 = strip * kStrip;

  float4 acc[kStrip];
#pragma unroll
  for (int s = 0; s < kStrip; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  // this thread's patch column: output column ow0's first input column
  const float4* pbase = patch + ((size_t)(row * g.sh) * g.pc + ow0 * SW) * g.cg + cgi;
#pragma unroll 1
  for (int dh = 0; dh < g.kh; ++dh) {
    // tap row dh's KW taps and the strip's input row, each read once
    float4 tap[KW], in[kSpan];
#pragma unroll
    for (int dw = 0; dw < KW; ++dw) tap[dw] = taps[(dh * KW + dw) * g.cg + cgi];
    const float4* prow = pbase + (size_t)dh * g.pc * g.cg;
#pragma unroll
    for (int i = 0; i < kSpan; ++i) in[i] = prow[i * g.cg];
#pragma unroll
    for (int dw = 0; dw < KW; ++dw)
#pragma unroll
      for (int s = 0; s < kStrip; ++s) fma4(acc[s], in[s * SW + dw], tap[dw]);
  }

  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g.bias != nullptr) {
    b.x = __ldg(g.bias + ch);
    if (ch + 1 < g.c) b.y = __ldg(g.bias + ch + 1);
    if (ch + 2 < g.c) b.z = __ldg(g.bias + ch + 2);
    if (ch + 3 < g.c) b.w = __ldg(g.bias + ch + 3);
  }
  float* yrow = g.y + (((size_t)n * g.oh + oh) * g.ow) * g.c + ch;
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    const int ow = ow0 + s;
    if (ow >= g.ow) break;
    float4 v;
    v.x = __fadd_rn(acc[s].x, b.x);
    v.y = __fadd_rn(acc[s].y, b.y);
    v.z = __fadd_rn(acc[s].z, b.z);
    v.w = __fadd_rn(acc[s].w, b.w);
    float* out = yrow + (size_t)ow * g.c;
    if (g.vec) {
      *reinterpret_cast<float4*>(out) = v;
    } else {
      out[0] = v.x;
      if (ch + 1 < g.c) out[1] = v.y;
      if (ch + 2 < g.c) out[2] = v.z;
      if (ch + 3 < g.c) out[3] = v.w;
    }
  }
}

// Raise an instantiation's dynamic shared memory limit once per device.
template <int KW, int SW>
cudaError_t launch_one(const Dw& g, dim3 grid, int threads, int smem,
                       int device, cudaStream_t stream) {
  static std::atomic<int> set[kMaxDevices];
  if (set[device].load(std::memory_order_acquire) < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(dwconv_f32_kernel<KW, SW>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set[device].store(smem, std::memory_order_release);
  }
  dwconv_f32_kernel<KW, SW><<<grid, threads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <int KW>
cudaError_t launch_kw(const Dw& g, int sw, dim3 grid, int threads, int smem,
                      int device, cudaStream_t stream) {
  return sw == 1 ? launch_one<KW, 1>(g, grid, threads, smem, device, stream)
                 : launch_one<KW, 2>(g, grid, threads, smem, device, stream);
}

}  // namespace

extern "C" {

// x: (n, h, w, c) contiguous float32; w: the taps (kh * kw, 4 *
// ceil(c / 4)), 16-byte aligned (ops/dwconv.py::pack_taps), kw <= 7; bias:
// (c) or null; y: (n, oh, ow, c), which the caller allocates. ph and pw are
// the low-side pads; the high-side pads are implied by the output extent.
// sw is 1 or 2. cg and rows: ops/dwconv.py::dw_plan's tile (channel groups
// of 4 and output rows per block, cg * rows * ceil(ow / 7) <= 256 threads,
// its patch and taps within the block's shared memory). device: the
// current device's ordinal. Returns a CUDA error code.
int vft_dwconv_f32(const void* x, const void* w, const void* bias, void* y,
                   int n, int h, int width, int c, int oh, int ow, int kh,
                   int kw, int sh, int sw, int ph, int pw, int cg, int rows,
                   int device, void* stream) {
  if (n < 0 || h < 1 || width < 1 || c < 1 || oh < 0 || ow < 0 || kh < 1
      || kw < 1 || kw > kMaxKw || sh < 1 || (sw != 1 && sw != 2) || ph < 0
      || pw < 0 || n > 65535 || cg < 1 || rows < 1 || device < 0
      || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const int vec = c % 4 == 0;
  if ((vec && (reinterpret_cast<uintptr_t>(x) % 16 != 0
               || reinterpret_cast<uintptr_t>(y) % 16 != 0))
      || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n == 0 || oh == 0 || ow == 0) return (int)cudaSuccess;
  const int groups = (c + 3) / 4;
  const int strips = (ow + kStrip - 1) / kStrip;
  const long long threads = (long long)cg * rows * strips;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const long long row_blocks = (oh + rows - 1) / rows;
  const long long group_blocks = (groups + cg - 1) / cg;
  if (row_blocks >= (1LL << 31) || group_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  // the patch: the rows' input rows and every strip's input columns
  const int pr = (rows - 1) * sh + kh;
  const int pc = (strips * kStrip - 1) * sw + kw;
  const long long smem = ((long long)pr * pc + (long long)kh * kw) * cg * 16;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  Dw g{static_cast<const float*>(x), static_cast<const float*>(w),
       static_cast<const float*>(bias), static_cast<float*>(y), h, width, c,
       oh, ow, kh, sh, ph, pw, groups, cg, rows, strips, pr, pc, vec};
  const dim3 grid((unsigned)row_blocks, (unsigned)group_blocks, (unsigned)n);
  const int nthreads = (int)((threads + 31) / 32 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return (int)launch_kw<1>(g, sw, grid, nthreads, (int)smem, device, s);
    case 2: return (int)launch_kw<2>(g, sw, grid, nthreads, (int)smem, device, s);
    case 3: return (int)launch_kw<3>(g, sw, grid, nthreads, (int)smem, device, s);
    case 4: return (int)launch_kw<4>(g, sw, grid, nthreads, (int)smem, device, s);
    case 5: return (int)launch_kw<5>(g, sw, grid, nthreads, (int)smem, device, s);
    case 6: return (int)launch_kw<6>(g, sw, grid, nthreads, (int)smem, device, s);
    default: return (int)launch_kw<7>(g, sw, grid, nthreads, (int)smem, device, s);
  }
}

}  // extern "C"
