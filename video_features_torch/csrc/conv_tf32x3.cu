// A convolution in 3xTF32 for Hopper (sm_90a): implicit GEMM, channels-last.
//
// Replaces no Pallas kernel. On the TPU the JAX package leaves every
// convolution of the fused RAFT -> I3D step and of the RAFT step to XLA, and
// under precision=mixed and high runs them with the ambient matmul precision
// 'high': three bf16 products per fp32 product
// (video_features_tpu/extract/base.py:177, ops/precision.py:34-44). cuDNN and
// cuBLAS have no three-pass mode, so on the card those lanes get this kernel
// for every convolution of the i3d and raft families
// (ops/conv_tf32x3.py, ops/nn.py::conv_route). It is the Hopper form of the
// TPU's three passes, with the arithmetic of csrc/gru_direction.cu: each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest (cvt.rna.tf32.f32), and every K step accumulates lo*hi + hi*lo +
// hi*hi in fp32. The dropped lo*lo term is below fp32's rounding.
//
// What it computes: y = conv(x, w) + bias with x (N, T, H, W, C) and y (N,
// OT, OH, OW, O) channels-last (2-D convolutions are T = KT = 1), each
// spatial axis with its own stride and its own zero padding per edge (I3D's
// TF-SAME pads are asymmetric), groups = 1, fp32 in and out. The weights
// come packed once per call by ops/conv_tf32x3.py::pack_weight as a (K_pad,
// O_pad) row-major matrix: K runs over taps (kt, kh, kw row-major) and, in
// each tap, over the input channels; O_pad is O rounded up to 128 with zero
// columns, so weight tiles never read past the matrix.
//
// What bounds it on the H100: operations, at the path's shapes. The
// heaviest convolution of RAFT's refinement iteration at the fused batch-8
// size (motion encoder convc2: 3x3, 256 -> 192, M = 176,128 output pixels)
// does 2 * M * 192 * 2304 = 1.56e11 flops against ~0.3 GB of input and
// output: 3 x 1.56e11 / 495 TFLOP/s = 0.94 ms at the tensor cores' TF32
// rate, 0.09 ms at 3.35 TB/s.
//
// Design: the simple form. A block computes BM = 128 output pixels x BN
// output channels (BN = 128, 64 or 16, picked from O so that narrow heads
// such as the flow head's 2 channels do not pay for 128), with 4 x 2 (or 4 x
// 1) warps of 32 x BN/2 (or 32 x BN) outputs each, on
// mma.sync.aligned.m16n8k8 TF32. K runs in chunks of 32, staged in shared
// memory by cp.async with two buffers, so the next chunk's copies overlap
// this one's products:
//
//   * A (activations): each row of a chunk is one output pixel's input at
//     one tap. Where C % 4 == 0 ("vector" mode) a chunk holds 32 channels of
//     one tap (C rounded up to 32 in K with zero weight rows), copied 16
//     bytes at a time; zero fill (source size 0) where the tap leaves the
//     input or the channel leaves C. Otherwise ("gather" mode: the RGB and
//     flow inputs of the encoders and towers, C = 3 or 2, and the motion
//     encoder's flow input) K runs over (tap, channel) pairs without
//     padding and each element is copied alone (4 bytes), so a 7x7x7 tap
//     set over 3 channels is 1,029 K, not 343 x 32.
//   * B (weights): 32 K rows x BN columns of the packed matrix per chunk.
//   * Arithmetic: every thread loads its fragments from shared memory and
//     splits hi and lo in registers (rows 36 floats and weight rows BN + 8
//     floats apart, so a fragment's 32 lanes hit 32 banks). Each chunk's 12
//     products per fragment (4 K steps x 3) go into a fresh accumulator,
//     which is then added to the running sum in fp32: the tensor cores'
//     accumulator truncates, and csrc/gru_direction.cu measured summing a
//     long K in it at ~2e-5 against float64, against ~1e-6 with the flush.
//
// No split-K and no atomics: every output is written once by one thread, so
// results are deterministic. wgmma, TMA and a ring with a producer warp are
// for a later redesign (the GRU kernel has them).
//
// The entry point launches on the given stream, does not synchronize, and
// returns a CUDA error code (0 on success) so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBM = 128;                 // output pixels per block
constexpr int kBK = 32;                  // K per staged chunk
constexpr int kLda = kBK + 4;            // floats per staged A row
constexpr int kStages = 2;
constexpr int kOPadMultiple = 128;       // ops/conv_tf32x3.py::O_PAD

struct Geometry {
  const float* x;      // (N, T, H, W, C)
  const float* w;      // packed (k_pad, o_pad)
  const float* bias;   // (O) or null
  float* y;            // (N, OT, OH, OW, O)
  long long m;         // output pixels: N * OT * OH * OW
  int t, h, w_, c;     // input extent
  int ot, oh, ow, o;   // output extent
  int kt, kh, kw;      // taps per axis
  int st, sh, sw;      // strides
  int pt, ph, pw;      // low-side zero padding
  int k_real;          // taps * C (gather mode's K before the chunk pad)
  int c_pad;           // K per tap in vector mode: C rounded up to 32
  int k_pad, o_pad;    // packed weight rows and columns
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TF32 rounding to nearest, ties away from zero: cvt.rna.tf32.f32 for
// finite x, in two integer operations (ops/gru.py::tf32_round on the host).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN >= 64 ? 2 : 1;
  static constexpr int kThreads = 128 * kWarpsN;     // 4 warps along M
  static constexpr int kWN = BN / (8 * kWarpsN);     // n8 tiles per warp
  static constexpr int kWM = 2;                      // m16 tiles per warp
  static constexpr int kLdb = BN + 8;                // floats per B row
  static constexpr size_t kSmem =
      sizeof(float) * kStages * (kBM * kLda + kBK * kLdb) + sizeof(int) * 4 * kBM;
};

// Stage chunk q of A and B into buffer `stage` (cp.async, not waited for).
template <int BN, bool VEC>
__device__ __forceinline__ void load_chunk(const Geometry& g, int q, int n0,
                                           float* as, float* bs,
                                           const int* rows) {
  using T = Tile<BN>;
  const int tid = threadIdx.x;
  const int khw = g.kh * g.kw;
  if (VEC) {
    const int per_tap = g.c_pad / kBK;
    const int tap = q / per_tap;
    const int c0 = (q - tap * per_tap) * kBK;
    const int dt = tap / khw, rem = tap - dt * khw;
    const int dh = rem / g.kw, dw = rem - dh * g.kw;
    for (int i = tid; i < kBM * (kBK / 4); i += T::kThreads) {
      const int r = i / (kBK / 4), j = i - r * (kBK / 4);
      const int c = c0 + 4 * j;
      const int b = rows[r];
      const int it = rows[kBM + r] + dt, ih = rows[2 * kBM + r] + dh,
                iw = rows[3 * kBM + r] + dw;
      const bool ok = b >= 0 && c < g.c && (unsigned)it < (unsigned)g.t
                      && (unsigned)ih < (unsigned)g.h
                      && (unsigned)iw < (unsigned)g.w_;
      const float* src = g.x;
      if (ok)
        src = g.x + ((((long long)b * g.t + it) * g.h + ih) * (long long)g.w_
                     + iw) * g.c + c;
      cp_async16(smem_addr(as + r * kLda + 4 * j), src, ok);
    }
  } else {
    for (int i = tid; i < kBM * kBK; i += T::kThreads) {
      const int r = i / kBK, kk = i - r * kBK;
      const int k = q * kBK + kk;
      const int b = rows[r];
      bool ok = false;
      const float* src = g.x;
      if (b >= 0 && k < g.k_real) {
        const int tap = k / g.c, c = k - tap * g.c;
        const int dt = tap / khw, rem = tap - dt * khw;
        const int dh = rem / g.kw, dw = rem - dh * g.kw;
        const int it = rows[kBM + r] + dt, ih = rows[2 * kBM + r] + dh,
                  iw = rows[3 * kBM + r] + dw;
        ok = (unsigned)it < (unsigned)g.t && (unsigned)ih < (unsigned)g.h
             && (unsigned)iw < (unsigned)g.w_;
        if (ok)
          src = g.x + ((((long long)b * g.t + it) * g.h + ih) * (long long)g.w_
                       + iw) * g.c + c;
      }
      cp_async4(smem_addr(as + r * kLda + kk), src, ok);
    }
  }
  const float* wsrc = g.w + (long long)q * kBK * g.o_pad + n0;
  for (int i = tid; i < kBK * (BN / 4); i += T::kThreads) {
    const int r = i / (BN / 4), j = i - r * (BN / 4);
    cp_async16(smem_addr(bs + r * T::kLdb + 4 * j),
               wsrc + (long long)r * g.o_pad + 4 * j, true);
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
conv_tf32x3_kernel(const Geometry g) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                                   // [kStages][kBM][kLda]
  float* bs = as + kStages * kBM * kLda;              // [kStages][kBK][kLdb]
  int* rows = reinterpret_cast<int*>(bs + kStages * kBK * T::kLdb);
  // rows: [batch | t0 | h0 | w0][kBM], batch -1 past the last pixel

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int grp = lane >> 2, tig = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  for (int r = tid; r < kBM; r += T::kThreads) {
    const long long m = m0 + r;
    int b = -1, t0 = 0, h0 = 0, w0 = 0;
    if (m < g.m) {
      long long q = m / g.ow;
      const int ow = (int)(m - q * g.ow);
      const long long q2 = q / g.oh;
      const int oh = (int)(q - q2 * g.oh);
      const long long q3 = q2 / g.ot;
      const int ot = (int)(q2 - q3 * g.ot);
      b = (int)q3;
      t0 = ot * g.st - g.pt;
      h0 = oh * g.sh - g.ph;
      w0 = ow * g.sw - g.pw;
    }
    rows[r] = b;
    rows[kBM + r] = t0;
    rows[2 * kBM + r] = h0;
    rows[3 * kBM + r] = w0;
  }
  __syncthreads();

  float acc[T::kWM][T::kWN][4];
#pragma unroll
  for (int i = 0; i < T::kWM; ++i)
#pragma unroll
    for (int j = 0; j < T::kWN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int chunks = g.k_pad / kBK;
  load_chunk<BN, VEC>(g, 0, n0, as, bs, rows);
  cp_async_commit();
  for (int q = 0; q < chunks; ++q) {
    const int cur = q & 1;
    if (q + 1 < chunks)
      load_chunk<BN, VEC>(g, q + 1, n0, as + (cur ^ 1) * kBM * kLda,
                          bs + (cur ^ 1) * kBK * T::kLdb, rows);
    cp_async_commit();                 // an empty group on the last chunk
    cp_async_wait<1>();                // chunk q has landed
    __syncthreads();

    const float* a = as + cur * kBM * kLda + (warp_m * 32 + grp) * kLda + tig;
    const float* bt = bs + cur * kBK * T::kLdb + tig * T::kLdb
                      + warp_n * (T::kWN * 8) + grp;
    float part[T::kWM][T::kWN][4];
#pragma unroll
    for (int i = 0; i < T::kWM; ++i)
#pragma unroll
      for (int j = 0; j < T::kWN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      uint32_t ahi[T::kWM][4], alo[T::kWM][4];
#pragma unroll
      for (int i = 0; i < T::kWM; ++i) {
        const float* ai = a + i * 16 * kLda + ks;
        split(ai[0], ahi[i][0], alo[i][0]);
        split(ai[8 * kLda], ahi[i][1], alo[i][1]);
        split(ai[4], ahi[i][2], alo[i][2]);
        split(ai[8 * kLda + 4], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < T::kWN; ++j) {
        uint32_t bhi0, blo0, bhi1, blo1;
        split(bt[ks * T::kLdb + j * 8], bhi0, blo0);
        split(bt[(ks + 4) * T::kLdb + j * 8], bhi1, blo1);
#pragma unroll
        for (int i = 0; i < T::kWM; ++i) {
          mma_tf32(part[i][j], alo[i], bhi0, bhi1);
          mma_tf32(part[i][j], ahi[i], blo0, blo1);
          mma_tf32(part[i][j], ahi[i], bhi0, bhi1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < T::kWM; ++i)
#pragma unroll
      for (int j = 0; j < T::kWN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    __syncthreads();                   // buffer cur is refilled next
  }

#pragma unroll
  for (int i = 0; i < T::kWM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kWN; ++j) {
      const int col = n0 + warp_n * (T::kWN * 8) + j * 8 + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 32 + i * 16 + grp + 8 * half;
        if (m >= g.m) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col + e;
          if (n < g.o)
            g.y[m * g.o + n] = acc[i][j][2 * half + e]
                               + (g.bias != nullptr ? g.bias[n] : 0.0f);
        }
      }
    }
  }
}

// Raise a kernel's dynamic shared memory limit once per device ordinal. The
// runtime keeps a function's attributes per device context: a flag set once
// per process would leave a second card at the 48 KB default, where the
// launch fails with cudaErrorInvalidValue.
constexpr int kMaxDevices = 64;

template <int BN, bool VEC>
cudaError_t allow_smem(int device) {
  static std::atomic<int> set[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int bytes = (int)Tile<BN>::kSmem;
  if (set[device].load(std::memory_order_acquire) == bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_tf32x3_kernel<BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess) set[device].store(bytes, std::memory_order_release);
  return err;
}

template <int BN, bool VEC>
int launch(const Geometry& g, int device, cudaStream_t stream) {
  cudaError_t err = allow_smem<BN, VEC>(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks_m = (g.m + kBM - 1) / kBM;
  if (blocks_m >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_m, (unsigned)((g.o + BN - 1) / BN));
  conv_tf32x3_kernel<BN, VEC>
      <<<grid, Tile<BN>::kThreads, Tile<BN>::kSmem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_width(const Geometry& g, int device, cudaStream_t stream) {
  if (g.o <= 16) return launch<16, VEC>(g, device, stream);
  if (g.o <= 64) return launch<64, VEC>(g, device, stream);
  return launch<128, VEC>(g, device, stream);
}

int round_up(long long v, int to) { return (int)((v + to - 1) / to * to); }

}  // namespace

extern "C" {

// x: (n, t, h, w, c) contiguous float32; w: ops/conv_tf32x3.py::pack_weight's
// (k_pad, o_pad) matrix; bias: (o) or null; y: (n, ot, oh, ow, o), which the
// caller allocates. Strides and low-side pads per axis; the high-side pads
// are implied by the output extent. A 2-D convolution passes t = ot = kt =
// st = 1 and pt = 0. c_pad is the packed K per tap in vector mode (c % 4 ==
// 0: c rounded up to 32) and c in gather mode. Returns a CUDA error code.
int vft_conv_tf32x3(const void* x, const void* w, const void* bias, void* y,
                    int n, int t, int h, int width, int c, int ot, int oh,
                    int ow, int o, int kt, int kh, int kw, int st, int sh,
                    int sw, int pt, int ph, int pw, int c_pad, int k_pad,
                    int o_pad, void* stream) {
  if (n < 0 || t < 1 || h < 1 || width < 1 || c < 1 || ot < 0 || oh < 0
      || ow < 0 || o < 1 || kt < 1 || kh < 1 || kw < 1 || st < 1 || sh < 1
      || sw < 1 || pt < 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  const long long taps = (long long)kt * kh * kw;
  const bool vec = c % 4 == 0;
  const long long k_real = taps * c;
  const long long k_want = vec ? taps * round_up(c, kBK) : round_up(k_real, kBK);
  if (c_pad != (vec ? round_up(c, kBK) : c) || k_pad != k_want
      || o_pad != round_up(o, kOPadMultiple) || k_real >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0
      || (vec && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long m = (long long)n * ot * oh * ow;
  if (m == 0) return (int)cudaSuccess;
  Geometry g{static_cast<const float*>(x), static_cast<const float*>(w),
             static_cast<const float*>(bias), static_cast<float*>(y), m,
             t, h, width, c, ot, oh, ow, o, kt, kh, kw, st, sh, sw, pt, ph, pw,
             (int)k_real, c_pad, k_pad, o_pad};
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_width<true>(g, device, s)
             : launch_width<false>(g, device, s);
}

}  // extern "C"
