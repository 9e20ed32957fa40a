// One SepConvGRU direction of RAFT's update block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/gru_kernel_experiment.py::
// pallas_direction (body _kernel). With h and motion (M pixels, 128 channels
// each, channels-last), the direction's weights in tap layout
// w_zr (5, 256 in, 256 out) and w_q (5, 256 in, 128 out) -- the in axis is
// [h | motion], zr's out axis is [z | r] -- and the precomputed context terms
// zr_term (M, 256) and q_term (M, 128):
//
//   zr  = sigmoid(sum_t [h, motion](p + t - 2) . w_zr[t] + zr_term)
//   q   = tanh(sum_t [r*h, motion](p + t - 2) . w_q[t] + q_term)
//   out = (1 - z) * h + z * q
//
// The tap offset runs along W (axis 'w', the 1x5 pass) or H (axis 'h', the
// 5x1 pass) with zero padding at the image's edge: a tap never reads into
// the next row or the next image of the batch.
//
// What bounds it on the H100: operations. Per pixel it does 2 * 1280 * 384 =
// 983,040 flops against 3 KB of input and output; at the main path's batch-8
// shape (M = 128 pairs x 32 x 43 = 176,128) that is 1.73e11 flops, 2.58 ms at
// the 67 TFLOP/s fp32 rate, against 0.16 ms for the 541 MB of h, motion,
// terms and output at 3.35 TB/s. No tensor cores: the port is true fp32
// under precision=highest, and TF32 would change the numbers.
//
// Design: two implicit GEMMs in fp32 FMA, M = pixels, N = output channels,
// K = 5 taps x 256 input channels, each a classic register-blocked SGEMM.
// A block computes BM pixels x 128 output channels; 256 threads each hold
// (BM/16) x 8 accumulators. The K loop walks 16 input channels of one tap at
// a time: the A tile (the tap-shifted, edge-masked input rows, read straight
// from the two 128-channel tensors, so no concatenation is ever stored) and
// the B tile (weights) go through registers into a double-buffered shared
// memory stage, so the next tile's global loads overlap this tile's FMAs.
//
//   1. gru_gemm<TM, true>: the 256-wide zr GEMM with the sigmoid epilogue.
//      The z half (blockIdx.y == 0) writes z; the r half writes r*h, which
//      is the q GEMM's input. Writing and reading both back is
//      4 x M x 512 bytes, ~0.1 ms at the batch-8 shape.
//   2. gru_gemm<TM, false>: the 128-wide q GEMM over [r*h, motion] with
//      the tanh and blend epilogue.
//
// Two launches instead of one because the q GEMM needs r at the neighbouring
// pixels; one launch would have to recompute the zr GEMM over a +-2 halo.
// BM is 128 when the pixel count gives at least two waves of 128-pixel
// blocks, else 64, so that the RAFT family's batch of 11,008 pixels still
// fills the 132 SMs. No atomics: every output is written once by one
// thread, so results are deterministic. The TPU kernel's (W, M, C)
// transposed VMEM buffer and its bf16 hi/lo split (3 MXU dots per tap) are
// artifacts of the TPU and are not carried over.
//
// The entry point launches on the given stream, does not synchronize, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                  // hidden and motion channels
constexpr int kIn = 2 * kC;              // input channels per tap
constexpr int kTaps = 5;
constexpr int kBN = 128;                 // output channels per block
constexpr int kBK = 16;                  // input channels per K step
constexpr int kSteps = kTaps * kIn / kBK;     // 80
constexpr int kStepsPerTap = kIn / kBK;       // 16
constexpr int kThreads = 256;

struct Args {
  const float* src0;     // conv input channels 0..127: h (zr) or r*h (q)
  const float* src1;     // conv input channels 128..255: motion
  const float* w;        // (5, 256, n_out)
  const float* term;     // (M, n_out)
  const float* h;        // (M, 128)
  const float* z;        // (M, 128), read by the q epilogue
  float* out0;           // zr: z; q: the new h
  float* out1;           // zr: r*h
  int m, height, width, axis_h, n_out;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// TM: accumulator rows per thread (BM = 16 * TM pixels per block).
// ZR: the zr GEMM and its epilogue, else the q GEMM and its epilogue.
template <int TM, bool ZR>
__global__ void __launch_bounds__(kThreads, 2)
gru_gemm(Args a) {
  constexpr int BM = 16 * TM;
  constexpr int LDA = BM + 4;                         // keeps float4 rows aligned
  constexpr int kALoads = BM * kBK / 4 / kThreads;    // float4 per thread
  constexpr int kBLoads = kBK * kBN / 4 / kThreads;
  __shared__ __align__(16) float As[2][kBK][LDA];     // [k][pixel]
  __shared__ __align__(16) float Bs[2][kBK][kBN];     // [k][out channel]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;

  // The pixels this thread loads (fixed over the K loop) and their position
  // along the tap axis, for the edge mask.
  const int quad = tid % 4;                           // 4 channels of kBK
  const int extent = a.axis_h ? a.height : a.width;
  const int stride = a.axis_h ? a.width : 1;
  int a_pix[kALoads], a_pos[kALoads];
#pragma unroll
  for (int i = 0; i < kALoads; ++i) {
    const int p = m0 + tid / 4 + i * (kThreads / 4);
    a_pix[i] = p;
    // a pixel past the end gets a position that fails every tap's mask
    a_pos[i] = p >= a.m ? -(1 << 20)
             : (a.axis_h ? (p / a.width) % a.height : p % a.width);
  }

  float4 ra[kALoads], rb[kBLoads];
  auto load = [&](int step) {
    const int tap = step / kStepsPerTap;
    const int c0 = (step % kStepsPerTap) * kBK;
    const float* src = c0 < kC ? a.src0 : a.src1;
    const int c = (c0 & (kC - 1)) + quad * 4;
    const int d = tap - kTaps / 2;
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int pos = a_pos[i] + d;
      ra[i] = (pos >= 0 && pos < extent)
          ? __ldg(reinterpret_cast<const float4*>(
                src + (int64_t)(a_pix[i] + d * stride) * kC + c))
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int k = step * kBK + tid / 32 + i * (kThreads / 32);
      rb[i] = __ldg(reinterpret_cast<const float4*>(
          a.w + (int64_t)k * a.n_out + n0 + (tid % 32) * 4));
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int row = tid / 4 + i * (kThreads / 4);
      As[buf][quad * 4 + 0][row] = ra[i].x;
      As[buf][quad * 4 + 1][row] = ra[i].y;
      As[buf][quad * 4 + 2][row] = ra[i].z;
      As[buf][quad * 4 + 3][row] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      *reinterpret_cast<float4*>(
          &Bs[buf][tid / 32 + i * (kThreads / 32)][(tid % 32) * 4]) = rb[i];
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < kSteps; ++step) {
    const int cur = step & 1;
    if (step + 1 < kSteps) load(step + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[8];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][k][g * 64 + ty * 4]);
        av[g * 4 + 0] = v.x; av[g * 4 + 1] = v.y;
        av[g * 4 + 2] = v.z; av[g * 4 + 3] = v.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (step + 1 < kSteps) store(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: thread row i is pixel m0 + (i/4)*64 + ty*4 + i%4; its columns
  // are tx*4 + 0..3 and 64 + tx*4 + 0..3 of this block's 128.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (p >= a.m) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = g * 64 + tx * 4;                  // channel in [0, 128)
      const float4 t = __ldg(reinterpret_cast<const float4*>(
          a.term + (int64_t)p * a.n_out + n0 + n));
      const float s0 = acc[i][g * 4 + 0] + t.x, s1 = acc[i][g * 4 + 1] + t.y;
      const float s2 = acc[i][g * 4 + 2] + t.z, s3 = acc[i][g * 4 + 3] + t.w;
      const int64_t o = (int64_t)p * kC + n;
      if constexpr (ZR) {
        const float4 v = make_float4(sigmoid(s0), sigmoid(s1), sigmoid(s2),
                                     sigmoid(s3));
        if (blockIdx.y == 0) {
          *reinterpret_cast<float4*>(a.out0 + o) = v;                 // z
        } else {
          const float4 h = __ldg(reinterpret_cast<const float4*>(a.h + o));
          *reinterpret_cast<float4*>(a.out1 + o) =                     // r*h
              make_float4(v.x * h.x, v.y * h.y, v.z * h.z, v.w * h.w);
        }
      } else {
        const float4 h = __ldg(reinterpret_cast<const float4*>(a.h + o));
        const float4 z = __ldg(reinterpret_cast<const float4*>(a.z + o));
        const float q0 = tanhf(s0), q1 = tanhf(s1);
        const float q2 = tanhf(s2), q3 = tanhf(s3);
        *reinterpret_cast<float4*>(a.out0 + o) = make_float4(
            (1.0f - z.x) * h.x + z.x * q0, (1.0f - z.y) * h.y + z.y * q1,
            (1.0f - z.z) * h.z + z.z * q2, (1.0f - z.w) * h.w + z.w * q3);
      }
    }
  }
}

template <int TM>
int launch(const Args& zr, const Args& q, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const unsigned mblocks = (unsigned)((zr.m + BM - 1) / BM);
  gru_gemm<TM, true><<<dim3(mblocks, 2 * kC / kBN), kThreads, 0, stream>>>(zr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gru_gemm<TM, false><<<dim3(mblocks, kC / kBN), kThreads, 0, stream>>>(q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h, motion, q_term, z, rh, out: (B, H, W, 128); zr_term: (B, H, W, 256);
// w_zr: (5, 256, 256); w_q: (5, 256, 128); all contiguous float32.
// axis_h: 0 for the 1x5 pass (taps along W), 1 for the 5x1 pass (along H).
// z and rh are scratch the caller allocates.
int vft_gru_direction(const void* h, const void* motion, const void* w_zr,
                      const void* w_q, const void* zr_term, const void* q_term,
                      void* z, void* rh, void* out, int batch, int height,
                      int width, int axis_h, void* stream) {
  const long long m = (long long)batch * height * width;
  if (m <= 0) return (int)cudaSuccess;
  if (m * kIn >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Args zr{static_cast<const float*>(h), static_cast<const float*>(motion),
          static_cast<const float*>(w_zr), static_cast<const float*>(zr_term),
          static_cast<const float*>(h), nullptr, static_cast<float*>(z),
          static_cast<float*>(rh), (int)m, height, width, axis_h, 2 * kC};
  Args q{static_cast<const float*>(rh), static_cast<const float*>(motion),
         static_cast<const float*>(w_q), static_cast<const float*>(q_term),
         static_cast<const float*>(h), static_cast<const float*>(z),
         static_cast<float*>(out), nullptr, (int)m, height, width, axis_h, kC};
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128-pixel blocks once the q GEMM alone gives two waves of them
  return (m + 127) / 128 >= 2LL * sms ? launch<8>(zr, q, s) : launch<4>(zr, q, s);
}

}  // extern "C"
