// The unified GANAX conv/tconv kernel for Hopper (sm_90a), f32.
//
// Replaces: ganax_conv_kernel / ganax_conv_pallas (with
// apply_epilogue_to_acc) in src/repro/kernels/ganax_conv.py, the 2-D
// Pallas TPU kernel.  It computes the same function with the same
// phase-major output contract:
//
//   out[b, p, qy, qx, n] = act(bias[n] + sum_{t < n_taps[p]} sum_c
//       x_pad[b, tap_dy[p,t] + qy*sy, tap_dx[p,t] + qx*sx, c]
//       * w_taps[p, t, c, n])
//
// Transposed convs arrive as P = sy*sx phases at unit stride (MIMD: each
// phase runs its own tap loop, of its own length); plain strided convs
// as one phase whose taps are the whole kernel (SIMD mode).
//
// What bounds it on the card: the DCGAN generator layers g1-g3 do
// 134 M consequential MACs per image against a few MB of operands, so
// at batch 64 they are bound by arithmetic (FP32 FFMA, 67 TFLOP/s on an
// H100 SXM); g4 (Cout = 3) is small either way.
//
// Design: an implicit GEMM per phase.  The rows are the B*Qy*Qx output
// pixels of the phase plane, the columns the Cout channels, and the
// reduction runs over (tap, Cin).  One block computes a BM x BN tile of
// one phase; the grid is (row tiles, Cout tiles, phases), all
// independent.  The TPU kernel walks Cin as a sequential grid axis and
// carries its sum in VMEM scratch between grid steps; nothing carries
// over between CUDA blocks, so the loops over the phase's taps and over
// Cin chunks of BK channels both run inside the block, into register
// accumulators.  The block reads its tap count and offsets itself from
// small int32 tables on the device, and addresses the strided input
// window directly (the TPU loads a window and subsamples it).  Each
// chunk stages a BK x BM slice of the gathered input and a BK x BN slice
// of the weights in shared memory; every thread then does TM x TN
// FFMAs per staged channel.  The flush adds the bias and applies the
// activation on the f32 accumulator and stores once.  Ragged rows,
// channels and Cout are masked, so any Cin / Cout works (Cout = 3 takes
// a narrow tile).  A phase with no taps still writes act(bias).  No
// TF32, no wgmma, no TMA: those are for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kBK = 16;  // Cin channels staged per step

// Activation codes (ACTIVATION_CODES in ganax_conv.py).
constexpr int kRelu = 1;
constexpr int kLeakyRelu = 2;
constexpr int kTanh = 3;

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == kRelu) return v > 0.f ? v : 0.f;
  if (act == kLeakyRelu) return v > 0.f ? v : slope * v;
  if (act == kTanh) return tanhf(v);
  return v;
}

// Copies N floats from shared memory with the widest aligned loads.
template <int N>
__device__ __forceinline__ void load_fragment(float (&dst)[N],
                                              const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(src)[q];
      dst[2 * q] = v.x;
      dst[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

// BM x BN output tile per block, TM x TN per thread.  All offsets are
// 32-bit: the wrapper refuses operands of 2^31 elements or more.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
ganax_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ n_taps,
                  const int* __restrict__ tap_dy,
                  const int* __restrict__ tap_dx,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int B, int Hp, int Wp, int Cin, int T, int Cout, int Qy,
                  int Qx, int sy, int sx, int act, float slope) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kRowsPerPass = kThreads / kBK;
  constexpr int kALoads = BM / kRowsPerPass;
  constexpr int kBLoads = (kBK * BN + kThreads - 1) / kThreads;
  static_assert(kThreads % kBK == 0 && BM % kRowsPerPass == 0,
                "the input tile must split evenly over the threads");
  static_assert(BM % 4 == 0 && BN % 4 == 0, "16-byte aligned tile rows");

  // +4 keeps each row 16-byte aligned for the fragment loads.
  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int p = blockIdx.z;
  const int P = gridDim.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int plane = Qy * Qx;
  const int M = B * plane;

  // The input rows this thread stages are fixed for the whole block:
  // row (b, qy, qx) of the phase plane starts at pixel
  // (qy*sy, qx*sx) of image b, before the tap's (dy, dx) shift.
  const int a_k = tid % kBK;
  const int a_row0 = tid / kBK;
  int a_base[kALoads];
#pragma unroll
  for (int i = 0; i < kALoads; ++i) {
    const int m = m0 + a_row0 + i * kRowsPerPass;
    if (m < M) {
      const int b = m / plane;
      const int r = m - b * plane;
      const int qy = r / Qx;
      const int qx = r - qy * Qx;
      a_base[i] = ((b * Hp + qy * sy) * Wp + qx * sx) * Cin;
    } else {
      a_base[i] = -1;
    }
  }

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nt = n_taps[p];
  for (int t = 0; t < nt; ++t) {
    const int tap_off = (tap_dy[p * T + t] * Wp + tap_dx[p * T + t]) * Cin;
    const float* wt = w + (p * T + t) * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      const int ca = c0 + a_k;
#pragma unroll
      for (int i = 0; i < kALoads; ++i) {
        As[a_k][a_row0 + i * kRowsPerPass] =
            (a_base[i] >= 0 && ca < Cin) ? x[a_base[i] + tap_off + ca] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBLoads; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < kBK * BN) {
          const int k = idx / BN;
          const int n = idx - k * BN;
          const int c = c0 + k;
          const int nn = n0 + n;
          Bs[k][n] = (c < Cin && nn < Cout) ? wt[c * Cout + nn] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[TM];
        float bv[TN];
        load_fragment<TM>(a, &As[k][ty * TM]);
        load_fragment<TN>(bv, &Bs[k][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Flush: bias and activation on the f32 accumulator, one store.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int b = m / plane;
    const int r = m - b * plane;
    float* orow = out + ((b * P + p) * plane + r) * Cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < Cout) {
        const float v = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
        orow[n] = activate(v, act, slope);
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const float* x, const float* w, const int* n_taps,
            const int* tap_dy, const int* tap_dx, const float* bias,
            float* out, int B, int Hp, int Wp, int Cin, int P, int T,
            int Cout, int Qy, int Qx, int sy, int sx, int act, float slope,
            cudaStream_t stream) {
  const int M = B * Qy * Qx;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, P);
  const dim3 block((BM / TM) * (BN / TN));
  ganax_conv_kernel<BM, BN, TM, TN><<<grid, block, 0, stream>>>(
      x, w, n_taps, tap_dy, tap_dx, bias, out, B, Hp, Wp, Cin, T, Cout, Qy,
      Qx, sy, sx, act, slope);
}

}  // namespace

// Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted).  `bias` may be
// null.
extern "C" int ganax_conv_f32(const float* x, const float* w,
                              const int* n_taps, const int* tap_dy,
                              const int* tap_dx, const float* bias,
                              float* out, int B, int Hp, int Wp, int Cin,
                              int P, int T, int Cout, int Qy, int Qx, int sy,
                              int sx, int act, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 8) {
    // narrow tile for image-producing layers (Cout = 1 or 3)
    launch<128, 8, 4, 2>(x, w, n_taps, tap_dy, tap_dx, bias, out, B, Hp, Wp,
                         Cin, P, T, Cout, Qy, Qx, sy, sx, act, slope, s);
  } else {
    launch<64, 64, 4, 4>(x, w, n_taps, tap_dy, tap_dx, bias, out, B, Hp, Wp,
                         Cin, P, T, Cout, Qy, Qx, sy, sx, act, slope, s);
  }
  return static_cast<int>(cudaGetLastError());
}
