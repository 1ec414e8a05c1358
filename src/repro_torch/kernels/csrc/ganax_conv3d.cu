// The volumetric GANAX conv/tconv kernel for Hopper (sm_90a), f32.
//
// Replaces: ganax_conv3d_kernel / ganax_conv3d_pallas in
// src/repro/kernels/ganax_conv.py, the 3-D Pallas TPU kernel (the twin of
// the planar kernel that ganax_conv.cu ports).  It computes the same
// function with the same phase-major output contract:
//
//   out[b, p, qz, qy, qx, n] = act(bias[n] + sum_{t < n_taps[p]} sum_c
//       x_pad[b, tap_dz[p,t] + qz*sz, tap_dy[p,t] + qy*sy,
//             tap_dx[p,t] + qx*sx, c] * w_taps[p, t, c, n])
//
// Transposed convs arrive as P = sz*sy*sx phases at unit stride (MIMD:
// each phase runs its own tap loop, of its own length); plain strided
// convs as one phase whose taps are the whole kernel (SIMD mode).
//
// What bounds it on the card: the 3D-GAN generator at batch 64 runs 8
// phases of 8 consequential taps per layer.  g1-g3 do 69, 137 and 275
// GFLOP against at most 0.7 GB of operands, so they are bound by
// arithmetic (FP32 FFMA, 67 TFLOP/s on an H100 SXM: 1.03, 2.05 and
// 4.10 ms).  g4 (Cin = 64, Cout = 1) is about balanced: 17 GFLOP take
// 0.26 ms at the FP32 peak, and its 0.7 GB (a 644 MB padded input) take
// 0.21 ms at 3.35 TB/s.
//
// Design: the implicit GEMM of ganax_conv.cu with a depth axis.  The
// rows are the B*Qz*Qy*Qx output voxels of the phase, the columns the
// Cout channels, and the reduction runs over (tap, Cin).  One block
// computes a BM x BN tile of one phase; the grid is (row tiles, Cout
// tiles, phases), all independent.  The TPU kernel holds a whole padded
// volume of one image in VMEM (about 10 MB at g4) and walks Cin as a
// sequential grid axis, carrying its sum in VMEM scratch; a CUDA block
// has at most 227 KB of shared memory and nothing carries over between
// blocks, so the block stages only a BK x BM slice of gathered input
// rows and a BK x BN slice of weights per step, and runs the tap loop
// and the Cin loop inside, into register accumulators.  The row base
// address is (((b*Dp + qz*sz)*Hp + qy*sy)*Wp + qx*sx)*Cin and each tap
// adds ((dz*Hp + dy)*Wp + dx)*Cin, read from small int32 tables on the
// device, so strided windows are addressed directly (the TPU loads a
// window and subsamples it).  The flush adds the bias and applies the
// activation on the f32 accumulator and stores once.  Ragged rows,
// channels and Cout are masked; a phase with no taps still writes
// act(bias).  The FFMA tile keeps the arithmetic-bound layers on the
// FP32 pipe; g4's Cout = 1 takes the narrow 128 x 8 tile, which issues
// 8 FFMAs for each useful one: a Cout = 1 tile, TF32 wgmma and TMA are
// for a later change.

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
ganax_conv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ n_taps,
                    const int* __restrict__ tap_dz,
                    const int* __restrict__ tap_dy,
                    const int* __restrict__ tap_dx,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int B, int Dp, int Hp, int Wp, int Cin, int T, int Cout,
                    int Qz, int Qy, int Qx, int sz, int sy, int sx, int act,
                    float slope) {
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
  const int vol = Qz * plane;
  const int M = B * vol;

  // The input rows this thread stages are fixed for the whole block:
  // row (b, qz, qy, qx) of the phase volume starts at voxel
  // (qz*sz, qy*sy, qx*sx) of image b, before the tap's (dz, dy, dx) shift.
  const int a_k = tid % kBK;
  const int a_row0 = tid / kBK;
  int a_base[kALoads];
#pragma unroll
  for (int i = 0; i < kALoads; ++i) {
    const int m = m0 + a_row0 + i * kRowsPerPass;
    if (m < M) {
      const int b = m / vol;
      const int r = m - b * vol;
      const int qz = r / plane;
      const int r2 = r - qz * plane;
      const int qy = r2 / Qx;
      const int qx = r2 - qy * Qx;
      a_base[i] = (((b * Dp + qz * sz) * Hp + qy * sy) * Wp + qx * sx) * Cin;
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
    const int pt = p * T + t;
    const int tap_off =
        ((tap_dz[pt] * Hp + tap_dy[pt]) * Wp + tap_dx[pt]) * Cin;
    const float* wt = w + pt * Cin * Cout;
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
    const int b = m / vol;
    const int r = m - b * vol;
    float* orow = out + ((b * P + p) * vol + r) * Cout;
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
            const int* tap_dz, const int* tap_dy, const int* tap_dx,
            const float* bias, float* out, int B, int Dp, int Hp, int Wp,
            int Cin, int P, int T, int Cout, int Qz, int Qy, int Qx, int sz,
            int sy, int sx, int act, float slope, cudaStream_t stream) {
  const int M = B * Qz * Qy * Qx;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, P);
  const dim3 block((BM / TM) * (BN / TN));
  ganax_conv3d_kernel<BM, BN, TM, TN><<<grid, block, 0, stream>>>(
      x, w, n_taps, tap_dz, tap_dy, tap_dx, bias, out, B, Dp, Hp, Wp, Cin, T,
      Cout, Qz, Qy, Qx, sz, sy, sx, act, slope);
}

}  // namespace

// Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted).  `bias` may be
// null.
extern "C" int ganax_conv3d_f32(const float* x, const float* w,
                                const int* n_taps, const int* tap_dz,
                                const int* tap_dy, const int* tap_dx,
                                const float* bias, float* out, int B, int Dp,
                                int Hp, int Wp, int Cin, int P, int T,
                                int Cout, int Qz, int Qy, int Qx, int sz,
                                int sy, int sx, int act, float slope,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 8) {
    // narrow tile for volume-producing layers (Cout = 1 at 3D-GAN g4)
    launch<128, 8, 4, 2>(x, w, n_taps, tap_dz, tap_dy, tap_dx, bias, out, B,
                         Dp, Hp, Wp, Cin, P, T, Cout, Qz, Qy, Qx, sz, sy, sx,
                         act, slope, s);
  } else {
    launch<64, 64, 4, 4>(x, w, n_taps, tap_dz, tap_dy, tap_dx, bias, out, B,
                         Dp, Hp, Wp, Cin, P, T, Cout, Qz, Qy, Qx, sz, sy, sx,
                         act, slope, s);
  }
  return static_cast<int>(cudaGetLastError());
}
