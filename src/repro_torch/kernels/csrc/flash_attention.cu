// Forward flash attention for Hopper (sm_90a): f32 storage at every head
// dim, bf16 at hd <= 80 (bf16 at hd 128 and 256 runs on the wgmma kernel,
// flash_attention_sm90.cu, and is not built here), and both at the split
// head dims of MLA, a q.k dim DK apart from the value dim DV: (96, 64)
// (MiniCPM3-4B: 64 + 32 rope dims against 64) and (48, 32) (its tiny
// preset); f32 compute.
//
// Replaces: _fa_kernel / flash_attention_pallas in
// src/repro/kernels/flash_attention.py, the Pallas TPU kernel.  It
// computes the same function:
//
//   out[b, i, h, :] = sum_j p[i, j] v[b, j, h, :] / max(sum_j p[i, j], 1e-30)
//   s[i, j] = (q[b, i, h, :] * DK^-0.5) . k[b, j, h, :], soft-capped to
//             c tanh(s / c) when the cap c is > 0, then -1e30 where the
//             causal mask (i >= j, indices aligned top-left) hides j
//   p[i, j] = exp(s[i, j] - max_j s[i, j]), kept by an online softmax
//
// q is scaled in f32 before the product; the scores, the running max and
// denominator, p and the accumulator are all f32 (p is not rounded to the
// storage type before p.v); the output is cast to the storage type once.
// Heads are MHA: the caller expands GQA first.  The soft-cap (Gemma's
// logit soft-capping, the reference's `softcap`) is a template flag: the
// instances without it are the same code as before it existed.  q, k and
// the score loop run over DK, v, the accumulator and the output over DV
// (the Pallas kernel reads dv from v the same way); the instances with
// DK == DV are the code of one head dim D.
//
// What bounds it on the card: a causal prefill of S tokens does about
// 2 S^2 hd FLOPs per head against 4 S hd elements of q, k, v and out,
// so at the LLM widths (hd 128-256, S in the thousands) it is bound by
// arithmetic: FP32 FFMA, 67 TFLOP/s on an H100 SXM.
//
// Design: one block computes BQ = 64 query rows of one (batch, head); the
// grid is (B*H, ceil(S/BQ)), all independent.  The TPU kernel's kv loop
// runs inside the block too, up to the same causal live-block bound
// n_live = min(ceil((qi+1) BQ / BK), ceil(T / BK)), so a causal prefill
// does about half the work of a full one.  The block reads q, k, v and
// writes out in their (B, S, H, hd) layout by strides (the Pallas wrapper
// transposes to (B*H, S, hd) first).  Per kv block it stages BK rows of k
// and v in shared memory as f32 (the q tile stays there, pre-scaled, for
// the whole loop), computes the BQ x BK scores with each thread owning a
// 4 x BK/16 micro-tile, runs the online softmax with four threads per
// row (shuffles for the row max and sum), and adds p.v into register
// accumulators, each thread owning a micro-tile of the BQ x hd output.
// Ragged S and T are masked (Pallas asserts divisibility instead): keys
// past T are never read and score -1e30, query rows past S are computed
// on zeros and never written.  BK is 64 for DK, DV <= 64 and 32 above, to
// keep the staged tiles of hd = 256 within 140 KB of shared memory.  The
// output micro-tile splits DV over the threads: at (96, 64) it is DV's 64
// columns (256 threads do not split over 96 / 8 = 12 columns); at hd 80
// a thread holds 5 columns of 16 thread columns (80 / 8 = 10 thread
// columns do not divide 256 threads either).  No
// wgmma, no TMA, no double buffering: those are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The tile shapes of a q.k head dim DK and a value head dim DV.
template <int DK, int DV>
struct Tiles {
  static constexpr int BK = DK <= 64 && DV <= 64 ? 64 : 32;
  // scores: a 4 x TN_S micro-tile per thread over BQ x BK
  static constexpr int TN_S = BK / 16;
  // output: TM_O x TN_O per thread over BQ x DV; columns are interleaved
  // over RD thread columns, rows over RQ thread rows
  static constexpr int TN_O =
      DV == 80 ? 5 : (DV >= 64 ? 8 : (DV >= 16 ? 4 : 2));
  static constexpr int RD = DV / TN_O;
  static constexpr int RQ = kThreads / RD;
  static constexpr int TM_O = kBQ / RQ;
  static_assert(RD * TN_O == DV && RQ * RD == kThreads && TM_O * RQ == kBQ,
                "the output tile must split evenly over the threads");
  // shared memory, in floats: q, k (rows padded to an odd stride), v,
  // p, and the per-row rescale factor and denominator
  static constexpr int QS = kBQ * (DK + 1);
  static constexpr int KS = BK * (DK + 1);
  static constexpr int VS = BK * DV;
  static constexpr int PS = kBQ * (BK + 1);
  static constexpr int kSmemBytes =
      (QS + KS + VS + PS + 2 * kBQ) * static_cast<int>(sizeof(float));
};

// All offsets are 32-bit: the wrapper refuses operands whose largest
// element offset reaches 2^31.
template <typename T, int DK, int DV, bool kSoftcap>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int H, int S,
          int Tk, int qsb, int qss, int qsh, int ksb, int kss, int ksh,
          int vsb, int vss, int vsh, int osb, int oss, int osh, int causal,
          float sm_scale, float softcap) {
  using Tl = Tiles<DK, DV>;
  constexpr int BK = Tl::BK;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [kBQ][DK + 1], pre-scaled
  float* Ks = Qs + Tl::QS;          // [BK][DK + 1]
  float* Vs = Ks + Tl::KS;          // [BK][DV]
  float* Ps = Vs + Tl::VS;          // [kBQ][BK + 1], scores then p
  float* row_alpha = Ps + Tl::PS;   // [kBQ]
  float* row_l = row_alpha + kBQ;   // [kBQ]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int idx = tid; idx < kBQ * DK; idx += kThreads) {
    const int r = idx / DK;
    const int d = idx - r * DK;
    const int i = q0 + r;
    Qs[r * (DK + 1) + d] = i < S ? to_f32(qb[i * qss + d]) * sm_scale : 0.f;
  }

  const int n_kv = (Tk + BK - 1) / BK;
  const int n_live = causal ? min((q0 + kBQ + BK - 1) / BK, n_kv) : n_kv;

  // softmax phase: four threads per row
  const int sm_row = tid >> 2;
  const int sm_part = tid & 3;
  float m = kNegInf;
  float l = 0.f;

  // score phase: rows sy + 16 i, columns sx + 16 j
  const int sy = tid / 16;
  const int sx = tid % 16;

  // p.v phase: rows oy + RQ i, columns ox + RD j
  const int oy = tid / Tl::RD;
  const int ox = tid % Tl::RD;
  float acc[Tl::TM_O][Tl::TN_O];
#pragma unroll
  for (int i = 0; i < Tl::TM_O; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TN_O; ++j) acc[i][j] = 0.f;

  for (int blk = 0; blk < n_live; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();  // the previous block's tiles are consumed
    for (int idx = tid; idx < BK * DK; idx += kThreads) {
      const int r = idx / DK;
      const int d = idx - r * DK;
      const int j = k0 + r;
      const bool live = j < Tk;
      Ks[r * (DK + 1) + d] = live ? to_f32(kb[j * kss + d]) : 0.f;
      if constexpr (DK == DV)
        Vs[r * DV + d] = live ? to_f32(vb[j * vss + d]) : 0.f;
    }
    if constexpr (DK != DV) {
      for (int idx = tid; idx < BK * DV; idx += kThreads) {
        const int r = idx / DV;
        const int d = idx - r * DV;
        const int j = k0 + r;
        Vs[r * DV + d] = j < Tk ? to_f32(vb[j * vss + d]) : 0.f;
      }
    }
    __syncthreads();

    // s = (q * scale) . k, soft-capped, masked
    {
      float s[4][Tl::TN_S];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < Tl::TN_S; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DK; ++d) {
        float a[4];
        float c[Tl::TN_S];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(sy + 16 * i) * (DK + 1) + d];
#pragma unroll
        for (int j = 0; j < Tl::TN_S; ++j)
          c[j] = Ks[(sx + 16 * j) * (DK + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < Tl::TN_S; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sy + 16 * i;
#pragma unroll
        for (int j = 0; j < Tl::TN_S; ++j) {
          const int c = sx + 16 * j;
          const int kpos = k0 + c;
          const bool ok = kpos < Tk && (!causal || q0 + r >= kpos);
          float sc = s[i][j];
          if constexpr (kSoftcap) sc = softcap * tanhf(sc / softcap);
          Ps[r * (BK + 1) + c] = ok ? sc : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax of one row, four threads each
    {
      float* prow = Ps + sm_row * (BK + 1);
      float mx = kNegInf;
      for (int c = sm_part; c < BK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float sum = 0.f;
      for (int c = sm_part; c < BK; c += 4) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l = l * alpha + sum;
      m = m_new;
      if (sm_part == 0) row_alpha[sm_row] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p.v
#pragma unroll
    for (int i = 0; i < Tl::TM_O; ++i) {
      const float alpha = row_alpha[oy + Tl::RQ * i];
#pragma unroll
      for (int j = 0; j < Tl::TN_O; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[Tl::TM_O];
      float w[Tl::TN_O];
#pragma unroll
      for (int i = 0; i < Tl::TM_O; ++i)
        p[i] = Ps[(oy + Tl::RQ * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < Tl::TN_O; ++j) w[j] = Vs[c * DV + ox + Tl::RD * j];
#pragma unroll
      for (int i = 0; i < Tl::TM_O; ++i)
#pragma unroll
        for (int j = 0; j < Tl::TN_O; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

  if (sm_part == 0) row_l[sm_row] = fmaxf(l, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < Tl::TM_O; ++i) {
    const int r = oy + Tl::RQ * i;
    const int row = q0 + r;
    if (row >= S) continue;
    const float den = row_l[r];
    T* orow = out + b * osb + row * oss + h * osh;
#pragma unroll
    for (int j = 0; j < Tl::TN_O; ++j)
      store(orow + ox + Tl::RD * j, acc[i][j] / den);
  }
}

template <typename T, int DK, int DV, bool SC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int S, int Tk, const int* st, int causal, float sm_scale,
           float softcap, cudaStream_t stream) {
  constexpr int smem = Tiles<DK, DV>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DK, DV, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  fa_kernel<T, DK, DV, SC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, S, Tk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, sm_scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SC>
int dispatch(int D, int DVal, const void* q, const void* k, const void* v,
             void* out, int B, int H, int S, int Tk, const int* st,
             int causal, float sm_scale, float cap, cudaStream_t s) {
  // the split head dims of MLA (q.k over D, v over DVal)
  if (D == 96 && DVal == 64) return launch<T, 96, 64, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
  if (D == 48 && DVal == 32) return launch<T, 48, 32, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
  if (DVal != D) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 8: return launch<T, 8, 8, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
    case 16: return launch<T, 16, 16, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
    case 32: return launch<T, 32, 32, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
    case 64: return launch<T, 64, 64, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
    case 80: return launch<T, 80, 80, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
    default: break;
  }
  if constexpr (std::is_same_v<T, float>) {
    if (D == 128) return launch<T, 128, 128, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
    if (D == 256) return launch<T, 256, 256, SC>(q, k, v, out, B, H, S, Tk, st, causal, sm_scale, cap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_cap(int D, int DVal, const void* q, const void* k,
                 const void* v, void* out, int B, int H, int S, int Tk,
                 const int* st, int causal, float sm_scale, float softcap,
                 cudaStream_t s) {
  if (softcap > 0.f)
    return dispatch<T, true>(D, DVal, q, k, v, out, B, H, S, Tk, st, causal,
                             sm_scale, softcap, s);
  return dispatch<T, false>(D, DVal, q, k, v, out, B, H, S, Tk, st, causal,
                            sm_scale, 0.f, s);
}

}  // namespace

// Launches on `stream` without synchronising and returns the CUDA error
// (0 when the launch was accepted).  dtype: 0 float32, 1 bfloat16.
// D: the head dim of q and k; DVal: that of v and out.  strides: 12
// element strides, (batch, position, head) of q, k, v and out in that
// order; the head dim is contiguous.  sm_scale: D^-0.5.  softcap: 0 for
// none, else the cap c of s -> c tanh(s / c).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int B, int H, int S, int Tk, int D,
                                   int DVal, const int* strides, int causal,
                                   float sm_scale, float softcap,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_cap<float>(D, DVal, q, k, v, out, B, H, S, Tk, strides,
                               causal, sm_scale, softcap, s);
  if (dtype == 1)
    return dispatch_cap<__nv_bfloat16>(D, DVal, q, k, v, out, B, H, S, Tk,
                                       strides, causal, sm_scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
