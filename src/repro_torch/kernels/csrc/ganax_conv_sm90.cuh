// The GANAX conv/tconv kernels for Hopper (sm_90a), of either spatial
// rank and each storage dtype (f32, bf16, f16): the shared body of
// ganax_conv.cu (rank 2) and ganax_conv3d.cu (rank 3).
//
// Replaces: ganax_conv_kernel / ganax_conv_pallas and
// ganax_conv3d_kernel / ganax_conv3d_pallas (with apply_epilogue_to_acc)
// in src/repro/kernels/ganax_conv.py.  The function, per output phase p
// of ND spatial dims:
//
//   out[b, p, q, n] = act(bias[n] + sum_{t < n_taps[p]} sum_c
//       x_pad[b, tap[p,t] + q*s, c] * w_taps[p, t, c, n])
//
// written phase-major, (B, P, *Q, Cout).  Transposed convs arrive as P
// phases at unit stride (MIMD), strided convs as one phase (SIMD).
//
// Every kernel is templated on the storage type T of x, w and out
// (float, __nv_bfloat16 or __half), as the Pallas kernels take blocks in
// whatever dtype they come in: the products are summed in f32 (the
// Pallas kernels' f32 VMEM scratch), bias and activation run on the f32
// sum, and the result is cast to T once, at the store (round to nearest
// even).  The notes below describe the f32 instances; where the 2-byte
// instances differ, they say so.
//
// It is an implicit GEMM per phase: the rows are the B*prod(Q) output
// pixels, the columns Cout, and K is (tap, Cin).  Every call takes one
// of three routes, picked in Python from the geometry alone
// (kernel_route in ganax_conv.py) and passed in; none falls back to
// another.
//
// 1. tc, Cout > 8: f32-exact products on the tensor cores, as 3xTF32.
//    What bounds the wide layers is arithmetic (DCGAN g1 and d4 do
//    ~17 GFLOP against ~20 MB); FFMA tops out at 67 TFLOP/s, and TF32
//    wgmma at 495, or 165 for the three products an f32-exact result
//    needs.  Each operand is split as x = hi + lo, hi = tf32_rna(x), lo =
//    tf32_rna(x - hi); |x - hi - lo| <= 2^-22 |x|, and the tensor cores
//    multiply tf32 pairs exactly.  a.b is taken as a_lo.b_hi + a_hi.b_lo
//    (summed first, while the sum is small) + a_hi.b_hi; a_lo.b_lo
//    (<= 2^-22 |a.b|) is dropped.
//    * A work item is 128 rows x BN (64 or 128) columns of one phase and
//      one K range.  The blocks are persistent, one an SM, each taking
//      every gridDim-th item, so that the producer runs on into the next
//      item's loads while the consumers store the last one's outputs (and
//      a layer of short K, such as 3D-GAN d1's 64, pays no launch and set
//      up per tile).  Three warpgroups: warpgroup 0 produces (setmaxnreg
//      56), warpgroups 1 and 2 consume 64 rows each (the wgmma M;
//      setmaxnreg 224).
//    * The K loop runs over stages of BK = 32 floats: one tap and 32
//      channels (Cin padded to 32 in B, zero-filled in A), or, where
//      Cin % 4 != 0 (Cin = 1 or 3: no 16-byte rows), 32 entries of the
//      flattened (tap, c) index of the phase, zero-padded at its end.
//      A Cin = 3 layer of 16 taps then stages 48 useful K in two
//      stages, not 16 stages of which 13/16 is zeros.
//    * B: the wrapper stores the weights as (P, Cout, K) split into
//      b_hi and b_lo (tf32_split in ganax_conv.py), K-major as the tf32
//      wgmma wants them; one thread loads each stage's two BN x 32 tiles
//      by TMA with the 128-byte swizzle (a row of 32 floats is one
//      swizzle atom).
//    * A: the producer warpgroup gathers each stage's 128 rows x 32
//      floats with cp.async: 16-byte copies (eight threads a row, one
//      128-byte row a pass) or, for the flattened K, 4-byte copies (one
//      thread a row, each entry's input offset read from a table of the
//      phase in shared memory); rows past the phase and channels past Cin
//      are zero-filled.  They land in rows of 128 bytes with the 16-byte
//      chunks XOR-swizzled by the row (the 128-byte swizzle's pattern),
//      so the consumers' fragment loads hit 32 distinct banks.  Each
//      producer thread's copies arrive on the stage's full barrier
//      (cp.async.mbarrier.arrive.noinc: 128 arrivals, plus the TMA
//      thread's expect_tx).  The ring has three stages at BN 128 (64 KB
//      each) and four at 64; the consumers free a stage on its empty
//      barrier.
//    * A is split in shared memory, not in registers: each consumer
//      warpgroup rewrites its 64 rows of the stage as tf32 hi (in place)
//      and lo (a second tile), 16 floats a thread (cvt.rna.tf32.f32),
//      and all three products read A by descriptor.  The split of stage
//      s + 1 then runs while stage s's wgmmas do.  Split in registers (A
//      fragments fed to wgmma), the next stage's fragments could be
//      loaded only into a second set of registers, and at BN 128 two
//      fragment sets (64 registers) do not fit beside the 64 x 128 sum
//      and the fresh accumulator (128) in the consumers' 224: a build
//      that split in registers waited out every stage's wgmmas before
//      touching the next stage.
//    * Short accumulator chains: a wgmma adds into a larger sum without
//      IEEE rounding and drops low bits (flash_attention_sm90.cu says
//      more), and K reaches 4,096 (DCGAN g1) and 32,768 (3D-GAN d5).
//      So each slab of one stage (32 K, 12 wgmma m64n128k8) at BN 128,
//      or of two stages (64 K, 24 wgmma m64n64k8, the small terms of
//      both first) at BN 64, goes into a fresh accumulator, which is then
//      added to the f32 sum by FADD.  The two consumer warpgroups overlap
//      each other's adds with their wgmmas.
//    * Epilogue: bias and activation on the f32 sum, stored from the
//      accumulator layout.
//    * At bf16 and f16 a product of two storage values is exact in f32,
//      so one wgmma (m64n{64,128}k16, .f32.bf16.bf16 or .f32.f16.f16)
//      a useful product replaces the three TF32 ones, and nothing is
//      split: a stage holds A and B once.  A 128-byte row is 64 values,
//      so a stage's K is 64 (kBK of the type) and its four k16 slices
//      are each 32 bytes apart, as the four k8 slices of f32; the stage
//      is 32 KB at BN 128 (six stages) and 24 KB at BN 64 (eight).  Each
//      stage's products go into a fresh accumulator (64 K), added to
//      the f32 sum by FADD.  A 16-byte copy is eight channels, so the
//      flattened K serves Cin % 8 != 0 (DCGAN d1's 3, 3D-GAN d1's 1);
//      cp.async has no 2-byte copy, so there the producer loads each
//      value with ld.global, stores the stage's row in 16-byte chunks,
//      and arrives on the full barrier after a proxy fence.  The
//      consumers fence the generic proxy's writes (the producer's
//      cp.async or stores) before their wgmmas read the stage.  The
//      weights come by TMA as one bf16 (f16) map, K padded to the
//      stage.
// 2. narrow, Cout <= 8 (g4, d1's dx, d5): a row-dot FFMA kernel.  On the
//    tensor cores these would do >= 8/Cout times the work; they are
//    bound by bytes or latency.  A warp computes 4 output rows at a
//    time; its lanes stride the row's (tap, c) index, 16 bytes a load
//    where Cin % 4 = 0; the phases' weights for the block's K range and
//    a table of each K chunk's input offset sit in shared memory; a
//    warp-shuffle tree sums each output.  Only useful products are
//    computed.  Each input element feeds up to 64 outputs of a k4 s2
//    tconv (4^3 taps over the 8 phases of 3D-GAN g4): a block takes all
//    phases of its rows, a warp runs them in turn, and the re-reads hit
//    L1 rather than L2.  At bf16 and f16 it reads x and w in the storage
//    type (four values, 8 bytes, a load where Cin % 4 = 0) and widens
//    them to f32: the weights once, as the block copies them into its
//    shared-memory table, which holds f32 (kNarrowSmemFloats counts f32
//    values at every type), and x as it loads it.
// 3. split-K, for either route when its output tiles cannot fill the
//    132 SMs (DCGAN d5: 64 x 1 outputs over K = 16,384; 3D-GAN d5: K =
//    32,768): block split s sums its K range into an f32 scratch
//    (splits, rows, Cout) without bias or activation, and splitk_reduce
//    sums the splits in a fixed order, then applies the epilogue and
//    casts to T.  The scratch is f32 at every type.  No atomics; no
//    epilogue ever runs on a partial sum.
//
// All offsets are 32-bit: the wrapper refuses operands of 2^31 elements
// or more.  The mbarrier and TMA helpers repeat those of
// flash_attention_sm90.cu.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ganax {

// Activation codes (ACTIVATION_CODES in ganax_conv.py).
constexpr int kRelu = 1;
constexpr int kLeakyRelu = 2;
constexpr int kTanh = 3;

// Route codes (ROUTE_CODES in ganax_conv.py).
constexpr int kRouteTc = 0;
constexpr int kRouteTcFlat = 1;
constexpr int kRouteNarrow = 2;

constexpr int kBM = 128;        // tc: rows a block
constexpr int kTcThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr int kFlatMax = 2048;  // tc: the longest flattened (tap, c) index
constexpr int kNarrowThreads = 256;
constexpr int kNarrowRows = 4;  // narrow: rows a warp computes together
constexpr int kNarrowSmemFloats = 12288;  // narrow: 48 KB of tables

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == kRelu) return v > 0.f ? v : 0.f;
  if (act == kLeakyRelu) return v > 0.f ? v : slope * v;
  if (act == kTanh) return tanhf(v);
  return v;
}

// -- the storage types -------------------------------------------------------
// The TMA element type of each, and whether the tc route splits it into
// tf32 hi and lo (f32 only: a 2-byte product is exact in f32).
template <typename T>
struct Storage;
template <>
struct Storage<float> {
  static constexpr bool kSplit = true;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Storage<__nv_bfloat16> {
  static constexpr bool kSplit = false;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Storage<__half> {
  static constexpr bool kSplit = false;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// f32 -> T, rounded to nearest even
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Four consecutive values at p (16-byte aligned at f32, 8 at 2 bytes),
// widened to f32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// One launch's geometry: the padded input's spatial dims S, the phase
// grid Q and the output strides st, slowest dim first; the tap tables.
template <int ND>
struct Geom {
  int B, Cin, P, T, Cout;
  int S[ND], Q[ND], st[ND];
  const int* n_taps;
  const int* tap[ND];   // (P, T) offsets per dim, into x_pad

  __host__ __device__ int plane() const {
    int n = 1;
#pragma unroll
    for (int d = 0; d < ND; ++d) n *= Q[d];
    return n;
  }
  // Offset of row m (b, q) of a phase in x_pad, before its tap's shift.
  __device__ int row_base(int m) const {
    int q[ND];
    int r = m;
#pragma unroll
    for (int d = ND - 1; d >= 0; --d) {
      q[d] = r % Q[d];
      r /= Q[d];
    }
    int off = r;  // b
#pragma unroll
    for (int d = 0; d < ND; ++d) off = off * S[d] + q[d] * st[d];
    return off * Cin;
  }
  __device__ int tap_off(int p, int t) const {
    int off = 0;
#pragma unroll
    for (int d = 0; d < ND; ++d) off = off * S[d] + tap[d][p * T + t];
    return off * Cin;
  }
  // Row of the (B, P, *Q) output of row m of phase p.
  __device__ int out_row(int m, int p) const {
    const int pl = plane();
    const int b = m / pl;
    return (b * P + p) * pl + (m - b * pl);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// -- cp.async ---------------------------------------------------------------
// 16 or 4 bytes global -> shared; `bytes` = 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
// One arrival on `bar` once every cp.async this thread issued before it
// has landed; counted in the barrier's expected arrivals (noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// -- TMA ----------------------------------------------------------------------
// One box of the 3-d map (K, Cout, P) at (c0, c1, c2), completing on bar.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma ---------------------------------------------------------------------
// Descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle, 8-row groups 1024 bytes apart; a k8 slice further along the
// row is this plus its byte offset / 16.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(16 >> 4) << 16)      // leading, unused
         | (static_cast<uint64_t>(1024 >> 4) << 32)    // stride
         | (1ull << 62);                               // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define GX_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GX_D16(i) GX_D4(i), GX_D4(i + 4), GX_D4(i + 8), GX_D4(i + 12)

// d (64 x N, f32) = a (64 x 8, tf32) . b (N x 8, tf32) + (scale_d ? d :
// 0), both K-major in shared memory, from their descriptors.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31},"
      " %32, %33, p, 1, 1;\n}\n"
      : GX_D16(0), GX_D16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
      " %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
      : GX_D16(0), GX_D16(16), GX_D16(32), GX_D16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same for 2-byte operands: d (64 x N, f32) = a (64 x 16) . b (N x
// 16) + (scale_d ? d : 0), T bf16 or f16, both K-major (no transpose).
#define GX_R32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
  " %30, %31"
#define GX_R64                                                              \
  GX_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"   \
  " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
  " %58, %59, %60, %61, %62, %63"
template <int N, typename T>
__device__ __forceinline__ void wgmma_16(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_16<64, __nv_bfloat16>(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" GX_R32 "},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GX_D16(0), GX_D16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_16<128, __nv_bfloat16>(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" GX_R64 "},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GX_D16(0), GX_D16(16), GX_D16(32), GX_D16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_16<64, __half>(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" GX_R32 "},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GX_D16(0), GX_D16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_16<128, __half>(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" GX_R64 "},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GX_D16(0), GX_D16(16), GX_D16(32), GX_D16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef GX_R64
#undef GX_R32
#undef GX_D16
#undef GX_D4

// x = hi + lo as two tf32 values (13 zero low bits), each rounded to
// nearest, ties away (tf32_split in ganax_conv.py).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// A stage: A (hi after the split, in place), A's lo, then B's hi and lo;
// every tile rows of 128 bytes with the 128-byte swizzle.  Three stages
// at BN 128 (192 KB), four at 64.  A slab, the stages whose products go
// into one fresh accumulator: two at BN 64; one at 128, where holding
// two of the three stages starved the producer (3D-GAN's step 10%
// slower on the card; at BN 64, 5% faster).  At 2 bytes (no split) a
// stage is A then B, six stages at BN 128 (192 KB) and eight at 64, and
// a slab is one stage.
template <int BN, typename T>
struct TcTiles {
  static_assert(BN == 64 || BN == 128, "tc tiles are 64 or 128 wide");
  static constexpr bool kSplit = Storage<T>::kSplit;
  static constexpr int kBK = 128 / static_cast<int>(sizeof(T));  // K a stage
  static constexpr int kStages = kSplit ? (BN == 128 ? 3 : 4)
                                        : (BN == 128 ? 6 : 8);
  static constexpr int kSlab = kSplit && BN == 64 ? 2 : 1;
  static constexpr int kParts = kSplit ? 2 : 1;         // hi and lo, or one
  static constexpr int kABytes = kBM * 128;             // 16 KB
  static constexpr int kBBytes = BN * 128;              // one of hi, lo
  static constexpr int kBOffset = kParts * kABytes;     // B in a stage
  static constexpr int kStageBytes = kParts * (kABytes + kBBytes);
  // 1024 bytes of slack to align the tiles to the swizzle atom, then
  // the barriers: full[kStages], empty[kStages], then the flattened
  // K's offset table
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes
                                    + 8 * 2 * kStages + 4 * kFlatMax;
};

// Work item `item` of a tc launch: row tile, Cout tile (the fastest, so
// that neighbouring items share their rows of A), phase and split.
struct TcItem {
  int mt, nt, p, s;
  __device__ TcItem(int item, int n_mt, int n_nt, int splits) {
    nt = item % n_nt;
    item /= n_nt;
    mt = item % n_mt;
    const int z = item / n_mt;
    p = z / splits;
    s = z - p * splits;
  }
};

// The tc route (see the note at the top).  K is staged in stages of kBK
// (TcTiles' K a stage, 32 at f32 and 64 at 2 bytes):
// stage k of phase p is tap k / cin_stages, channels from
// (k % cin_stages) * kBK, or (flat) entries k*kBK.. of the flattened
// (tap, c) index.  Split s of `splits` takes stages [s*per, (s+1)*per).
// The blocks are persistent: block b takes work items b, b + gridDim.x,
// ..., and the producer runs on into the next item's stages while the
// consumers store the last one's outputs.  The ring's stage counter runs
// on across items.
template <int ND, int kBK>
struct TcSpan {
  int st0, cnt;
  __device__ TcSpan(const Geom<ND>& g, int p, int s, int flat, int k_stages,
                    int splits) {
    const int nt = g.n_taps[p];
    const int cin_stages = (g.Cin + kBK - 1) / kBK;
    const int n_st = flat ? (nt * g.Cin + kBK - 1) / kBK : nt * cin_stages;
    const int per = (k_stages + splits - 1) / splits;
    st0 = s * per;
    cnt = max(min(st0 + per, n_st) - st0, 0);
  }
};

template <int ND, int BN, typename T>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap tb_hi,
          const __grid_constant__ CUtensorMap tb_lo,
          const T* __restrict__ x, const Geom<ND> g, int flat,
          int k_stages, int splits, int n_mt, int n_nt,
          const float* __restrict__ bias, T* __restrict__ out,
          float* __restrict__ scratch, int act, float slope) {
  using Tl = TcTiles<BN, T>;
  constexpr int kBK = Tl::kBK;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // a 16-byte copy
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(tiles + Tl::kStages * Tl::kStageBytes);
  uint64_t* empty = full + Tl::kStages;
  int* flat_off = reinterpret_cast<int*>(empty + Tl::kStages);

  const int M = g.B * g.plane();
  const int n_items = n_mt * n_nt * g.P * splits;
  const int cin_stages = (g.Cin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < Tl::kStages; ++i) {
      mbar_init(&full[i], 128 + 1);  // the producers' copies, the TMA
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer warpgroup: B by TMA, A by cp.async ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int i = threadIdx.x;
    // 16-byte copies: thread i copies chunk i % 8 of rows 16 j + i / 8;
    // flat: all of row i, from the phase's offset table
    const int chunk = i & 7;
    int it = 0, table_p = -1;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const TcItem w(item, n_mt, n_nt, splits);
      const TcSpan<ND, kBK> span(g, w.p, w.s, flat, k_stages, splits);
      if (span.cnt == 0) continue;
      const int m0 = w.mt * kBM;
      const int kmax = g.n_taps[w.p] * g.Cin;
      if (flat && w.p != table_p) {
        // the producers' own barrier: no copy is still being addressed
        // from the old table, then none reads the new one half-written
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        for (int e = i; e < kmax; e += 128) {
          const int t = e / g.Cin;
          flat_off[e] = g.tap_off(w.p, t) + (e - t * g.Cin);
        }
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        table_p = w.p;
      }
      int base[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = flat ? i : 16 * j + (i >> 3);
        base[j] = (m0 + r < M && (!flat || j == 0)) ? g.row_base(m0 + r) : -1;
      }
      for (int k = span.st0; k < span.st0 + span.cnt; ++k, ++it) {
        const int stg = it % Tl::kStages;
        mbar_wait(&empty[stg], ((it / Tl::kStages) & 1) ^ 1);
        uint8_t* a = tiles + stg * Tl::kStageBytes;
        if (i == 0) {
          uint8_t* b = a + Tl::kBOffset;
          mbar_expect_tx(&full[stg], Tl::kParts * Tl::kBBytes);
          tma_load3(b, &tb_hi, &full[stg], k * kBK, w.nt * BN, w.p);
          if constexpr (Tl::kSplit)
            tma_load3(b + Tl::kBBytes, &tb_lo, &full[stg], k * kBK,
                      w.nt * BN, w.p);
        }
        if (!flat) {
          const int t = k / cin_stages;
          const int c = (k - t * cin_stages) * kBK + kVec * chunk;
          const int off = g.tap_off(w.p, t) + c;
          const bool c_ok = c < g.Cin;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = 16 * j + (i >> 3);
            const bool ok = c_ok && base[j] >= 0;
            cp_async16(a + r * 128 + ((chunk ^ (r & 7)) << 4),
                       ok ? x + base[j] + off : x, ok ? 16 : 0);
          }
        } else if constexpr (sizeof(T) == 4) {
#pragma unroll 8
          for (int e = 0; e < kBK; ++e) {
            const int kk = k * kBK + e;
            const bool ok = base[0] >= 0 && kk < kmax;
            cp_async4(a + i * 128 + (((e >> 2) ^ (i & 7)) << 4) + 4 * (e & 3),
                      ok ? x + base[0] + flat_off[kk] : x, ok ? 4 : 0);
          }
        } else {
          // no 2-byte cp.async: load each value, store 16-byte chunks
          const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
#pragma unroll 1
          for (int q = 0; q < 8; ++q) {
            uint32_t v[4];
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              uint32_t pair = 0;
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int kk = k * kBK + 8 * q + 2 * h + u;
                const uint32_t bits =
                    base[0] >= 0 && kk < kmax
                        ? __ldg(xs + base[0] + flat_off[kk]) : 0u;
                pair |= bits << (16 * u);
              }
              v[h] = pair;
            }
            *reinterpret_cast<uint4*>(a + i * 128 + ((q ^ (i & 7)) << 4)) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
        if (flat && sizeof(T) == 2) {
          // the stores reach the wgmmas' (async) proxy, then the release
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(&full[stg]);
        } else {
          cp_async_arrive(&full[stg]);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // -- consumers: 64 rows each ---------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int cw = wg - 1;
    const int lt = threadIdx.x - 128 * wg;
    const int warp = lt >> 5;
    const int lane = lt & 31;
    const int t4 = lane & 3;
    const int r0 = 64 * cw + 16 * warp + (lane >> 2);  // rows of the tile
    const int r1 = r0 + 8;                              // this thread holds
    const int bar_id = 2 + cw;  // this warpgroup's named barrier
    float sum[BN / 2], acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    const int Mtot = g.B * g.P * g.plane();
    // At f32, splits this warpgroup's 64 rows of the stage's A into tf32
    // hi (in place) and lo (A's lo tile): four 16-byte chunks a thread,
    // the layout kept.  Then, at every type, makes the stage's generic
    // writes (the split's, the producer's) visible to the wgmmas.
    auto split_stage = [&](int stg) {
      if constexpr (Tl::kSplit) {
        uint8_t* a = tiles + stg * Tl::kStageBytes + cw * 64 * 128;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4* hi = reinterpret_cast<float4*>(a + 16 * (lt + 128 * q));
          float4* lo = reinterpret_cast<float4*>(
              a + Tl::kABytes + 16 * (lt + 128 * q));
          float4 v = *hi, l;
          split_tf32(v.x, v.x, l.x);
          split_tf32(v.y, v.y, l.y);
          split_tf32(v.z, v.z, l.z);
          split_tf32(v.w, v.w, l.w);
          *hi = v;
          *lo = l;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const TcItem w(item, n_mt, n_nt, splits);
      const TcSpan<ND, kBK> span(g, w.p, w.s, flat, k_stages, splits);
      const int m0 = w.mt * kBM;
      const int n0 = w.nt * BN;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sum[e] = 0.f;
      if (span.cnt > 0) {
        mbar_wait(&full[it % Tl::kStages], (it / Tl::kStages) & 1);
        split_stage(it % Tl::kStages);
        asm volatile("bar.sync %0, 128;\n" :: "r"(bar_id) : "memory");
      }
      // each slab (kSlab stages, at most 64 K) into a fresh accumulator:
      // at f32 its stages' small terms first, then their a_hi.b_hi (each
      // k8 slice is 32 bytes: +2 in a descriptor); at 2 bytes one stage's
      // four k16 slices (32 bytes each too)
      for (int k = 0; k < span.cnt;) {
        const int n = min(Tl::kSlab, span.cnt - k);
        int stg[2];
        uint64_t da_hi[2], da_lo[2], db_hi[2], db_lo[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          stg[h] = (it + h) % Tl::kStages;
          const uint8_t* a = tiles + stg[h] * Tl::kStageBytes + cw * 64 * 128;
          const uint8_t* b = tiles + stg[h] * Tl::kStageBytes + Tl::kBOffset;
          da_hi[h] = smem_desc(a);
          da_lo[h] = smem_desc(a + Tl::kABytes);
          db_hi[h] = smem_desc(b);
          db_lo[h] = smem_desc(b + Tl::kBBytes);
        }
        wgmma_fence();
        if constexpr (!Tl::kSplit) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_16<BN, T>(acc, da_hi[0] + 2 * ks, db_hi[0] + 2 * ks, ks > 0);
        } else {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_tf32<BN>(acc, da_lo[0] + 2 * ks, db_hi[0] + 2 * ks, ks > 0);
            wgmma_tf32<BN>(acc, da_hi[0] + 2 * ks, db_lo[0] + 2 * ks, 1);
          }
          if (n == 2) {
            // the slab's second stage is split while those run
            mbar_wait(&full[stg[1]], ((it + 1) / Tl::kStages) & 1);
            split_stage(stg[1]);
            asm volatile("bar.sync %0, 128;\n" :: "r"(bar_id) : "memory");
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              wgmma_tf32<BN>(acc, da_lo[1] + 2 * ks, db_hi[1] + 2 * ks, 1);
              wgmma_tf32<BN>(acc, da_hi[1] + 2 * ks, db_lo[1] + 2 * ks, 1);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h < n) {
#pragma unroll
              for (int ks = 0; ks < 4; ++ks)
                wgmma_tf32<BN>(acc, da_hi[h] + 2 * ks, db_hi[h] + 2 * ks, 1);
            }
          }
        }
        wgmma_commit();
        // while they run: the next slab's first split
        const bool more = k + n < span.cnt;
        if (more) {
          const int nxt = (it + n) % Tl::kStages;
          mbar_wait(&full[nxt], ((it + n) / Tl::kStages) & 1);
          split_stage(nxt);
        }
        fence_regs(acc);
        wgmma_wait_all();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty[stg[0]]);
          if (n == 2) mbar_arrive(&empty[stg[1]]);
        }
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
        if (more) asm volatile("bar.sync %0, 128;\n" :: "r"(bar_id) : "memory");
        k += n;
        it += n;
      }

      // -- epilogue: accumulator layout d[4j + e] at row (e < 2 ? r0 : r1),
      // column 8j + 2 t4 + (e & 1) --------------------------------------------
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + (h ? r1 : r0);
        if (m >= M) continue;
        const int orow = g.out_row(m, w.p);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * j + 2 * t4 + e;
            if (n >= g.Cout) continue;
            const float v = sum[4 * j + 2 * h + e];
            if (splits == 1) {
              out[orow * g.Cout + n] = from_f32<T>(
                  activate(v + (bias != nullptr ? bias[n] : 0.f), act, slope));
            } else {
              scratch[(w.s * Mtot + orow) * g.Cout + n] = v;
            }
          }
        }
      }
    }
  }
}

// The narrow route (see the note at the top).  Split s of phase p sums
// the K range [s * kps, (s + 1) * kps) of the phase's n_taps * Cin;
// VEC = 4 loads 16 bytes where Cin % 4 = 0.  NC = Cout.  A block takes
// PG phases (all P where their tables fit in shared memory, else one),
// each warp every phase of its rows in turn: the phases of a tconv read
// overlapping windows of the same input rows, which then come from L1.
// VEC = 4 loads four values (16 bytes at f32, 8 at 2 bytes).
template <int ND, int NC, int VEC, typename T>
__global__ void __launch_bounds__(kNarrowThreads)
narrow_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const Geom<ND> g, int splits, int kps, int pg,
              int rows_per_block, const float* __restrict__ bias,
              T* __restrict__ out, float* __restrict__ scratch, int act,
              float slope) {
  // per phase of the group: [kps][NC] weights (f32); then [kps/VEC]
  // offsets
  extern __shared__ float ws[];
  int* offs = reinterpret_cast<int*>(ws + pg * kps * NC);
  const int kc = kps / VEC;  // offset-table entries a phase
  const int s = blockIdx.z % splits;
  const int p0 = (blockIdx.z / splits) * pg;
  const int k_lo = s * kps;
  for (int ph = 0; ph < pg; ++ph) {
    const int p = p0 + ph;
    const int nk = max(min(k_lo + kps, g.n_taps[p] * g.Cin) - k_lo, 0);
    const T* wp = w + (p * g.T * g.Cin + k_lo) * NC;
    for (int e = threadIdx.x; e < nk * NC; e += kNarrowThreads)
      ws[ph * kps * NC + e] = to_f32(wp[e]);
    for (int j = threadIdx.x; j < nk / VEC; j += kNarrowThreads) {
      const int kk = k_lo + j * VEC;
      const int t = kk / g.Cin;
      offs[ph * kc + j] = g.tap_off(p, t) + (kk - t * g.Cin);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int M = g.B * g.plane();
  const int Mtot = g.B * g.P * g.plane();
  const int r_end = min((blockIdx.x + 1) * rows_per_block, M);
  for (int r = blockIdx.x * rows_per_block + warp * kNarrowRows; r < r_end;
       r += kNarrowRows * (kNarrowThreads / 32)) {
    int base[kNarrowRows];
#pragma unroll
    for (int i = 0; i < kNarrowRows; ++i)
      base[i] = r + i < r_end ? g.row_base(r + i) : -1;
    for (int ph = 0; ph < pg; ++ph) {
      const int p = p0 + ph;
      // kps and the phase's K are multiples of VEC
      const int nchunks =
          max(min(k_lo + kps, g.n_taps[p] * g.Cin) - k_lo, 0) / VEC;
      const float* wsp = ws + ph * kps * NC;
      const int* ofp = offs + ph * kc;
      float acc[kNarrowRows][NC];
#pragma unroll
      for (int i = 0; i < kNarrowRows; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
      for (int j = lane; j < nchunks; j += 32) {
        const int off = ofp[j];
        float wv[VEC][NC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
#pragma unroll
          for (int n = 0; n < NC; ++n) wv[v][n] = wsp[(j * VEC + v) * NC + n];
#pragma unroll
        for (int i = 0; i < kNarrowRows; ++i) {
          if (base[i] < 0) continue;
          float xv[VEC];
          if constexpr (VEC == 4) {
            load4(x + base[i] + off, xv);
          } else {
            xv[0] = to_f32(x[base[i] + off]);
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v)
#pragma unroll
            for (int n = 0; n < NC; ++n)
              acc[i][n] = fmaf(xv[v], wv[v][n], acc[i][n]);
        }
      }
#pragma unroll
      for (int i = 0; i < kNarrowRows; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc[i][n] += __shfl_xor_sync(0xffffffffu, acc[i][n], o);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kNarrowRows; ++i) {
          if (base[i] < 0) continue;
          const int orow = g.out_row(r + i, p);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            if (splits == 1)
              out[orow * NC + n] = from_f32<T>(activate(
                  acc[i][n] + (bias != nullptr ? bias[n] : 0.f), act, slope));
            else
              scratch[(s * Mtot + orow) * NC + n] = acc[i][n];
          }
        }
      }
    }
  }
}

// out[e] = T(act(bias + sum_s scratch[s][e])), the splits summed in
// order in f32, cast once.
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ scratch, int splits,
                              int n, int Cout,
                              const float* __restrict__ bias,
                              T* __restrict__ out, int act, float slope) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += scratch[s * n + e];
    if (bias != nullptr) v += bias[e % Cout];
    out[e] = from_f32<T>(activate(v, act, slope));
  }
}

// -- host side ----------------------------------------------------------------
// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        p == nullptr)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of the prepared (P, Cout, K) weights of type T as (K, Cout,
// P), in boxes of one 128-byte row of K (kBK values) x BN with the
// 128-byte swizzle; rows past Cout read as zeros.
template <typename T>
inline CUresult make_b_map(EncodeTiledFn fn, CUtensorMap* map, const T* b,
                           int P, int Cout, int K, int BN) {
  constexpr cuuint64_t kSize = sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(Cout),
                              static_cast<cuuint64_t>(P)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * kSize,
                                 static_cast<cuuint64_t>(K) * Cout * kSize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / kSize),
                             static_cast<cuuint32_t>(BN), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, Storage<T>::kTma, 3, const_cast<T*>(b), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The SMs of the current device (read once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// b_lo is read at f32 only (the split); at 2 bytes b_hi holds the
// weights and the kernel's second map is a copy of the first.
template <int ND, int BN, typename T>
int launch_tc(const Geom<ND>& g, const T* x, const T* b_hi, const T* b_lo,
              int kb, int flat, int splits, const float* bias, T* out,
              float* scratch, int act, float slope, cudaStream_t stream) {
  using Tl = TcTiles<BN, T>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap maps[2];
  const T* ptrs[2] = {b_hi, b_lo};
  for (int i = 0; i < Tl::kParts; ++i) {
    const CUresult r = make_b_map(fn, &maps[i], ptrs[i], g.P, g.Cout, kb, BN);
    if (r != CUDA_SUCCESS) return -(1000 * (i + 1) + static_cast<int>(r));
  }
  if (!Tl::kSplit) maps[1] = maps[0];
  const cudaError_t err = cudaFuncSetAttribute(
      tc_kernel<ND, BN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_mt = (g.B * g.plane() + kBM - 1) / kBM;
  const int n_nt = (g.Cout + BN - 1) / BN;
  const int n_items = n_mt * n_nt * g.P * splits;
  tc_kernel<ND, BN, T><<<min(n_items, sm_count()), kTcThreads,
                         Tl::kSmemBytes, stream>>>(
      maps[0], maps[1], x, g, flat, kb / Tl::kBK, splits, n_mt, n_nt, bias,
      out, scratch, act, slope);
  return 0;
}

template <int ND, int NC, typename T>
int launch_narrow(const Geom<ND>& g, const T* x, const T* w, int kps,
                  int splits, const float* bias, T* out, float* scratch,
                  int act, float slope, cudaStream_t stream) {
  const int M = g.B * g.plane();
  const int vec = g.Cin % 4 == 0 ? 4 : 1;
  // a phase's tables: kps * NC weights and kps / vec offsets (the wrapper
  // keeps one phase's within kNarrowSmemFloats); all phases in one block
  // where they fit
  const int per_phase = kps * NC + kps / vec;
  const int pg = g.P * per_phase <= kNarrowSmemFloats ? g.P : 1;
  const int smem = pg * per_phase * 4;
  // 32 to 128 rows a block: at least a wave of 8 blocks an SM where the
  // rows allow (128 timed best, by a few percent, of 32 to 512 on the
  // 3D-GAN and DCGAN g4 geometries)
  const int z = g.P / pg * splits;
  const long long work = static_cast<long long>(M) * z;
  const int blocks = sm_count() * 8;
  int rpb = static_cast<int>((work + blocks - 1) / blocks);
  rpb = min(128, max(32, (rpb + 31) / 32 * 32));
  const dim3 grid((M + rpb - 1) / rpb, 1, z);
  if (vec == 4)
    narrow_kernel<ND, NC, 4, T><<<grid, kNarrowThreads, smem, stream>>>(
        x, w, g, splits, kps, pg, rpb, bias, out, scratch, act, slope);
  else
    narrow_kernel<ND, NC, 1, T><<<grid, kNarrowThreads, smem, stream>>>(
        x, w, g, splits, kps, pg, rpb, bias, out, scratch, act, slope);
  return 0;
}

// One call: the route's kernel of storage type T, then (splits > 1) the
// reduce.  `kb` is the prepared weights' K (tc) or the K range of a split
// (narrow); `block_n` the tc tile's width (kernel_route's).
// Returns 0 when every launch was accepted, a CUDA runtime error (> 0),
// -1 when the driver has no cuTensorMapEncodeTiled, -(1000 (i + 1) + r)
// when encoding the map of b_hi (i = 0) or b_lo (i = 1) failed with
// CUresult r, or -2 for a route, tile width or Cout the kernels do not
// take.
template <int ND, typename T>
int run(const Geom<ND>& g, const T* x, const T* w, const T* b_hi,
        const T* b_lo, const float* bias, T* out, float* scratch, int route,
        int block_n, int splits, int kb, int act, float slope,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -2;
  if (route == kRouteTc || route == kRouteTcFlat) {
    const int flat = route == kRouteTcFlat;
    if (block_n == 64)
      rc = launch_tc<ND, 64, T>(g, x, b_hi, b_lo, kb, flat, splits, bias,
                                out, scratch, act, slope, st);
    else if (block_n == 128)
      rc = launch_tc<ND, 128, T>(g, x, b_hi, b_lo, kb, flat, splits, bias,
                                 out, scratch, act, slope, st);
  } else if (route == kRouteNarrow) {
    switch (g.Cout) {
#define GX_NARROW(nc)                                                        \
  case nc:                                                                   \
    rc = launch_narrow<ND, nc, T>(g, x, w, kb, splits, bias, out, scratch,  \
                                  act, slope, st);                           \
    break;
      GX_NARROW(1) GX_NARROW(2) GX_NARROW(3) GX_NARROW(4)
      GX_NARROW(5) GX_NARROW(6) GX_NARROW(7) GX_NARROW(8)
#undef GX_NARROW
      default:
        break;
    }
  }
  if (rc != 0) return rc;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int n = g.B * g.P * g.plane() * g.Cout;
    const int blocks = min((n + 255) / 256, 132 * 8);
    splitk_reduce<T><<<blocks, 256, 0, st>>>(scratch, splits, n, g.Cout,
                                             bias, out, act, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ganax
